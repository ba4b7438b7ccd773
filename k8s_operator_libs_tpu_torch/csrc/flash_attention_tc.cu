// Flash attention on Hopper's tensor cores (sm_90a): the forward (A-K1) and
// the backward, dq (A-K2) and dk/dv (A-K3), for bf16 and fp16.
//
// Replaces the TPU kernels in the JAX package's ops/attention.py:
//   flash_fwd_tc_kernel     <- _flash_kernel          (:236, pallas_call :406, A-K1)
//   flash_bwd_dq_tc_kernel  <- _flash_bwd_dq_kernel   (:439, pallas_call :651, A-K2)
//   flash_bwd_dkv_tc_kernel <- _flash_bwd_dkv_kernel  (:519, pallas_call :663, A-K3)
// launched there by _flash_forward / _flash_backward under the custom VJP of
// flash_attention. fp32 keeps the FMA kernels of flash_attention.cu: on the
// tensor cores fp32 would be TF32 (about 3 decimal digits), which fp32
// parity cannot afford. The Python wrapper picks the source by dtype.
//
// What they compute is flash_attention.cu's, rounding for rounding
// (q [B,T,H,Dh], k/v [B,T,KV,Dh], head h = kv*G + g; lse, delta fp32
// [B*KV, G, T]):
//   qs = round_T(q * round_T(scale*log2e)), s2 = qs . k, visible iff key < T
//        and, when causal, key <= query position
//   A-K1: online softmax in base 2, fp32 running max m (from -1e30) and
//         denominator l summing the unrounded p; acc += round_T(p) . v;
//         out = acc / max(l, 1e-30), lse = m*ln2 + log(max(l, 1e-30))
//   A-K2: p = exp2(s2 - lse*log2e), dq = round_T(scale * sum_k round_T(p (do.v - delta)) k)
//   A-K3: dv = round_T(sum round_T(p)^T do), dk = round_T(scale * sum ds^T q)
//         with ds = round_T(p (do.v - delta)) and the UNSCALED q, summed over
//         the rows of all G heads (the GQA sum is inside the contraction).
//
// Bound: the three do 4, 6 and 8 x B*H*Dh*sum_visible flops (the backward
// recomputes S, and dP in both kernels) on O(T*Dh) bytes, so operations
// bound them, at 989 TFLOP/s bf16 on the tensor cores. What the design
// does about that:
//   - every product is a wgmma (m64nNk16, bf16/fp16 in, fp32 accumulate):
//     S = Qs K^T and dP = dO V^T with both operands in shared memory,
//     O += P V, dQ += dS K, dV += P^T dO and dK += dS^T q with the left
//     operand converted from the accumulator layout into registers (where
//     P and dS are rounded) and the right one read MN-major (transposed)
//     from the same tile;
//   - operands stay in shared memory as stored, 128B-swizzled (each
//     64-column block of a tile is a run of 8-row x 128-byte atoms), so
//     wgmma reads them without bank conflicts and nothing is converted;
//   - a warpgroup owns 64 rows: folded (head, position) rows in A-K1 and
//     A-K2, so a K/V tile serves all G heads; A-K3's 64 keys, walking the
//     q/dO chunks of all G heads, so the group sum costs nothing. A-K1's
//     CTA is three warpgroups (192 rows) on one K/V ring, which copies
//     each K/V byte from L2 a third as often as one warpgroup per CTA
//     would; its softmax statistics stay in the 4 lanes that hold a row
//     of the accumulator (a quad shuffle). A-K2 and A-K3 are one
//     warpgroup per CTA, two CTAs per SM;
//   - cp.async copies the next K/V tile (A-K1, A-K2) or q/dO chunk (A-K3)
//     into a second stage while the tensor cores work on the current one,
//     and the warpgroups on an SM (A-K1's three, two CTAs' in A-K2/A-K3)
//     overlap one's softmax with another's products;
//   - tiles above the causal diagonal are neither loaded nor computed; only
//     tiles that straddle it or the end of T are masked (S to -inf in A-K1,
//     P and dS to zero in the backward: zero-filled rows alone give p = 1);
//   - CTAs start longest first, and every output element is written by one
//     CTA without atomics, so all three kernels are deterministic.
// Dh 32 runs as Dh 64 with zero columns (wgmma's swizzled tiles are 64
// wide). Nothing is allocated here; the Python wrapper allocates outputs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF (running-max init)
constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 64;          // wgmma M: a warpgroup's rows (A-K3: keys)
constexpr int kFwdGroups = 3;      // A-K1's warpgroups: 192 folded rows share a K/V tile
constexpr int kFwdThreads = kFwdGroups * kThreads;
constexpr int kFwdRows = kFwdGroups * kRows;
constexpr int kFwdKeys = 64;       // K/V tile of A-K1
constexpr int kDqKeys = 64;        // K/V tile of A-K2
constexpr int kDkvRows = 32;       // q/dO rows per A-K3 chunk

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// two values rounded to T, lo in the low half (the lower column)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T v[2] = {from_f32<T>(lo), from_f32<T>(hi)};
  uint32_t r;
  memcpy(&r, v, 4);
  return r;
}

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in a tile
// of R rows: 64-column blocks of R x 128 bytes, 128B-swizzled within each
// 8-row atom (what TMA's SWIZZLE_128B writes and wgmma's layout 1 reads).
__device__ __forceinline__ uint32_t tile_off(int R, int r, int c) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes from global (zeros where !valid; src must still be a valid address)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ wgmma

// Matrix descriptor of a 128B-swizzled operand (layout type 1).
// K-major: lbo unused, sbo = 1024 (the next 8 rows). MN-major: lbo = the
// next 64-column block, sbo = 1024 (the next 8 rows along K).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A . B for one k16 step. SS: A and B from shared memory
// (A K-major; B K-major if TB is 0, MN-major if 1). RS: A from registers in
// the m16n8k16 fragment layout, one 16-row slab per warp.
template <typename T, int N, int TB> struct WgmmaSS;
template <typename T, int N, int TB> struct WgmmaRS;
#define WGMMA_WRAPPERS(CT, TY)                                                                                               \
  template <int TB> struct WgmmaSS<CT, 32, TB> {                                                                             \
    static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32" TY " {"                                                      \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                                 \
                   "%16, %17, p, 1, 1, 0, %19;\n}\n"                                                                         \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])    \
                   : "l"(a), "l"(b), "r"(acc), "n"(TB));                                                                     \
    }                                                                                                                        \
  };                                                                                                                         \
  template <int TB> struct WgmmaRS<CT, 32, TB> {                                                                             \
    static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32" TY " {"                                                      \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                                 \
                   "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"                                                           \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])    \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));                                 \
    }                                                                                                                        \
  };                                                                                                                         \
  template <int TB> struct WgmmaSS<CT, 64, TB> {                                                                             \
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " {"                                                      \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
                   "%32, %33, p, 1, 1, 0, %35;\n}\n"                                                                         \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
                     "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
                   : "l"(a), "l"(b), "r"(acc), "n"(TB));                                                                     \
    }                                                                                                                        \
  };                                                                                                                         \
  template <int TB> struct WgmmaRS<CT, 64, TB> {                                                                             \
    static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " {"                                                      \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
                   "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                                                           \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
                     "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));                                 \
    }                                                                                                                        \
  };                                                                                                                         \
  template <int TB> struct WgmmaSS<CT, 128, TB> {                                                                            \
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " {"                                                     \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
                   "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
                   "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
                   "%64, %65, p, 1, 1, 0, %67;\n}\n"                                                                         \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
                     "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
                     "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                     "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
                     "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
                   : "l"(a), "l"(b), "r"(acc), "n"(TB));                                                                     \
    }                                                                                                                        \
  };                                                                                                                         \
  template <int TB> struct WgmmaRS<CT, 128, TB> {                                                                            \
    static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                              \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " {"                                                     \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
                   "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
                   "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
                   "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                                                           \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
                     "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
                     "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
                     "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                     "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
                     "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));                                 \
    }                                                                                                                        \
  };

WGMMA_WRAPPERS(__nv_bfloat16, ".bf16.bf16")
WGMMA_WRAPPERS(__half, ".f16.f16")
#undef WGMMA_WRAPPERS

// acc[64 x N] += A[64 x DP] . B[N x DP]^T, both K-major tiles in shared
// memory of a_rows and N rows (the K loop over DP in k16 steps)
template <typename T, int N, int DP>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
  for (int k = 0; k < DP / 16; ++k)  // a k16 step is 32 bytes into a 64-column block
    WgmmaSS<T, N, 0>::run(acc, desc(a + (k / 4) * a_rows * 128 + (k % 4) * 32, 16, 1024),
                          desc(b + (k / 4) * N * 128 + (k % 4) * 32, 16, 1024), 1);
}

// acc[64 x DP] += A[64 x K] . B[K x DP]: A in registers (K/16 fragments), B
// the K-row tile at b read MN-major (its 64-column blocks b_rows x 128 B apart)
template <typename T, int DP, int K>
__device__ __forceinline__ void gemm_rs(float (&acc)[DP / 2], const uint32_t (&a)[K / 16][4],
                                        uint32_t b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    WgmmaRS<T, DP, 1>::run(acc, a[kk], desc(b + kk * 16 * 128, b_rows * 128, 1024), 1);
}

// the accumulator of a [64 x K] product as K/16 A fragments, rounded to T
template <typename T, int K>
__device__ __forceinline__ void to_frags(const float (&x)[K / 2], uint32_t (&f)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack2<T>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// q * qmul rounded to T, from n bytes of shared memory to dst, by NT
// threads (the TPU kernels' scaled q; elementwise, so the swizzle does not
// matter)
template <typename T, int NT = kThreads>
__device__ __forceinline__ void scale_round(uint8_t* dst, const uint8_t* src, int n, float qmul) {
  for (int i = threadIdx.x * 16; i < n; i += NT * 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(src + i);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = from_f32<T>(to_f32<T>(e[j]) * qmul);
    *reinterpret_cast<uint4*>(dst + i) = raw;
  }
}

// max / sum over the 4 lanes that hold one row of a wgmma accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH> __host__ __device__ constexpr int padded() { return DH < 64 ? 64 : DH; }

// cp.async, by NT threads, of an R-row tile of folded rows of src ([B, T,
// H, DH]): row r is head kv*G + r/BQ at position q0 + r%BQ; rows past G*BQ
// or T and the padding columns land as zeros
template <typename T, int DH, int R = kRows, int NT = kThreads>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, int b, int kv, int G,
                                          int BQ, int q0, int T_, int H) {
  constexpr int CH = padded<DH>() / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int t = q0 + r % BQ;
    const bool ok = r < G * BQ && t < T_ && c < DH / 8;
    const T* p =
        ok ? src + ((static_cast<size_t>(b) * T_ + t) * H + kv * G + r / BQ) * DH + c * 8 : src;
    cp16(dst + tile_off(R, r, c), p, ok);
  }
}

// cp.async, by NT threads, of keys k0..k0+BK-1 of K/V head kv ([B, T, KV,
// DH]) into a K tile at dst and a V tile right after it; keys past T land
// as zeros
template <typename T, int DH, int BK, int NT = kThreads>
__device__ __forceinline__ void load_keys(uint32_t dst, const T* k, const T* v, int b, int kv,
                                          int k0, int T_, int KV) {
  constexpr int CH = padded<DH>() / 8;
  constexpr uint32_t kTile = BK * padded<DH>() * 2;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const T* base = m ? v : k;
    for (int i = threadIdx.x; i < BK * CH; i += NT) {
      const int j = i / CH, c = i % CH;
      const int key = k0 + j;
      const bool ok = key < T_ && c < DH / 8;
      const T* p =
          ok ? base + ((static_cast<size_t>(b) * T_ + key) * KV + kv) * DH + c * 8 : base;
      cp16(dst + m * kTile + tile_off(BK, j, c), p, ok);
    }
  }
}

template <int DH> constexpr size_t fwd_smem() {
  return 1024 + static_cast<size_t>(kFwdRows + 4 * kFwdKeys) * padded<DH>() * 2;
}
template <int DH> constexpr size_t dq_smem() {
  return 1024 + static_cast<size_t>(2 * kRows + 4 * kDqKeys) * padded<DH>() * 2;
}
template <int DH> constexpr size_t dkv_smem() {
  return 1024 + static_cast<size_t>(2 * kRows + 5 * kDkvRows) * padded<DH>() * 2 +
         2 * 2 * kDkvRows * sizeof(float);
}

// ------------------------------------------------------------------ A-K1

// 1-D grid of B*KV x q-tiles, the tiles with the most keys first. Row r =
// g*BQ + i of the CTA (BQ = 192/G) is head kv*G + g at position q0 + i.
// Warpgroup w owns rows 64w..64w+63; its thread (warp u, lane l) holds
// accumulator rows 64w + 16u + l/4 and +8, and the running max and
// denominator of both. Per K/V tile, each warpgroup: S = Qs K^T, the online
// softmax on S in registers, O += round_T(P) V.
template <typename T, int DH>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                        int T_, int H, int KV, int BQ, int n_bkv, int causal, float qmul) {
  constexpr int DP = padded<DH>();
  constexpr int R = kFwdRows;
  constexpr int NT = kFwdThreads;
  constexpr int BK = kFwdKeys;
  constexpr uint32_t kRowTile = R * DP * 2;
  constexpr uint32_t kKeyTile = BK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sq = smem_addr(smem);  // qs, at the end out [R][DP]
  const uint32_t skv = sq + kRowTile;   // 2 stages of K, V [BK][DP]

  const int G = H / KV;
  const int bkv = blockIdx.x % n_bkv;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int n_qt = gridDim.x / n_bkv;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bkv) * BQ;
  const int rows = G * BQ;

  const int q_last = min(q0 + BQ - 1, T_ - 1);
  const int n_tiles = causal ? q_last / BK + 1 : (T_ + BK - 1) / BK;
  load_rows<T, DH, R, NT>(sq, q, b, kv, G, BQ, q0, T_, H);
  load_keys<T, DH, BK, NT>(skv, k, v, b, kv, 0, T_, KV);
  cp_commit();

  const int wg = threadIdx.x / kThreads;
  const int warp = (threadIdx.x % kThreads) >> 5, lane = threadIdx.x & 31;
  const uint32_t sa = sq + wg * kRows * 128;  // this warpgroup's rows of qs
  int pos[2];
  float m[2], l[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    pos[a] = q0 + (kRows * wg + 16 * warp + lane / 4 + 8 * a) % BQ;
    m[a] = kNegInf;
    l[a] = 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  cp_wait_all();
  __syncthreads();
  scale_round<T, NT>(smem, smem, kRowTile, qmul);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile kt has landed; tile kt-1's stage is free
    if (kt + 1 < n_tiles)
      load_keys<T, DH, BK, NT>(skv + ((kt + 1) & 1) * 2 * kKeyTile, k, v, b, kv, (kt + 1) * BK,
                               T_, KV);
    cp_commit();
    const uint32_t sk = skv + (kt & 1) * 2 * kKeyTile;
    const uint32_t sv = sk + kKeyTile;

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
    gemm_ss<T, BK, DP>(s, sa, R, sk);
    wg_commit();
    wg_wait_all();
    pin(s);

    // element i is row a = (i >> 1) & 1 at key k0 + 8(i >> 2) + 2(lane & 3)
    // + (i & 1); mask only a tile that straddles the diagonal or T
    const int k0 = kt * BK;
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > T_) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key >= T_ || (causal && key > pos[(i >> 1) & 1])) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float m_new = fmaxf(m[a], quad_max(mx[a]));
      alpha[a] = exp2f(m[a] - m_new);
      m[a] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += s[i];  // l sums p unrounded; P V takes round_T(p)
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) l[a] = l[a] * alpha[a] + quad_sum(psum[a]);
    uint32_t pf[BK / 16][4];
    to_frags<T, BK>(s, pf);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pin(acc);
    wg_fence();
    gemm_rs<T, DP, BK>(acc, pf, sv, BK);
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

  // out through the qs tile (swizzled, so the 4-byte writes of a warp hit
  // 32 banks), then to global memory 16 bytes a thread
  __syncthreads();  // every product's reads of qs are done
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = kRows * wg + 16 * warp + lane / 4 + 8 * a;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(smem + tile_off(R, r, j) + 4 * (lane & 3)) =
          pack2<T>(acc[4 * j + 2 * a] / den, acc[4 * j + 2 * a + 1] / den);
    if ((lane & 3) == 0 && r < rows && pos[a] < T_)
      lse[(static_cast<size_t>(bkv) * G + r / BQ) * T_ + pos[a]] = m[a] * kLn2 + logf(den);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * (DH / 8); i += NT) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    const int t = q0 + r % BQ;
    if (r < rows && t < T_)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * T_ + t) * H + kv * G + r / BQ) *
                                          DH + c * 8) =
          *reinterpret_cast<const uint4*>(smem + tile_off(R, r, c));
  }
}

// ------------------------------------------------------------------ A-K2

// 1-D grid and rows as in A-K1, with one warpgroup and BQ = 64/G. Per K/V
// tile: S = Qs K^T and dP = dO V^T, dS = round_T(P (dP - delta)), dQ += dS K.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int T_, int H, int KV, int BQ, int n_bkv,
                           int causal, float qmul, float scale) {
  constexpr int DP = padded<DH>();
  constexpr int BK = kDqKeys;
  constexpr uint32_t kRowTile = kRows * DP * 2;
  constexpr uint32_t kKeyTile = BK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sq = smem_addr(smem);  // qs        [64][DP]
  const uint32_t sdo = sq + kRowTile;   // dO        [64][DP]
  const uint32_t skv = sdo + kRowTile;  // 2 stages of K, V [BK][DP]

  const int G = H / KV;
  const int bkv = blockIdx.x % n_bkv;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int n_qt = gridDim.x / n_bkv;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bkv) * BQ;
  const int rows = G * BQ;
  const int tid = threadIdx.x;

  const int q_last = min(q0 + BQ - 1, T_ - 1);
  const int n_tiles = causal ? q_last / BK + 1 : (T_ + BK - 1) / BK;
  load_rows<T, DH>(sq, q, b, kv, G, BQ, q0, T_, H);
  load_rows<T, DH>(sdo, dout, b, kv, G, BQ, q0, T_, H);
  load_keys<T, DH, BK>(skv, k, v, b, kv, 0, T_, KV);
  cp_commit();

  const int warp = tid >> 5, lane = tid & 31;
  int pos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = 16 * warp + lane / 4 + 8 * a;
    pos[a] = q0 + r % BQ;
    const bool ok = r < rows && pos[a] < T_;
    const size_t i = (static_cast<size_t>(bkv) * G + r / BQ) * T_ + pos[a];
    lse2[a] = ok ? lse[i] * kLog2e : 0.f;
    dl[a] = ok ? delta[i] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  cp_wait_all();
  __syncthreads();
  scale_round<T>(smem, smem, kRowTile, qmul);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile kt has landed; tile kt-1's stage is free
    if (kt + 1 < n_tiles)
      load_keys<T, DH, BK>(skv + ((kt + 1) & 1) * 2 * kKeyTile, k, v, b, kv, (kt + 1) * BK, T_,
                           KV);
    cp_commit();
    const uint32_t sk = skv + (kt & 1) * 2 * kKeyTile;
    const uint32_t sv = sk + kKeyTile;

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
    gemm_ss<T, BK, DP>(s, sq, kRows, sk);
    gemm_ss<T, BK, DP>(dp, sdo, kRows, sv);
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    // p and ds in place of s; mask only a tile that straddles the diagonal
    // or the end of T
    const int k0 = kt * BK;
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > T_;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int a = (i >> 1) & 1;
      const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float p = exp2f(s[i] - lse2[a]);
      if (masked && (key >= T_ || (causal && key > pos[a]))) p = 0.f;
      s[i] = p * (dp[i] - dl[a]);
    }
    uint32_t ds[BK / 16][4];
    to_frags<T, BK>(s, ds);
    pin(acc);
    wg_fence();
    gemm_rs<T, DP, BK>(acc, ds, sk, BK);
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = 16 * warp + lane / 4 + 8 * a;
    if (r >= rows || pos[a] >= T_) continue;
    T* drow = dq + ((static_cast<size_t>(b) * T_ + pos[a]) * H + kv * G + r / BQ) * DH;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < DH)
        *reinterpret_cast<uint32_t*>(drow + col) =
            pack2<T>(acc[4 * j + 2 * a] * scale, acc[4 * j + 2 * a + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ A-K3

// 1-D grid of B*KV x key tiles, the first keys (the most rows under
// causality) first. The CTA owns keys k0..k0+63 (accumulator rows) and
// walks, for each head g of the group, the 32-row q/dO chunks from the
// diagonal on; S^T and dP^T are [64 keys x 32 rows].
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int T_, int H, int KV,
                            int n_bkv, int causal, float qmul, float scale) {
  constexpr int DP = padded<DH>();
  constexpr int RQ = kDkvRows;
  constexpr int CH = DP / 8;
  constexpr uint32_t kKeyTile = kRows * DP * 2;
  constexpr uint32_t kChunk = RQ * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sk = smem_addr(smem);  // K  [64][DP]
  const uint32_t sv = sk + kKeyTile;    // V  [64][DP]
  const uint32_t sqs = sv + kKeyTile;   // qs [RQ][DP] of the current chunk
  const uint32_t sst = sqs + kChunk;    // 2 stages of q, dO [RQ][DP]
  uint8_t* qs_ptr = smem + 2 * kKeyTile;
  float* slse = reinterpret_cast<float*>(smem + 2 * kKeyTile + 5 * kChunk);  // 2 x [RQ] lse, delta

  const int G = H / KV;
  const int bkv = blockIdx.x % n_bkv;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int k0 = static_cast<int>(blockIdx.x) / n_bkv * kRows;
  const int tid = threadIdx.x;

  load_keys<T, DH, kRows>(sk, k, v, b, kv, k0, T_, KV);  // K at sk, V at sv

  const int n_chunks = (T_ + RQ - 1) / RQ;
  const int c_lo = causal ? k0 / RQ : 0;  // rows before k0 see none of these keys
  const int per_head = n_chunks - c_lo;
  const int total = G * per_head;
  auto load_chunk = [&](int it) {
    const int g = it / per_head;
    const int t0 = (c_lo + it % per_head) * RQ;
    const int h = kv * G + g;
    const uint32_t dst = sst + (it & 1) * 2 * kChunk;
    for (int i = tid; i < 2 * RQ * CH; i += kThreads) {
      const int m = i / (RQ * CH), r = (i / CH) % RQ, c = i % CH;
      const int t = t0 + r;
      const bool ok = t < T_ && c < DH / 8;
      const T* base = m ? dout : q;
      const T* p = ok ? base + ((static_cast<size_t>(b) * T_ + t) * H + h) * DH + c * 8 : base;
      cp16(dst + m * kChunk + tile_off(RQ, r, c), p, ok);
    }
    if (tid < 2 * RQ) {
      const int t = t0 + tid % RQ;
      const float* base = tid < RQ ? lse : delta;
      const bool ok = t < T_;
      const float* p = ok ? base + (static_cast<size_t>(bkv) * G + g) * T_ + t : base;
      cp4(smem_addr(slse + (it & 1) * 2 * RQ + tid), p, ok);
    }
  };
  if (total > 0) load_chunk(0);
  cp_commit();

  const int warp = tid >> 5, lane = tid & 31;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_wait_all();
    __syncthreads();  // chunk it has landed; chunk it-1's stage and qs are free
    if (it + 1 < total) load_chunk(it + 1);
    cp_commit();
    const uint32_t sq = sst + (it & 1) * 2 * kChunk;
    const uint32_t sdo = sq + kChunk;
    const float* cl = slse + (it & 1) * 2 * RQ;  // lse, then delta
    scale_round<T>(qs_ptr, qs_ptr + (sq - sqs), kChunk, qmul);
    fence_async_smem();
    __syncthreads();

    float st[RQ / 2], dpt[RQ / 2];
#pragma unroll
    for (int i = 0; i < RQ / 2; ++i) st[i] = dpt[i] = 0.f;
    pin(st);
    pin(dpt);
    wg_fence();
    gemm_ss<T, RQ, DP>(st, sk, kRows, sqs);
    gemm_ss<T, RQ, DP>(dpt, sv, kRows, sdo);
    wg_commit();
    wg_wait_all();
    pin(st);
    pin(dpt);

    // fully visible iff the chunk's first row is at or past the last key
    const int t0 = (c_lo + it % per_head) * RQ;
    const bool masked = (causal && t0 < k0 + kRows - 1) || t0 + RQ > T_ || k0 + kRows > T_;
#pragma unroll
    for (int i = 0; i < RQ / 2; ++i) {
      const int key = k0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int t = t0 + col;
      float p = exp2f(st[i] - cl[col] * kLog2e);
      if (masked && (t >= T_ || key >= T_ || (causal && key > t))) p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - cl[RQ + col]);
    }
    uint32_t pf[RQ / 16][4], df[RQ / 16][4];
    to_frags<T, RQ>(st, pf);
    to_frags<T, RQ>(dpt, df);
    pin(dva);
    pin(dka);
    wg_fence();
    gemm_rs<T, DP, RQ>(dva, pf, sdo, RQ);
    gemm_rs<T, DP, RQ>(dka, df, sq, RQ);
    wg_commit();
    wg_wait_all();
    pin(dva);
    pin(dka);
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + 16 * warp + lane / 4 + 8 * a;
    if (key >= T_) continue;
    const size_t off = ((static_cast<size_t>(b) * T_ + key) * KV + kv) * DH;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= DH) continue;
      *reinterpret_cast<uint32_t*>(dk + off + col) =
          pack2<T>(dka[4 * j + 2 * a] * scale, dka[4 * j + 2 * a + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + col) =
          pack2<T>(dva[4 * j + 2 * a], dva[4 * j + 2 * a + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse;
  const void* delta;
  void* o0;  // out / dq / dk
  void* o1;  // lse / dv
  int B, T, H, KV, causal;
  float qmul, scale;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_fwd(const Args& a) {
  const int BQ = kFwdRows / (a.H / a.KV);
  const long long blocks = static_cast<long long>((a.T + BQ - 1) / BQ) * a.B * a.KV;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_tc_kernel<T, DH>;
  const size_t smem = fwd_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.T, a.H, a.KV, BQ, a.B * a.KV, a.causal,
      a.qmul);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dq(const Args& a) {
  const int BQ = kRows / (a.H / a.KV);
  const long long blocks = static_cast<long long>((a.T + BQ - 1) / BQ) * a.B * a.KV;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_tc_kernel<T, DH>;
  const size_t smem = dq_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0), a.T, a.H, a.KV, BQ, a.B * a.KV,
      a.causal, a.qmul, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv(const Args& a) {
  const long long blocks = static_cast<long long>((a.T + kRows - 1) / kRows) * a.B * a.KV;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkv_tc_kernel<T, DH>;
  const size_t smem = dkv_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.T, a.H,
      a.KV, a.B * a.KV, a.causal, a.qmul, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// element kinds shared with the Python wrapper (fp32, 0, is not taken here)
enum Kind { kBF16 = 1, kF16 = 2 };
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DH>
int launch_one(int which, const Args& a) {
  switch (which) {
    case kFwd:
      return launch_fwd<T, DH>(a);
    case kDq:
      return launch_dq<T, DH>(a);
    case kDkv:
      return launch_dkv<T, DH>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dh(int which, int Dh, const Args& a) {
  switch (Dh) {
    case 32:
      return launch_one<T, 32>(which, a);
    case 64:
      return launch_one<T, 64>(which, a);
    case 128:
      return launch_one<T, 128>(which, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(int which, int kind, int Dh, const Args& a) {
  if (a.B <= 0 || a.T <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kBF16:
      return launch_dh<__nv_bfloat16>(which, Dh, a);
    case kF16:
      return launch_dh<__half>(which, Dh, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The signatures of flash_attention.cu's flash_forward_launch,
// flash_bwd_dq_launch and flash_bwd_dkv_launch: tensors on the device,
// contiguous, q/out/do/dq [B, T, H, Dh] and k/v/dk/dv [B, T, KV, Dh] of
// `kind` (bf16 or fp16); lse/delta fp32 [B*KV, H/KV, T]. qmul is
// round_T(scale * log2e), scale 1/sqrt(Dh). Each returns cudaGetLastError()
// after its launch (0 on success), or cudaErrorInvalidValue for a shape or
// type it does not take.

// A-K1: out and lse (base e) from q, k, v.
int flash_forward_tc_launch(int kind, const void* q, const void* k, const void* v, void* out,
                            void* lse, int B, int T, int H, int KV, int Dh, int causal,
                            float qmul, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, B, T, H, KV, causal, qmul, 0.f,
               static_cast<cudaStream_t>(stream)};
  return launch(kFwd, kind, Dh, a);
}

// A-K2: dq from q, k, v, dO, lse and delta = rowsum(dO * out).
int flash_bwd_dq_tc_launch(int kind, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int B,
                           int T, int H, int KV, int Dh, int causal, float qmul, float scale,
                           void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, T, H, KV, causal, qmul, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(kDq, kind, Dh, a);
}

// A-K3: dk and dv from the same inputs.
int flash_bwd_dkv_tc_launch(int kind, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int B, int T, int H, int KV, int Dh, int causal, float qmul,
                            float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, T, H, KV, causal, qmul, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(kDkv, kind, Dh, a);
}

}  // extern "C"

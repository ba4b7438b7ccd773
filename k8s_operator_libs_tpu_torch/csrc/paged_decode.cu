// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels in k8s_operator_libs_tpu/ops/attention.py:
//   paged_decode_kernel   (:734, A-K4) — pools in the model dtype
//   paged_decode_kernel_q (:828, A-K5) — int8 pools with fp32 row scales
// dispatched there by models/paged.py:_attend_paged_kernel.
//
// What it computes, per sequence b and query head h (GQA group of kv):
//   s_t = (q_h . k_t) / sqrt(Dh)            int8: (q_h . k_t) * ks_t / sqrt(Dh)
//   visible iff t <= lengths[b]             (lengths are pre-write lengths)
//   out = sum_t softmax(s)_t * v_t          int8: weights p_t * vs_t
// with a base-e online softmax in fp32 (running max, denominator,
// accumulator) and out = acc / max(l, 1e-30). Only blocks
// 0 .. lengths[b] / BS of the table row are read, so dead blocks may hold
// anything (NaN included); inside the last live block the rows past
// lengths[b] are skipped, never multiplied by a zero weight.
//
// Bound: bytes. A decode step reads each visible K/V row (t <= lengths[b])
// once and does 4 * Dh flops per (query head, key) — far below the ~295
// flop/byte the H100 needs before its tensor cores would be the limit — so
// the least time is visible K/V bytes / 3.35 TB/s.
//
// Design (simple and right first): one CTA per (sequence, KV head), which
// reads its own table row and length (Hopper has no scalar prefetch).
// One warp per query row of the group, q held in registers as fp32, each
// lane owning Dh/32 contiguous elements; a dot product is a per-lane
// partial plus a butterfly shuffle reduction. The live blocks stream
// through shared memory double-buffered with cp.async: block mb+1 is in
// flight while block mb is scored. Grouped GQA: the K/V tile is loaded
// once per CTA and read by all G warps — no K/V repeat. Nothing is
// allocated here; the wrapper allocates the output.
//
// At B = 4 and KV = 8 this launches 32 CTAs on 132 SMs and walks a long
// sequence's blocks one after another, so it is latency-bound well above
// its byte bound; splitting the sequence across CTAs (flash-decoding) is
// the redesign that closes the gap.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDpl = 8;  // Dh <= 256

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory per stage: K tile [BS][Dh] | V tile [BS][Dh] | (int8) ks[BS] | vs[BS]
template <typename P, int BS, bool QUANT>
__host__ __device__ constexpr size_t stage_bytes_for(int Dh) {
  return 2 * static_cast<size_t>(BS) * Dh * sizeof(P) + (QUANT ? 2 * BS * sizeof(float) : 0);
}

template <typename P, typename Q, int BS, bool QUANT>
__global__ void paged_decode_kernel(const Q* __restrict__ q,            // [B, H, Dh]
                                    const P* __restrict__ k_pool,       // [NB, BS, KV, Dh]
                                    const P* __restrict__ v_pool,       // [NB, BS, KV, Dh]
                                    const float* __restrict__ k_scale,  // [NB, BS, KV]
                                    const float* __restrict__ v_scale,  // [NB, BS, KV]
                                    const int* __restrict__ table,      // [B, MB]
                                    const int* __restrict__ lengths,    // [B]
                                    Q* __restrict__ out,                // [B, H, Dh]
                                    int H, int KV, int Dh, int MB, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;  // this warp's query row in the group
  const int dpl = Dh / 32;
  const size_t row_bytes = static_cast<size_t>(Dh) * sizeof(P);
  const size_t tile_bytes = BS * row_bytes;
  const size_t stage_bytes = stage_bytes_for<P, BS, QUANT>(Dh);

  const int len = lengths[b];
  int n_live = len / BS + 1;
  if (n_live > MB) n_live = MB;
  const int* trow = table + static_cast<size_t>(b) * MB;

  auto issue = [&](int mb, int stage) {
    const size_t blk = static_cast<size_t>(trow[mb]);
    unsigned char* st = smem + stage * stage_bytes;
    const int chunks = static_cast<int>(row_bytes / 16);
    for (int c = tid; c < BS * chunks; c += blockDim.x) {
      const int t = c / chunks;
      const int cc = c % chunks;
      const size_t row = (blk * BS + t) * KV + kv;
      cp_async16(st + t * row_bytes + cc * 16,
                 reinterpret_cast<const unsigned char*>(k_pool + row * Dh) + cc * 16);
      cp_async16(st + tile_bytes + t * row_bytes + cc * 16,
                 reinterpret_cast<const unsigned char*>(v_pool + row * Dh) + cc * 16);
    }
    if (QUANT) {
      float* ks = reinterpret_cast<float*>(st + 2 * tile_bytes);
      for (int t = tid; t < BS; t += blockDim.x) {
        const size_t srow = (blk * BS + t) * KV + kv;
        cp_async4(ks + t, k_scale + srow);
        cp_async4(ks + BS + t, v_scale + srow);
      }
    }
    cp_async_commit();
  };

  const int h = kv * G + g;
  const Q* qrow = q + (static_cast<size_t>(b) * H + h) * Dh + lane * dpl;
  float qv[kMaxDpl];
  float acc[kMaxDpl];
#pragma unroll
  for (int i = 0; i < kMaxDpl; ++i) {
    qv[i] = (i < dpl) ? to_f32<Q>(qrow[i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  issue(0, 0);
  for (int mb = 0; mb < n_live; ++mb) {
    const int stage = mb & 1;
    if (mb + 1 < n_live) {
      issue(mb + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const unsigned char* st = smem + stage * stage_bytes;
    const P* kt = reinterpret_cast<const P*>(st);
    const P* vt = reinterpret_cast<const P*>(st + tile_bytes);
    const float* ks = reinterpret_cast<const float*>(st + 2 * tile_bytes);
    int nv = len - mb * BS + 1;  // visible keys in this block, >= 1
    if (nv > BS) nv = BS;

    float s[BS];
    float bmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      const P* krow = kt + t * Dh + lane * dpl;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i)
        if (i < dpl) part += qv[i] * to_f32<P>(krow[i]);
      part = warp_sum(part);
      float sc = QUANT ? part * ks[t] * scale : part * scale;
      s[t] = (t < nv) ? sc : -INFINITY;
      bmax = fmaxf(bmax, s[t]);
    }
    const float m_new = fmaxf(m, bmax);  // finite: key mb*BS is always visible
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      const float p = (t < nv) ? expf(s[t] - m_new) : 0.f;
      psum += p;
      s[t] = QUANT ? p * ks[BS + t] : p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      if (t < nv) {
        const P* vrow = vt + t * Dh + lane * dpl;
#pragma unroll
        for (int i = 0; i < kMaxDpl; ++i)
          if (i < dpl) acc[i] += s[t] * to_f32<P>(vrow[i]);
      }
    }
    m = m_new;
    __syncthreads();  // the next iteration's issue overwrites this stage
  }

  Q* orow = out + (static_cast<size_t>(b) * H + h) * Dh + lane * dpl;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxDpl; ++i)
    if (i < dpl) orow[i] = from_f32<Q>(acc[i] / denom);
}

template <typename P, typename Q, int BS, bool QUANT>
int launch_impl(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                const void* v_scale, const int* table, const int* lengths, void* out, int B,
                int H, int KV, int Dh, int MB, cudaStream_t stream) {
  const size_t smem = 2 * stage_bytes_for<P, BS, QUANT>(Dh);
  auto kernel = paged_decode_kernel<P, Q, BS, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  kernel<<<B * KV, 32 * (H / KV), smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const P*>(k_pool), static_cast<const P*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), table, lengths,
      static_cast<Q*>(out), H, KV, Dh, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename Q, bool QUANT>
int launch_bs(int BS, const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
              const void* v_scale, const int* table, const int* lengths, void* out, int B, int H,
              int KV, int Dh, int MB, cudaStream_t stream) {
  switch (BS) {
    case 8:
      return launch_impl<P, Q, 8, QUANT>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                         out, B, H, KV, Dh, MB, stream);
    case 16:
      return launch_impl<P, Q, 16, QUANT>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                          out, B, H, KV, Dh, MB, stream);
    case 32:
      return launch_impl<P, Q, 32, QUANT>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                          out, B, H, KV, Dh, MB, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// element kinds shared with the Python wrapper
enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

}  // namespace

extern "C" {

// One decode-attention launch on `stream`. q/out: [B, H, Dh] of q_kind;
// pools [NB, BS, KV, Dh] of pool_kind; scales [NB, BS, KV] fp32 (int8 pools
// only, else null); table [B, MB] and lengths [B] int32, all on the device.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or type this kernel does not take.
int paged_decode_launch(int pool_kind, int q_kind, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale, const void* v_scale,
                        const void* table, const void* lengths, void* out, int B, int H, int KV,
                        int Dh, int BS, int MB, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 || Dh % 32 != 0 || Dh > 32 * kMaxDpl ||
      MB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_kind == kI8) {
    if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (q_kind) {
      case kF32:
        return launch_bs<int8_t, float, true>(BS, q, k_pool, v_pool, k_scale, v_scale, tbl, lens,
                                              out, B, H, KV, Dh, MB, s);
      case kBF16:
        return launch_bs<int8_t, __nv_bfloat16, true>(BS, q, k_pool, v_pool, k_scale, v_scale,
                                                      tbl, lens, out, B, H, KV, Dh, MB, s);
      case kF16:
        return launch_bs<int8_t, __half, true>(BS, q, k_pool, v_pool, k_scale, v_scale, tbl,
                                               lens, out, B, H, KV, Dh, MB, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pool_kind != q_kind) return static_cast<int>(cudaErrorInvalidValue);
  switch (pool_kind) {
    case kF32:
      return launch_bs<float, float, false>(BS, q, k_pool, v_pool, nullptr, nullptr, tbl, lens,
                                            out, B, H, KV, Dh, MB, s);
    case kBF16:
      return launch_bs<__nv_bfloat16, __nv_bfloat16, false>(BS, q, k_pool, v_pool, nullptr,
                                                            nullptr, tbl, lens, out, B, H, KV,
                                                            Dh, MB, s);
    case kF16:
      return launch_bs<__half, __half, false>(BS, q, k_pool, v_pool, nullptr, nullptr, tbl, lens,
                                              out, B, H, KV, Dh, MB, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

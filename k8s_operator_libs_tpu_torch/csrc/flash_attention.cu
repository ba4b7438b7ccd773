// Flash attention, forward and backward, in fp32 on Hopper's FMA units
// (sm_90a). bf16 and fp16 run on the tensor cores (flash_attention_tc.cu);
// this file takes fp32 only.
//
// Replaces the TPU kernels in the JAX package's ops/attention.py:
//   flash_fwd_kernel     <- _flash_kernel          (:236, pallas_call :406, A-K1)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (:439, pallas_call :651, A-K2)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (:519, pallas_call :663, A-K3)
// launched there by _flash_forward / _flash_backward under the custom VJP
// of flash_attention (the training path of models/llama.py).
//
// What they compute (q [B,T,H,Dh], k/v [B,T,KV,Dh], H = G*KV; head
// h = kv*G + g shares K/V head kv; lse and delta fp32 [B*KV, G, T]):
//   qs = round_T(q * round_T(scale*log2e))    (the TPU kernel's rounding, :278)
//   s2 = qs . k   (base-2 logits, fp32)       visible iff key < T and, when
//                                              causal, key <= query position
//   A-K1: online softmax in base 2 with fp32 running max m, denominator l,
//         accumulator acc += round_T(p) . v;  out = acc / max(l, 1e-30),
//         lse = m*ln2 + log(max(l, 1e-30))  (stored in base e)
//   A-K2: p = exp2(s2 - lse*log2e), dp = do . v, ds = round_T(p*(dp - delta)),
//         dq = round_T(scale * sum ds . k)
//   A-K3: dv = round_T(sum round_T(p)^T . do), dk = round_T(scale * sum ds^T . q)
//         over the rows of all G heads of the group (the GQA sum is inside
//         the contraction), with the UNSCALED q (:569, :612)
// Every product accumulates in fp32 by FMA; T is fp32 (the templates are
// instantiated for it alone).
//
// Bound: at the Llama-3-8B training shape (T 2048, Dh 128) the work is
// 4*B*H*Dh*sum_visible flops forward (6x backward dq, 8x dkv) on O(T*Dh)
// bytes, far above the ~295 flop/byte the H100 needs before its tensor
// cores would be the limit; so operations bound it, at 989 TFLOP/s bf16.
// These kernels multiply on the FMA units (fp32), whose peak is 67 TFLOP/s,
// so they cannot come near the bound; fp32 stays here because the tensor
// cores' fp32 (TF32) would not hold fp32 parity. What this design
// does about the bound it can see:
//   - the TPU's sequential third grid dimension (the streamed superblock,
//     state in VMEM scratch) is a loop inside one CTA, state in registers;
//   - A-K1/A-K2: one CTA per (b*KV, q-tile) walks the K/V tiles up to the
//     causal diagonal; A-K3: one CTA per (b*KV, k-tile) walks the q/dO
//     rows of all G heads from the diagonal on. dk/dv need no atomics and
//     all three kernels are deterministic;
//   - GQA is folded as on the TPU: the CTA's 64 rows are (g, position)
//     pairs of one K/V head, so every K/V tile staged in shared memory is
//     used by the G query heads and never repeated;
//   - tiles above the diagonal are neither loaded nor computed, and only
//     tiles that straddle the diagonal or the ragged end T are masked;
//   - tiles are staged in shared memory (rows padded by 4 floats so
//     16-byte reads are conflict-free); each
//     thread owns a 4-row slab of the score tile and the same rows of the
//     accumulator, so the softmax statistics never leave its half-warp.
// Nothing is allocated here; the Python wrapper allocates every output.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF (running-max init)
constexpr int kThreads = 256;      // 16 row groups x 16 lanes
constexpr int kRows = 64;          // folded (head, position) rows of an A-K1/A-K2 CTA
constexpr int kFwdKeys = 64;       // K/V tile of A-K1
constexpr int kDqKeys = 32;        // K/V tile of A-K2
constexpr int kDkvKeys = 64;       // keys owned by an A-K3 CTA
constexpr int kDkvRows = 32;       // q/dO rows per A-K3 chunk

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to the storage type and back (the TPU kernels' .astype(dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// sum / max over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float lane(float4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Stage n rows of DH elements into fp32 shared rows of stride DH + 4 with
// 16-byte global reads. src(r) gives row r's address, nullptr for a row
// that lies past the tensor (staged as zeros). Each element is passed
// through f; a second destination dst2 (if not null) receives f2 of it.
template <typename T, int DH, typename Src, typename F, typename F2>
__device__ __forceinline__ void stage(float* dst, float* dst2, int n, Src src, F f, F2 f2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DH / VEC;
  constexpr int LD = DH + 4;
  for (int c = threadIdx.x; c < n * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS;
    const int cc = c % CHUNKS;
    const T* p = src(r);
    float x[VEC];
    if (p != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + cc * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = to_f32<T>(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LD + cc * VEC);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      d[i] = make_float4(f(x[4 * i]), f(x[4 * i + 1]), f(x[4 * i + 2]), f(x[4 * i + 3]));
    if (dst2 != nullptr) {
      float4* d2 = reinterpret_cast<float4*>(dst2 + r * LD + cc * VEC);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        d2[i] = make_float4(f2(x[4 * i]), f2(x[4 * i + 1]), f2(x[4 * i + 2]), f2(x[4 * i + 3]));
    }
  }
}

struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// q * qmul rounded to the storage type: the TPU kernels' scaled q
template <typename T> struct ScaleRound {
  float qmul;
  __device__ __forceinline__ float operator()(float x) const { return round_to<T>(x * qmul); }
};

template <int DH> constexpr size_t fwd_smem() {
  return sizeof(float) * (static_cast<size_t>(kRows) * (DH + 4) +
                          static_cast<size_t>(kFwdKeys) * (DH + 4) + kRows * (kFwdKeys + 4));
}
template <int DH> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(kRows) * (DH + 4) +
                          static_cast<size_t>(kDqKeys) * (DH + 4) + kRows * (kDqKeys + 4));
}
template <int DH> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(kDkvKeys) * (DH + 4) +
                          3 * static_cast<size_t>(kDkvRows) * (DH + 4) +
                          2 * kDkvRows * (kDkvKeys + 4) + 2 * kDkvRows);
}

// ------------------------------------------------------------------ A-K1

// grid (q-tiles, B*KV); the CTA's row r = g*BQ + i is head kv*G + g at
// position q0 + i. Thread (ty, tx) owns rows 4ty..4ty+3, score columns
// tx + 16j and accumulator columns tx + 16c.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int T_, int H, int KV, int BQ,
                     int causal, float qmul) {
  constexpr int LD = DH + 4;
  constexpr int BK = kFwdKeys;
  constexpr int LDP = BK + 4;
  constexpr int DPT = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [kRows][LD]  scaled, rounded q
  float* skv = sq + kRows * LD;  // [BK][LD]     K, then V
  float* sp = skv + BK * LD;     // [kRows][LDP] round_T(p)

  const int G = H / KV;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows start first
  const int rows = G * BQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  stage<T, DH>(
      sq, nullptr, kRows,
      [&](int r) -> const T* {
        const int t = q0 + r % BQ;
        if (r >= rows || t >= T_) return nullptr;
        return q + ((static_cast<size_t>(b) * T_ + t) * H + kv * G + r / BQ) * DH;
      },
      ScaleRound<T>{qmul}, Identity{});

  int pos[4];
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    pos[a] = q0 + (4 * ty + a) % BQ;
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + BQ - 1, T_ - 1);
  const int n_tiles = causal ? q_last / BK + 1 : (T_ + BK - 1) / BK;
  const T* kbase = k + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;
  const T* vbase = v + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's V and P reads are done
    stage<T, DH>(
        skv, nullptr, BK,
        [&](int r) -> const T* {
          return k0 + r < T_ ? kbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
        },
        Identity{}, Identity{});
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = ld4(sq + (4 * ty + a) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ld4(skv + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = dot4(s[a][j], qa[a], kb[j]);
    }

    // mask only a tile that straddles the diagonal or the end of T
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > T_;
    if (masked) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key >= T_ || (causal && key > pos[a])) s[a][j] = -INFINITY;
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
      mx = group_max(mx);
      const float m_new = fmaxf(m[a], mx);
      const float alpha = exp2f(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[a][j] - m_new);
        psum += p;
        sp[(4 * ty + a) * LDP + tx + 16 * j] = round_to<T>(p);
      }
      psum = group_sum(psum);
      l[a] = l[a] * alpha + psum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[a][c] *= alpha;
    }

    __syncthreads();  // K reads are done and P is written
    stage<T, DH>(
        skv, nullptr, BK,
        [&](int r) -> const T* {
          return k0 + r < T_ ? vbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
        },
        Identity{}, Identity{});
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ld4(sp + (4 * ty + a) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) vv[c] = skv[(kk + u) * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = lane(pa[a], u);
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    if (r >= rows || pos[a] >= T_) continue;
    const int g = r / BQ;
    const float den = fmaxf(l[a], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * T_ + pos[a]) * H + kv * G + g) * DH;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[tx + 16 * c] = from_f32<T>(acc[a][c] / den);
    if (tx == 0) lse[(static_cast<size_t>(bkv) * G + g) * T_ + pos[a]] = m[a] * kLn2 + logf(den);
  }
}

// ------------------------------------------------------------------ A-K2

// grid (q-tiles, B*KV), rows as in A-K1. Per K/V tile: dP = dO V^T, then
// S = Qs K^T, dS = round_T(P (dP - delta)), dq += dS K.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int T_, int H, int KV, int BQ, int causal, float qmul,
                        float scale) {
  constexpr int LD = DH + 4;
  constexpr int BK = kDqKeys;
  constexpr int LDS = BK + 4;
  constexpr int DPT = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;               // [kRows][LD] scaled, rounded q
  float* sdo = sq + kRows * LD;   // [kRows][LD] dO
  float* skv = sdo + kRows * LD;  // [BK][LD]    V, then K
  float* sds = skv + BK * LD;     // [kRows][LDS] dS

  const int G = H / KV;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int rows = G * BQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  auto row_ptr = [&](const T* base, int r) -> const T* {
    const int t = q0 + r % BQ;
    if (r >= rows || t >= T_) return nullptr;
    return base + ((static_cast<size_t>(b) * T_ + t) * H + kv * G + r / BQ) * DH;
  };
  stage<T, DH>(sq, nullptr, kRows, [&](int r) { return row_ptr(q, r); }, ScaleRound<T>{qmul},
               Identity{});
  stage<T, DH>(sdo, nullptr, kRows, [&](int r) { return row_ptr(dout, r); }, Identity{},
               Identity{});

  int pos[4];
  float lse2[4], dl[4], acc[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    pos[a] = q0 + r % BQ;
    const bool ok = r < rows && pos[a] < T_;
    const size_t i = (static_cast<size_t>(bkv) * G + r / BQ) * T_ + pos[a];
    lse2[a] = ok ? lse[i] * kLog2e : 0.f;
    dl[a] = ok ? delta[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + BQ - 1, T_ - 1);
  const int n_tiles = causal ? q_last / BK + 1 : (T_ + BK - 1) / BK;
  const T* kbase = k + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;
  const T* vbase = v + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS reads are done
    stage<T, DH>(
        skv, nullptr, BK,
        [&](int r) -> const T* {
          return k0 + r < T_ ? vbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
        },
        Identity{}, Identity{});
    __syncthreads();

    float dp[4][2], s[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j) dp[a][j] = s[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 oa[4], vb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) oa[a] = ld4(sdo + (4 * ty + a) * LD + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) vb[j] = ld4(skv + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) dp[a][j] = dot4(dp[a][j], oa[a], vb[j]);
    }

    __syncthreads();  // V reads are done
    stage<T, DH>(
        skv, nullptr, BK,
        [&](int r) -> const T* {
          return k0 + r < T_ ? kbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
        },
        Identity{}, Identity{});
    __syncthreads();

#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = ld4(sq + (4 * ty + a) * LD + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) kb[j] = ld4(skv + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[a][j] = dot4(s[a][j], qa[a], kb[j]);
    }

    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > T_;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = exp2f(s[a][j] - lse2[a]);
        if (masked && (key >= T_ || (causal && key > pos[a]))) p = 0.f;
        sds[(4 * ty + a) * LDS + tx + 16 * j] = round_to<T>(p * (dp[a][j] - dl[a]));
      }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = ld4(sds + (4 * ty + a) * LDS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv_[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) kv_[c] = skv[(kk + u) * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ds = lane(da[a], u);
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[a][c] = fmaf(ds, kv_[c], acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    if (r >= rows || pos[a] >= T_) continue;
    T* drow = dq + ((static_cast<size_t>(b) * T_ + pos[a]) * H + kv * G + r / BQ) * DH;
#pragma unroll
    for (int c = 0; c < DPT; ++c) drow[tx + 16 * c] = from_f32<T>(acc[a][c] * scale);
  }
}

// ------------------------------------------------------------------ A-K3

// grid (k-tiles, B*KV). The CTA owns keys k0..k0+63 and walks, for each
// head g of the group, the 32-row q/dO chunks from the diagonal on.
// Thread (ty, tx) owns keys 4ty..4ty+3; in the score tile (S^T) it takes
// rows tx and tx + 16 of the chunk, in dk/dv the columns tx + 16c.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int T_, int H, int KV,
                         int causal, float qmul, float scale) {
  constexpr int LD = DH + 4;
  constexpr int BKV = kDkvKeys;
  constexpr int RQ = kDkvRows;
  constexpr int LDP = BKV + 4;
  constexpr int DPT = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;               // [BKV][LD]
  float* sv = sk + BKV * LD;      // [BKV][LD]
  float* sqr = sv + BKV * LD;     // [RQ][LD]  q as stored
  float* sqs = sqr + RQ * LD;     // [RQ][LD]  scaled, rounded q
  float* sdo = sqs + RQ * LD;     // [RQ][LD]  dO
  float* sp = sdo + RQ * LD;      // [RQ][LDP] round_T(p)
  float* sds = sp + RQ * LDP;     // [RQ][LDP] round_T(dS)
  float* slse = sds + RQ * LDP;   // [RQ]      lse * log2e
  float* sdl = slse + RQ;         // [RQ]      delta

  const int G = H / KV;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int k0 = blockIdx.x * kDkvKeys;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const T* kbase = k + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;
  const T* vbase = v + static_cast<size_t>(b) * T_ * KV * DH + kv * DH;
  stage<T, DH>(
      sk, nullptr, BKV,
      [&](int r) -> const T* {
        return k0 + r < T_ ? kbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
      },
      Identity{}, Identity{});
  stage<T, DH>(
      sv, nullptr, BKV,
      [&](int r) -> const T* {
        return k0 + r < T_ ? vbase + static_cast<size_t>(k0 + r) * KV * DH : nullptr;
      },
      Identity{}, Identity{});

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dka[a][c] = dva[a][c] = 0.f;

  const int n_chunks = (T_ + RQ - 1) / RQ;
  const int c_lo = causal ? k0 / RQ : 0;  // rows before k0 see none of these keys
  for (int g = 0; g < G; ++g) {
    const int h = kv * G + g;
    const float* lrow = lse + (static_cast<size_t>(bkv) * G + g) * T_;
    const float* drow = delta + (static_cast<size_t>(bkv) * G + g) * T_;
    for (int ch = c_lo; ch < n_chunks; ++ch) {
      const int t0 = ch * RQ;
      __syncthreads();  // the previous chunk's reads are done
      auto row_ptr = [&](const T* base, int r) -> const T* {
        return t0 + r < T_ ? base + ((static_cast<size_t>(b) * T_ + t0 + r) * H + h) * DH
                           : nullptr;
      };
      stage<T, DH>(sqr, sqs, RQ, [&](int r) { return row_ptr(q, r); }, Identity{},
                   ScaleRound<T>{qmul});
      stage<T, DH>(sdo, nullptr, RQ, [&](int r) { return row_ptr(dout, r); }, Identity{},
                   Identity{});
      if (threadIdx.x < RQ) {
        const int t = t0 + threadIdx.x;
        slse[threadIdx.x] = t < T_ ? lrow[t] * kLog2e : 0.f;
        sdl[threadIdx.x] = t < T_ ? drow[t] : 0.f;
      }
      __syncthreads();

      float st[4][2], dpt[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) st[a][j] = dpt[a][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
        float4 ka[4], va[4], qb[2], ob[2];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ka[a] = ld4(sk + (4 * ty + a) * LD + d);
          va[a] = ld4(sv + (4 * ty + a) * LD + d);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qb[j] = ld4(sqs + (tx + 16 * j) * LD + d);
          ob[j] = ld4(sdo + (tx + 16 * j) * LD + d);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[a][j] = dot4(st[a][j], ka[a], qb[j]);
            dpt[a][j] = dot4(dpt[a][j], va[a], ob[j]);
          }
      }

      // fully visible iff the chunk's first row is at or past the last key
      const bool masked = (causal && t0 < k0 + BKV - 1) || t0 + RQ > T_ || k0 + BKV > T_;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tx + 16 * j;
        const int t = t0 + r;
        const float l2 = slse[r];
        const float dl = sdl[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int key = k0 + 4 * ty + a;
          float p = exp2f(st[a][j] - l2);
          if (masked && (t >= T_ || key >= T_ || (causal && key > t))) p = 0.f;
          sp[r * LDP + 4 * ty + a] = round_to<T>(p);
          sds[r * LDP + 4 * ty + a] = round_to<T>(p * (dpt[a][j] - dl));
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < RQ; ++r) {
        const float4 pp = ld4(sp + r * LDP + 4 * ty);
        const float4 dd = ld4(sds + r * LDP + 4 * ty);
        float ov[DPT], qv[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          ov[c] = sdo[r * LD + tx + 16 * c];
          qv[c] = sqr[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pa = lane(pp, a);
          const float da = lane(dd, a);
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dva[a][c] = fmaf(pa, ov[c], dva[a][c]);
            dka[a][c] = fmaf(da, qv[c], dka[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + 4 * ty + a;
    if (key >= T_) continue;
    const size_t off = ((static_cast<size_t>(b) * T_ + key) * KV + kv) * DH;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dka[a][c] * scale);
      dv[off + tx + 16 * c] = from_f32<T>(dva[a][c]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse_in;
  const void* delta;
  void* o0;  // out / dq / dk
  void* o1;  // lse / dv
  int B, T, H, KV, causal;
  float qmul, scale;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_fwd(const Args& a) {
  const int BQ = kRows / (a.H / a.KV);
  const dim3 grid((a.T + BQ - 1) / BQ, a.B * a.KV);
  auto kernel = flash_fwd_kernel<T, DH>;
  const size_t smem = fwd_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.T, a.H, a.KV, BQ, a.causal, a.qmul);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dq(const Args& a) {
  const int BQ = kRows / (a.H / a.KV);
  const dim3 grid((a.T + BQ - 1) / BQ, a.B * a.KV);
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  const size_t smem = dq_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0), a.T, a.H, a.KV, BQ, a.causal,
      a.qmul, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv(const Args& a) {
  const dim3 grid((a.T + kDkvKeys - 1) / kDkvKeys, a.B * a.KV);
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  const size_t smem = dkv_smem<DH>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.T,
      a.H, a.KV, a.causal, a.qmul, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// element kinds shared with the Python wrapper: bf16 (1) and fp16 (2) run
// on the tensor cores (flash_attention_tc.cu); here only fp32
enum Kind { kF32 = 0 };
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
  if (kind != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dh<float>(which, Dh, a);
}

}  // namespace

extern "C" {

// All tensors on the device, contiguous: q/out/dq/do [B, T, H, Dh] and
// k/v/dk/dv [B, T, KV, Dh] of `kind` (fp32); lse/delta fp32 [B*KV, H/KV, T].
// qmul is round_T(scale * log2e), scale 1/sqrt(Dh). Each returns
// cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape or type it does not take.

// A-K1 (fp32): out and lse (base e) from q, k, v.
int flash_forward_launch(int kind, const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int T, int H, int KV, int Dh, int causal, float qmul,
                         void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, B, T, H, KV, causal, qmul, 0.f,
               static_cast<cudaStream_t>(stream)};
  return launch(kFwd, kind, Dh, a);
}

// A-K2 (fp32): dq from q, k, v, dO, lse and delta = rowsum(dO * out).
int flash_bwd_dq_launch(int kind, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int T, int H, int KV,
                        int Dh, int causal, float qmul, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, T, H, KV, causal, qmul, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(kDq, kind, Dh, a);
}

// A-K3 (fp32): dk and dv from the same inputs.
int flash_bwd_dkv_launch(int kind, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                         int B, int T, int H, int KV, int Dh, int causal, float qmul, float scale,
                         void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, T, H, KV, causal, qmul, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(kDkv, kind, Dh, a);
}

}  // extern "C"

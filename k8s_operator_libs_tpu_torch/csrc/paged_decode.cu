// Paged single-token decode attention for Hopper (sm_90a), split over the
// sequence (flash-decoding).
//
// Replaces the TPU kernels in the JAX package's ops/attention.py:
//   paged_decode_kernel   (:734, A-K4) — pools in the model dtype
//   paged_decode_kernel_q (:828, A-K5) — int8 pools with fp32 row scales
// dispatched there by models/paged.py:_attend_paged_kernel.
//
// What it computes, per sequence b and query head h (GQA group of kv):
//   s_t = (q_h . k_t) / sqrt(Dh)            int8: (q_h . k_t) * ks_t / sqrt(Dh)
//   visible iff t <= lengths[b]             (lengths are pre-write lengths)
//   out = sum_t softmax(s)_t * v_t          int8: weights p_t * vs_t
// with the softmax in fp32 and out = acc / max(l, 1e-30). Only blocks
// 0 .. lengths[b] / BS (capped at MB) of the table row are read, table
// entries included, so dead blocks may hold anything (NaN included); inside
// the last live block the rows past lengths[b] are skipped, never multiplied
// by a zero weight. Roundings: the TPU kernel's. P is rounded to the pool
// type before P V, and int8's p * vs to q's type (ops/attention.py:815, :899
// of the JAX package); l sums the unrounded p. q and the pools are widened
// to fp32 and every product accumulates in fp32, on the FMA units: fp32
// pools must not take TF32.
//
// Bound: bytes. A decode step reads each visible K/V row once and does
// 4 * Dh flops per (query head, key) — with G query heads per K/V row that
// is about G flop/byte, far below the ~295 flop/byte the H100 needs before
// its tensor cores would be the limit — so the least time is the visible
// K/V bytes / 3.35 TB/s.
//
// Design: what it does about the bound.
// - Split. One CTA per (sequence, KV head) walking every live block in turn
//   would give 32 CTAs on 132 SMs at the serving shape, the longest
//   sequence's CTAs waiting on one block at a time. So the grid is
//   (B * KV, n_split): CTA (bkv, i) takes blocks [i * split_blocks,
//   (i + 1) * split_blocks) of its sequence, cut at n_live, and returns
//   before it reads anything when that range is empty. split_blocks and
//   n_split come from the host (ops/paged_attention.py:split_plan) from the
//   shapes and the SM count only, never from lengths, which live on the
//   card.
// - Ring. Each CTA streams its K blocks and then its V blocks through a
//   four-stage cp.async ring of 16-byte copies (int8 scales beside them):
//   three stages are in flight while one is used. A stage holds as many
//   consecutive blocks of one pool as fit in 8 KB (2 for bf16 at Dh 128 and
//   BS 16, 4 for int8), so a CTA passes few barriers per byte.
// - Occupancy. The kernel issues many dependent shared-memory loads, FMAs
//   and shuffles per byte it reads, so it needs warps to hide their latency:
//   at Dh <= 128 with few P V units its register arrays are halved (an
//   instance of its own), which fits six CTAs per SM instead of three.
// - Scores without a serial chain. A team of 8 lanes takes one key: each lane
//   holds 16-byte chunks of the key row widened to fp32 and dots them with
//   the G query rows (fp32, in shared memory), so each of the G x BS scores of
//   a block is one 3-step shuffle reduction, independent of the others.
//   Scores of the whole split (at most 256 keys) stay in shared memory; the
//   softmax over them runs once, a warp per query row.
// - P V. A thread owns 4 columns of 4 query rows, so each V element it
//   widens serves 4 rows; with G * Dh / 16 below the CTA's 128 threads the
//   keys are dealt out in phases (every 4th key at G 4, Dh 128) and the
//   phases' fp32 sums are added in phase order through shared memory.
// - Merge. A CTA writes fp32 partials (m_i, l_i, acc_i) per query row to a
//   workspace the wrapper allocates; a second kernel, launched from the same
//   entry point, reads the live splits in split order and writes
//   out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30), M the
//   largest m_i. No atomics, so the result is the same bits every call. Split
//   0 holds key 0, so M is finite; a split with m_i = -inf adds exactly 0. A
//   sequence whose live blocks fit in one split is written directly by its
//   CTA, and the merge kernel skips it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // four warps per CTA
constexpr int kStages = 4;          // cp.async ring: three stages in flight
constexpr int kStageBytes = 8192;   // a stage holds this much of K or V, or one block
constexpr int kTeam = 8;            // lanes per key in the score phase
constexpr int kTeams = kThreads / kTeam;
constexpr int kLaneElems = 32;      // row elements per score lane: Dh / kTeam, Dh <= 256
constexpr int kMaxSplitKeys = 256;  // a split's scores live in shared memory
constexpr int kMaxUnits = 4;        // P V units per thread: (4 rows, 4 columns), G * Dh <= 8192

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// x rounded to T (round to nearest even) and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The elements of one 32-bit word of a row, widened to fp32 (exactly).
template <typename P> __device__ __forceinline__ void unpack(unsigned w, float* dst);
template <> __device__ __forceinline__ void unpack<float>(unsigned w, float* dst) {
  dst[0] = __uint_as_float(w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(unsigned w, float* dst) {
  dst[0] = __uint_as_float(w << 16);
  dst[1] = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void unpack<__half>(unsigned w, float* dst) {
  dst[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  dst[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
// int8 without the quarter-rate I2F: byte i + 128 becomes the low mantissa
// byte of 2^23 (one byte permute), and 2^23 + 128 comes off exactly.
template <> __device__ __forceinline__ void unpack<int8_t>(unsigned w, float* dst) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
}

// 16 bytes of a row in shared memory (16 / sizeof(P) elements) as fp32.
template <typename P> __device__ __forceinline__ void load16(const P* src, float* dst) {
  constexpr int kPerWord = 4 / sizeof(P);
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  unpack<P>(v.x, dst);
  unpack<P>(v.y, dst + kPerWord);
  unpack<P>(v.z, dst + 2 * kPerWord);
  unpack<P>(v.w, dst + 3 * kPerWord);
}

// Four consecutive elements of a row in shared memory as fp32.
template <typename P> __device__ __forceinline__ void load4(const P* src, float* dst) {
  if constexpr (sizeof(P) == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    unpack<P>(v.x, dst);
    unpack<P>(v.y, dst + 1);
    unpack<P>(v.z, dst + 2);
    unpack<P>(v.w, dst + 3);
  } else if constexpr (sizeof(P) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    unpack<P>(v.x, dst);
    unpack<P>(v.y, dst + 2);
  } else {
    unpack<P>(*reinterpret_cast<const unsigned*>(src), dst);
  }
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One block of one pool in a ring stage: its rows and (int8) their scales
template <typename P, int BS, bool QUANT>
__host__ __device__ constexpr size_t block_bytes_for(int Dh) {
  return static_cast<size_t>(BS) * Dh * sizeof(P) + (QUANT ? BS * sizeof(float) : 0);
}

// Blocks per ring stage: about kStageBytes, so that small blocks (int8,
// short rows) still keep that many bytes in flight per stage
template <typename P, int BS, bool QUANT>
__host__ __device__ constexpr int stage_blocks_for(int Dh, int split_blocks) {
  const int fit = static_cast<int>(kStageBytes / block_bytes_for<P, BS, QUANT>(Dh));
  return fit < 1 ? 1 : (fit < split_blocks ? fit : split_blocks);
}

// P V units, one per (group of 4 query rows, 4 columns): each thread takes
// one unit and a share (phase) of the keys, or several units and all keys
__host__ __device__ constexpr int pv_units(int G, int Dh) { return (Dh / 4) * ((G + 3) / 4); }
__host__ __device__ constexpr int pv_phases(int G, int Dh) {
  return pv_units(G, Dh) >= kThreads ? 1 : kThreads / pv_units(G, Dh);
}

// Dynamic shared memory: the ring of kStages stages, each CB blocks of one
// pool (rows [CB*BS][Dh] | scales [CB*BS]), which the phases' P V sums
// [phases][units][16] reuse at the end | q [G][Dh] | scores [G][split keys]
// | (m, l) [G][2]
template <typename P, int BS, bool QUANT>
__host__ __device__ constexpr size_t smem_bytes_for(int G, int Dh, int split_blocks) {
  const size_t ring = kStages * stage_blocks_for<P, BS, QUANT>(Dh, split_blocks) *
                      block_bytes_for<P, BS, QUANT>(Dh);
  const size_t sums = sizeof(float) * 16 * pv_phases(G, Dh) * pv_units(G, Dh);
  return (ring > sums ? ring : sums) +
         sizeof(float) * (static_cast<size_t>(G) * Dh + static_cast<size_t>(G) * split_blocks * BS +
                          2 * G);
}

// LANE_ELEMS (Dh / kTeam at most) and MAX_UNITS (P V units per thread) size
// the register arrays: the small instance (Dh <= 128, G * Dh / 16 <= 128
// units) needs half the registers and so fits twice the CTAs per SM.
template <typename P, typename Q, int BS, bool QUANT, int LANE_ELEMS, int MAX_UNITS>
__global__ void __launch_bounds__(kThreads, MAX_UNITS == 1 ? 6 : 3)
    paged_decode_split_kernel(const Q* __restrict__ q,            // [B, H, Dh]
                              const P* __restrict__ k_pool,       // [NB, BS, KV, Dh]
                              const P* __restrict__ v_pool,       // [NB, BS, KV, Dh]
                              const float* __restrict__ k_scale,  // [NB, BS, KV]
                              const float* __restrict__ v_scale,  // [NB, BS, KV]
                              const int* __restrict__ table,      // [B, MB]
                              const int* __restrict__ lengths,    // [B]
                              Q* __restrict__ out,                // [B, H, Dh]
                              float* __restrict__ ws_acc,         // [B*KV, n_split, G, Dh]
                              float* __restrict__ ws_ml,          // [B*KV, n_split, G, 2]
                              int H, int KV, int Dh, int MB, int split_blocks, float scale) {
  constexpr int kEpc = 16 / sizeof(P);  // elements per 16-byte chunk
  constexpr int kChunksPerLane = LANE_ELEMS / kEpc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int G = H / KV;
  const int tid = threadIdx.x;

  const int len = lengths[b];
  const int n_live = min(len / BS + 1, MB);
  const int mb0 = split * split_blocks;
  if (mb0 >= n_live) return;
  const int nb = min(split_blocks, n_live - mb0);  // blocks of this split

  const int SK = split_blocks * BS;
  const int CB = stage_blocks_for<P, BS, QUANT>(Dh, split_blocks);  // blocks per stage
  const int n_items = (nb + CB - 1) / CB;  // stages of each pool
  const int chunks = Dh / kEpc;            // 16-byte chunks per row
  const size_t row_bytes = static_cast<size_t>(Dh) * sizeof(P);
  const size_t rows_bytes = static_cast<size_t>(CB) * BS * row_bytes;
  const size_t stage_bytes = CB * block_bytes_for<P, BS, QUANT>(Dh);
  const int units = pv_units(G, Dh);
  const int phases = pv_phases(G, Dh);
  const size_t sums_bytes = sizeof(float) * 16 * phases * units;
  const size_t ring_bytes = kStages * stage_bytes;
  float* qs = reinterpret_cast<float*>(smem + (ring_bytes > sums_bytes ? ring_bytes : sums_bytes));
  float* ss = qs + G * Dh;  // [G][SK]: scores, then probabilities
  float* ml = ss + G * SK;  // [G][2]: row max, row sum
  const int* trow = table + static_cast<size_t>(b) * MB;

  // item i < n_items holds K blocks mb0 + i*CB .. (at most CB of them, cut
  // at nb), item n_items + i the same V blocks: CB*BS consecutive keys,
  // rows then scales. An item past the last still commits an (empty)
  // group, so the wait count is fixed.
  auto issue = [&](int item) {
    if (item < 2 * n_items) {
      const bool is_v = item >= n_items;
      const int first = (is_v ? item - n_items : item) * CB;  // block within the split
      const int rows = min(CB, nb - first) * BS;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(is_v ? v_pool : k_pool);
      unsigned char* st = smem + (item % kStages) * stage_bytes;
      for (int c = tid; c < rows * chunks; c += kThreads) {
        const int r = c / chunks;
        const int cc = c - r * chunks;
        const size_t blk = static_cast<size_t>(trow[mb0 + first + r / BS]);
        cp_async16(st + r * row_bytes + cc * 16,
                   src + ((blk * BS + r % BS) * KV + kv) * row_bytes + cc * 16);
      }
      if (QUANT) {
        const float* sc = is_v ? v_scale : k_scale;
        for (int r = tid; r < rows; r += kThreads) {
          const size_t blk = static_cast<size_t>(trow[mb0 + first + r / BS]);
          cp_async4(reinterpret_cast<float*>(st + rows_bytes) + r,
                    sc + (blk * BS + r % BS) * KV + kv);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const Q* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) qs[i] = to_f32<Q>(qg[i]);

  // ---- scores: a team of 8 lanes per key, G independent reductions each
  const int team = tid / kTeam;
  const int sub = tid % kTeam;
  int item = 0;
  for (int j = 0; j < n_items; ++j, ++item) {
    issue(item + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (item % kStages) * stage_bytes;
    const P* kt = reinterpret_cast<const P*>(st);
    const float* ksc = reinterpret_cast<const float*>(st + rows_bytes);
    const int key0 = (mb0 + j * CB) * BS;  // position of the item's first key
    const int n_keys = min(CB, nb - j * CB) * BS;
    float* sj = ss + j * CB * BS;
    // n_keys is a multiple of 8, so a warp's four teams all enter or all
    // skip, and the shuffles below run on full warps
    for (int t = team; t < n_keys; t += kTeams) {
      float kf[LANE_ELEMS];
#pragma unroll
      for (int c = 0; c < kChunksPerLane; ++c) {
        const int cc = sub + c * kTeam;
        if (cc < chunks) load16<P>(kt + t * Dh + cc * kEpc, kf + c * kEpc);
      }
      const bool visible = key0 + t <= len;
#pragma unroll 4
      for (int g = 0; g < G; ++g) {
        const float* qrow = qs + g * Dh;
        float two[2] = {0.f, 0.f};  // two chains: half the dependent FMAs
#pragma unroll
        for (int c = 0; c < kChunksPerLane; ++c) {
          const int cc = sub + c * kTeam;
          if (cc < chunks) {
#pragma unroll
            for (int e = 0; e < kEpc; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qrow + cc * kEpc + e);
              float& part = two[((c * kEpc + e) / 4) & 1];
              part = fmaf(kf[c * kEpc + e], qv.x, part);
              part = fmaf(kf[c * kEpc + e + 1], qv.y, part);
              part = fmaf(kf[c * kEpc + e + 2], qv.z, part);
              part = fmaf(kf[c * kEpc + e + 3], qv.w, part);
            }
          }
        }
        float part = two[0] + two[1];
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (sub == 0) {
          const float s = QUANT ? part * ksc[t] * scale : part * scale;
          sj[g * SK + t] = visible ? s : -INFINITY;
        }
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }

  // ---- softmax over the split, a warp per query row; key mb0 * BS is
  // visible, so every row max is finite
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int keys = nb * BS;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* srow = ss + g * SK;
    float m = -INFINITY;
    for (int k = lane; k < keys; k += 32) m = fmaxf(m, srow[k]);
    m = warp_max(m);
    float l = 0.f;
    for (int k = lane; k < keys; k += 32) {
      const float p = expf(srow[k] - m);  // exactly 0 for an invisible key
      if constexpr (QUANT) {
        srow[k] = p;  // rounded with its v scale in P V
      } else {
        srow[k] = round_to<P>(p);
      }
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * g] = m;
      ml[2 * g + 1] = l;
    }
  }

  // ---- P V: a thread takes one unit (4 rows x 4 columns) and every
  // phases-th visible key, or (G * Dh / 16 > kThreads) several units and
  // every key; the V loop's first barrier orders the softmax's writes
  // before these reads
  const int D4 = Dh / 4;
  const int phase = units >= kThreads ? 0 : tid / units;
  float acc[MAX_UNITS][4][4];
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][r][e] = 0.f;
  for (int j = 0; j < n_items; ++j, ++item) {
    issue(item + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (item % kStages) * stage_bytes;
    const P* vt = reinterpret_cast<const P*>(st);
    const float* vsc = reinterpret_cast<const float*>(st + rows_bytes);
    const int key0 = (mb0 + j * CB) * BS;
    // visible keys of the item (a prefix, at least one)
    const int nv = min(min(CB, nb - j * CB) * BS, len - key0 + 1);
#pragma unroll
    for (int ui = 0; ui < MAX_UNITS; ++ui) {
      const int u = units >= kThreads ? tid + ui * kThreads : (ui == 0 ? tid % units : units);
      if (phase < phases && u < units) {
        const int g0 = (u / D4) * 4;
        const int d = (u % D4) * 4;
        const float* p0 = ss + g0 * SK + j * CB * BS;
        for (int t = phase; t < nv; t += phases) {
          float vf[4];
          load4<P>(vt + t * Dh + d, vf);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (g0 + r < G) {
              float w = p0[r * SK + t];
              if constexpr (QUANT) w = round_to<Q>(w * vsc[t]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[ui][r][e] = fmaf(w, vf[e], acc[ui][r][e]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- the phases' sums through shared memory (the ring is free now),
  // added in phase order
  float* sums = reinterpret_cast<float*>(smem);  // [phases][units][4 rows][4 columns]
#pragma unroll
  for (int ui = 0; ui < MAX_UNITS; ++ui) {
    const int u = units >= kThreads ? tid + ui * kThreads : (ui == 0 ? tid % units : units);
    if (phase < phases && u < units) {
      float* dst = sums + (static_cast<size_t>(phase) * units + u) * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(dst + 4 * r) =
            make_float4(acc[ui][r][0], acc[ui][r][1], acc[ui][r][2], acc[ui][r][3]);
    }
  }
  __syncthreads();

  // ---- out directly when one split holds the sequence, else the partials
  const bool direct = n_live <= split_blocks;
  const size_t part0 = static_cast<size_t>(bkv) * n_split + split;
  for (int i = tid; i < G * D4; i += kThreads) {
    const int g = i / D4;
    const int d = (i - g * D4) * 4;
    const float* src = sums + ((g / 4) * D4 + d / 4) * 16 + (g % 4) * 4;
    float4 o = *reinterpret_cast<const float4*>(src);
    for (int ph = 1; ph < phases; ++ph) {
      const float4 x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(ph) * units * 16);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    if (direct) {
      const float denom = fmaxf(ml[2 * g + 1], 1e-30f);
      Q* orow = out + (static_cast<size_t>(b) * H + kv * G + g) * Dh + d;
      orow[0] = from_f32<Q>(o.x / denom);
      orow[1] = from_f32<Q>(o.y / denom);
      orow[2] = from_f32<Q>(o.z / denom);
      orow[3] = from_f32<Q>(o.w / denom);
    } else {
      *reinterpret_cast<float4*>(ws_acc + (part0 * G + g) * Dh + d) = o;
    }
  }
  if (!direct && tid < 2 * G) ws_ml[part0 * G * 2 + tid] = ml[tid];
}

template <typename Q>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                              const int* __restrict__ lengths, Q* __restrict__ out, int H, int KV,
                              int Dh, int MB, int BS, int split_blocks, int n_split) {
  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kv = bkv % KV;
  const int G = H / KV;
  const int n_live = min(lengths[b] / BS + 1, MB);
  if (n_live <= split_blocks) return;  // its split kernel wrote out directly
  const int ns = (n_live + split_blocks - 1) / split_blocks;
  const int D4 = Dh / 4;
  const size_t base = static_cast<size_t>(bkv) * n_split;
  for (int pair = threadIdx.x; pair < G * D4; pair += kThreads) {
    const int g = pair / D4;
    const int d = (pair - g * D4) * 4;
    const float* mlg = ws_ml + base * G * 2 + 2 * g;  // split i at + i * 2G
    float M = -INFINITY;
    for (int i = 0; i < ns; ++i) M = fmaxf(M, mlg[i * 2 * G]);
    float L = 0.f;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < ns; ++i) {  // split order: the same bits every call
      const float mi = mlg[i * 2 * G];
      const float w = mi == -INFINITY ? 0.f : expf(mi - M);
      L = fmaf(w, mlg[i * 2 * G + 1], L);
      const float4 x = *reinterpret_cast<const float4*>(ws_acc + ((base + i) * G + g) * Dh + d);
      a[0] = fmaf(w, x.x, a[0]);
      a[1] = fmaf(w, x.y, a[1]);
      a[2] = fmaf(w, x.z, a[2]);
      a[3] = fmaf(w, x.w, a[3]);
    }
    const float denom = fmaxf(L, 1e-30f);
    Q* orow = out + (static_cast<size_t>(b) * H + kv * G + g) * Dh + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[e] = from_f32<Q>(a[e] / denom);
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  void* out;
  float* ws_acc;
  float* ws_ml;
  int B, H, KV, Dh, MB, split_blocks, n_split;
  cudaStream_t stream;
};

template <typename P, typename Q, int BS, bool QUANT>
int launch_impl(const Args& a) {
  const int G = a.H / a.KV;
  const size_t smem = smem_bytes_for<P, BS, QUANT>(G, a.Dh, a.split_blocks);
  const bool small = a.Dh <= kLaneElems * kTeam / 2 && pv_units(G, a.Dh) <= kThreads;
  auto kernel = small ? paged_decode_split_kernel<P, Q, BS, QUANT, kLaneElems / 2, 1>
                      : paged_decode_split_kernel<P, Q, BS, QUANT, kLaneElems, kMaxUnits>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  kernel<<<dim3(a.B * a.KV, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const P*>(a.k_pool),
      static_cast<const P*>(a.v_pool), a.k_scale, a.v_scale, a.table, a.lengths,
      static_cast<Q*>(a.out), a.ws_acc, a.ws_ml, a.H, a.KV, a.Dh, a.MB, a.split_blocks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  paged_decode_merge_kernel<Q><<<a.B * a.KV, kThreads, 0, a.stream>>>(
      a.ws_acc, a.ws_ml, a.lengths, static_cast<Q*>(a.out), a.H, a.KV, a.Dh, a.MB, BS,
      a.split_blocks, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename Q, bool QUANT>
int launch_bs(int BS, const Args& a) {
  switch (BS) {
    case 8:
      return launch_impl<P, Q, 8, QUANT>(a);
    case 16:
      return launch_impl<P, Q, 16, QUANT>(a);
    case 32:
      return launch_impl<P, Q, 32, QUANT>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// element kinds shared with the Python wrapper
enum Kind { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

}  // namespace

extern "C" {

// One decode-attention call on `stream`: the split kernel and, when
// n_split > 1, the merge kernel. q/out: [B, H, Dh] of q_kind; pools
// [NB, BS, KV, Dh] of pool_kind; scales [NB, BS, KV] fp32 (int8 pools only,
// else null); table [B, MB] and lengths [B] int32; the fp32 workspace
// ws_acc [B*KV, n_split, G, Dh] and ws_ml [B*KV, n_split, G, 2] (null when
// n_split is 1), all on the device. Split i of a sequence takes blocks
// [i * split_blocks, (i + 1) * split_blocks); split_blocks * BS <= 256 and
// n_split * split_blocks >= MB. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for a shape, type or
// split this kernel does not take.
int paged_decode_launch(int pool_kind, int q_kind, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale, const void* v_scale,
                        const void* table, const void* lengths, void* out, void* ws_acc,
                        void* ws_ml, int B, int H, int KV, int Dh, int BS, int MB,
                        int split_blocks, int n_split, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > 32 || Dh % 32 != 0 || Dh > 8 * kLaneElems ||
      MB <= 0 || split_blocks <= 0 || split_blocks * BS > kMaxSplitKeys || n_split <= 0 ||
      n_split > 65535 || static_cast<long long>(n_split) * split_blocks < MB ||
      pv_units(H / KV, Dh) > kThreads * kMaxUnits ||
      (n_split > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(lengths),
               out,
               static_cast<float*>(ws_acc),
               static_cast<float*>(ws_ml),
               B,
               H,
               KV,
               Dh,
               MB,
               split_blocks,
               n_split,
               static_cast<cudaStream_t>(stream)};
  if (pool_kind == kI8) {
    if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (q_kind) {
      case kF32:
        return launch_bs<int8_t, float, true>(BS, a);
      case kBF16:
        return launch_bs<int8_t, __nv_bfloat16, true>(BS, a);
      case kF16:
        return launch_bs<int8_t, __half, true>(BS, a);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pool_kind != q_kind) return static_cast<int>(cudaErrorInvalidValue);
  switch (pool_kind) {
    case kF32:
      return launch_bs<float, float, false>(BS, a);
    case kBF16:
      return launch_bs<__nv_bfloat16, __nv_bfloat16, false>(BS, a);
    case kF16:
      return launch_bs<__half, __half, false>(BS, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Dense flash decode attention (one new query per slot over a dense KV
// cache plus the new token's own K/V), hand-written for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/pallas/decode_attention.py, _decode_kernel (via
// _pallas_decode / flash_decode_attention) - the online-softmax decode the
// speculative draft model runs on every step.
// Numerics are the TPU kernel's, not the _snap oracle's: float32 from end
// to end, q scaled before the dot, running max / normaliser / P.V updated
// once per block of 128 positions, the new token folded in last, and the
// output acc / max(l, 1e-30) cast to bf16 once.
//
// What bounds it on the H100: bytes. Each query row does 4 FLOPs per cached
// element it reads (about 8 FLOPs per byte at GQA 4:1), far under the
// card's ~295 FLOP/byte balance point, so the floor is reading every live K
// and V row once at 3.35 TB/s.
//
// What this design does about it: the positions are split across blocks.
// flash_decode_partial runs on a (Hkv, B, splits) grid: each block takes
// one chunk of positions that is a whole number of 128-position blocks
// (256 by default, so the block boundaries stay the plain version's and
// 8 chunks cover T 2048: 512 blocks at 8 slots and 8 KV heads, where one
// block per (slot, head) gave 64 on 132 SMs). It holds that head's `group`
// pre-scaled query rows in registers, so each K/V row is read once for the
// whole group, and walks only the blocks of its chunk below cache_len[b]
// (the Pallas index-map clamp): the dead tail of the static window is never
// read, positions past the fill inside the last block are neither read nor
// counted, and a chunk that starts at or past the fill writes an empty
// partial (m = -1e30, l = 0) and exits. Inside a block of 128 positions
// each half-warp takes 8 positions (16 lanes x 16-byte loads = one 256-byte
// row); its 8 K rows are all in flight at once, then its 8 V rows, which
// load while the block max is exchanged through shared memory, so a step
// waits for two memory latencies, not one per position (at group 8, where
// the registers hold 64 scores, each V row loads at its use). Each
// half-warp rescales its own P.V partial by the common correction factor.
// Each chunk's (m, l, acc[group][D]) goes to float32 scratch that the
// wrapper allocates. flash_decode_combine, one block per (KV head, slot),
// folds the chunks below the fill (float32, in a fixed order: the
// statistics one chunk per lane, the accumulators in chunk order), then
// the new token, and casts once. The split count comes from T, the static cache width,
// never from cache_len: the host reads nothing.
//
// Layout: q (B,1,Hq,D); k_cache/v_cache (B,T,Hkv,D), or the first T
// positions of a (B,slot_T,Hkv,D) cache (an attention window's view);
// k_new/v_new (B,Hkv,D);
// cache_len (B,) int32 (valid entries excluding the new token); out
// (B,1,Hq,D); scratch (B,Hkv,splits,group,D+2) float32 (acc, then m, l).
// All bf16 except cache_len and the scratch. D is 128; the group (Hq/Hkv)
// is 1, 2, 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int BLOCK_K = 128;                   // positions per online step
constexpr int PER_STREAM = BLOCK_K / STREAMS;  // 8 positions a half-warp
constexpr int MAX_SPLITS = 16;                 // chunks a combine folds
constexpr int PART = D + 2;                    // floats of one partial row

__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j) out[j] = __bfloat162float(h[j]);
}

template <int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_cache,
                     const __nv_bfloat16* __restrict__ v_cache,
                     const int32_t* __restrict__ cache_len,
                     float* __restrict__ part, int T, int slot_T, int Hkv,
                     int chunk, float sm_scale) {
  __shared__ float part_m[STREAMS][G];
  __shared__ float part_l[STREAMS][G];
  __shared__ float part_acc[WARPS][G][D];

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = warp * 2 + lane / 16;
  const int d0 = (lane % 16) * LANE_ELEMS;

  // at group 8 the registers hold the scores: each V row loads at its use
  constexpr bool HOIST_V = G <= 4;
  const int len = max(0, min(cache_len[b], T));
  const int first = split * chunk;
  const int stop = min(first + chunk, len);
  float* dst = part + (((long)b * Hkv + h) * gridDim.z + split) * G * PART;
  if (first >= len) {  // an empty partial: the combine never folds it
    if (tid < G) {
      dst[tid * PART + D] = NEG_INF;
      dst[tid * PART + D + 1] = 0.f;
    }
    return;
  }
  const long pos_stride = (long)Hkv * D;
  const long head_off = (long)h * D + d0;
  const __nv_bfloat16* kc =
      k_cache + (long)b * slot_T * pos_stride + head_off;
  const __nv_bfloat16* vc =
      v_cache + (long)b * slot_T * pos_stride + head_off;

  // q scaled before the dot, as the TPU kernel does
  float qv[G][LANE_ELEMS];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long)b * Hq + (long)h * G + g) * D + d0, qv[g]);
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j) qv[g][j] *= sm_scale;
  }

  float m[G], l[G], acc[G][LANE_ELEMS];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] = 0.f;
  }

  for (int base = first; base < stop; base += BLOCK_K) {
    // this half-warp's 8 K rows, all in flight at once (zeros when dead)
    uint4 raw[PER_STREAM];
#pragma unroll
    for (int i = 0; i < PER_STREAM; ++i) {
      const int t = base + i * STREAMS + stream;
      raw[i] = t < stop ? load_raw(kc + t * pos_stride)
                        : make_uint4(0, 0, 0, 0);
    }
    // scores of the 8 positions; dead ones are NEG_INF
    float s[PER_STREAM][G], m_loc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) m_loc[g] = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER_STREAM; ++i) {
      const bool live = base + i * STREAMS + stream < stop;
      float kv[LANE_ELEMS];
      unpack8(raw[i], kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j) dot = fmaf(qv[g][j], kv[j], dot);
        dot = half_sum(dot);
        s[i][g] = live ? dot : NEG_INF;
        m_loc[g] = fmaxf(m_loc[g], s[i][g]);
      }
    }
    // the 8 V rows go out before the block max is exchanged
    if constexpr (HOIST_V) {
#pragma unroll
      for (int i = 0; i < PER_STREAM; ++i) {
        const int t = base + i * STREAMS + stream;
        raw[i] = t < stop ? load_raw(vc + t * pos_stride)
                          : make_uint4(0, 0, 0, 0);
      }
    }
    if (lane % 16 == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) part_m[stream][g] = m_loc[g];
    }
    __syncthreads();
    // every thread derives the same new max and correction
    float m_new[G], corr[G], l_loc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
      for (int k = 0; k < STREAMS; ++k) mx = fmaxf(mx, part_m[k][g]);
      m_new[g] = mx;
      corr[g] = expf(m[g] - mx);
      l_loc[g] = 0.f;
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] *= corr[g];
    }
#pragma unroll
    for (int i = 0; i < PER_STREAM; ++i) {
      const int t = base + i * STREAMS + stream;
      if (t >= stop) continue;
      float vv[LANE_ELEMS];
      if constexpr (HOIST_V)
        unpack8(raw[i], vv);
      else
        load8(vc + t * pos_stride, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[i][g] - m_new[g]);
        l_loc[g] += p;
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j)
          acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
    if (lane % 16 == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) part_l[stream][g] = l_loc[g];
    }
    __syncthreads();
    // part_m / part_l are rewritten only after the next step's first
    // barrier, which every thread reaches after these reads
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sum = 0.f;
      for (int k = 0; k < STREAMS; ++k) sum += part_l[k][g];
      l[g] = l[g] * corr[g] + sum;
      m[g] = m_new[g];
    }
  }

  // both halves of a warp hold the same columns: fold them, then the warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j)
      acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], 16);
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j)
        part_acc[warp][g][d0 + j] = acc[g][j];
  }
  if (tid < G) {  // m and l are the same in every thread
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == tid) {
        dst[g * PART + D] = m[g];
        dst[g * PART + D + 1] = l[g];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w) a += part_acc[w][g][d];
    dst[g * PART + d] = a;
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     const int32_t* __restrict__ cache_len,
                     const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ out, int T, int Hkv,
                     int chunk, int splits, float sm_scale) {
  static_assert(G <= WARPS, "one warp per query row of the group");
  __shared__ float weight[G][MAX_SPLITS];  // exp(m_s - m) of each chunk
  __shared__ float fin_corr[G], fin_p_new[G], fin_l[G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = max(0, min(cache_len[b], T));
  const int visited = (len + chunk - 1) / chunk;  // chunks below the fill
  const long pos_stride = (long)Hkv * D;
  const float* src = part + ((long)b * Hkv + h) * splits * G * PART;

  if (warp < G) {
    const int g = warp;
    // the new token's score: q (pre-scaled) . k_new, 4 elements a lane
    const __nv_bfloat16* qg = q + ((long)b * Hq + (long)h * G + g) * D;
    const __nv_bfloat16* kn = k_new + (long)b * pos_stride + (long)h * D;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const int d = lane * (D / 32) + j;
      dot = fmaf(__bfloat162float(qg[d]) * sm_scale, __bfloat162float(kn[d]),
                 dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    // the chunks' statistics, lane s holding chunk s
    const bool has = lane < visited;
    const float m_s = has ? src[(lane * G + g) * PART + D] : NEG_INF;
    const float l_s = has ? src[(lane * G + g) * PART + D + 1] : 0.f;
    float m_all = m_s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
    const float e = has ? expf(m_s - m_all) : 0.f;
    float l_all = l_s * e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l_all += __shfl_xor_sync(0xffffffffu, l_all, off);
    if (has) weight[g][lane] = e;
    if (lane == 0) {
      // the new token (position len, always attended) is folded last
      const float m_fin = fmaxf(m_all, dot);
      const float c = expf(m_all - m_fin);
      const float p_new = expf(dot - m_fin);
      fin_corr[g] = c;
      fin_p_new[g] = p_new;
      fin_l[g] = fmaxf(l_all * c + p_new, 1e-30f);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int s = 0; s < visited; ++s)
      a = fmaf(src[(s * G + g) * PART + d], weight[g][s], a);
    const float vn =
        __bfloat162float(v_new[(long)b * pos_stride + (long)h * D + d]);
    const float o = (a * fin_corr[g] + fin_p_new[g] * vn) / fin_l[g];
    out[((long)b * Hq + (long)h * G + g) * D + d] = __float2bfloat16_rn(o);
  }
}

template <int G>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_new, const void* v_new,
                   const void* cache_len, void* out, void* scratch, int B,
                   int T, int slot_T, int Hkv, int chunk, int splits,
                   cudaStream_t stream) {
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const int32_t* lens = static_cast<const int32_t*>(cache_len);
  float* part = static_cast<float*>(scratch);
  flash_decode_partial<G><<<dim3(Hkv, B, splits), THREADS, 0, stream>>>(
      qp, static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), lens, part, T, slot_T, Hkv,
      chunk, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<G><<<dim3(Hkv, B), THREADS, 0, stream>>>(
      qp, static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), lens, part,
      static_cast<__nv_bfloat16*>(out), T, Hkv, chunk, splits, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// chunk (a multiple of 128 positions) and splits = ceil(T / chunk) come
// from the wrapper (ops/cuda/decode_attention.split_plan); scratch holds
// B * Hkv * splits * group * (D + 2) floats. T is the positions the call
// attends (a window's length); slot_T >= T the positions one slot holds in
// memory (the full cache's), so slot b starts at b * slot_T * Hkv * D.
// Returns a cudaError_t (0 = success).
extern "C" int gofr_flash_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    void* scratch, int B, int T, int slot_T, int Hq, int Hkv, int head_dim,
    int chunk, int splits, void* stream) {
  if (head_dim != D || B <= 0 || T <= 0 || slot_T < T || Hkv <= 0 ||
      Hq % Hkv != 0 || B > 65535 || chunk <= 0 || chunk % BLOCK_K != 0 ||
      splits <= 0 || splits > MAX_SPLITS || (long)(splits - 1) * chunk >= T ||
      (long)splits * chunk < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1:
      return (int)launch<1>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, scratch, B, T, slot_T, Hkv, chunk, splits,
                            st);
    case 2:
      return (int)launch<2>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, scratch, B, T, slot_T, Hkv, chunk, splits,
                            st);
    case 4:
      return (int)launch<4>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, scratch, B, T, slot_T, Hkv, chunk, splits,
                            st);
    case 8:
      return (int)launch<8>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, scratch, B, T, slot_T, Hkv, chunk, splits,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
// What this design does about it: one block per (slot, KV head) holds that
// head's `group` pre-scaled query rows in registers, so each K/V row is read
// once for the whole group, and only the blocks of 128 positions below
// cache_len[b] are walked (the Pallas index-map clamp): the dead tail of
// the static window is never read, and positions past the fill inside the
// last block are neither read nor counted. Inside a block each half-warp
// takes 8 positions (16 lanes x 16-byte loads = one 256-byte row), the
// block max comes from shared memory, and each half-warp rescales its own
// P.V partial by the common correction factor, so their sum at the end is
// the TPU kernel's accumulator. Only B*Hkv blocks run (64 at the engine's
// 8 slots and 8 KV heads); splitting the positions across blocks is later
// work.
//
// Layout: q (B,1,Hq,D); k_cache/v_cache (B,T,Hkv,D); k_new/v_new (B,Hkv,D);
// cache_len (B,) int32 (valid entries excluding the new token); out
// (B,1,Hq,D). All bf16 except cache_len. D is 128; the group (Hq/Hkv) is
// 1, 2, 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int BLOCK_K = 128;                   // positions per online step
constexpr int PER_STREAM = BLOCK_K / STREAMS;  // 8 positions a half-warp

template <int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_cache,
                    const __nv_bfloat16* __restrict__ v_cache,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ out, int T, int Hkv,
                    float sm_scale) {
  __shared__ float part_m[STREAMS][G];
  __shared__ float part_l[STREAMS][G];
  __shared__ float part_acc[WARPS][G][D];
  __shared__ float fin_corr[G], fin_p_new[G], fin_l[G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = warp * 2 + lane / 16;
  const int d0 = (lane % 16) * LANE_ELEMS;

  const int len = max(0, min(cache_len[b], T));
  const long pos_stride = (long)Hkv * D;
  const long head_off = (long)h * D + d0;
  const __nv_bfloat16* kc = k_cache + (long)b * T * pos_stride + head_off;
  const __nv_bfloat16* vc = v_cache + (long)b * T * pos_stride + head_off;

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

  for (int base = 0; base < len; base += BLOCK_K) {
    // scores of this half-warp's 8 positions; dead ones are NEG_INF
    float s[PER_STREAM][G], m_loc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) m_loc[g] = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER_STREAM; ++i) {
      const int t = base + i * STREAMS + stream;
      const bool live = t < len;
      float kv[LANE_ELEMS] = {};
      if (live) load8(kc + t * pos_stride, kv);
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
      if (t >= len) continue;
      float vv[LANE_ELEMS];
      load8(vc + t * pos_stride, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[i][g] - m_new[g]);
        l_loc[g] += p;
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
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
      for (int j = 0; j < LANE_ELEMS; ++j) part_acc[warp][g][d0 + j] = acc[g][j];
  }
  // the new token (position len, always attended) is folded last
  float s_new[G];
  {
    float kv[LANE_ELEMS];
    load8(k_new + (long)b * pos_stride + head_off, kv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j) dot = fmaf(qv[g][j], kv[j], dot);
      s_new[g] = half_sum(dot);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_fin = fmaxf(m[g], s_new[g]);
      const float c = expf(m[g] - m_fin);
      const float p_new = expf(s_new[g] - m_fin);
      fin_corr[g] = c;
      fin_p_new[g] = p_new;
      fin_l[g] = fmaxf(l[g] * c + p_new, 1e-30f);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w) a += part_acc[w][g][d];
    const float vn = __bfloat162float(v_new[(long)b * pos_stride + (long)h * D + d]);
    const float o = (a * fin_corr[g] + fin_p_new[g] * vn) / fin_l[g];
    out[((long)b * Hq + (long)h * G + g) * D + d] = __float2bfloat16_rn(o);
  }
}

template <int G>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_new, const void* v_new,
                   const void* cache_len, void* out, int B, int T, int Hkv,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  flash_decode_kernel<G><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const int32_t*>(cache_len),
      static_cast<__nv_bfloat16*>(out), T, Hkv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success).
extern "C" int gofr_flash_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    int B, int T, int Hq, int Hkv, int head_dim, void* stream) {
  if (head_dim != D || B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1:
      return (int)launch<1>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, B, T, Hkv, st);
    case 2:
      return (int)launch<2>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, B, T, Hkv, st);
    case 4:
      return (int)launch<4>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, B, T, Hkv, st);
    case 8:
      return (int)launch<8>(q, k_cache, v_cache, k_new, v_new, cache_len,
                            out, B, T, Hkv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Ragged paged decode attention (one new query per slot, bf16 pools),
// hand-written for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/pallas/ragged_paged_attention.py, _ragged_kernel
// (via _pallas_ragged / ragged_paged_decode_attention, G = 1, bf16) -
// attention of each slot's new query over the KV pool pages its page table
// names, plus the new token's own K/V, without gathering a dense view.
//
// What bounds it on the H100: bytes. Each slot's query does 4*group FLOPs
// per cached K/V element it reads (about 2 FLOPs per byte at GQA 4:1), two
// orders of magnitude under the card's ~295 FLOP/byte balance point, so the
// floor is reading every live K and V row once at 3.35 TB/s.
//
// What this design does about it: one block per (slot, KV head) holds that
// head's `group` query rows in registers, so each K/V row is fetched once
// for all the heads that share it (GQA without a repeat). The block reads
// its own page-table entries (the TPU kernel's scalar prefetch) and walks
// only pages < ceil(cache_len/page): sentinel entries and pages past the
// fill are never dereferenced. Each half-warp takes one position at a time
// (16 lanes x 16-byte loads = one 256-byte K or V row), so the loads are
// coalesced and no dense (B, P*page) view is ever written.
// Two passes keep token identity with decode_attention_cached (the
// oracle's rounding points): pass 1 gets the final max and normaliser
// (each score rounded to bf16 after the dot, then scaled, new token folded
// in); pass 2 recomputes the scores, forms p = exp(s - m) / l rounded to
// bf16 and accumulates P.V in float32. K is therefore read twice and V
// once (1.5x the byte floor); a single-pass kernel would renormalise with
// correction factors the oracle never applies. Only B*Hkv blocks run, so a
// small batch leaves SMs idle: splitting the position range across blocks
// is later work.
//
// Layout: q (B,1,Hq,D); k_pages/v_pages (N,page,Hkv,D); table (B,P) int32
// with sentinel N; k_new/v_new (B,Hkv,D); cache_len (B,) int32 (valid
// tokens excluding the new one); out (B,1,Hq,D). All bf16 except the ints.
// D is 128; the group (Hq/Hkv) is 1, 2, 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int D = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STREAMS = WARPS * 2;  // half-warps, each walking positions
constexpr int LANE_ELEMS = 8;       // bf16 per lane: one 16-byte load
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j) out[j] = __bfloat162float(h[j]);
}

// sum over the 16 lanes of a half-warp (xor offsets below 16 stay inside it)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// offset of position t's row in a pool leaf, through the slot's page
// table; t is always below the fill, so its entry is a real page (clamped
// into the pool all the same, so a broken table cannot read out of bounds)
__device__ __forceinline__ long row_offset(const int32_t* trow, int t,
                                           int page, int num_pages,
                                           long page_stride,
                                           long pos_stride) {
  const int pi = t / page, off = t - pi * page;
  const int pid = min(max(trow[pi], 0), num_pages - 1);
  return pid * page_stride + off * pos_stride;
}

template <int G>
__device__ __forceinline__ void scores(const float (&qv)[G][LANE_ELEMS],
                                       const float* kv, float sm_scale,
                                       float (&s)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j) dot = fmaf(qv[g][j], kv[j], dot);
    // oracle order: dot -> bf16 round -> * scale
    s[g] = round_bf16(half_sum(dot)) * sm_scale;
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_pages,
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int32_t* __restrict__ table,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     const int32_t* __restrict__ cache_len,
                     __nv_bfloat16* __restrict__ out, int num_pages,
                     int page, int Hkv, int P, float sm_scale) {
  __shared__ float part_m[STREAMS][G];
  __shared__ float part_l[STREAMS][G];
  __shared__ float part_acc[WARPS][G][D];
  __shared__ float p_new_sh[G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = warp * 2 + lane / 16;  // this half-warp's index
  const int d0 = (lane % 16) * LANE_ELEMS;

  // live positions; a length past the table's reach is clamped to it
  const int len = max(0, min(cache_len[b], P * page));
  const int32_t* trow = table + (long)b * P;
  const long pos_stride = (long)Hkv * D;
  const long page_stride = (long)page * pos_stride;
  const long head_off = (long)h * D + d0;

  float qv[G][LANE_ELEMS];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load8(q + ((long)b * Hq + (long)h * G + g) * D + d0, qv[g]);

  // -- pass 1: softmax statistics over the live positions ---------------
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  // the loop bound is uniform per warp (the shuffles need both halves);
  // a half whose position is past the fill loads nothing and adds nothing
  for (int base = warp * 2; base < len; base += STREAMS) {
    const int t = base + lane / 16;
    const bool live = t < len;
    float kv[LANE_ELEMS] = {};
    if (live) load8(k_pages + row_offset(trow, t, page, num_pages,
                                         page_stride, pos_stride) + head_off,
                    kv);
    float s[G];
    scores<G>(qv, kv, sm_scale, s);
    if (!live) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], s[g]);
      l[g] = l[g] * expf(m[g] - mn) + expf(s[g] - mn);
      m[g] = mn;
    }
  }
  if (lane % 16 == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      part_m[stream][g] = m[g];
      part_l[stream][g] = l[g];
    }
  }
  // the new token's score (every stream computes it; K row is 256 bytes)
  float s_new[G];
  {
    float kv[LANE_ELEMS];
    load8(k_new + (long)b * pos_stride + head_off, kv);
    scores<G>(qv, kv, sm_scale, s_new);
  }
  __syncthreads();
  float m_fin[G], l_fin[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = NEG_INF;
    for (int i = 0; i < STREAMS; ++i) mx = fmaxf(mx, part_m[i][g]);
    float sum = 0.f;
    for (int i = 0; i < STREAMS; ++i)
      sum += part_l[i][g] * expf(part_m[i][g] - mx);
    // fold the new token: the statistics are final after this
    m_fin[g] = fmaxf(mx, s_new[g]);
    l_fin[g] = sum * expf(mx - m_fin[g]) + expf(s_new[g] - m_fin[g]);
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      p_new_sh[g] = round_bf16(expf(s_new[g] - m_fin[g]) / l_fin[g]);
  }

  // -- pass 2: the oracle's exact probabilities, P.V in float32 ----------
  float acc[G][LANE_ELEMS];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] = 0.f;
  for (int base = warp * 2; base < len; base += STREAMS) {
    const int t = base + lane / 16;
    const bool live = t < len;
    float kv[LANE_ELEMS] = {}, vv[LANE_ELEMS] = {};
    if (live) {
      const long row = row_offset(trow, t, page, num_pages, page_stride,
                                  pos_stride) + head_off;
      load8(k_pages + row, kv);
      load8(v_pages + row, vv);
    }
    float s[G];
    scores<G>(qv, kv, sm_scale, s);
    if (!live) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = round_bf16(expf(s[g] - m_fin[g]) / l_fin[g]);
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
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
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float cache_part = 0.f;
    for (int w = 0; w < WARPS; ++w) cache_part += part_acc[w][g][d];
    const float vn = __bfloat162float(v_new[(long)b * pos_stride + (long)h * D + d]);
    const float new_part = round_bf16(p_new_sh[g] * vn);
    // oracle: round the cache and new-token einsums, add, round the sum
    const float o = round_bf16(round_bf16(cache_part) + new_part);
    out[((long)b * Hq + (long)h * G + g) * D + d] = __float2bfloat16_rn(o);
  }
}

template <int G>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* table, const void* k_new, const void* v_new,
                   const void* cache_len, void* out, int B, int Hkv,
                   int num_pages, int page, int P, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  ragged_decode_kernel<G><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int32_t*>(table),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const int32_t*>(cache_len),
      static_cast<__nv_bfloat16*>(out), num_pages, page, Hkv, P, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success).
extern "C" int gofr_ragged_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* k_new, const void* v_new,
    const void* cache_len, void* out, int B, int Hq, int Hkv, int head_dim,
    int num_pages, int page, int P, void* stream) {
  if (head_dim != D || B <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      num_pages <= 0 || page <= 0 || P <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1:
      return (int)launch<1>(q, k_pages, v_pages, table, k_new, v_new,
                            cache_len, out, B, Hkv, num_pages, page, P, st);
    case 2:
      return (int)launch<2>(q, k_pages, v_pages, table, k_new, v_new,
                            cache_len, out, B, Hkv, num_pages, page, P, st);
    case 4:
      return (int)launch<4>(q, k_pages, v_pages, table, k_new, v_new,
                            cache_len, out, B, Hkv, num_pages, page, P, st);
    case 8:
      return (int)launch<8>(q, k_pages, v_pages, table, k_new, v_new,
                            cache_len, out, B, Hkv, num_pages, page, P, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

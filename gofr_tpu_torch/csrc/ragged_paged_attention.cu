// Ragged paged attention over bf16 or int8 pools, hand-written for Hopper
// (sm_90a): decode (one new query per slot) and speculative verify (G new
// queries per slot) in one kernel.
//
// Replaces: gofr_tpu/ops/pallas/ragged_paged_attention.py, _ragged_kernel
// (via _pallas_ragged): ragged_paged_decode_attention (G = 1) and
// ragged_paged_verify_attention (G > 1), over bf16 pools and over int8
// pools with their per-(position, head) float32 scale planes (the
// kernel's `int8` branch). Query g of a slot sits at
// position cache_len + g and attends the KV pool pages its page table
// names, below cache_len, plus the G new tokens' own K/V causally
// (u <= g), without gathering a dense view.
//
// What bounds it on the H100: bytes. Each query row does 4 FLOPs per
// cached K/V element it reads (about 2 FLOPs per byte per query at GQA
// 4:1), two orders of magnitude under the card's ~295 FLOP/byte balance
// point, so the floor is reading every live K and V row once at 3.35 TB/s.
//
// What this design does about it: one block per (KV head, slot, query)
// holds that query's `group` rows in registers, so each K/V row is fetched
// once for all the heads that share it (GQA without a repeat). The TPU
// kernel stacks all G x group rows of a KV head in one program; here that
// would hold up to 20 query rows and accumulators a thread (G 5, GQA 4:1),
// so the query index is the grid's third axis instead, and the G blocks of
// a (slot, KV head) read the same pages at the same time: the repeats come
// from L2 rather than device memory. A block reads its own page-table
// entries (the TPU kernel's scalar prefetch) and walks only positions below
// cache_len: sentinel entries and rows past the fill are never
// dereferenced. Each half-warp takes one position at a time (16 lanes x
// 16-byte loads = one 256-byte K or V row), so the loads are coalesced.
// Two passes keep token identity with the oracle (verify_attention's
// rounding points): pass 1 gets the final max and normaliser (each score
// rounded to bf16 after the dot, then scaled; the new tokens folded in);
// pass 2 recomputes the scores, forms p = exp(s - m) / l rounded to bf16
// and accumulates P.V in float32; the cache and new-token parts are each
// rounded, then added and rounded. K is therefore read twice and V once
// (1.5x the byte floor); a single-pass kernel would renormalise with
// correction factors the oracle never applies. Decode is the G = 1
// launch. Only B*Hkv*G blocks run, so a small batch leaves SMs idle:
// splitting the position range across blocks is later work.
//
// int8 pools (KV = int8_t) dequantise in the kernel, in the oracle's
// int8 formulation: the dot of the bf16 query with the int8 row (as f32)
// is rounded to bf16, scaled by sm_scale, then by the row's K scale; the
// cache probabilities are not rounded but multiplied by the row's V
// scale before they weight the int8 V row in f32. A K or V row is 128
// bytes, so each half-warp lane loads 8 bytes (8 elements, the bf16
// layout's lane split) and a position's row is still one coalesced load
// per half-warp; its scale is one float that the half-warp's lanes load
// from one address (one transaction). Scales are read only for live
// positions, like the rows: a NaN scale in a dead row or a sentinel page
// never reaches the output. The new tokens' K/V arrive as bf16 and take
// the bf16 path. The bytes per position fall from 512 to 264 (K, V and
// two scales), the block count is unchanged.
//
// Layout: q (B,G,Hq,D); k_pages/v_pages (N,page,Hkv,D) bf16 or int8;
// k_scale/v_scale (N,page,Hkv) f32 with int8 pools; table (B,P) int32
// with sentinel N; k_new/v_new (B,G,Hkv,D); cache_len (B,) int32 (valid
// tokens excluding the new ones); out (B,G,Hq,D). q, new K/V and out
// bf16. D is 128; the group (Hq/Hkv) is 1, 2, 4 or 8; 1 <= G <= MAX_NEW.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int MAX_NEW = 8;  // at most 8 new tokens a slot (gamma <= 7)

// 8 int8 elements (one 8-byte load) as floats: the int8 pools' lane share
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j) out[j] = static_cast<float>(c[j]);
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

// One block per (KV head, slot, query qi): the walk for query qi's `G`
// rows, with the new-token fold over the keys u <= qi. NEW bounds the new
// tokens at compile time: 1 for a decode launch (the fold is then u = 0
// alone, with no per-query loops), MAX_NEW for verify. KV is the pools'
// element type: __nv_bfloat16, or int8_t with the scale planes.
template <int G, int NEW, typename KV>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const __nv_bfloat16* __restrict__ q,
              const KV* __restrict__ k_pages,
              const KV* __restrict__ v_pages,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int32_t* __restrict__ table,
              const __nv_bfloat16* __restrict__ k_new,
              const __nv_bfloat16* __restrict__ v_new,
              const int32_t* __restrict__ cache_len,
              __nv_bfloat16* __restrict__ out, int num_pages, int page,
              int Hkv, int P, int g_len, float sm_scale) {
  __shared__ float part_m[STREAMS][G];
  __shared__ float part_l[STREAMS][G];
  __shared__ float part_acc[WARPS][G][D];
  __shared__ float p_new_sh[NEW][G];
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;

  const int h = blockIdx.x, b = blockIdx.y, qi = blockIdx.z;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = warp * 2 + lane / 16;
  const int d0 = (lane % 16) * LANE_ELEMS;

  const int len = max(0, min(cache_len[b], P * page));
  const int32_t* trow = table + (long)b * P;
  const long pos_stride = (long)Hkv * D;
  const long page_stride = (long)page * pos_stride;
  const long head_off = (long)h * D + d0;
  // rows of (b, qi) in q/out, and of (b, u = 0) in k_new/v_new
  const long q_row0 = ((long)b * g_len + qi) * Hq + (long)h * G;
  const long new_row0 = (long)b * g_len * pos_stride;

  float qv[G][LANE_ELEMS];
#pragma unroll
  for (int g = 0; g < G; ++g) load8(q + (q_row0 + g) * D + d0, qv[g]);

  // -- pass 1: softmax statistics over the live positions ---------------
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  for (int base = warp * 2; base < len; base += STREAMS) {
    const int t = base + lane / 16;
    const bool live = t < len;
    float kv[LANE_ELEMS] = {};
    float ks = 0.f;
    if (live) {
      load8(k_pages + row_offset(trow, t, page, num_pages, page_stride,
                                 pos_stride) + head_off,
            kv);
      // the scale load goes out with the row's, not after the dot
      if constexpr (INT8)
        ks = k_scale[row_offset(trow, t, page, num_pages, (long)page * Hkv,
                                Hkv) + h];
    }
    float s[G];
    scores<G>(qv, kv, sm_scale, s);
    if (!live) continue;
    if constexpr (INT8) {
      // oracle: (round(dot) * sm_scale) * k_scale, before the mask; the
      // _rn product is never contracted into the max/exp arithmetic
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = __fmul_rn(s[g], ks);
    }
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
  // the new tokens' scores, keys u <= qi (qi is uniform in the block, so
  // the shuffles inside scores() never diverge)
  float s_new[NEW][G];
#pragma unroll
  for (int u = 0; u < NEW; ++u) {
    if (u > qi) break;
    float kv[LANE_ELEMS];
    load8(k_new + new_row0 + u * pos_stride + head_off, kv);
    scores<G>(qv, kv, sm_scale, s_new[u]);
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
    // fold the new tokens (u = 0 always attends)
    float mf = fmaxf(mx, s_new[0][g]);
#pragma unroll
    for (int u = 1; u < NEW; ++u)
      if (u <= qi) mf = fmaxf(mf, s_new[u][g]);
    float lf = sum * expf(mx - mf) + expf(s_new[0][g] - mf);
#pragma unroll
    for (int u = 1; u < NEW; ++u)
      if (u <= qi) lf += expf(s_new[u][g] - mf);
    m_fin[g] = mf;
    l_fin[g] = lf;
  }
  if (tid == 0) {
#pragma unroll
    for (int u = 0; u < NEW; ++u) {
      if (u > qi) break;
#pragma unroll
      for (int g = 0; g < G; ++g)
        p_new_sh[u][g] = round_bf16(expf(s_new[u][g] - m_fin[g]) / l_fin[g]);
    }
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
    float ks = 0.f, vs = 0.f;
    if (live) {
      const long row = row_offset(trow, t, page, num_pages, page_stride,
                                  pos_stride) + head_off;
      load8(k_pages + row, kv);
      load8(v_pages + row, vv);
      if constexpr (INT8) {
        const long srow = row_offset(trow, t, page, num_pages,
                                     (long)page * Hkv, Hkv) + h;
        ks = k_scale[srow];
        vs = v_scale[srow];
      }
    }
    float s[G];
    scores<G>(qv, kv, sm_scale, s);
    if (!live) continue;
    if constexpr (INT8) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // oracle int8 V path: the probability stays f32, times the scale
        const float p =
            (expf(__fmul_rn(s[g], ks) - m_fin[g]) / l_fin[g]) * vs;
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j)
          acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = round_bf16(expf(s[g] - m_fin[g]) / l_fin[g]);
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j)
          acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
  }
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
    const long vrow = new_row0 + (long)h * D + d;
    float new_acc = p_new_sh[0][g] * __bfloat162float(v_new[vrow]);
    for (int u = 1; u < NEW && u <= qi; ++u)
      new_acc = fmaf(p_new_sh[u][g],
                     __bfloat162float(v_new[vrow + u * pos_stride]), new_acc);
    const float new_part = round_bf16(new_acc);
    // oracle: round the cache and new-token einsums, add, round the sum
    const float o = round_bf16(round_bf16(cache_part) + new_part);
    out[(q_row0 + g) * D + d] = __float2bfloat16_rn(o);
  }
}

// The pools and their scale planes (null for bf16 pools).
struct Pools {
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
};

template <int G, int NEW, typename KV>
cudaError_t launch(const void* q, Pools pools, const void* table,
                   const void* k_new, const void* v_new,
                   const void* cache_len, void* out, int B, int g_len,
                   int Hkv, int num_pages, int page, int P,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, B, g_len);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  ragged_kernel<G, NEW, KV><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const KV*>(pools.k), static_cast<const KV*>(pools.v),
      static_cast<const float*>(pools.k_scale),
      static_cast<const float*>(pools.v_scale),
      static_cast<const int32_t*>(table),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const int32_t*>(cache_len),
      static_cast<__nv_bfloat16*>(out), num_pages, page, Hkv, P, g_len,
      sm_scale);
  return cudaGetLastError();
}

// Decode (g_len 1) takes the NEW = 1 instantiation unless verify_form asks
// for the verify one, which must give the same bits at g_len 1.
template <int G, typename KV>
cudaError_t launch_group(const void* q, Pools pools, const void* table,
                         const void* k_new, const void* v_new,
                         const void* cache_len, void* out, int B, int g_len,
                         int Hkv, int num_pages, int page, int P,
                         bool verify_form, cudaStream_t stream) {
  if (g_len == 1 && !verify_form)
    return launch<G, 1, KV>(q, pools, table, k_new, v_new, cache_len, out,
                            B, g_len, Hkv, num_pages, page, P, stream);
  return launch<G, MAX_NEW, KV>(q, pools, table, k_new, v_new, cache_len,
                                out, B, g_len, Hkv, num_pages, page, P,
                                stream);
}

template <typename KV>
int dispatch(const void* q, Pools pools, const void* table,
             const void* k_new, const void* v_new, const void* cache_len,
             void* out, int B, int g_len, int Hq, int Hkv, int head_dim,
             int num_pages, int page, int P, bool verify_form,
             void* stream) {
  if (head_dim != D || B <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      num_pages <= 0 || page <= 0 || P <= 0 || B > 65535 || g_len < 1 ||
      g_len > MAX_NEW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1:
      return (int)launch_group<1, KV>(q, pools, table, k_new, v_new,
                                      cache_len, out, B, g_len, Hkv,
                                      num_pages, page, P, verify_form, st);
    case 2:
      return (int)launch_group<2, KV>(q, pools, table, k_new, v_new,
                                      cache_len, out, B, g_len, Hkv,
                                      num_pages, page, P, verify_form, st);
    case 4:
      return (int)launch_group<4, KV>(q, pools, table, k_new, v_new,
                                      cache_len, out, B, g_len, Hkv,
                                      num_pages, page, P, verify_form, st);
    case 8:
      return (int)launch_group<8, KV>(q, pools, table, k_new, v_new,
                                      cache_len, out, B, g_len, Hkv,
                                      num_pages, page, P, verify_form, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry returns a cudaError_t (0 = success). bf16 pools:
extern "C" int gofr_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* k_new, const void* v_new,
    const void* cache_len, void* out, int B, int g_len, int Hq, int Hkv,
    int head_dim, int num_pages, int page, int P, void* stream) {
  return dispatch<__nv_bfloat16>(
      q, Pools{k_pages, v_pages, nullptr, nullptr}, table, k_new, v_new,
      cache_len, out, B, g_len, Hq, Hkv, head_dim, num_pages, page, P,
      false, stream);
}

// The same launch through the verify instantiation at every g_len, 1
// included: a check holds its g_len 1 output bit for bit against the
// decode instantiation's. Served paths call the entry above.
extern "C" int gofr_ragged_paged_attention_verify_form(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* k_new, const void* v_new,
    const void* cache_len, void* out, int B, int g_len, int Hq, int Hkv,
    int head_dim, int num_pages, int page, int P, void* stream) {
  return dispatch<__nv_bfloat16>(
      q, Pools{k_pages, v_pages, nullptr, nullptr}, table, k_new, v_new,
      cache_len, out, B, g_len, Hq, Hkv, head_dim, num_pages, page, P, true,
      stream);
}

// int8 pools with their (N,page,Hkv) f32 scale planes.
extern "C" int gofr_ragged_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    int B, int g_len, int Hq, int Hkv, int head_dim, int num_pages,
    int page, int P, void* stream) {
  return dispatch<int8_t>(q, Pools{k_pages, v_pages, k_scale, v_scale},
                          table, k_new, v_new, cache_len, out, B, g_len, Hq,
                          Hkv, head_dim, num_pages, page, P, false, stream);
}

// The int8 launch through the verify instantiation at every g_len (the
// int8 counterpart of gofr_ragged_paged_attention_verify_form).
extern "C" int gofr_ragged_paged_attention_int8_verify_form(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    int B, int g_len, int Hq, int Hkv, int head_dim, int num_pages,
    int page, int P, void* stream) {
  return dispatch<int8_t>(q, Pools{k_pages, v_pages, k_scale, v_scale},
                          table, k_new, v_new, cache_len, out, B, g_len, Hq,
                          Hkv, head_dim, num_pages, page, P, true, stream);
}

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
// Walked by one block a slot, one position a half-warp at a time, it is
// bound instead by memory latency on the longest slot (~128 dependent
// round trips a pass at fill 2047: 0.24 ms against a 0.004 ms floor); with
// a block set per query, verify pays that G times over.
//
// What this design does about it:
// - A thread-block cluster of CLUSTER (8) blocks per (KV head, slot)
//   splits the slot's live pages into page-aligned chunks of
//   ceil(pages / 8), rank order, the tail ranks possibly empty, so a long
//   slot is walked by 8 SMs in one launch. Each block reads its chunk's
//   page-table entries once into shared memory (the TPU kernel's scalar
//   prefetch), clamped into the pool, and walks only positions below
//   cache_len: sentinel entries and rows past the fill are never
//   dereferenced.
// - The cluster serves all G queries of the slot (the TPU kernel's one
//   program for all G x group rows), so K and V leave device memory once
//   per launch, not once per query.
// - Pass 1's dots run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   float32 out): the query rows of all G queries are the A operand, a
//   tile of 8 positions' K rows the B operand, with the head dimension
//   permuted so that each lane loads 64 contiguous bytes of one K row
//   (int8 rows widened to bf16 exactly); each warp loads 2 tiles before
//   it multiplies; the new tokens' keys are one more tile. Each score is
//   then rounded to bf16 and scaled as the oracle does.
// - Pass 2 on the CUDA cores in float32 (the int8 V path weights int8
//   rows by unrounded probabilities): each half-warp issues 16 V rows
//   before it uses the first (an int8 row's scale load beside its row;
//   the page table walked from one division a run), so a chunk of 256
//   positions is one run, kept in registers for every query (the
//   accumulators take the group's rows in two halves from group 4 up).
//   16 lanes x 16 bytes = one 256-byte bf16 row (8 bytes a lane for
//   int8). The first run is issued before the cluster barrier, so its
//   latency hides behind the folds.
// - The softmax runs as sweeps over the scores in shared memory, one
//   thread an element, not once a lane.
// - Fixed costs are cut for the many short slots: three cluster barriers
//   a launch, and a block with an empty chunk does no pass 2.
// The oracle's rounding points are kept (verify_attention; a single-pass
// online softmax would renormalise with correction factors the oracle
// never applies): each score is rounded to bf16 after the dot, then
// scaled. Each block takes its chunk's max m_r of every (query, row) and
// the sum l_r of exp(s - m_r); after a cluster barrier every block folds
// the 8 blocks' (m_r, l_r) through distributed shared memory in rank
// order, then the new tokens' scores, so all 8 hold the same bits of the
// final (m, l); p = exp(s - m) / l once a score, rounded to bf16. Pass 2
// accumulates P.V in float32, query by query (a warp whose positions fit
// one run of rows keeps them for every query); after a second barrier
// each block writes an eighth of the output: the busy blocks' partials
// summed in rank order, the new-token part, and the oracle's roundings
// (the cache and new-token parts are each rounded, then added and
// rounded). A last barrier keeps every block alive until the others have
// read its partials. No block returns early: an empty chunk contributes
// max -1e30 and sum 0, and skips pass 2. Decode is the G = 1 launch of
// the same body (new-token bound NEW = 1): the chunking and every fold
// order are independent of NEW, so the verify instantiation at G = 1
// gives the decode instantiation's bits. One launch a call: no stats or
// combine kernel, no scratch buffer in device memory.
//
// int8 pools (KV = int8_t) dequantise in the kernel, in the oracle's
// int8 formulation: the dot of the bf16 query with the int8 row (as f32)
// is rounded to bf16, scaled by sm_scale, then by the row's K scale; the
// cache probabilities are not rounded but multiplied by the row's V
// scale before they weight the int8 V row in f32. A position's scale is
// one float that the half-warp's lanes load from one address (one
// transaction). Scales are read only for live positions, like the rows:
// a NaN scale in a dead row or a sentinel page never reaches the output.
// The new tokens' K/V arrive as bf16 and take the bf16 path. The bytes
// per position fall from 512 to 264 (K, V and two scales).
//
// Layout: q (B,G,Hq,D); k_pages/v_pages (N,page,Hkv,D) bf16 or int8;
// k_scale/v_scale (N,page,Hkv) f32 with int8 pools; table (B,P) int32
// with sentinel N; k_new/v_new (B,G,Hkv,D); cache_len (B,) int32 (valid
// tokens excluding the new ones); out (B,G,Hq,D). q, new K/V and out
// bf16. D is 128; the group (Hq/Hkv) is 1, 2, 4 or 8; 1 <= G <= MAX_NEW.
// Grid (Hkv * CLUSTER, B), clusters of (CLUSTER, 1, 1), 256 threads;
// dynamic shared memory (dyn_smem_bytes) at most MAX_DYN_SMEM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <type_traits>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_NEW = 8;     // at most 8 new tokens a slot (gamma <= 7)
constexpr int CLUSTER = 8;     // blocks a (KV head, slot): portable size
// pass 1: tiles of 8 K rows a warp loads before it multiplies; pass 2: V
// rows a half-warp issues before it uses the first (a chunk of 256
// positions is one run, kept in registers for every query)
constexpr int K_TILES = 2;
constexpr int V_RUN = 16;
// dynamic shared memory a block may take (its chunk's scores, partials,
// queries and page ids), and what one block may use on sm_90
constexpr long MAX_DYN_SMEM = 160 * 1024;
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

// one lane's share of a K or V row: 8 elements, 16 bytes bf16, 8 int8
template <typename KV>
using Row = typename std::conditional<std::is_same<KV, int8_t>::value,
                                      uint2, uint4>::type;

__device__ __forceinline__ uint4 load_row(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint2 load_row(const int8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j) out[j] = __bfloat162float(h[j]);
}

// int8 to float exactly in two full-rate operations an element: the
// biased byte becomes the low mantissa byte of 2^23, which is subtracted
__device__ __forceinline__ float int8_to_float(unsigned biased, int j) {
  return __int_as_float(static_cast<int>(
             __byte_perm(biased, 0x4B000000u, 0x7540u + j))) -
         8388736.0f;
}

__device__ __forceinline__ void unpack(const uint2& raw, float* out) {
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j)
    out[j] = int8_to_float((j < 4 ? raw.x : raw.y) ^ 0x80808080u, j % 4);
}

// The rank's chunk of one slot: positions [t0, t1), whole pages from p0.
struct Chunk {
  int p0, n_pages, t0, t1;
};

__device__ __forceinline__ Chunk rank_chunk(int len, int page, int rank) {
  const int pages = (len + page - 1) / page;
  const int per_rank = (pages + CLUSTER - 1) / CLUSTER;
  Chunk c;
  c.p0 = rank * per_rank;
  c.n_pages = max(0, min(per_rank, pages - c.p0));
  c.t0 = c.p0 * page;
  c.t1 = c.n_pages > 0 ? min(c.t0 + c.n_pages * page, len) : c.t0;
  return c;
}

// Where one KV head's rows of the chunk sit in a pool.
struct Walk {
  const int32_t* pid;   // the chunk's page ids (shared memory)
  int t0, t1, page, Hkv, h;
  long page_stride, pos_stride, head_off;
};

// Issue the loads of N consecutive positions from `first` (the rows and,
// with int8 pools, their scales); positions at or past t1 load nothing and
// read as zero. The page table is walked from one division a run.
template <typename KV, int N>
__device__ __forceinline__ void load_run(const Walk& w, const KV* pool,
                                         const float* scale, int first,
                                         Row<KV> (&rows)[N],
                                         float (&scales)[N]) {
  const int lt = first - w.t0;
  int pi = lt / w.page, off = lt - pi * w.page;
  long pid = first < w.t1 ? w.pid[pi] : 0;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    rows[u] = Row<KV>{};
    scales[u] = 0.f;
    if (first + u < w.t1) {
      if (off == w.page) {          // the run crosses into the next page
        off = 0;
        pid = w.pid[++pi];
      }
      rows[u] = load_row(pool + pid * w.page_stride + off * w.pos_stride +
                         w.head_off);
      // the scale load goes out with the row's, not after its use
      if constexpr (std::is_same<KV, int8_t>::value)
        scales[u] = scale[(pid * w.page + off) * w.Hkv + w.h];
      ++off;
    }
  }
}

// D += A B on the tensor cores: m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The dots of the R query rows in q_sh with NT tiles of 8 key rows, on the
// tensor cores: the query rows are the A operand (16 a tile), the keys the
// B operand, the head dimension permuted so that lane (n, c) holds
// elements [32c, 32c + 32) of key n of each tile in kw (as bf16 pairs;
// 8 mma k-steps of 4 of them). Calls out(t, r, n, dot) for each query row
// r < R and key n of tile t whose dot this lane holds.
template <int NT, typename Out>
__device__ __forceinline__ void tile_dots(const __nv_bfloat16* q_sh, int R,
                                          const unsigned (&kw)[NT][16],
                                          int lane, Out out) {
  const int kn = lane / 4, kc = lane % 4;
  for (int r0 = 0; r0 < R; r0 += 16) {    // warp-uniform
    const int ra = r0 + kn, rb = ra + 8;  // this lane's two rows
    unsigned qa[16], qb[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 va = ra < R ? *reinterpret_cast<const uint4*>(
                                    q_sh + ra * D + 32 * kc + 8 * i)
                              : make_uint4(0, 0, 0, 0);
      const uint4 vb = rb < R ? *reinterpret_cast<const uint4*>(
                                    q_sh + rb * D + 32 * kc + 8 * i)
                              : make_uint4(0, 0, 0, 0);
      qa[4 * i] = va.x; qa[4 * i + 1] = va.y;
      qa[4 * i + 2] = va.z; qa[4 * i + 3] = va.w;
      qb[4 * i] = vb.x; qb[4 * i + 1] = vb.y;
      qb[4 * i + 2] = vb.z; qb[4 * i + 3] = vb.w;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < 8; ++s)
        mma_bf16(c, qa[2 * s], qb[2 * s], qa[2 * s + 1], qb[2 * s + 1],
                 kw[t][2 * s], kw[t][2 * s + 1]);
      // c: rows ra, rb at keys 2c, 2c + 1
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = k < 2 ? ra : rb;
        if (r < R) out(t, r, 2 * kc + k % 2, c[k]);
      }
    }
  }
}

// A fold over the cluster: this rank's per-(query, row) values `mine`
// become visible, then every rank copies all 8 ranks' into `all` in rank
// order. `mine` must not be written again in this launch.
__device__ __forceinline__ void gather(cg::cluster_group& cluster,
                                       float* mine, float* all, int n,
                                       int tid) {
  cluster.sync();
  for (int i = tid; i < CLUSTER * n; i += THREADS)
    all[i] = *cluster.map_shared_rank(mine + i % n, i / n);
  __syncthreads();
}

// Block `rank` of the cluster for (KV head h, slot b): its chunk's walk
// for all g_len queries' `G` rows, the cluster's folds, and an eighth of
// the output, with the new tokens' keys u <= qi for query qi. NEW bounds the
// new tokens at compile time: 1 for a decode launch, MAX_NEW for verify;
// the arithmetic and its order do not depend on it. KV is the pools'
// element type: __nv_bfloat16, or int8_t with the scale planes.
template <int G, int NEW, typename KV>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, G <= 4 ? 2 : 1)
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
  // dynamic: the queries [query][G][D] bf16; each query's chunk partial
  // [query][G][D] (read by every rank); each query's chunk scores, later
  // p, [query][position][G]; the chunk's page ids
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[WARPS][NEW * G];
  __shared__ float rank_ml[2 * NEW * G];    // (m, l): read by every rank
  __shared__ float all[CLUSTER * 2 * NEW * G];
  __shared__ float m_fin[NEW * G], l_fin[NEW * G];
  __shared__ float s_new[NEW][NEW][G], p_new[NEW][NEW][G];
  __shared__ __align__(16) __nv_bfloat16 k_new_sh[NEW][D];
  __shared__ __align__(16) __nv_bfloat16 v_new_sh[NEW][D];
  __shared__ float part_acc[WARPS][G][D];
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int V_STRIDE = STREAMS * V_RUN;
  // pass 2's accumulators take the group's rows in two halves from 4 up,
  // over the same V registers
  constexpr int G_PART = G < 4 ? G : G / 2;
  constexpr int VEC = D / LANE_ELEMS;       // 16-byte vectors a row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / CLUSTER, b = blockIdx.y;
  const int Hq = Hkv * G, rows = g_len * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = lane / 16;
  const int d0 = (lane % 16) * LANE_ELEMS;
  const int per_rank = (P + CLUSTER - 1) / CLUSTER;
  const int cap = per_rank * page;           // positions a chunk may hold
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* acc_sh = smem + (long)rows * D / 2;
  float* e_sh = acc_sh + (long)rows * D;
  int32_t* pid_sh = reinterpret_cast<int32_t*>(e_sh + (long)g_len * cap * G);

  const int len = max(0, min(cache_len[b], P * page));
  const Chunk chunk = rank_chunk(len, page, rank);
  const int n_chunk = chunk.t1 - chunk.t0;
  Walk walk;
  walk.pid = pid_sh;
  walk.t0 = chunk.t0;
  walk.t1 = chunk.t1;
  walk.page = page;
  walk.Hkv = Hkv;
  walk.h = h;
  walk.pos_stride = (long)Hkv * D;
  walk.page_stride = (long)page * walk.pos_stride;
  walk.head_off = (long)h * D + d0;
  // the rows of (b, query 0) in q/out, and of (b, u = 0) in k_new/v_new
  const long q_row0 = (long)b * g_len * Hq + (long)h * G;
  const long new_row0 = (long)b * g_len * walk.pos_stride + (long)h * D;
  // a warp's two half-warps take consecutive runs of positions; the loop
  // bounds are warp-uniform, so the shuffles never diverge
  const int v_base0 = chunk.t0 + warp * 2 * V_RUN;

  // -- every small input at once: ids (clamped into the pool, so a broken
  // table cannot read out of it), queries, the new tokens' K and V ------
  for (int i = tid; i < chunk.n_pages; i += THREADS)
    pid_sh[i] = min(max(table[(long)b * P + chunk.p0 + i], 0),
                    num_pages - 1);
  for (int i = tid; i < rows * VEC; i += THREADS) {
    const int qi = i / (G * VEC), g = (i / VEC) % G, c = i % VEC;
    reinterpret_cast<uint4*>(q_sh)[i] = *reinterpret_cast<const uint4*>(
        q + (q_row0 + (long)qi * Hq + g) * D + c * LANE_ELEMS);
  }
  for (int i = tid; i < 2 * g_len * VEC; i += THREADS) {
    const int kv = i / (g_len * VEC), u = (i / VEC) % g_len, c = i % VEC;
    const long src = new_row0 + u * walk.pos_stride + c * LANE_ELEMS;
    *reinterpret_cast<uint4*>(kv ? &v_new_sh[u][c * LANE_ELEMS]
                                 : &k_new_sh[u][c * LANE_ELEMS]) =
        *reinterpret_cast<const uint4*>((kv ? v_new : k_new) + src);
  }
  __syncthreads();

  // -- pass 1: every query's chunk scores into shared memory, the dots on
  // the tensor cores; each warp loads K_TILES tiles of 8 K rows (lane
  // (n, c): elements [32c, 32c + 32) of row n, int8 widened to bf16
  // exactly) before it multiplies --------------------------------------
  const int kn = lane / 4, kc = lane % 4;
  const long k_col = (long)h * D + 32 * kc;
  for (int base = chunk.t0 + warp * 8 * K_TILES; base < chunk.t1;
       base += WARPS * 8 * K_TILES) {     // warp-uniform
    unsigned kw[K_TILES][16];
    float ks[K_TILES][2];   // int8: the K scales of keys 2c, 2c + 1
#pragma unroll
    for (int t = 0; t < K_TILES; ++t) {
      const int pos = base + t * 8 + kn;
      float scale = 0.f;
#pragma unroll
      for (int w = 0; w < 16; ++w) kw[t][w] = 0u;
      if (pos < chunk.t1) {
        const int lt = pos - chunk.t0, pi = lt / page, off = lt - pi * page;
        const long pid = pid_sh[pi];
        const uint4* src = reinterpret_cast<const uint4*>(
            k_pages + pid * walk.page_stride + off * walk.pos_stride + k_col);
        if constexpr (INT8) {
          const uint4 raw[2] = {src[0], src[1]};
          const unsigned* word = reinterpret_cast<const unsigned*>(raw);
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            const unsigned biased = word[w] ^ 0x80808080u;
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const __nv_bfloat162 pair = __floats2bfloat162_rn(
                  int8_to_float(biased, 2 * hi),
                  int8_to_float(biased, 2 * hi + 1));
              kw[t][2 * w + hi] = *reinterpret_cast<const unsigned*>(&pair);
            }
          }
          // the scale load goes out with the row's, not after its use
          scale = k_scale[(pid * page + off) * Hkv + h];
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 v = src[i];
            kw[t][4 * i] = v.x;
            kw[t][4 * i + 1] = v.y;
            kw[t][4 * i + 2] = v.z;
            kw[t][4 * i + 3] = v.w;
          }
        }
      }
      if constexpr (INT8) {
        ks[t][0] = __shfl_sync(FULL, scale, (2 * kc) * 4);
        ks[t][1] = __shfl_sync(FULL, scale, (2 * kc + 1) * 4);
      }
    }
    tile_dots<K_TILES>(q_sh, rows, kw, lane,
                       [&](int t, int r, int n, float dot) {
      const int p = base + t * 8 + n;
      if (p >= chunk.t1) return;
      // the oracle's score: round(dot) * sm_scale, for int8 then times the
      // K scale; the _rn product is never contracted into later arithmetic
      float s = round_bf16(dot) * sm_scale;
      if constexpr (INT8) s = __fmul_rn(s, ks[t][n % 2]);
      e_sh[((long)(r / G) * cap + p - chunk.t0) * G + r % G] = s;
    });
  }
  // the new tokens' scores: their K rows are one tile (g_len <= 8)
  if (warp == 0) {
    unsigned kw[1][16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = kn < g_len ? *reinterpret_cast<const uint4*>(
                                       &k_new_sh[kn][32 * kc + 8 * i])
                                 : make_uint4(0, 0, 0, 0);
      kw[0][4 * i] = v.x;
      kw[0][4 * i + 1] = v.y;
      kw[0][4 * i + 2] = v.z;
      kw[0][4 * i + 3] = v.w;
    }
    tile_dots<1>(q_sh, rows, kw, lane, [&](int, int r, int u, float dot) {
      if (u <= r / G) s_new[r / G][u][r % G] = round_bf16(dot) * sm_scale;
    });
  }
  // pass 2's first V rows go out now: they arrive during the folds
  Row<KV> vr[V_RUN];
  float vs[V_RUN];
  load_run<KV, V_RUN>(walk, v_pages, v_scale, v_base0 + half * V_RUN, vr,
                      vs);

  // -- the chunk's statistics of each (query, row): its max m_r, then the
  // sum of exp(s - m_r) -------------------------------------------------
  __syncthreads();
  const int gt = tid % G;           // THREADS % G == 0: one row a thread
  for (int qi = 0; qi < g_len; ++qi) {
    const float* e = e_sh + (long)qi * cap * G;
    float mx = NEG_INF;
    for (int i = tid; i < n_chunk * G; i += THREADS) mx = fmaxf(mx, e[i]);
#pragma unroll
    for (int off = 16; off >= G; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    if (lane < G) part[warp][qi * G + lane] = mx;
  }
  __syncthreads();
  if (tid < rows) {
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, part[w][tid]);
    m_fin[tid] = mx;
  }
  __syncthreads();
  for (int qi = 0; qi < g_len; ++qi) {
    const float* e = e_sh + (long)qi * cap * G;
    const float m = m_fin[qi * G + gt];
    float sum = 0.f;
    for (int i = tid; i < n_chunk * G; i += THREADS) sum += expf(e[i] - m);
#pragma unroll
    for (int off = 16; off >= G; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    if (lane < G) part[warp][qi * G + lane] = sum;
  }
  __syncthreads();
  if (tid < rows) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += part[w][tid];
    rank_ml[tid] = m_fin[tid];
    rank_ml[rows + tid] = sum;
  }

  // -- the final (m, l), the same bits on every rank: the 8 ranks' in rank
  // order (an empty chunk's max -1e30 and sum 0 add nothing), then the new
  // keys'; then the oracle's exact probabilities, once a score ----------
  gather(cluster, rank_ml, all, 2 * rows, tid);
  if (tid < rows) {
    const int qi = tid / G, g = tid % G;
    float m = NEG_INF;
    for (int r = 0; r < CLUSTER; ++r) m = fmaxf(m, all[r * 2 * rows + tid]);
    for (int u = 0; u <= qi; ++u) m = fmaxf(m, s_new[qi][u][g]);
    float l = 0.f;
    for (int r = 0; r < CLUSTER; ++r)
      l += all[r * 2 * rows + rows + tid] *
           expf(all[r * 2 * rows + tid] - m);
    for (int u = 0; u <= qi; ++u) l += expf(s_new[qi][u][g] - m);
    m_fin[tid] = m;
    l_fin[tid] = l;
    for (int u = 0; u <= qi; ++u)
      p_new[qi][u][g] = round_bf16(expf(s_new[qi][u][g] - m) / l);
  }
  __syncthreads();
  // bf16 rounds p like probs.astype(bf16); int8 keeps it in f32 (times
  // the V scale below)
  for (int qi = 0; qi < g_len; ++qi) {
    float* e = e_sh + (long)qi * cap * G;
    const float m = m_fin[qi * G + gt], l = l_fin[qi * G + gt];
    for (int i = tid; i < n_chunk * G; i += THREADS) {
      const float p = expf(e[i] - m) / l;
      e[i] = INT8 ? p : round_bf16(p);
    }
  }
  __syncthreads();

  // -- pass 2: P.V in float32, query by query (an empty chunk has no
  // partial: the output sums the busy ranks' only) ---------------------
  // a warp whose positions fit one run keeps its V rows for every query;
  // otherwise the next query's first run is loaded during the reduction
  const bool one_run = v_base0 + V_STRIDE >= chunk.t1;
  for (int qi = 0; qi < g_len && chunk.n_pages > 0; ++qi) {
    const float* pq = e_sh + (long)qi * cap * G;
    for (int g0 = 0; g0 < G; g0 += G_PART) {
      float acc[G_PART][LANE_ELEMS];
#pragma unroll
      for (int g = 0; g < G_PART; ++g)
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j) acc[g][j] = 0.f;
      for (int base = v_base0; base < chunk.t1; base += V_STRIDE) {
        const int first = base + half * V_RUN;
        if (base != v_base0)
          load_run<KV, V_RUN>(walk, v_pages, v_scale, first, vr, vs);
#pragma unroll
        for (int u = 0; u < V_RUN; ++u) {
          if (first + u >= chunk.t1) break;
          const float* p = pq + (first + u - chunk.t0) * G + g0;
          float vv[LANE_ELEMS];
          unpack(vr[u], vv);
#pragma unroll
          for (int g = 0; g < G_PART; ++g) {
            const float pg = INT8 ? p[g] * vs[u] : p[g];
#pragma unroll
            for (int j = 0; j < LANE_ELEMS; ++j)
              acc[g][j] = fmaf(pg, vv[j], acc[g][j]);
          }
        }
      }
      // the next rows' (or query's) first run goes out during the sums
      if (!one_run && (g0 + G_PART < G || qi + 1 < g_len))
        load_run<KV, V_RUN>(walk, v_pages, v_scale, v_base0 + half * V_RUN,
                            vr, vs);
#pragma unroll
      for (int g = 0; g < G_PART; ++g)
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j)
          acc[g][j] += __shfl_xor_sync(FULL, acc[g][j], 16);
      if (lane < 16) {
#pragma unroll
        for (int g = 0; g < G_PART; ++g)
#pragma unroll
          for (int j = 0; j < LANE_ELEMS; ++j)
            part_acc[warp][g0 + g][d0 + j] = acc[g][j];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {   // the chunk's partial
      float sum = 0.f;
      for (int w = 0; w < WARPS; ++w) sum += part_acc[w][i / D][i % D];
      acc_sh[qi * G * D + i] = sum;
    }
    __syncthreads();
  }

  // -- the output, an eighth on each rank: the busy ranks' partials in
  // rank order (the busy ranks are a prefix), the new tokens, the
  // oracle's roundings --------------------------------------------------
  cluster.sync();     // every rank's partials are visible
  const int pages = (len + page - 1) / page;
  const int busy = pages == 0 ? 0 : (pages - 1) / ((pages + CLUSTER - 1) /
                                                   CLUSTER) + 1;
  const int per_out = rows * D / CLUSTER;
  for (int i = rank * per_out + tid; i < (rank + 1) * per_out; i += THREADS) {
    const int qi = i / (G * D), g = (i / D) % G, d = i % D;
    float cache_part = 0.f;
    for (int r = 0; r < busy; ++r)
      cache_part += cluster.map_shared_rank(acc_sh, r)[i];
    float new_acc = p_new[qi][0][g] * __bfloat162float(v_new_sh[0][d]);
    for (int u = 1; u <= qi; ++u)
      new_acc = fmaf(p_new[qi][u][g], __bfloat162float(v_new_sh[u][d]),
                     new_acc);
    // oracle: round the cache and new-token einsums, add, round the sum
    const float o = round_bf16(round_bf16(cache_part) + round_bf16(new_acc));
    out[(q_row0 + (long)qi * Hq + g) * D + d] = __float2bfloat16_rn(o);
  }
  cluster.sync();     // no rank exits while another reads its partials
}

// dynamic shared memory of a launch: the queries, one rank's partials,
// scores and page ids
long dyn_smem_bytes(int P, int page, int group, int g_len) {
  const long per_rank = (P + CLUSTER - 1) / CLUSTER;
  const long rows = (long)g_len * group;
  return rows * D * (long)(sizeof(__nv_bfloat16) + sizeof(float)) +
         rows * per_rank * page * (long)sizeof(float) +
         per_rank * (long)sizeof(int32_t);
}

// Lift the kernel's dynamic shared-memory limit to what the card allows
// beside its static shared memory, once per instantiation.
template <int G, int NEW, typename KV>
cudaError_t allow_dyn_smem() {
  static const cudaError_t status = [] {
    cudaFuncAttributes attrs;
    cudaError_t err = cudaFuncGetAttributes(&attrs, ragged_kernel<G, NEW, KV>);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        ragged_kernel<G, NEW, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT - (int)attrs.sharedSizeBytes);
  }();
  return status;
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
  const dim3 grid(Hkv * CLUSTER, B, 1);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  const cudaError_t err = allow_dyn_smem<G, NEW, KV>();
  if (err != cudaSuccess) return err;
  ragged_kernel<G, NEW, KV>
      <<<grid, THREADS, dyn_smem_bytes(P, page, G, g_len), stream>>>(
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
      g_len > MAX_NEW || Hkv > INT_MAX / CLUSTER ||
      (long)P * page > INT_MAX ||
      dyn_smem_bytes(P, page, Hq / Hkv, g_len) > MAX_DYN_SMEM)
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

template <int G, int NEW, typename KV>
cudaError_t occupancy(int P, int page, int g_len, int* clusters) {
  const cudaError_t err = allow_dyn_smem<G, NEW, KV>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = dyn_smem_bytes(P, page, G, g_len);
  return cudaOccupancyMaxActiveClusters(clusters, ragged_kernel<G, NEW, KV>,
                                        &config);
}

template <typename KV>
cudaError_t occupancy_group(int group, bool verify, int P, int page,
                            int g_len, int* clusters) {
  switch (group * 2 + (verify ? 1 : 0)) {
    case 2: return occupancy<1, 1, KV>(P, page, g_len, clusters);
    case 3: return occupancy<1, MAX_NEW, KV>(P, page, g_len, clusters);
    case 4: return occupancy<2, 1, KV>(P, page, g_len, clusters);
    case 5: return occupancy<2, MAX_NEW, KV>(P, page, g_len, clusters);
    case 8: return occupancy<4, 1, KV>(P, page, g_len, clusters);
    case 9: return occupancy<4, MAX_NEW, KV>(P, page, g_len, clusters);
    case 16: return occupancy<8, 1, KV>(P, page, g_len, clusters);
    case 17: return occupancy<8, MAX_NEW, KV>(P, page, g_len, clusters);
    default: return cudaErrorInvalidValue;
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

// How many clusters of the instantiation (group 1/2/4/8, verify or decode
// bound, int8 or bf16 pools) the card holds at once for g_len queries a
// slot and a table of P columns of `page` positions
// (cudaOccupancyMaxActiveClusters), in *clusters.
extern "C" int gofr_ragged_cluster_occupancy(int group, int verify,
                                             int int8, int P, int page,
                                             int g_len, int* clusters) {
  if (P <= 0 || page <= 0 || group <= 0 || g_len < 1 || g_len > MAX_NEW ||
      (!verify && g_len != 1) ||
      dyn_smem_bytes(P, page, group, g_len) > MAX_DYN_SMEM)
    return (int)cudaErrorInvalidValue;
  return (int)(int8 ? occupancy_group<int8_t>(group, verify != 0, P, page,
                                              g_len, clusters)
                    : occupancy_group<__nv_bfloat16>(group, verify != 0, P,
                                                     page, g_len, clusters));
}

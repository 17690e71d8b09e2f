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
//   rows by unrounded probabilities): each group of D / 8 lanes holds one
//   V row, 16 bytes a lane (8 bytes for int8), and issues D / 8 rows
//   before it uses the first (an int8 row's scale load beside its row;
//   the page table walked from one division a run), so a chunk of 256
//   positions is one run, kept in registers for every query (the
//   accumulators take the group's rows in two halves from group 4 up).
//   The first run is issued before the cluster barrier, so its latency
//   hides behind the folds.
// - Head dim D is a template parameter: this body serves D 128, and at
//   D 64 only the verify launches of more than 8 query rows (group 2 and
//   up; the head_dim-64 body below takes the rest). At D 128 a half-warp
//   holds a 256-byte bf16 row; at D 64 a quarter-warp holds a 128-byte
//   row (4 row streams a warp, not 2), runs of 8 rows, not 16, and pass 1
//   takes 4 mma k-steps, not 8. The quarter-warp keeps every lane's load
//   at 16 bytes (8 for int8), the width a warp reads device memory
//   fastest at. Either way the stride of a pass-2 sweep stays 256
//   positions, so the chunk rule and every fold order are the D-128
//   kernel's.
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
// one float that the row's lanes load from one address (one
// transaction). Scales are read only for live positions, like the rows:
// a NaN scale in a dead row or a sentinel page never reaches the output.
// The new tokens' K/V arrive as bf16 and take the bf16 path. The bytes
// per position and KV head fall from 4D to 2D + 8 (K, V and two scales).
//
// The head_dim-64 body (ragged_kernel_d64; every decode and every verify
// of group x G <= 8 rows at D 64, `small`'s whole path). At `small`'s
// shapes (group 1, B 8, Hkv 16, a table of 32 pages of 32) the body above
// takes 128 clusters of 8 blocks, about four waves of the card, each
// block paying three cluster barriers, eight block barriers and four
// sweeps of shared memory for a chunk of at most 128 positions, with one
// of the 16 rows of its mma tiles live. This body:
// - Sizes the split by positions: sweeps of 512 positions (32 row
//   streams, quarter-warps, of 16), sweep k = [512 k, 512 (k + 1));
//   ranks_for(P, page) = ceil(P * page / 512) blocks a (KV head, slot), at
//   most 8 (a cluster of that many), from the table's width, never
//   cache_len; rank r walks sweeps r, r + ranks, ... below cache_len, one
//   sweep a rank up to a table of 4096 positions. Every fold order is a
//   function of the fill alone: a dense cache's identity table at any
//   window rung and a paged table give the same bits, so the dense and
//   paged engines keep the same greedy tokens. Rungs 128-512 are one
//   block a (KV head, slot) with no cluster barrier at all, `small`'s
//   whole 1024 two.
// - Fits the card in one wave at `small`'s widest table: 2 blocks of 256
//   threads an SM (at most 128 registers a thread), so 16 KV heads x 8
//   slots x 2 ranks = 256 blocks are all resident at once. A lane holds
//   one sweep's K rows (16 of 16 bytes; int8 16 of 8 bytes and the
//   scales), the query rows sit in shared memory, and the V rows go out
//   into the K rows' registers once the scores are taken, arriving during
//   the softmax's folds. The page ids go out before cache_len is back.
//   (Sweeps of 256 positions would spill at 4 blocks an SM, <= 64
//   registers, and still take 1.03 waves in clusters of 4; at 2 an SM,
//   2 waves.) A stream walks its positions' pages by steps, one division
//   a sweep.
// - Runs pass 1 on the CUDA cores: each lane's 8 columns of the K row
//   against each query row, summed over the row's 8 lanes (row_sum);
//   lane r of the stream keeps row r's score, so the scores stay in
//   registers (no shared memory sized by the table) and exp is taken
//   once a score. At most 8 rows: decode at every group, verify of group
//   x G <= 8 (`small`'s G 5 at group 1).
// - Takes a sweep's max and sum by warp shuffles and one shared-memory
//   step each (two block barriers a sweep); a rank of several sweeps (a
//   table wider than 4096 positions) folds its sweeps' (m, l) in order,
//   L = L exp(M - M') + l exp(m - M'), and reads K again in pass 2.
// - Exchanges the ranks' (m, l) by each rank storing its own into every
//   rank's shared memory, then one cluster barrier (the first, opened at
//   the kernel's start, only proves every block is running); each lane
//   folds its row's in rank order, then the new keys'. P.V takes each
//   probability from its lane by shuffle; the warps' partials fold in
//   shared memory in warp order; each rank stores its partial on rank 0,
//   and after the second barrier rank 0 sums them in rank order and
//   writes the output with the oracle's roundings. No scratch in device
//   memory and no dynamic shared memory: any table width is served.
// The rounding points are the oracle's, as above, and the fold orders do
// not depend on the new-token bound NEW, so the verify instantiation at
// G = 1 gives the decode instantiation's bits.
//
// Layout: q (B,G,Hq,D); k_pages/v_pages (N,page,Hkv,D) bf16 or int8;
// k_scale/v_scale (N,page,Hkv) f32 with int8 pools; table (B,P) int32
// with sentinel N; k_new/v_new (B,G,Hkv,D); cache_len (B,) int32 (valid
// tokens excluding the new ones); out (B,G,Hq,D). q, new K/V and out
// bf16. D is 64 or 128; the group (Hq/Hkv) is 1, 2, 4 or 8;
// 1 <= G <= MAX_NEW.
// The cluster-of-8 body: grid (Hkv * CLUSTER, B), clusters of (CLUSTER,
// 1, 1), 256 threads; dynamic shared memory (dyn_smem_bytes) at most
// MAX_DYN_SMEM. The head_dim-64 body: grid (Hkv * ranks, B), clusters of
// (ranks, 1, 1) set at launch, 256 threads, static shared memory only.

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
// pass 1: tiles of 8 K rows a warp loads before it multiplies
constexpr int K_TILES = 2;
// dynamic shared memory a block may take (its chunk's scores, partials,
// queries and page ids), and what one block may use on sm_90
constexpr long MAX_DYN_SMEM = 160 * 1024;
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

// one lane's share of a V row in pass 2: 8 elements, 16 bytes bf16, 8
// int8
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
// elements [c D/4, (c + 1) D/4) of key n of each tile in kw (KW = D / 8
// bf16 pairs; D / 16 mma k-steps of 4 of them). Calls out(t, r, n, dot)
// for each query row r < R and key n of tile t whose dot this lane holds.
template <int D, int NT, typename Out>
__device__ __forceinline__ void tile_dots(const __nv_bfloat16* q_sh, int R,
                                          const unsigned (&kw)[NT][D / 8],
                                          int lane, Out out) {
  constexpr int KW = D / 8;
  const int kn = lane / 4, kc = lane % 4;
  for (int r0 = 0; r0 < R; r0 += 16) {    // warp-uniform
    const int ra = r0 + kn, rb = ra + 8;  // this lane's two rows
    unsigned qa[KW], qb[KW];
#pragma unroll
    for (int i = 0; i < KW / 4; ++i) {
      const uint4 va = ra < R ? *reinterpret_cast<const uint4*>(
                                    q_sh + ra * D + (D / 4) * kc + 8 * i)
                              : make_uint4(0, 0, 0, 0);
      const uint4 vb = rb < R ? *reinterpret_cast<const uint4*>(
                                    q_sh + rb * D + (D / 4) * kc + 8 * i)
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
      for (int s = 0; s < KW / 2; ++s)
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
template <int D, int G, int NEW, typename KV>
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
  constexpr int ROW = Lanes<D>::ROW;        // lanes a V row in pass 2
  constexpr int SUBS = Lanes<D>::SUBS;      // V row streams a warp
  constexpr int KW = D / 8;                 // pass 1: bf16 pairs a lane
  // pass 2: V rows a stream issues before it uses the first; a sweep of
  // the block covers 256 positions at either D
  constexpr int V_RUN = D / 8;
  constexpr int V_STRIDE = Lanes<D>::STREAMS * V_RUN;
  // pass 2's accumulators take the group's rows in two halves from 4 up,
  // over the same V registers
  constexpr int G_PART = G < 4 ? G : G / 2;
  constexpr int VEC = D / LANE_ELEMS;       // 16-byte vectors a row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / CLUSTER, b = blockIdx.y;
  const int Hq = Hkv * G, rows = g_len * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / ROW;
  const int d0 = (lane % ROW) * LANE_ELEMS;
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
  // a warp's row streams take consecutive runs of positions; the loop
  // bounds are warp-uniform, so the shuffles never diverge
  const int v_base0 = chunk.t0 + warp * SUBS * V_RUN;

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
  // (n, c): elements [c D/4, (c + 1) D/4) of row n, int8 widened to bf16
  // exactly) before it multiplies --------------------------------------
  const int kn = lane / 4, kc = lane % 4;
  const long k_col = (long)h * D + (D / 4) * kc;
  for (int base = chunk.t0 + warp * 8 * K_TILES; base < chunk.t1;
       base += WARPS * 8 * K_TILES) {     // warp-uniform
    unsigned kw[K_TILES][KW];
    float ks[K_TILES][2];   // int8: the K scales of keys 2c, 2c + 1
#pragma unroll
    for (int t = 0; t < K_TILES; ++t) {
      const int pos = base + t * 8 + kn;
      float scale = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) kw[t][w] = 0u;
      if (pos < chunk.t1) {
        const int lt = pos - chunk.t0, pi = lt / page, off = lt - pi * page;
        const long pid = pid_sh[pi];
        const uint4* src = reinterpret_cast<const uint4*>(
            k_pages + pid * walk.page_stride + off * walk.pos_stride + k_col);
        if constexpr (INT8) {
          uint4 raw[D / 64];      // D / 4 int8 bytes
#pragma unroll
          for (int i = 0; i < D / 64; ++i) raw[i] = src[i];
          const unsigned* word = reinterpret_cast<const unsigned*>(raw);
#pragma unroll
          for (int w = 0; w < KW / 2; ++w) {
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
          for (int i = 0; i < KW / 4; ++i) {
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
    tile_dots<D, K_TILES>(q_sh, rows, kw, lane,
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
    unsigned kw[1][KW];
#pragma unroll
    for (int i = 0; i < KW / 4; ++i) {
      const uint4 v = kn < g_len ? *reinterpret_cast<const uint4*>(
                                       &k_new_sh[kn][(D / 4) * kc + 8 * i])
                                 : make_uint4(0, 0, 0, 0);
      kw[0][4 * i] = v.x;
      kw[0][4 * i + 1] = v.y;
      kw[0][4 * i + 2] = v.z;
      kw[0][4 * i + 3] = v.w;
    }
    tile_dots<D, 1>(q_sh, rows, kw, lane, [&](int, int r, int u, float dot) {
      if (u <= r / G) s_new[r / G][u][r % G] = round_bf16(dot) * sm_scale;
    });
  }
  // pass 2's first V rows go out now: they arrive during the folds
  Row<KV> vr[V_RUN];
  float vs[V_RUN];
  load_run<KV, V_RUN>(walk, v_pages, v_scale, v_base0 + sub * V_RUN, vr,
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
        const int first = base + sub * V_RUN;
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
        load_run<KV, V_RUN>(walk, v_pages, v_scale, v_base0 + sub * V_RUN,
                            vr, vs);
      // the warp's row streams hold the same columns: fold them
#pragma unroll
      for (int g = 0; g < G_PART; ++g)
#pragma unroll
        for (int j = 0; j < LANE_ELEMS; ++j)
          acc[g][j] = sub_fold<ROW>(acc[g][j]);
      if (lane < ROW) {
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

// ---------------------------------------------------------------------------
// The head_dim-64 body (see the file's header): every launch of up to
// MAX_ROWS query rows a (KV head, slot), which is every decode and the
// verify launches of group x G <= 8.
namespace d64 {

constexpr int D = 64;
constexpr int ROW = Lanes<D>::ROW;          // 8 lanes a K/V row
constexpr int STREAMS = THREADS / ROW;      // 32 row streams a block
constexpr int PER = 16;                     // positions a stream a sweep
constexpr int SPAN = STREAMS * PER;         // positions a sweep: 512
constexpr int MAX_RANKS = 8;                // the portable cluster size
constexpr int MAX_ROWS = ROW;               // one row a lane of a stream
// blocks an SM holds: 2 x 256 threads at <= 128 registers, so a launch of
// 256 blocks (`small`'s 32-page table: 16 KV heads x 8 slots x 2 ranks)
// is one wave of the card
constexpr int MIN_BLOCKS = 2;

// Blocks a (KV head, slot): one per sweep of the table's P * page
// positions, at most MAX_RANKS. From the table's width, never from
// cache_len: the launch's shape needs no read of the device.
__host__ __device__ inline int ranks_for(int P, int page) {
  const long sweeps = ((long)P * page + SPAN - 1) / SPAN;
  return (int)(sweeps < 1 ? 1 : sweeps > MAX_RANKS ? MAX_RANKS : sweeps);
}

// A copy of a row's words the compiler must treat as new at each use: the
// row is unpacked again where it is used, not once outside a loop over
// query rows (16 rows unpacked at once take 128 registers and spill).
__device__ __forceinline__ uint4 opaque(uint4 w) {
  asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
  return w;
}

__device__ __forceinline__ uint2 opaque(uint2 w) {
  asm volatile("" : "+r"(w.x), "+r"(w.y));
  return w;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block `rank` of the `ranks` blocks for (KV head h, slot b). Row r of the
// R = g_len * GROUP query rows is query r / GROUP, head h * GROUP + r %
// GROUP. NEW bounds the new tokens at compile time (1: decode, MAX_NEW:
// verify); the arithmetic and its order do not depend on it.
template <int GROUP, int NEW, typename KV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ragged_kernel_d64(const __nv_bfloat16* __restrict__ q,
                  const KV* __restrict__ k_pages,
                  const KV* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ table,
                  const __nv_bfloat16* __restrict__ k_new,
                  const __nv_bfloat16* __restrict__ v_new,
                  const int32_t* __restrict__ cache_len,
                  __nv_bfloat16* __restrict__ out, int num_pages, int page,
                  int Hkv, int P, int g_len, int ranks, float sm_scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int ROWS = NEW * GROUP < MAX_ROWS ? NEW * GROUP : MAX_ROWS;
  constexpr int RB = ROWS < 2 ? ROWS : 2;     // P.V rows a pass
  __shared__ __align__(16) __nv_bfloat16 q_sh[ROWS][D];
  __shared__ __align__(16) __nv_bfloat16 k_new_sh[NEW][D], v_new_sh[NEW][D];
  __shared__ float red_m[WARPS][ROW], red_l[WARPS][ROW];
  __shared__ float rank_m[MAX_RANKS][ROW], rank_l[MAX_RANKS][ROW];
  __shared__ float s_new[ROWS][NEW], p_new[ROWS][NEW];
  __shared__ float part_acc[WARPS][ROWS][D];
  __shared__ float rank_acc[MAX_RANKS][ROWS][D];     // read on rank 0

  cg::cluster_group cluster = cg::this_cluster();
  // the first cluster barrier opens now and closes before the first
  // remote store: every block of the cluster has started by then
  if (ranks > 1) cluster_arrive_relaxed();
  const int rank = ranks > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int h = blockIdx.x / ranks, b = blockIdx.y;
  const int Hq = Hkv * GROUP, R = g_len * GROUP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = tid / ROW, col = lane % ROW, d0 = col * LANE_ELEMS;
  const int sbase = lane & ~(ROW - 1);      // the stream's first lane
  const bool own = col < R;                 // this lane keeps row col's scores
  // sweep k of the slot is positions [k SPAN, (k + 1) SPAN); rank r takes
  // sweeps r, r + ranks, r + 2 ranks, ... below the fill t1, so every
  // fold order depends on the fill alone, never on the table's width
  // (a dense cache's identity table and a paged table give the same
  // bits); t_cap, the table's end, bounds the page-id reads
  const int t_cap = P * page;
  const int t1 = max(0, min(cache_len[b], t_cap));
  const int t0 = rank * SPAN, stride = ranks * SPAN;
  const bool one_sweep = stride >= t_cap;    // a rank holds at most one
  const int n_sweeps =
      one_sweep ? 1 : max(0, (t1 - t0 + stride - 1) / stride);
  const long pos_stride = (long)Hkv * D;
  const long page_stride = (long)page * pos_stride;
  const long head_off = (long)h * D + d0;
  const int32_t* ids = table + (long)b * P;

  // a stream's positions of the sweep at `base`: base + i * STREAMS +
  // stream; dead ones load nothing and hold zeros
  Row<KV> kr[PER], vr[PER];
  float ks[PER], vs[PER], s[PER], p[PER];
  auto live = [&](int base, int i) {
    return base + i * STREAMS + stream < t1;
  };
  // the stream's (table column, offset) of position base + stream, then
  // of each next one, STREAMS further: one division a sweep
  auto walk = [&](int base, int& col_i, int& off_i) {
    col_i = (base + stream) / page;
    off_i = base + stream - col_i * page;
  };
  auto step = [&](int& col_i, int& off_i) {
    off_i += STREAMS;
    while (off_i >= page) {                  // page-uniform
      off_i -= page;
      ++col_i;
    }
  };
  // the K rows (`v` false) or the V rows of a sweep, and with int8 pools
  // their scales; the page ids go out before cache_len is back (they do
  // not depend on it), the rows only for live positions, so no sentinel
  // page and no row past the fill is read
  auto load = [&](int base, bool v) {
    int pid[PER];
    int ci, oi;
    walk(base, ci, oi);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      pid[i] = base + i * STREAMS + stream < t_cap ? ids[ci] : 0;
      step(ci, oi);
    }
    walk(base, ci, oi);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int pos = base + i * STREAMS + stream;
      Row<KV> row{};
      float scale = 0.f;
      if (pos < t1) {
        const long id = min(max(pid[i], 0), num_pages - 1);
        row = load_row((v ? v_pages : k_pages) + id * page_stride +
                       oi * pos_stride + head_off);
        if constexpr (INT8)
          scale = (v ? v_scale : k_scale)[(id * page + oi) * Hkv + h];
      }
      step(ci, oi);
      if (v) {
        vr[i] = row;
        vs[i] = scale;
      } else {
        kr[i] = row;
        ks[i] = scale;
      }
    }
  };
  // the query rows and the new tokens' K and V rows go to shared memory
  // while the first K rows are out, one 16-byte piece a thread
  auto load_small = [&]() {
    const int n_q = R * ROW, n_new = g_len * ROW;
    if (tid < n_q) {
      const int r = tid / ROW;
      *reinterpret_cast<uint4*>(&q_sh[r][d0]) =
          *reinterpret_cast<const uint4*>(
              q + (((long)b * g_len + r / GROUP) * Hq + (long)h * GROUP +
                   r % GROUP) * D + d0);
    } else if (tid < n_q + 2 * n_new) {
      const int k = tid - n_q, u = (k % n_new) / ROW;
      const long at = (((long)b * g_len + u) * Hkv + h) * D + d0;
      if (k < n_new)
        *reinterpret_cast<uint4*>(&k_new_sh[u][d0]) =
            *reinterpret_cast<const uint4*>(k_new + at);
      else
        *reinterpret_cast<uint4*>(&v_new_sh[u][d0]) =
            *reinterpret_cast<const uint4*>(v_new + at);
    }
    __syncthreads();
  };
  // positions a stream holds in the sweep at `base` that some stream has
  // live: the loops over a sweep stop there (block-uniform)
  auto n_live = [&](int base) {
    return min(PER, max(0, (t1 - base + STREAMS - 1) / STREAMS));
  };
  // pass 1 on the CUDA cores: each stream's lanes hold 8 columns of a K
  // row; the dot of every query row is summed over the stream's lanes and
  // lane r keeps row r's: the oracle's score, round(dot) * sm_scale (int8:
  // then times the K scale), never contracted into later arithmetic
  auto scores = [&](int base) {
    const int n = n_live(base);
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      float qv[LANE_ELEMS];
      load8(&q_sh[r][d0], qv);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (i < n) {                         // block-uniform
          float kv[LANE_ELEMS];
          unpack(opaque(kr[i]), kv);
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < LANE_ELEMS; ++j) dot = fmaf(qv[j], kv[j], dot);
          dot = row_sum<ROW>(dot);
          if (col == r) s[i] = dot;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float sc = __fmul_rn(round_bf16(s[i]), sm_scale);
      if constexpr (INT8) sc = __fmul_rn(sc, ks[i]);
      s[i] = own && live(base, i) ? sc : NEG_INF;
    }
  };
  // a sweep's max m_s and sum of exp(s - m_s) of each row (the same bits
  // in every lane of that row), folded into the rank's (M, L) in sweep
  // order: L = L exp(M - M') + l_s exp(m_s - M'); one sweep gives (m_s,
  // l_s) exactly
  float M = NEG_INF, L = 0.f;
  auto fold_sweep = [&](int base) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER; ++i) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, ROW));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2 * ROW));
    if (lane < ROW) red_m[warp][lane] = mx;
    __syncthreads();
    float m_s = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m_s = fmaxf(m_s, red_m[w][col]);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (own && live(base, i)) sum += expf(s[i] - m_s);
    sum += __shfl_xor_sync(FULL, sum, ROW);
    sum += __shfl_xor_sync(FULL, sum, 2 * ROW);
    if (lane < ROW) red_l[warp][lane] = sum;
    __syncthreads();
    float l_s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l_s += red_l[w][col];
    const float m2 = fmaxf(M, m_s);
    L = __fadd_rn(__fmul_rn(L, expf(M - m2)), __fmul_rn(l_s, expf(m_s - m2)));
    M = m2;
  };

  // -- pass 1: the first sweep's K rows go out, then the queries; one
  // sweep's V rows go out once its scores are taken, and arrive during
  // the folds; a longer chunk reads K a sweep at a time
  load(t0, false);
  load_small();
  // the new tokens' scores: pair (r, u <= r / GROUP) of the R x g_len on
  // warp (pair mod WARPS)
#pragma unroll 1
  for (int pr = warp; pr < R * g_len; pr += WARPS) {
    const int r = pr / g_len, u = pr % g_len;
    if (u > r / GROUP) continue;             // warp-uniform
    float kv[LANE_ELEMS], qv[LANE_ELEMS];
    load8(&k_new_sh[u][d0], kv);
    load8(&q_sh[r][d0], qv);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < LANE_ELEMS; ++j) dot = fmaf(qv[j], kv[j], dot);
    dot = row_sum<ROW>(dot);
    if (lane == 0) s_new[r][u] = __fmul_rn(round_bf16(dot), sm_scale);
  }
  if (one_sweep) {
    scores(t0);
    load(t0, true);
    fold_sweep(t0);
  } else {
    for (int sw = 0; sw < n_sweeps; ++sw) {
      if (sw > 0) load(t0 + sw * stride, false);
      scores(t0 + sw * stride);
      fold_sweep(t0 + sw * stride);
    }
    __syncthreads();                          // s_new, with no sweep
  }

  // -- the ranks' (M, L): each rank stores its own into every rank's
  // shared memory, then one barrier
  if (ranks > 1) {
    cluster_wait();
    if (tid < ranks * ROW && own) {           // col == tid % ROW
      const int dst = tid / ROW;
      *cluster.map_shared_rank(&rank_m[rank][col], dst) = M;
      *cluster.map_shared_rank(&rank_l[rank][col], dst) = L;
    }
    cluster_arrive();
    cluster_wait();
  }
  // the final (m, l) of row col, the same bits on every rank: the ranks'
  // in rank order (an empty rank's -1e30 and 0 add nothing), then the new
  // keys'
  float m = NEG_INF, l = 0.f;
  if (own) {
    const int qi = col / GROUP;
    for (int rk = 0; rk < ranks; ++rk)
      m = fmaxf(m, ranks > 1 ? rank_m[rk][col] : M);
#pragma unroll
    for (int u = 0; u < NEW; ++u)
      if (u <= qi) m = fmaxf(m, s_new[col][u]);
    for (int rk = 0; rk < ranks; ++rk) {
      const float mr = ranks > 1 ? rank_m[rk][col] : M;
      const float lr = ranks > 1 ? rank_l[rk][col] : L;
      l = __fadd_rn(l, __fmul_rn(lr, expf(mr - m)));
    }
#pragma unroll
    for (int u = 0; u < NEW; ++u)
      if (u <= qi) l = __fadd_rn(l, expf(s_new[col][u] - m));
    if (rank == 0 && stream == 0) {
#pragma unroll
      for (int u = 0; u < NEW; ++u)
        if (u <= qi) p_new[col][u] = round_bf16(expf(s_new[col][u] - m) / l);
    }
  }
  // the oracle's probabilities, once a score by the lane that keeps it:
  // bf16 rounds p like probs.astype(bf16); int8 keeps it in f32, times
  // the V scale
  auto probs = [&](int base) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float e = expf(s[i] - m) / l;
      p[i] = !(own && live(base, i)) ? 0.f
             : INT8                  ? __fmul_rn(e, vs[i])
                                     : round_bf16(e);
    }
  };

  // -- pass 2: P.V in float32, RB rows at a time; each stream's V rows
  // take their probabilities from the stream's lanes by shuffle
  if (one_sweep) probs(t0);
#pragma unroll 1
  for (int r0 = 0; r0 < R; r0 += RB) {
    float acc[RB][LANE_ELEMS];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j) acc[rr][j] = 0.f;
    for (int sw = 0; sw < n_sweeps; ++sw) {
      const int base = t0 + sw * stride;
      if (!one_sweep) {                       // K again, for the scores
        load(base, false);
        scores(base);
        load(base, true);
        probs(base);
      }
      const int n = n_live(base);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (i >= n) continue;                 // block-uniform
        float vv[LANE_ELEMS];
        unpack(opaque(vr[i]), vv);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const float pr = __shfl_sync(FULL, p[i], sbase + r0 + rr);
#pragma unroll
          for (int j = 0; j < LANE_ELEMS; ++j)
            acc[rr][j] = fmaf(pr, vv[j], acc[rr][j]);
        }
      }
    }
    // the warp's 4 streams hold the same columns: fold them
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int j = 0; j < LANE_ELEMS; ++j)
        acc[rr][j] = sub_fold<ROW>(acc[rr][j]);
    if (lane < ROW) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        if (r0 + rr < R) {
#pragma unroll
          for (int j = 0; j < LANE_ELEMS; ++j)
            part_acc[warp][r0 + rr][d0 + j] = acc[rr][j];
        }
    }
  }
  __syncthreads();

  // -- the output: the rank's partial (the warps in order); with several
  // ranks each stores it on rank 0, which sums them in rank order; the new
  // tokens; the oracle's roundings (the cache and new-token parts each
  // rounded, then added and rounded)
  const int n_out = R * D;
  auto finish = [&](int i, float cache) {
    const int r = i / D, d = i % D, qi = r / GROUP, g = r % GROUP;
    float new_acc = __fmul_rn(p_new[r][0], __bfloat162float(v_new_sh[0][d]));
#pragma unroll
    for (int u = 1; u < NEW; ++u)
      if (u <= qi)
        new_acc = fmaf(p_new[r][u], __bfloat162float(v_new_sh[u][d]),
                       new_acc);
    const float o = round_bf16(__fadd_rn(round_bf16(cache),
                                         round_bf16(new_acc)));
    out[(((long)b * g_len + qi) * Hq + (long)h * GROUP + g) * D + d] =
        __float2bfloat16_rn(o);
  };
  for (int i = tid; i < n_out; i += THREADS) {
    float part = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) part += part_acc[w][i / D][i % D];
    if (ranks > 1)
      *cluster.map_shared_rank(&rank_acc[rank][0][0] + i, 0) = part;
    else
      finish(i, part);
  }
  if (ranks > 1) {
    cluster_arrive();
    cluster_wait();          // after it no block reads another's memory
    if (rank == 0) {
      for (int i = tid; i < n_out; i += THREADS) {
        float cache = 0.f;
        for (int rk = 0; rk < ranks; ++rk) cache += (&rank_acc[rk][0][0])[i];
        finish(i, cache);
      }
    }
  }
}

// A launch of (Hkv * ranks, B) blocks in clusters of `ranks`.
cudaLaunchConfig_t launch_config(int Hkv, int B, int ranks,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(Hkv * ranks, B, 1);
  c.blockDim = dim3(THREADS, 1, 1);
  c.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  c.attrs = attr;
  c.numAttrs = 1;
  return c;
}

}  // namespace d64

// dynamic shared memory of a launch: the queries, one rank's partials,
// scores and page ids
long dyn_smem_bytes(int P, int page, int group, int g_len, int head_dim) {
  const long per_rank = (P + CLUSTER - 1) / CLUSTER;
  const long rows = (long)g_len * group;
  return rows * head_dim * (long)(sizeof(__nv_bfloat16) + sizeof(float)) +
         rows * per_rank * page * (long)sizeof(float) +
         per_rank * (long)sizeof(int32_t);
}

// Lift the kernel's dynamic shared-memory limit to what the card allows
// beside its static shared memory, once per instantiation.
template <int D, int G, int NEW, typename KV>
cudaError_t allow_dyn_smem() {
  static const cudaError_t status = [] {
    cudaFuncAttributes attrs;
    cudaError_t err =
        cudaFuncGetAttributes(&attrs, ragged_kernel<D, G, NEW, KV>);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        ragged_kernel<D, G, NEW, KV>,
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

// One call's operands and geometry.
struct Call {
  const void* q;
  Pools pools;
  const void* table;
  const void* k_new;
  const void* v_new;
  const void* cache_len;
  void* out;
  int B, g_len, Hkv, num_pages, page, P;
  cudaStream_t stream;
};

template <int D, int G, int NEW, typename KV>
cudaError_t launch(const Call& c) {
  const dim3 grid(c.Hkv * CLUSTER, c.B, 1);
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  const cudaError_t err = allow_dyn_smem<D, G, NEW, KV>();
  if (err != cudaSuccess) return err;
  ragged_kernel<D, G, NEW, KV>
      <<<grid, THREADS, dyn_smem_bytes(c.P, c.page, G, c.g_len, D),
         c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const KV*>(c.pools.k), static_cast<const KV*>(c.pools.v),
      static_cast<const float*>(c.pools.k_scale),
      static_cast<const float*>(c.pools.v_scale),
      static_cast<const int32_t*>(c.table),
      static_cast<const __nv_bfloat16*>(c.k_new),
      static_cast<const __nv_bfloat16*>(c.v_new),
      static_cast<const int32_t*>(c.cache_len),
      static_cast<__nv_bfloat16*>(c.out), c.num_pages, c.page, c.Hkv, c.P,
      c.g_len, sm_scale);
  return cudaGetLastError();
}

// Decode (g_len 1) takes the NEW = 1 instantiation unless verify_form asks
// for the verify one, which must give the same bits at g_len 1.
template <int D, int G, typename KV>
cudaError_t launch_group(const Call& c, bool verify_form) {
  if (c.g_len == 1 && !verify_form) return launch<D, G, 1, KV>(c);
  return launch<D, G, MAX_NEW, KV>(c);
}

template <int D, typename KV>
cudaError_t launch_head_dim(const Call& c, int group, bool verify_form) {
  switch (group) {
    case 1: return launch_group<D, 1, KV>(c, verify_form);
    case 2: return launch_group<D, 2, KV>(c, verify_form);
    case 4: return launch_group<D, 4, KV>(c, verify_form);
    case 8: return launch_group<D, 8, KV>(c, verify_form);
    default: return cudaErrorInvalidValue;
  }
}

// Which body a launch takes: the head_dim-64 one for up to d64::MAX_ROWS
// query rows a (KV head, slot), the cluster-of-8 one otherwise.
bool d64_body(int head_dim, int group, int g_len) {
  return head_dim == 64 && group * g_len <= d64::MAX_ROWS;
}

template <int GROUP, int NEW, typename KV>
cudaError_t launch_d64(const Call& c) {
  const int ranks = d64::ranks_for(c.P, c.page);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      d64::launch_config(c.Hkv, c.B, ranks, c.stream, &attr);
  return cudaLaunchKernelEx(
      &config, d64::ragged_kernel_d64<GROUP, NEW, KV>,
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const KV*>(c.pools.k), static_cast<const KV*>(c.pools.v),
      static_cast<const float*>(c.pools.k_scale),
      static_cast<const float*>(c.pools.v_scale),
      static_cast<const int32_t*>(c.table),
      static_cast<const __nv_bfloat16*>(c.k_new),
      static_cast<const __nv_bfloat16*>(c.v_new),
      static_cast<const int32_t*>(c.cache_len),
      static_cast<__nv_bfloat16*>(c.out), c.num_pages, c.page, c.Hkv, c.P,
      c.g_len, ranks, (float)(1.0 / sqrt((double)d64::D)));
}

template <int GROUP, typename KV>
cudaError_t launch_d64_group(const Call& c, bool verify_form) {
  if (c.g_len == 1 && !verify_form) return launch_d64<GROUP, 1, KV>(c);
  return launch_d64<GROUP, MAX_NEW, KV>(c);
}

// head_dim 64: the D-64 body, or the cluster-of-8 body's verify
// instantiation for more than d64::MAX_ROWS rows (group 2 and up, G > 8 /
// group)
template <typename KV>
cudaError_t launch_d64_head(const Call& c, int group, bool verify_form) {
  if (d64_body(64, group, c.g_len)) {
    switch (group) {
      case 1: return launch_d64_group<1, KV>(c, verify_form);
      case 2: return launch_d64_group<2, KV>(c, verify_form);
      case 4: return launch_d64_group<4, KV>(c, verify_form);
      case 8: return launch_d64_group<8, KV>(c, verify_form);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (group) {
    case 2: return launch<64, 2, MAX_NEW, KV>(c);
    case 4: return launch<64, 4, MAX_NEW, KV>(c);
    case 8: return launch<64, 8, MAX_NEW, KV>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
int dispatch(const Call& c, int Hq, int head_dim, bool verify_form) {
  if ((head_dim != 64 && head_dim != 128) || c.B <= 0 || c.Hkv <= 0 ||
      Hq % c.Hkv != 0 || c.num_pages <= 0 || c.page <= 0 || c.P <= 0 ||
      c.B > 65535 || c.g_len < 1 || c.g_len > MAX_NEW ||
      c.Hkv > INT_MAX / CLUSTER || (long)c.P * c.page > INT_MAX ||
      (!d64_body(head_dim, Hq / c.Hkv, c.g_len) &&
       dyn_smem_bytes(c.P, c.page, Hq / c.Hkv, c.g_len, head_dim) >
           MAX_DYN_SMEM))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    return (int)launch_d64_head<KV>(c, Hq / c.Hkv, verify_form);
  return (int)launch_head_dim<128, KV>(c, Hq / c.Hkv, verify_form);
}

template <int D, int G, int NEW, typename KV>
cudaError_t occupancy(int P, int page, int g_len, int* clusters) {
  const cudaError_t err = allow_dyn_smem<D, G, NEW, KV>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = dyn_smem_bytes(P, page, G, g_len, D);
  return cudaOccupancyMaxActiveClusters(
      clusters, ragged_kernel<D, G, NEW, KV>, &config);
}

template <int D, typename KV>
cudaError_t occupancy_group(int group, bool verify, int P, int page,
                            int g_len, int* clusters) {
  switch (group * 2 + (verify ? 1 : 0)) {
    case 2: return occupancy<D, 1, 1, KV>(P, page, g_len, clusters);
    case 3: return occupancy<D, 1, MAX_NEW, KV>(P, page, g_len, clusters);
    case 4: return occupancy<D, 2, 1, KV>(P, page, g_len, clusters);
    case 5: return occupancy<D, 2, MAX_NEW, KV>(P, page, g_len, clusters);
    case 8: return occupancy<D, 4, 1, KV>(P, page, g_len, clusters);
    case 9: return occupancy<D, 4, MAX_NEW, KV>(P, page, g_len, clusters);
    case 16: return occupancy<D, 8, 1, KV>(P, page, g_len, clusters);
    case 17: return occupancy<D, 8, MAX_NEW, KV>(P, page, g_len, clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <int GROUP, int NEW, typename KV>
cudaError_t occupancy_d64(int P, int page, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      d64::launch_config(1, 1, d64::ranks_for(P, page), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, d64::ragged_kernel_d64<GROUP, NEW, KV>, &config);
}

template <typename KV>
cudaError_t occupancy_d64_group(int group, bool verify, int P, int page,
                                int* clusters) {
  switch (group * 2 + (verify ? 1 : 0)) {
    case 2: return occupancy_d64<1, 1, KV>(P, page, clusters);
    case 3: return occupancy_d64<1, MAX_NEW, KV>(P, page, clusters);
    case 4: return occupancy_d64<2, 1, KV>(P, page, clusters);
    case 5: return occupancy_d64<2, MAX_NEW, KV>(P, page, clusters);
    case 8: return occupancy_d64<4, 1, KV>(P, page, clusters);
    case 9: return occupancy_d64<4, MAX_NEW, KV>(P, page, clusters);
    case 16: return occupancy_d64<8, 1, KV>(P, page, clusters);
    case 17: return occupancy_d64<8, MAX_NEW, KV>(P, page, clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
cudaError_t occupancy_head_dim(int head_dim, int group, bool verify, int P,
                               int page, int g_len, int* clusters) {
  if (d64_body(head_dim, group, g_len))
    return occupancy_d64_group<KV>(group, verify, P, page, clusters);
  if (head_dim == 64) {        // verify of more than d64::MAX_ROWS rows
    switch (group) {
      case 2: return occupancy<64, 2, MAX_NEW, KV>(P, page, g_len, clusters);
      case 4: return occupancy<64, 4, MAX_NEW, KV>(P, page, g_len, clusters);
      case 8: return occupancy<64, 8, MAX_NEW, KV>(P, page, g_len, clusters);
      default: return cudaErrorInvalidValue;
    }
  }
  return occupancy_group<128, KV>(group, verify, P, page, g_len, clusters);
}

Call make_call(const void* q, Pools pools, const void* table,
               const void* k_new, const void* v_new, const void* cache_len,
               void* out, int B, int g_len, int Hkv, int num_pages, int page,
               int P, void* stream) {
  return Call{q, pools, table, k_new, v_new, cache_len, out, B, g_len, Hkv,
              num_pages, page, P, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Each entry returns a cudaError_t (0 = success). bf16 pools:
extern "C" int gofr_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* k_new, const void* v_new,
    const void* cache_len, void* out, int B, int g_len, int Hq, int Hkv,
    int head_dim, int num_pages, int page, int P, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_call(q, Pools{k_pages, v_pages, nullptr, nullptr}, table, k_new,
                v_new, cache_len, out, B, g_len, Hkv, num_pages, page, P,
                stream),
      Hq, head_dim, false);
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
      make_call(q, Pools{k_pages, v_pages, nullptr, nullptr}, table, k_new,
                v_new, cache_len, out, B, g_len, Hkv, num_pages, page, P,
                stream),
      Hq, head_dim, true);
}

// int8 pools with their (N,page,Hkv) f32 scale planes.
extern "C" int gofr_ragged_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    int B, int g_len, int Hq, int Hkv, int head_dim, int num_pages,
    int page, int P, void* stream) {
  return dispatch<int8_t>(
      make_call(q, Pools{k_pages, v_pages, k_scale, v_scale}, table, k_new,
                v_new, cache_len, out, B, g_len, Hkv, num_pages, page, P,
                stream),
      Hq, head_dim, false);
}

// The int8 launch through the verify instantiation at every g_len (the
// int8 counterpart of gofr_ragged_paged_attention_verify_form).
extern "C" int gofr_ragged_paged_attention_int8_verify_form(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* k_new, const void* v_new, const void* cache_len, void* out,
    int B, int g_len, int Hq, int Hkv, int head_dim, int num_pages,
    int page, int P, void* stream) {
  return dispatch<int8_t>(
      make_call(q, Pools{k_pages, v_pages, k_scale, v_scale}, table, k_new,
                v_new, cache_len, out, B, g_len, Hkv, num_pages, page, P,
                stream),
      Hq, head_dim, true);
}

// The blocks a (KV head, slot) of a launch at head_dim 64/128, group
// 1/2/4/8, g_len queries a slot and a table of P columns of `page`
// positions: its cluster size.
extern "C" int gofr_ragged_cluster_size(int head_dim, int group, int g_len,
                                        int P, int page) {
  return d64_body(head_dim, group, g_len) ? d64::ranks_for(P, page)
                                          : CLUSTER;
}

// How many clusters of the instantiation (head_dim 64/128, group 1/2/4/8,
// verify or decode bound, int8 or bf16 pools) the card holds at once for
// g_len queries a slot and a table of P columns of `page` positions
// (cudaOccupancyMaxActiveClusters), in *clusters; a cluster is
// gofr_ragged_cluster_size blocks.
extern "C" int gofr_ragged_cluster_occupancy(int head_dim, int group,
                                             int verify, int int8, int P,
                                             int page, int g_len,
                                             int* clusters) {
  if ((head_dim != 64 && head_dim != 128) || P <= 0 || page <= 0 ||
      group <= 0 || g_len < 1 || g_len > MAX_NEW ||
      (!verify && g_len != 1) ||
      (!d64_body(head_dim, group, g_len) &&
       dyn_smem_bytes(P, page, group, g_len, head_dim) > MAX_DYN_SMEM))
    return (int)cudaErrorInvalidValue;
  return (int)(int8 ? occupancy_head_dim<int8_t>(head_dim, group,
                                                 verify != 0, P, page,
                                                 g_len, clusters)
                    : occupancy_head_dim<__nv_bfloat16>(
                          head_dim, group, verify != 0, P, page, g_len,
                          clusters));
}

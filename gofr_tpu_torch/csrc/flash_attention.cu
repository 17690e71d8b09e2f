// Flash attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/pallas/flash_attention.py, _flash_kernel (via
// _pallas_flash / flash_attention) - causal (or full) attention with an
// online softmax, GQA through the K/V head index, fully masked causal
// blocks skipped.
//
// What bounds it on the H100: at the engine's buckets (S <= 512) bytes,
// barely: B 4 / S 512 moves 42 MB (0.0125 ms at 3.35 TB/s) for 8.6 GFLOP
// (0.0087 ms at 989 TFLOP/s of bf16 tensor cores); from S ~ 1024 on,
// operations. Either way the roofline needs the tensor cores.
//
// bf16 (every engine path): flash_wgmma_kernel. One warpgroup (128
// threads) per 64-row Q tile and (batch, q-head); both products on the
// tensor cores through wgmma (m64n64k16, bf16 operands, float32
// accumulators in registers):
//   S = Q.K^T   Q and K tiles in shared memory, both K-major (rows of the
//               head dim), 128-byte swizzled, D = 128 as two 64-column
//               halves;
//   O += P.V    P rounded to bf16 in registers straight from the S
//               accumulator fragment (the f32 accumulator's pair layout is
//               the bf16 A-operand layout, no shuffle), V from shared
//               memory as an MN-major B operand (transpose bit set), one
//               wgmma per 64 output columns.
// K/V tiles of 64 positions stream through a 2-stage ring filled by
// 16-byte cp.async copies written straight into the swizzled layout (no
// tensor-map descriptor to encode on the host at every launch), so tile
// j + 1 loads while tile j multiplies. The softmax runs on the
// accumulator fragment: each row lives in one quad of lanes, so its max
// and sum take two shuffles; D^-0.5 * log2(e) is folded into one
// multiply-add before exp2f. Rows and keys past S are zero-filled by the
// copy and masked; the causal loop stops at the diagonal tile, the only
// one (with a ragged last tile) that pays for the mask. The output tile
// goes back through shared memory as 16-byte stores. q-tiles are launched
// heaviest first.
// Numerics: P is rounded to bf16 before P.V (the JAX kernel keeps it in
// float32); the plain version (ops/attention.attention) rounds scores and
// normalised probabilities to bf16 on the card too.
//
// float32 (no engine path on the card; the wrapper accepts it, as the JAX
// kernel does): flash_fwd_kernel, the first port's CUDA-core body,
// unchanged - bf16 tensor-core operands could not hold its 2e-5 bound.
// One 4-warp block per 64-row Q tile, K/V staged as float32 in shared
// memory, register-tiled float32 products, q scaled by D^-0.5 before the
// dot as the Pallas kernel does.
//
// Layout: q (B,S,Hq,D), k/v (B,S,Hkv,D), all contiguous, read strided in
// place (no transposed copy). Out (B,S,Hq,D) in q's type. The TPU's
// sequential k grid axis is the loop inside the block. The last tile is
// masked, so any S works; D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int QP = BQ + 1;    // padded leading dim of transposed tiles
constexpr int KP = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
constexpr int smem_bytes() {
  // Qs [D][QP] + KVs (K^T [D][KP], then V [BK][D]) + Ps [BK][QP] + 3 rows
  return (D * QP + D * KP + BK * QP + 3 * BQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
                 int Hkv, int causal, float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // Q^T, pre-scaled: Qs[d * QP + r]
  float* KVs = Qs + D * QP;       // K^T: KVs[d * KP + c]; V: KVs[c * D + d]
  float* Ps = KVs + D * KP;       // scores / probs, transposed: Ps[c * QP + r]
  float* row_m = Ps + BK * QP;    // running max per q row
  float* row_l = row_m + BQ;      // running normaliser per q row
  float* row_c = row_l + BQ;      // this tile's correction factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // heaviest causal tiles first: the diagonal tiles at the end of the
  // sequence walk the longest K loop
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;

  const long q_stride = (long)Hq * D;    // between sequence positions
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + (long)b * S * q_stride + (long)h * D;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * D;
  T* ob = out + (long)b * S * q_stride + (long)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    const float x = s < S ? to_f32(qb[(long)s * q_stride + d]) : 0.f;
    Qs[d * QP + r] = x * sm_scale;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  // score micro-tile: rows sr..sr+3, columns tx8 + 8*j (bank-conflict free)
  const int sr = (tid / 8) * 4;
  const int tx8 = tid % 8;
  // output micro-tile: rows orow..orow+7, columns tx16 + 16*c
  const int orow = (tid / 16) * 8;
  const int tx16 = tid % 16;
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's V/P reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int t = k0 + c;
      KVs[d * KP + c] = t < S ? to_f32(kb[(long)t * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[d * QP + sr + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = KVs[d * KP + tx8 + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qpos = q0 + sr + i, kpos = k0 + tx8 + 8 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        Ps[(tx8 + 8 * j) * QP + sr + i] = ok ? s[i][j] : NEG_INF;
      }
    __syncthreads();  // scores complete; K no longer read

    // V tile into the K buffer while the softmax runs on Ps
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int t = k0 + c;
      KVs[c * D + d] = t < S ? to_f32(vb[(long)t * kv_stride + d]) : 0.f;
    }
    // online softmax: warp w owns rows 16w..16w+15, a lane two columns
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const float x0 = Ps[lane * QP + r];
      const float x1 = Ps[(lane + 32) * QP + r];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      // masked entries contribute exactly zero, even in a row that has
      // seen no live key yet
      const float p0 = x0 == NEG_INF ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == NEG_INF ? 0.f : expf(x1 - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      Ps[lane * QP + r] = p0;
      Ps[(lane + 32) * QP + r] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + ps;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = row_c[orow + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[8], vv[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = Ps[j * QP + orow + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = KVs[j * D + tx16 + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = q0 + orow + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(row_l[orow + i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(long)s * q_stride + tx16 + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  // the float nearest D^-0.5, as the Python side computes it
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, causal,
      sm_scale);
  return cudaGetLastError();
}


// ---- bf16: tensor cores (wgmma) -------------------------------------------

namespace wg {

// the tiles above: BQ q rows (one wgmma M), BK positions (the S product's
// N), THREADS one warpgroup
static_assert(BQ == 64 && BK == 64 && THREADS == 128, "wgmma m64n64");
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16 of the head dim
constexpr int SWIZZLE_ATOM = 8 * ROW_BYTES;  // 8 rows; 1024-byte aligned

template <int D>
constexpr int smem_bytes() {
  // alignment slack + Q tile + 2 stages of (K tile, V tile)
  return 1024 + BQ * D * 2 + 2 * 2 * BK * D * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 of the head dim) of row r in a
// tile of ROWS rows: the head dim is cut into 64-column halves, each a
// (ROWS, 128-byte) block whose chunks are XOR-swizzled by r % 8 - the
// 128B-swizzle layout wgmma's descriptor describes, K-major for Q and K,
// MN-major for V.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * ROW_BYTES) + r * ROW_BYTES +
         (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // a row past S is zero-filled: nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies' generic-proxy writes, made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product's issue and wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A.B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B, m64n64k16, A (bf16 pairs) from registers, B from shared memory
// MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS x D tile from rows row0.. of a strided (rows, D) view into the
// swizzled layout at dst; rows at or past S are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long row_stride, int row0, int S,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i % CH;
    const int s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + swz<ROWS>(r, c),
               src + (long)(ok ? s : row0) * row_stride + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                   int causal, float scale_log2) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  constexpr int NH = D / 64;  // 64-column halves of the head dim
  constexpr int CH = D / 8;
  constexpr uint32_t Q_BYTES = BQ * D * 2;
  constexpr uint32_t TILE_BYTES = BK * D * 2;
  constexpr uint32_t HALF_BYTES = BK * ROW_BYTES;  // one half of a K/V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  // stage st: K tile at kv_addr(st), V tile right after it
  auto kv_addr = [&](int st) { return base + Q_BYTES + st * 2 * TILE_BYTES; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // heaviest causal tiles first: the whole grid's last q-tiles (the
  // longest K loops) are the first blocks scheduled
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const long q_stride = (long)Hq * D;  // between sequence positions
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + (long)b * S * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * S * kv_stride + (long)hk * D;
  __nv_bfloat16* ob = out + (long)b * S * q_stride + (long)h * D;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<BQ, D>(sQ, qb, q_stride, q0, S, tid);
  load_tile<BK, D>(kv_addr(0), kb, kv_stride, 0, S, tid);
  load_tile<BK, D>(kv_addr(0) + TILE_BYTES, vb, kv_stride, 0, S, tid);
  cp_async_commit();

  // accumulator fragment of an m64nN product: this thread holds rows
  // r0 and r0 + 8 of the tile, columns 8j + cq and 8j + cq + 1, in
  // d[4j + 2i + c] (i: row half, c: column)
  const int r0 = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  float o[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {  // the next tile loads while this one runs
      load_tile<BK, D>(kv_addr(st ^ 1), kb, kv_stride, k0 + BK, S, tid);
      load_tile<BK, D>(kv_addr(st ^ 1) + TILE_BYTES, vb, kv_stride,
                       k0 + BK, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = kv_addr(st), sV = sK + TILE_BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
    fence_acc(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns of the head dim: half kk / 4, 32 bytes a step in it
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      wgmma_ss(s, desc(sQ + off, 16, SWIZZLE_ATOM),
               desc(sK + off, 16, SWIZZLE_ATOM));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);

    if (k0 + BK > S || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = q0 + r0 + 8 * i, col = k0 + 8 * j + cq + c;
            if (col >= S || (causal && col > row))
              s[4 * j + 2 * i + c] = -INFINITY;
          }
    }
    // online softmax in log2 units: masked scores give exp2f(-inf) = 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(fmaf(s[4 * j + 2 * i + c], scale_log2, -m_new));
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[hh][4 * j + 2 * i] *= corr;
          o[hh][4 * j + 2 * i + 1] *= corr;
        }
    }
    // P as the A operand: k-step kk covers columns 16kk..16kk+15, i.e.
    // accumulator groups j = 2kk (a0, a1) and 2kk + 1 (a2, a3)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_acc(o[hh]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        // 16 positions (two 8-row swizzle atoms) of output half hh
        wgmma_rs_t(o[hh], pa[kk],
                   desc(sV + hh * HALF_BYTES + kk * 2 * SWIZZLE_ATOM,
                        HALF_BYTES, SWIZZLE_ATOM));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_acc(o[hh]);
    __syncthreads();  // this stage is free for the tile after next
  }

  // epilogue: the row sums over each quad, then the normalised tile
  // through the (free) Q buffer and out as 16-byte rows
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = l[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[i] = 1.f / fmaxf(t, 1e-30f);
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        *reinterpret_cast<uint32_t*>(
            smem + swz<BQ>(row, hh * 8 + j) + cq * 2) =
            pack_bf16(o[hh][4 * j + 2 * i] * inv[i],
                      o[hh][4 * j + 2 * i + 1] * inv[i]);
      }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < BQ * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i % CH;
    const int srow = q0 + r;
    if (srow < S)
      *reinterpret_cast<uint4*>(ob + (long)srow * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<BQ>(r, c));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  // D^-0.5 * log2(e): scores go to exp2f in one multiply-add
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_wgmma_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, Hq, Hkv, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int gofr_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int Hq, int Hkv, int D, int causal,
                                    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return (int)wg::launch<128>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  if (dtype == 1 && D == 64)
    return (int)wg::launch<64>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  return (int)cudaErrorInvalidValue;
}

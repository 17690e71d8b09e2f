// Flash attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/pallas/flash_attention.py, _flash_kernel (via
// _pallas_flash / flash_attention) - causal (or full) attention with an
// online softmax, GQA through the K/V head index, fully masked causal
// blocks skipped.
//
// What bounds it on the H100: operations. Causal prefill does
// 2*B*Hq*S^2*D multiply-adds' worth of FLOPs over O(B*S*H*D) bytes, far
// above the card's ~295 FLOP/byte balance point for every bucket the
// engine uses (S >= 32). The roofline is the bf16 tensor-core rate.
//
// What this design does about it: it keeps the S x S scores out of
// device memory (one 64-row Q tile per block, K/V streamed through shared
// memory, m/l/acc in float32 registers and shared memory) and stops the
// K loop at the causal diagonal, so the bytes stay O(S) and half the
// products are never computed. The products themselves run on the CUDA
// cores in float32 (register-tiled 4x8 and 8x8 micro-tiles from shared
// memory), not on the tensor cores: this is the simple first kernel, and
// wgmma/TMA/warp specialisation are later work, so it sits well below the
// operations bound.
//
// Layout: q (B,S,Hq,D), k/v (B,S,Hkv,D), all contiguous, read strided in
// place (no transposed copy). Out (B,S,Hq,D) in q's type. One block per
// (64-row q tile, batch*q-head); the TPU's sequential k grid axis is the
// loop inside the block. q is scaled by D^-0.5 before the dot, as the
// Pallas kernel does. The last tile is masked, so any S works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int QP = BQ + 1;    // padded leading dim of transposed tiles
constexpr int KP = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, B, S, Hq, Hkv,
                                           causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Hq, Hkv,
                                          causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, out, B, S, Hq, Hkv, causal, st);
  return (int)cudaErrorInvalidValue;
}

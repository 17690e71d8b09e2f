// Helpers shared by the decode-shaped attention kernels
// (ragged_paged_attention.cu, decode_attention.cu): one block of 8 warps
// whose lanes walk K/V positions in groups, every lane holding 8 head-dim
// elements of one position (one 16-byte bf16 load). A position's row of D
// elements takes D / 8 lanes: a half-warp at D 128, a quarter-warp at D 64,
// so a warp walks 2 or 4 positions at a time (Lanes<D>).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANE_ELEMS = 8;       // bf16 per lane: one 16-byte load
constexpr float NEG_INF = -1e30f;

// How a head dimension D maps onto a warp: ROW lanes hold one position's
// row, SUBS such groups a warp, STREAMS groups a block, each walking
// positions of its own.
template <int D>
struct Lanes {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int ROW = D / LANE_ELEMS;
  static constexpr int SUBS = 32 / ROW;
  static constexpr int STREAMS = WARPS * SUBS;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_ELEMS; ++j) out[j] = __bfloat162float(h[j]);
}

// sum over the ROW lanes that hold one position's row (xor offsets below
// ROW stay inside the group)
template <int ROW>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = ROW / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// fold the SUBS groups of a warp that hold the same columns (xor offsets
// ROW and up): afterwards every group holds the warp's sum
template <int ROW>
__device__ __forceinline__ float sub_fold(float x) {
#pragma unroll
  for (int off = 16; off >= ROW; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace

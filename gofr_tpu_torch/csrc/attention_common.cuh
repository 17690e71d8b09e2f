// Helpers shared by the decode-shaped attention kernels
// (ragged_paged_attention.cu, decode_attention.cu): one block of 8 warps
// whose 16 half-warps each take one K/V position at a time, every lane
// holding 8 of the 128 head-dim elements (one 16-byte load).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

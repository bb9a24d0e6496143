// Pieces shared by the tile-blend and point kernels (blend_fwd.cu B1,
// blend_bwd.cu B2, sample_fwd.cu B3 / B4, sample_bwd.cu B5): the thread-block
// size, the shared-memory staging of a tile's pair payload, the alpha test
// and a block-wide max. B1 runs one thread per pixel, a 32x32 binning tile as
// four 16x16 blocks, each walking the tile's whole list; B2 runs a tile as
// one block of the same 256 threads, four pixels a thread.
#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kF = 16;                  // floats per pair payload
constexpr int kSide = 16;               // block = kSide x kSide pixels
constexpr int kThreads = kSide * kSide;
constexpr int kBatch = kThreads;        // pairs staged per batch

// Payload as four float4 per pair: mean2d(0,1) conic(2,3,4) opacity(5)
// colour(6,7,8) ray_plane(9,10,11,12) normal(13,14,15):
//   q0 = (gx, gy, ca, cb)  q1 = (cc, op, r, g)
//   q2 = (b, rp0, rp1, tc) q3 = (rsigma, nx, ny, nz)
using Batch = float4[kBatch][4];

// Pairs [b0, b0 + n) of the list starting at `start`, one per thread.
__device__ __forceinline__ void stage(const float* feats, Batch& s, int start,
                                      int b0, int n) {
  const int i = threadIdx.y * kSide + threadIdx.x;
  if (i < n) {
    const float4* src = reinterpret_cast<const float4*>(
        feats + (static_cast<size_t>(start) + b0 + i) * kF);
    s[i][0] = src[0];
    s[i][1] = src[1];
    s[i][2] = src[2];
    s[i][3] = src[3];
  }
}

// Gaussian exponent of pair (q0, q1) at offset (dx, dy) from its centre.
__device__ __forceinline__ float pair_power(float4 q0, float4 q1, float dx,
                                            float dy) {
  return -0.5f * (q0.z * dx * dx + q1.x * dy * dy) - q0.w * dx * dy;
}

// alpha = min(alpha_clamp, op exp(power)) of pair (q0, q1) at pixel (px, py);
// false if the pair is skipped (power > 0 or alpha < alpha_min), as
// render_ref._alpha_terms. `expp` is exp(power).
__device__ __forceinline__ bool pair_alpha(float alpha_clamp, float alpha_min,
                                           float4 q0, float4 q1, float px,
                                           float py, float& alpha,
                                           float& expp, float& dx,
                                           float& dy) {
  dx = q0.x - px;
  dy = q0.y - py;
  const float power = pair_power(q0, q1, dx, dy);
  if (power > 0.f) return false;
  expp = expf(power);
  alpha = fminf(alpha_clamp, q1.y * expp);
  return alpha >= alpha_min;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory (where static and
// dynamic exceed 48 KB together the launch must ask for it first); returns
// the CUDA error (0 = allowed).
template <typename Kernel>
inline int set_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes == 0) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Largest v over the block; every thread of the block must call it.
__device__ int block_max(int v, int* slot) {
  __syncthreads();                      // earlier readers of *slot are done
  if (threadIdx.x == 0 && threadIdx.y == 0) *slot = 0;
  __syncthreads();
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (((threadIdx.y * kSide + threadIdx.x) & 31) == 0) atomicMax(slot, v);
  __syncthreads();
  return *slot;
}

}  // namespace blend

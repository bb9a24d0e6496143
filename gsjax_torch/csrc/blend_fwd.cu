// Forward tile blend with RaDe-GS median depth, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `gsjax/ops/raster/render_pallas.py:_fwd_kernel`
// (with `_median_search`, reached through `_fwd_call` / `blend_pallas`). For
// one frame it computes, per pixel, what that kernel computes per tile:
// front-to-back blend of the tile's depth-sorted pair list (colour + T*bg,
// alpha = 1 - T, normal / (1 - T), n_contrib, md_init, T_final) and the
// median z-depth, the root of T(t) = 0.5 of the half-gaussian-CDF
// transmittance model found by safeguarded Newton, with in_range and
// dlogT/dt at the root (what a backward pass reads).
//
// Output: [16, H, W] float32 planes, the rows of the TPU kernel's [T, 16, P]
// output laid out as images: 0-2 colour, 3-5 normal, 6 alpha, 7 median
// z-depth, 8 n_contrib, 9 md_init, 10 T_final, 11 in_range, 12 dlogT/dt at
// the root, 13-15 zero.
//
// What bounds it on an H100: operations, not bytes. Each pair is read once
// from device memory per 16x16 block (64 bytes) but evaluated against every
// pixel of the block: the alpha test alone costs 16 fp32 operations per
// (pair, pixel) interaction with one exp, and the median search sweeps each
// pixel's contributors 14 times at ~40 operations (an exp and two logs)
// each. The pair payload is staged in shared memory and read as broadcasts,
// so memory traffic stays far below the arithmetic.
//
// Design (the reference CUDA rasterizer's own form, not the Pallas layout):
//   - one thread per pixel; a 32x32 binning tile (kept so the lists match
//     gsjax's) runs as four 256-thread blocks of 16x16 pixels, each walking
//     the tile's whole list;
//   - the block stages the list cooperatively in batches of 256 pairs
//     (16 KB of shared memory a batch);
//   - each pixel stops on its own once T would fall below 1e-4, and the
//     block stops staging when __syncthreads_count says every pixel is done;
//   - the median search re-walks the list for each evaluation (one sweep for
//     both bracket ends, 12 Newton sweeps, one final sweep), only up to the
//     largest n_contrib among the block's pixels that still need a root.
// The TPU kernel's 5-sigma chunk cull is not copied: every applied gaussian
// is evaluated exactly in every sweep. Its Newton is kept (secant start,
// bracket safeguard, final refinement that also yields dlogT/dt) with one
// more safeguard, rtsafe's: bisect when a Newton step would not halve the
// previous one; with it, 12 iterations in place of 7.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "median.cuh"

namespace {

using namespace blend;

struct Params {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* bg;          // [3]
  float* out;               // [16, H, W]
  int width, height, tiles_x, tile, max_per_tile, require_depth;
  float fx, fy, alpha_clamp, alpha_min, t_min, sample_range, min_transmittance;
};

__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const Params p) {
  __shared__ Batch s;
  __shared__ int s_max;

  const int nsub = p.tile / kSide;
  const int tile_id = (blockIdx.y / nsub) * p.tiles_x + blockIdx.x / nsub;
  const int start = p.tile_start[tile_id];
  const int count = min(p.tile_count[tile_id], p.max_per_tile);
  const int pxi = blockIdx.x * kSide + threadIdx.x;
  const int pyi = blockIdx.y * kSide + threadIdx.y;
  const bool inside = pxi < p.width && pyi < p.height;
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);

  // --- front-to-back blend (render_forward.cu:455-533) ---------------------
  float T = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float md_init = 0.f;
  int last = -1;
  bool done = !inside;
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier before the batch buffer is overwritten
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, count - b0);
    stage(p.feats, s, start, b0, n);
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float4 q0 = s[j][0], q1 = s[j][1];
      float alpha, expp, dx, dy;
      if (!pair_alpha(p.alpha_clamp, p.alpha_min, q0, q1, px, py, alpha, expp,
                      dx, dy))
        continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < p.t_min) {
        done = true;
        break;
      }
      const float4 q2 = s[j][2], q3 = s[j][3];
      const float w = alpha * T;
      c0 += w * q1.z;
      c1 += w * q1.w;
      c2 += w * q2.x;
      n0 += w * q3.y;
      n1 += w * q3.z;
      n2 += w * q3.w;
      // median-depth init: the last applied pair whose preceding T > 0.5
      if (T > 0.5f) md_init = q2.y * dx + q2.z * dy + q2.w;
      last = b0 + j;
      T = test_t;
    }
  }
  const int n_contrib = last + 1;

  // --- median depth: safeguarded Newton on log T(t) = log 1/2 -------------
  // (median.cuh; render_pallas.py:_median_search, the 5-sigma cull left out)
  Median med{0.f, 0.f, false};
  if (p.require_depth) {
    const Query q{p.feats, start, px, py, p.alpha_clamp, p.alpha_min};
    med = median_search(q, s, &s_max, inside && T <= p.min_transmittance,
                        n_contrib, md_init, p.sample_range);
  }
  if (!inside) return;

  const size_t hw = static_cast<size_t>(p.height) * p.width;
  float* o = p.out + static_cast<size_t>(pyi) * p.width + pxi;
  const bool has = last >= 0;
  const float inv_om = 1.f / fmaxf(1.f - T, 1e-12f);
  o[0 * hw] = c0 + T * p.bg[0];
  o[1 * hw] = c1 + T * p.bg[1];
  o[2 * hw] = c2 + T * p.bg[2];
  o[3 * hw] = has ? n0 * inv_om : 0.f;
  o[4 * hw] = has ? n1 * inv_om : 0.f;
  o[5 * hw] = has ? n2 * inv_om : 0.f;
  o[6 * hw] = 1.f - T;
  // ray distance -> z depth (render_pallas.py:_ray_to_z)
  const float pnx = (px - (p.width - 1.f) * 0.5f) / p.fx;
  const float pny = (py - (p.height - 1.f) * 0.5f) / p.fy;
  o[7 * hw] = med.m_t * rsqrtf(pnx * pnx + pny * pny + 1.f);
  o[8 * hw] = static_cast<float>(n_contrib);
  o[9 * hw] = md_init;
  o[10 * hw] = T;
  o[11 * hw] = med.in_range ? 1.f : 0.f;
  o[12 * hw] = med.in_range ? med.d_denom : 0.f;
  o[13 * hw] = 0.f;
  o[14 * hw] = 0.f;
  o[15 * hw] = 0.f;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsjax_blend_fwd(const float* feats, const int* tile_start,
                               const int* tile_count, const float* bg,
                               float* out, int width, int height, int tiles_x,
                               int tiles_y, int tile, float fx, float fy,
                               int max_per_tile, int require_depth,
                               float alpha_clamp, float alpha_min, float t_min,
                               float sample_range, float min_transmittance,
                               void* stream) {
  const Params p{feats, tile_start, tile_count, bg, out,
                 width, height, tiles_x, tile, max_per_tile, require_depth,
                 fx, fy, alpha_clamp, alpha_min, t_min, sample_range,
                 min_transmittance};
  const int nsub = tile / kSide;
  const dim3 grid(tiles_x * nsub, tiles_y * nsub);
  const dim3 block(kSide, kSide);
  blend_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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

namespace {

using namespace blend;

// render_pallas.py uses 7 iterations without the progress test below; on
// dense scenes that leaves ~0.5% of pixels short of the root (bracket still
// up to 0.3 wide), 12 with the test converge on every pixel measured.
constexpr int kNewtonIters = 12;
constexpr float kLogHalf = -0.69314718055994531f;

struct Params {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* bg;          // [3]
  float* out;               // [16, H, W]
  int width, height, tiles_x, tile, max_per_tile, require_depth;
  float fx, fy, alpha_clamp, alpha_min, t_min, sample_range, min_transmittance;
};

// log T(ts[k]) of the half-gaussian-CDF model (render_pallas.py:_median_model)
// over this pixel's applied pairs (index < my_n), for NPTS depths in one
// sweep of the tile's list; with WANT_D also d(log T)/dt. `nmax` (the block's
// largest my_n) bounds the staging and is uniform over the block.
template <int NPTS, bool WANT_D>
__device__ void model_sweep(const Params& p, Batch& s, int start, int nmax,
                            int my_n, float px, float py, const float* ts,
                            float* lt, float* dlt) {
#pragma unroll
  for (int k = 0; k < NPTS; ++k) {
    lt[k] = 0.f;
    dlt[k] = 0.f;
  }
  for (int b0 = 0; b0 < nmax; b0 += kBatch) {
    __syncthreads();                    // the previous batch is consumed
    const int n = min(kBatch, nmax - b0);
    stage(p.feats, s, start, b0, n);
    __syncthreads();
    const int jn = min(n, my_n - b0);
    for (int j = 0; j < jn; ++j) {
      float alpha, expp, dx, dy;
      if (!pair_alpha(p.alpha_clamp, p.alpha_min, s[j][0], s[j][1], px, py,
                      alpha, expp, dx, dy))
        continue;
      const float4 q2 = s[j][2];
      const float rsig = s[j][3].x;
      const float t_peak = q2.y * dx + q2.z * dy + q2.w;
      const float l1m = log1pf(-alpha);
#pragma unroll
      for (int k = 0; k < NPTS; ++k) {
        const float delta = (ts[k] - t_peak) * rsig;
        const float hg = rsig > 0.f ? expf(-0.5f * delta * delta) : 0.f;
        const float om = fmaxf(1.f - alpha * hg, 1e-12f);
        const float hl = 0.5f * logf(om);
        const bool behind = ts[k] > t_peak;
        lt[k] += behind ? l1m - hl : hl;
        if (WANT_D) {
          const float dlf = 0.5f * (alpha / om) * (-hg * delta * rsig);
          dlt[k] += behind ? dlf : -dlf;
        }
      }
    }
  }
}

__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) > 1e-20f ? d : 1e-20f;
}

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
  // (render_pallas.py:_median_search, the 5-sigma cull left out)
  float m_t = 0.f, d_denom = 0.f;
  bool in_range = false;
  if (p.require_depth) {
    const bool cand = inside && T <= p.min_transmittance;
    const int nmax = block_max(cand ? n_contrib : 0, &s_max);
    if (nmax > 0) {
      float lo = fmaxf(md_init - p.sample_range, 0.f);
      float hi = fmaxf(md_init + p.sample_range, 0.f);
      float ts[2] = {lo, hi}, lt[2], dl[2];
      model_sweep<2, false>(p, s, start, nmax, cand ? n_contrib : 0, px, py,
                            ts, lt, dl);
      float t_lo = expf(lt[0]), t_hi = expf(lt[1]);
      in_range = cand && t_lo >= 0.5f && t_hi <= 0.5f;
      const int my_n = in_range ? n_contrib : 0;
      const int nmax2 = block_max(my_n, &s_max);
      if (nmax2 > 0) {
        // the first iterate is the log-linear secant through the bracket
        const float w0 = fminf(fmaxf(
            (lt[0] - kLogHalf) / safe_den(lt[0] - lt[1]), 0.f), 1.f);
        float t = lo + w0 * (hi - lo);
        float last_step = hi - lo;
        for (int it = 0; it < kNewtonIters; ++it) {
          float l, d;
          model_sweep<1, true>(p, s, start, nmax2, my_n, px, py, &t, &l, &d);
          const float tv = expf(l);
          const bool right = tv >= 0.5f;          // the root is at t or right
          if (right) {
            lo = t;
            t_lo = tv;
          } else {
            hi = t;
            t_hi = tv;
          }
          const bool ok = d < -1e-20f;
          const float step = (l - kLogHalf) / (ok ? d : -1.f);
          const float t_n = t - step;
          // Newton only while it stays in the bracket and at least halves
          // the previous step (rtsafe's progress test); else bisect
          const bool newton = ok && t_n > lo && t_n < hi &&
                              2.f * fabsf(step) <= fabsf(last_step);
          last_step = newton ? step : 0.5f * (hi - lo);
          t = newton ? t_n : 0.5f * (lo + hi);
        }
        const float w = fminf(fmaxf((t_lo - 0.5f) / safe_den(t_lo - t_hi),
                                    0.f), 1.f);
        float t_star = w * hi + (1.f - w) * lo;
        // dlogT/dt at the root, which also buys a last Newton refinement
        float l_star;
        model_sweep<1, true>(p, s, start, nmax2, my_n, px, py, &t_star,
                             &l_star, &d_denom);
        const bool ok = d_denom < -1e-20f;
        const float t_ref = t_star - (l_star - kLogHalf) / (ok ? d_denom : -1.f);
        if (ok && t_ref > lo && t_ref < hi) t_star = t_ref;
        if (in_range) m_t = t_star;
      }
    }
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
  o[7 * hw] = m_t * rsqrtf(pnx * pnx + pny * pny + 1.f);
  o[8 * hw] = static_cast<float>(n_contrib);
  o[9 * hw] = md_init;
  o[10 * hw] = T;
  o[11 * hw] = in_range ? 1.f : 0.f;
  o[12 * hw] = in_range ? d_denom : 0.f;
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

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
// A tile-row list (`tile_rows`, `n_rows`; the TPU kernel's tile subset,
// blend_pallas's `tile_ids`) blends only those rows of tiles, a band of the
// frame on the multi-device path: block row r takes tile row tile_rows[r]
// and writes band-local planes [16, n_rows * tile, W], local row
// r * tile + y of tile row tile_rows[r]'s pixel row y. Pixels past the
// frame's height are not written. Each listed tile is the same work on the
// same list as in the full-frame launch (nullptr), so it gives the same
// bits.
//
// What bounds it on an H100: the median search, and there the special-
// function rate and barriers, not bytes. Each pair is read once from device
// memory per 16x16 block (64 bytes) and evaluated against every pixel of the
// block from shared memory; the blend alone costs ~16 fp32 operations and one
// exp per (pair, pixel) interaction. Each term of the median model costs an
// exp, a log and a division, which the card issues at a fraction of its fp32
// rate, and a search that re-walks the list also repeats the alpha test and
// log1p(-alpha) and waits at two barriers per 256 staged pairs.
//
// Design (the reference CUDA rasterizer's own form, not the Pallas layout):
//   - one thread per pixel; a 32x32 binning tile (kept so the lists match
//     gsjax's) runs as four 256-thread blocks of 16x16 pixels, each walking
//     the tile's whole list;
//   - the block stages the list cooperatively in batches of 256 pairs
//     (16 KB of shared memory a batch);
//   - each pixel stops on its own once T would fall below 1e-4, and the
//     block stops staging when __syncthreads_count says every pixel is done;
//   - the median search (median.cuh) walks the list once more, folding every
//     pair at least 6 sigmas behind or ahead of the pixel's bracket into an
//     exact constant (the premise: no fast math, no flush-to-zero) and
//     keeping the rest in the pixel's slots in dynamic shared memory
//     (`slots` of 12 bytes a pixel, 32 by default: 96 KB a block, two
//     blocks an SM); Newton then runs in the slots, each pixel on its own,
//     refolding as its bracket narrows, until its iterate stands still;
//   - a pixel whose set does not fit re-walks the staged list for its next
//     evaluations, after the others are done, until its narrowed set fits.
// The TPU kernel's 5-sigma chunk cull is not copied (it is approximate);
// the fold above is exact. Its Newton is kept (secant start, bracket
// safeguard, final refinement that also yields dlogT/dt) with rtsafe's
// progress test (bisect when a Newton step would not halve the previous
// one), up to 12 evaluations in place of 7, started from the half of the
// bracket that holds the root, and left once it converges. The blend alone
// (no median depth) is its own template instance: no slots, its own
// registers.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "median.cuh"

namespace {

using namespace blend;

struct Params {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const int* tile_rows;     // [n_rows] tile rows to blend, or nullptr: all
  const float* bg;          // [3]
  float* out;               // [16, out_height, W]
  int* counters;            // median.cuh:Counter, or nullptr
  int width, height, out_height, tiles_x, tile, max_per_tile, slots;
  float fx, fy, alpha_clamp, alpha_min, t_min, sample_range, min_transmittance;
};

// kDepth: with the median depth (rows 7, 11, 12); a template argument, so
// that the blend alone keeps its own registers and no shared slots
template <bool kDepth>
__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const Params p) {
  __shared__ Batch s;
  __shared__ int s_max;
  extern __shared__ float slots[];      // [3][p.slots][kThreads], with depth
  const long long t_start = kDepth && p.counters != nullptr ? clock64() : 0;

  const int nsub = p.tile / kSide;
  const int band_row = blockIdx.y / nsub;
  const int ty = p.tile_rows != nullptr ? p.tile_rows[band_row] : band_row;
  const int tile_id = ty * p.tiles_x + blockIdx.x / nsub;
  const int start = p.tile_start[tile_id];
  const int count = min(p.tile_count[tile_id], p.max_per_tile);
  const int pxi = blockIdx.x * kSide + threadIdx.x;
  const int sub_y = (blockIdx.y % nsub) * kSide + threadIdx.y;
  const int pyi = ty * p.tile + sub_y;               // the frame's pixel row
  const int oyi = band_row * p.tile + sub_y;         // the output's row
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
  if (kDepth) {
    const Query q{p.feats, start, px, py, p.alpha_clamp, p.alpha_min};
    const int tid = threadIdx.y * kSide + threadIdx.x;
    med = median_search(q, s, &s_max, Slots{slots + tid, p.slots}, p.counters,
                        tid, t_start, inside && T <= p.min_transmittance,
                        n_contrib, md_init, p.sample_range);
  }
  if (!inside) return;

  const size_t hw = static_cast<size_t>(p.out_height) * p.width;
  float* o = p.out + static_cast<size_t>(oyi) * p.width + pxi;
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

// Launch on `stream` with `slots` median slots per pixel (0: every search
// re-walks) and `counters` (nullptr, or kCounters zeroed ints the search
// adds to), over the `n_rows` tile rows of `tile_rows` into [16, n_rows *
// tile, W] planes, or with tile_rows = nullptr over the whole frame into
// [16, H, W]; returns the CUDA error (0 = launched).
extern "C" int gsjax_blend_fwd(const float* feats, const int* tile_start,
                               const int* tile_count, const int* tile_rows,
                               int n_rows, const float* bg,
                               float* out, int* counters, int width,
                               int height, int tiles_x, int tiles_y, int tile,
                               float fx, float fy, int max_per_tile,
                               int require_depth, int slots, float alpha_clamp,
                               float alpha_min, float t_min,
                               float sample_range, float min_transmittance,
                               void* stream) {
  const int rows = tile_rows != nullptr ? n_rows : tiles_y;
  const int out_height = tile_rows != nullptr ? n_rows * tile : height;
  const Params p{feats, tile_start, tile_count, tile_rows, bg, out, counters,
                 width, height, out_height, tiles_x, tile, max_per_tile, slots,
                 fx, fy, alpha_clamp, alpha_min, t_min, sample_range,
                 min_transmittance};
  const int nsub = tile / kSide;
  const dim3 grid(tiles_x * nsub, rows * nsub);
  const dim3 block(kSide, kSide);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!require_depth) {
    blend_fwd_kernel<false><<<grid, block, 0, st>>>(p);
  } else {
    const int smem = 3 * slots * kThreads * static_cast<int>(sizeof(float));
    const int rc = set_dynamic_smem(blend_fwd_kernel<true>, smem);
    if (rc != 0) return rc;
    blend_fwd_kernel<true><<<grid, block, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

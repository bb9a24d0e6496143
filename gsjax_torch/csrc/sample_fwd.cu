// Point query for NVIDIA Hopper (sm_90a): the median ray distance (B3) at
// arbitrary points.
//
// Replaces the TPU kernel `gsjax/ops/raster/sample_pallas.py:_sfwd_kernel`
// in depth mode (reached through `_sfwd_call` from `sample_depth_pallas`;
// its integrate mode is integrate_fwd.cu, B4). Each query point, at
// continuous pixel coordinates (px, py) of one view, marches its tile's
// depth-sorted pair list as a pixel does in the blend (alpha test, stop for
// good before T would fall below 1e-4; T, n_contrib, md_init), then finds
// the median, the root of T(t) = 0.5 of the half-gaussian-CDF model, by the
// blend's own safeguarded Newton (median.cuh), with dlogT/dt at the root.
//
// Input: the pair payload [K, 16] of the view in binning order with its tile
// ranges; the points [Q, 2] (px, py) sorted by tile; a block table [NB, 3]
// (tile, first sorted point, count <= 256): each tile's points cut into
// blocks of at most 256. Output [6, Q] float32 in sorted order: 0 m_t (ray
// distance, 0 out of range), 1 in_range, 2 n_contrib, 3 md_init, 4 T_final,
// 5 dlogT/dt at the root (0 out of range) -- what sample_bwd.cu (B5) reads.
//
// What bounds it on an H100: the median search, and there the
// special-function rate and barriers, not bytes. A block reads its tile's
// pairs once (64 bytes each) and evaluates each against every point of the
// block: the alpha test is ~16 fp32 operations with one exp per (pair,
// point); each term of the median model costs an exp, a log and a division,
// which the card issues at a fraction of its fp32 rate. Points are sparse
// per tile (a neighbour view's query set, or the tetra points near a
// surface), so a block is often far from full and its lanes idle: the
// design's own cost, as the list is staged for however few points.
//
// Design (the reference's point binning, rasterizer_impl.cu:1161-1236, not
// the Pallas layout): one thread per point; a block stages its tile's list in
// shared memory in batches of 256 pairs (blend_common.cuh:stage); each point
// stops for good once T would fall below 1e-4, and the block stops staging
// when __syncthreads_count says every point is done; then the median
// search of B1 (median.cuh): one more walk of the list folds
// every pair at least 6 sigmas behind or ahead of the point's bracket into
// an exact constant (no fast math, no flush-to-zero) and keeps the rest in
// the point's `slots` (12 bytes each) of dynamic shared memory, where Newton
// runs without barriers; a point whose set does not fit re-walks the list
// until its narrowed set fits. The TPU kernel's 128-aligned point windows,
// rounds and double-buffered copies are not carried over.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "median.cuh"

namespace {

using namespace blend;

struct SampleParams {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* pts;         // [Q, 2] (px, py), sorted by tile
  const int* blocks;        // [NB, 3] tile, first point, point count
  float* out;               // [6, Q]
  int* counters;            // median.cuh:Counter, or nullptr
  int q, max_per_tile, slots;
  float alpha_clamp, alpha_min, t_min, sample_range, min_transmittance;
};

__global__ void __launch_bounds__(kThreads)
sample_fwd_kernel(const SampleParams p) {
  __shared__ Batch s;
  __shared__ int s_max;
  extern __shared__ float slots[];      // [3][p.slots][kThreads]
  const long long t_start = p.counters != nullptr ? clock64() : 0;

  const int* blk = p.blocks + 3 * blockIdx.x;
  const int tile = blk[0];
  const int qi = blk[1] + static_cast<int>(threadIdx.x);
  const bool active = static_cast<int>(threadIdx.x) < blk[2];
  const int start = p.tile_start[tile];
  const int count = min(p.tile_count[tile], p.max_per_tile);
  float px = 0.f, py = 0.f;
  if (active) {
    px = p.pts[2 * static_cast<size_t>(qi)];
    py = p.pts[2 * static_cast<size_t>(qi) + 1];
  }

  // --- front-to-back march (sampleDepthCUDA, sample_forward.cu:430-700) -----
  float T = 1.f, md_init = 0.f;
  int last = -1;
  bool done = !active;
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier before the batch buffer is overwritten
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, count - b0);
    stage(p.feats, s, start, b0, n);
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      float alpha, expp, dx, dy;
      if (!pair_alpha(p.alpha_clamp, p.alpha_min, s[j][0], s[j][1], px, py,
                      alpha, expp, dx, dy))
        continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < p.t_min) {
        done = true;
        break;
      }
      // the pair is applied: median-depth init (the last applied pair whose
      // preceding T > 0.5)
      const float4 q2 = s[j][2];
      const float t_peak = q2.y * dx + q2.z * dy + q2.w;
      if (T > 0.5f) md_init = t_peak;
      last = b0 + j;
      T = test_t;
    }
  }
  const int n_contrib = last + 1;
  const size_t qs = static_cast<size_t>(p.q);

  const Query q{p.feats, start, px, py, p.alpha_clamp, p.alpha_min};
  const int tid = static_cast<int>(threadIdx.x);
  const Median med = median_search(q, s, &s_max, Slots{slots + tid, p.slots},
                                   p.counters, tid, t_start,
                                   active && T <= p.min_transmittance,
                                   n_contrib, md_init, p.sample_range);
  if (!active) return;
  float* o = p.out + qi;
  o[0] = med.m_t;
  o[qs] = med.in_range ? 1.f : 0.f;
  o[2 * qs] = static_cast<float>(n_contrib);
  o[3 * qs] = md_init;
  o[4 * qs] = T;
  o[5 * qs] = med.in_range ? med.d_denom : 0.f;
}

}  // namespace

// Launch on `stream` with `slots` median slots per point (0: every search
// re-walks) and `counters` (nullptr, or kCounters zeroed ints the search
// adds to); returns the CUDA error (0 = launched).
extern "C" int gsjax_sample_fwd(const float* feats, const int* tile_start,
                                const int* tile_count, const float* pts,
                                const int* blocks, float* out, int* counters,
                                int n_blocks, int q, int max_per_tile,
                                int slots, float alpha_clamp, float alpha_min,
                                float t_min, float sample_range,
                                float min_transmittance, void* stream) {
  const SampleParams p{feats, tile_start, tile_count, pts, blocks, out,
                       counters, q, max_per_tile, slots, alpha_clamp, alpha_min,
                       t_min, sample_range, min_transmittance};
  const int smem = 3 * slots * kThreads * static_cast<int>(sizeof(float));
  const int rc = set_dynamic_smem(sample_fwd_kernel, smem);
  if (rc != 0) return rc;
  sample_fwd_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

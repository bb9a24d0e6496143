// Point query backward: VJP of the median ray distance w.r.t. the pair
// payload and the query points, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `gsjax/ops/raster/sample_pallas.py:_sbwd_kernel`
// (reached through `_sbwd_call` / the `custom_vjp` of `sample_depth_pallas`).
// From B3's rows (sample_fwd.cu: m_t, in_range, n_contrib, dlogT/dt at the
// root) and the cotangent g of m_t, per point, it applies the implicit
// function m_t(theta): dm/dtheta = -(dlogT/dtheta) / (dlogT/dt). With
// s = -g / (dlogT/dt) for a point in range (else 0), every pair the point
// applied (before its n_contrib, passing the alpha test) adds s times
// d(log T(m_t))/d(its alpha, ray-depth plane, rsigma) over the whole
// half-gaussian CDF (the TPU kernel's 5-sigma shortcut is not copied),
// chained through alpha = min(0.99, op exp(power)) to opacity, conic and
// mean2d and through the ray-depth plane to its four columns. Outputs:
// d_payload [K, 16] (columns 0-5 and 9-12; zeroed by the caller) and d(px),
// d(py) [Q, 2] in sorted order, minus the sums of each point's mean2d terms
// (dx = gx - px).
//
// What bounds it on an H100: operations. Each pair is read once per block
// and evaluated against every point of the block: the alpha test (~16 fp32
// operations with one exp) and, where applied, ~70 more with an exp for the
// median term and the chain. The reduce over points is the design's own
// cost: 10 warp sums (5 shuffles each) and 10 atomicAdds per (warp, pair)
// where any lane of the warp applies the pair.
//
// Design (B2's, blend_bwd.cu, over B3's block table): one thread per point,
// a block per (tile, up to 256 of its points); the block walks its tile's
// list up to the largest n_contrib among its points with s != 0, staging 256
// pairs at a time in shared memory; per pair, a warp with any applying lane
// reduces the 10 columns with __shfl_down_sync and lane 0 adds them with
// atomicAdd; a warp with none skips the pair (__any_sync). A point is owned
// by one thread, so its d(px), d(py) stay in registers and are written once.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kCols = 10;
// payload column of each accumulated term: mean2d (0, 1), conic (2-4),
// opacity (5), ray-depth plane (9-11), rsigma (12)
__constant__ int kColOf[kCols] = {0, 1, 2, 3, 4, 5, 9, 10, 11, 12};

struct SampleBwdParams {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* pts;         // [Q, 2] (px, py), sorted by tile
  const int* blocks;        // [NB, 3] tile, first point, point count
  const float* res;         // [6, Q] B3's rows
  const float* g;           // [Q] cotangent of m_t
  float* d_feats;           // [K, 16], zeroed by the caller
  float* d_pts;             // [Q, 2]
  int q, max_per_tile;
  float alpha_clamp, alpha_min;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sample_bwd_kernel(const SampleBwdParams p) {
  __shared__ Batch s;
  __shared__ int s_max;

  const int* blk = p.blocks + 3 * blockIdx.x;
  const int tile = blk[0];
  const int qi = blk[1] + static_cast<int>(threadIdx.x);
  const bool active = static_cast<int>(threadIdx.x) < blk[2];
  const int start = p.tile_start[tile];
  const int count = min(p.tile_count[tile], p.max_per_tile);

  // --- per-point residuals (sample_pallas.py:290-315) ----------------------
  float px = 0.f, py = 0.f, m_t = 0.f, s_pt = 0.f;
  int my_n = 0;
  if (active) {
    const size_t qs = static_cast<size_t>(p.q);
    const float* r = p.res + qi;
    px = p.pts[2 * static_cast<size_t>(qi)];
    py = p.pts[2 * static_cast<size_t>(qi) + 1];
    const float d_den = r[5 * qs];
    if (r[qs] > 0.f && fabsf(d_den) > 1e-20f) {
      m_t = r[0];
      s_pt = -p.g[qi] / d_den;
    }
    if (s_pt != 0.f) my_n = min(static_cast<int>(r[2 * qs]), count);
  }
  const int nmax = block_max(my_n, &s_max);
  const int lane = threadIdx.x & 31;

  // --- re-walk the list up to n_contrib -------------------------------------
  float dpx = 0.f, dpy = 0.f;
  for (int b0 = 0; b0 < nmax; b0 += kBatch) {
    __syncthreads();                    // the previous batch is consumed
    const int n = min(kBatch, nmax - b0);
    stage(p.feats, s, start, b0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float d[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) d[k] = 0.f;
      float alpha, expp, dx, dy;
      const float4 q0 = s[j][0], q1 = s[j][1];
      const bool on = b0 + j < my_n &&
                      pair_alpha(p.alpha_clamp, p.alpha_min, q0, q1, px, py,
                                 alpha, expp, dx, dy);
      if (!__any_sync(0xffffffffu, on)) continue;
      if (on) {
        // implicit median term (sample_pallas.py:326-341)
        const float4 q2 = s[j][2];
        const float rsig = s[j][3].x;
        const float t_val = q2.y * dx + q2.z * dy + q2.w;
        const float delta = (m_t - t_val) * rsig;
        const float hg = rsig > 0.f ? expf(-0.5f * delta * delta) : 0.f;
        const float half_r = 0.5f / fmaxf(1.f - alpha * hg, 1e-12f);
        const bool behind = m_t > t_val;
        const float d_a = s_pt * (behind ? -1.f / (1.f - alpha) + half_r * hg
                                         : -half_r * hg);
        const float dlf_dg = (behind ? half_r : -half_r) * alpha;
        const float d_tp = s_pt * dlf_dg * hg * delta * rsig;
        // chain alpha -> power / opacity (:357-373), power -> payload
        const bool notclamped = q1.y * expp < p.alpha_clamp;
        const float d_pow = notclamped ? d_a * alpha : 0.f;
        d[0] = -d_pow * (q0.z * dx + q0.w * dy) + d_tp * q2.y;
        d[1] = -d_pow * (q1.x * dy + q0.w * dx) + d_tp * q2.z;
        d[2] = -0.5f * d_pow * dx * dx;
        d[3] = -d_pow * dx * dy;
        d[4] = -0.5f * d_pow * dy * dy;
        d[5] = notclamped ? d_a * expp : 0.f;
        d[6] = d_tp * dx;
        d[7] = d_tp * dy;
        d[8] = d_tp;
        d[9] = rsig > 0.f ? s_pt * dlf_dg * (-hg * delta * delta) / rsig : 0.f;
        // the point's own gradient (:385-387)
        dpx -= d[0];
        dpy -= d[1];
      }
      float* dst = p.d_feats + (static_cast<size_t>(start) + b0 + j) * kF;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float v = warp_sum(d[k]);
        if (lane == 0 && v != 0.f) atomicAdd(dst + kColOf[k], v);
      }
    }
  }
  if (active) {
    p.d_pts[2 * static_cast<size_t>(qi)] = dpx;
    p.d_pts[2 * static_cast<size_t>(qi) + 1] = dpy;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsjax_sample_bwd(const float* feats, const int* tile_start,
                                const int* tile_count, const float* pts,
                                const int* blocks, const float* res,
                                const float* g, float* d_feats, float* d_pts,
                                int n_blocks, int q, int max_per_tile,
                                float alpha_clamp, float alpha_min,
                                void* stream) {
  const SampleBwdParams p{feats, tile_start, tile_count, pts, blocks, res, g,
                          d_feats, d_pts, q, max_per_tile, alpha_clamp,
                          alpha_min};
  sample_bwd_kernel<<<n_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

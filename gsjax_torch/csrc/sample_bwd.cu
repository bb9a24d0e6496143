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
// median term and the chain. The sum over points is the design's own cost:
// as five-shuffle warp sums and global atomicAdds it would take 10 of each
// per (warp, pair) where any lane of the warp applies the pair.
//
// Design (B2's reduction, blend_bwd.cu and bwd_common.cuh, over B3's block
// table): one thread per point, a block per (tile, up to 256 of its points);
// the block walks its tile's list up to the largest n_contrib among its
// points with s != 0, kWin = 64 pairs a window staged in shared memory, a
// warp stopping at its own points' largest and skipping a pair none of them
// applies (__ballot_sync). Per pair a thread's terms sit in registers in
// payload-column order (16, six of them always 0), the warp reduces them by
// recursive halving and the block adds its warps' sums in a fixed order once
// a window. A tile with one point block (its points fit 256) writes each
// pair's row with plain stores; where a tile's points span several blocks
// (consecutive in the table, `ops/sample.py:point_blocks`), each block adds
// its row with one atomicAdd per (block, pair, column), 10 columns. A point
// is owned by one thread, so its d(px), d(py) stay in registers and are
// written once.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "bwd_common.cuh"

namespace {

using namespace blend;

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
  unsigned long long* counters;   // bwd::Counter, or nullptr
  int n_blocks, q, max_per_tile;
  float alpha_clamp, alpha_min;
};

// Whether payload column c is one B5 writes: mean2d (0, 1), conic (2-4),
// opacity (5), ray-depth plane (9-11), rsigma (12).
__device__ __forceinline__ bool written(int c) { return c <= 5 || (c >= 9 && c <= 12); }

template <bool PROFILE>
__global__ void __launch_bounds__(kThreads)
sample_bwd_kernel(const SampleBwdParams p) {
  __shared__ bwd::Window win;
  __shared__ int s_max;
  bwd::Profile<PROFILE> prof;
  prof.start();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* blk = p.blocks + 3 * blockIdx.x;
  const int tile = blk[0];
  const int qi = blk[1] + tid;
  const bool active = tid < blk[2];
  const int start = p.tile_start[tile];
  const int count = min(p.tile_count[tile], p.max_per_tile);
  // another block holds points of this tile: add rows, do not store them
  const bool shared_tile = (blockIdx.x > 0 && blk[-3] == tile) ||
                           (blockIdx.x + 1 < p.n_blocks && blk[3] == tile);

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
  const int warp_n = __reduce_max_sync(bwd::kAll, my_n);
  const int nmax = block_max(my_n, &s_max);
  prof.lap(bwd::kCyclesSetup);

  // --- re-walk the list up to n_contrib, a window at a time ------------------
  float dpx = 0.f, dpy = 0.f;
  for (int b0 = 0; b0 < nmax; b0 += bwd::kWin) {
    const int n = min(bwd::kWin, nmax - b0);
    __syncthreads();                    // the previous window is summed
    bwd::stage_window(p.feats, win, start, b0, n, tid);
    __syncthreads();
    prof.lap(bwd::kCyclesStage);
    unsigned long long mask = 0;
    const int jn = min(n, warp_n - b0);   // uniform over the warp
    for (int j = 0; j < jn; ++j) {
      float alpha, expp, dx, dy;
      const float4 q0 = win.pairs[j][0], q1 = win.pairs[j][1];
      const bool on = b0 + j < my_n &&
                      pair_alpha(p.alpha_clamp, p.alpha_min, q0, q1, px, py,
                                 alpha, expp, dx, dy);
      const unsigned act = __ballot_sync(bwd::kAll, on);
      prof.pair(act, on);
      prof.lap(bwd::kCyclesAlpha);
      if (!act) continue;
      mask |= 1ull << j;
      float d[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) d[c] = 0.f;
      if (on) {
        // implicit median term (sample_pallas.py:326-341)
        const float4 q2 = win.pairs[j][2];
        const float rsig = win.pairs[j][3].x;
        const float t_val = q2.y * dx + q2.z * dy + q2.w;
        const float gap = m_t - t_val;
        const float delta = gap * rsig;
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
        d[9] = d_tp * dx;
        d[10] = d_tp * dy;
        d[11] = d_tp;
        // d/d(rsig) = s dlf_dg (-hg delta^2 / rsig), delta^2 / rsig = delta gap
        d[12] = rsig > 0.f ? s_pt * dlf_dg * (-hg * delta * gap) : 0.f;
        // the point's own gradient (:385-387)
        dpx -= d[0];
        dpy -= d[1];
      }
      prof.lap(bwd::kCyclesApply);
      bwd::put_partial(win, warp, j, lane, bwd::warp_reduce_16(d, lane));
      prof.lap(bwd::kCyclesReduce);
    }
    if (lane == 0) win.mask[warp] = mask;
    __syncthreads();
    prof.lap(bwd::kCyclesStage);
    // the block's sum: pair tid / 4, columns 4 (tid % 4) .. + 3
    const int j = tid >> 2, c4 = (tid & 3) * 4;
    if (j < n) {
      const float4 v = bwd::window_sum(win, j, c4);
      float* dst = p.d_feats + (static_cast<size_t>(start) + b0 + j) * kF + c4;
      if (!shared_tile) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (written(c4 + c) && vs[c] != 0.f) atomicAdd(dst + c, vs[c]);
      }
    }
    prof.lap(bwd::kCyclesReduce);
  }
  prof.flush(p.counters, lane);
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
                                void* counters, int n_blocks, int q,
                                int max_per_tile, float alpha_clamp,
                                float alpha_min, void* stream) {
  const SampleBwdParams p{feats, tile_start, tile_count, pts, blocks, res, g,
                          d_feats, d_pts,
                          static_cast<unsigned long long*>(counters), n_blocks,
                          q, max_per_tile, alpha_clamp, alpha_min};
  const auto st = static_cast<cudaStream_t>(stream);
  if (counters != nullptr)
    sample_bwd_kernel<true><<<n_blocks, kThreads, 0, st>>>(p);
  else
    sample_bwd_kernel<false><<<n_blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

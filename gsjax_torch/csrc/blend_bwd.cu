// Backward tile blend (VJP w.r.t. the pair payload), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `gsjax/ops/raster/render_pallas.py:_bwd_kernel`
// (reached through `_bwd_call` / the `custom_vjp` of `blend_pallas`). From
// the pair payload of a frame in binning order, the forward's [16, H, W]
// planes (blend_fwd.cu: rows 0-7 the outputs, 8 n_contrib, 10 T_final,
// 11 in_range, 12 dlogT/dt at the median root) and their [16, H, W]
// cotangent (rows 0-7 read), it computes d(payload) [K, 16] float32:
//   - the blend VJP, front to back from the saved totals: with
//     q = colour . gc + normal . gn and w = alpha T, for each applied pair
//     dL/dalpha = T q - (S_q - sum_{j<=i} w_j q_j + T_final gamma)/(1 - alpha),
//     S_q the pixel's total sum of w q and gamma the direct dL/dT_final;
//   - the median depth's implicit-function term: with s = -dL/dm_t /
//     (dlogT/dt), each applied pair adds s times d(log T)/d(its alpha,
//     ray-depth plane, rsigma) at the root, over the whole half-gaussian
//     CDF (the TPU kernel's 5-sigma skip is not copied);
//   - the chain through alpha = min(0.99, op exp(power)) to opacity, conic
//     and mean2d, and through the ray-depth plane to its four columns.
//
// What bounds it on an H100: operations, as in the forward. A (pair, pixel)
// interaction costs the alpha test (~16 fp32 operations with one exp) and,
// where the pair is applied, ~60 more for the blend and chain terms and ~30
// with an exp for the median term. The sum over pixels is the design's own
// cost: as five-shuffle warp sums and global atomicAdds it would take ~96
// warp instructions and 16 atomics per (warp, pair), more than the math, with
// up to 32 warps adding into one pair's row (PERF.md, PR 6).
//
// Design (the TPU kernel's per-tile accumulator, render_pallas.py:976-1018,
// rebuilt for this card):
//   - one 256-thread block per 32x32 binning tile; warp w owns a 16x8 patch
//     (2 across, 4 down the tile), each lane a 2x2 quad of it. The block holds
//     every pixel of the tile, so it alone writes each pair's d(payload) row:
//     plain stores, no atomics;
//   - the block walks the tile's list up to the largest n_contrib among its
//     pixels, kWin = 64 pairs a window staged in shared memory; a warp stops
//     at the largest n_contrib among its own pixels, and skips a pair none
//     of its 128 pixels applies (__ballot_sync);
//   - each pixel re-derives its own T front to back (the forward's
//     multiplicative order) and applies the pairs before its n_contrib that
//     pass the alpha test, so a stopped pixel stays stopped;
//   - a thread evaluates the alpha test and the terms of its four pixels
//     without a branch, selecting away a pixel that does not apply the pair,
//     so the four dependent chains (each two exps, a reciprocal and a
//     division deep) interleave: with two blocks an SM (115-119 registers) a
//     warp has few neighbours to hide its latency behind;
//   - per pair a thread sums its quad's terms in registers, the warp reduces
//     the 16 columns by recursive halving, and the block adds the 8 warps'
//     sums in a fixed order once a window (bwd_common.cuh). The result is the
//     same bit for bit from run to run.
// The wrapper passes the binning tile; the kernel takes 32 only.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "bwd_common.cuh"

namespace {

using namespace blend;

constexpr int kTile = 32;                 // the binning tile, one block
constexpr int kQuad = 4;                  // pixels a thread: a 2x2 quad

struct BwdParams {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* planes;      // [16, H, W] forward output
  const float* grad;        // [16, H, W] its cotangent (rows 0-7 read)
  const float* bg;          // [3]
  float* d_feats;           // [K, 16], zeroed by the caller
  unsigned long long* counters;   // bwd::Counter, or nullptr
  int width, height, tiles_x, max_per_tile;
  float fx, fy, alpha_clamp, alpha_min;
};

// One pixel's residuals and cotangent (render_pallas.py:856-894), and its
// running T and sum of w q.
struct Pixel {
  float gc0, gc1, gc2, gn0, gn1, gn2;
  float s_q, tf_gamma, s_pix, m_t;
  float T, wq;
  int n;
};

template <bool DEPTH>
__device__ __forceinline__ Pixel load_pixel(const BwdParams& p, int pxi, int pyi,
                                            int count) {
  Pixel r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0};
  if (pxi >= p.width || pyi >= p.height) return r;
  const size_t hw = static_cast<size_t>(p.height) * p.width;
  const size_t o = static_cast<size_t>(pyi) * p.width + pxi;
  const float* pl = p.planes + o;
  const float* g = p.grad + o;
  const float t_final = pl[10 * hw];
  r.n = min(static_cast<int>(pl[8 * hw]), count);
  const float has = pl[8 * hw] > 0.f ? 1.f : 0.f;
  const float om = fmaxf(1.f - t_final, 1e-12f);
  const float inv_om = 1.f / om;
  r.gc0 = g[0];
  r.gc1 = g[hw];
  r.gc2 = g[2 * hw];
  const float g3 = g[3 * hw] * has, g4 = g[4 * hw] * has, g5 = g[5 * hw] * has;
  r.gn0 = g3 * inv_om;
  r.gn1 = g4 * inv_om;
  r.gn2 = g5 * inv_om;
  const float na0 = pl[3 * hw] * om, na1 = pl[4 * hw] * om, na2 = pl[5 * hw] * om;
  const float ca0 = pl[0] - t_final * p.bg[0];
  const float ca1 = pl[hw] - t_final * p.bg[1];
  const float ca2 = pl[2 * hw] - t_final * p.bg[2];
  const float gamma = -g[6 * hw] + p.bg[0] * r.gc0 + p.bg[1] * r.gc1 +
                      p.bg[2] * r.gc2 +
                      inv_om * inv_om * (g3 * na0 + g4 * na1 + g5 * na2);
  r.s_q = r.gc0 * ca0 + r.gc1 * ca1 + r.gc2 * ca2 + r.gn0 * na0 + r.gn1 * na1 +
          r.gn2 * na2;
  r.tf_gamma = t_final * gamma;
  if (DEPTH && pl[11 * hw] > 0.f) {
    const float pnx = (pxi - (p.width - 1.f) * 0.5f) / p.fx;
    const float pny = (pyi - (p.height - 1.f) * 0.5f) / p.fy;
    const float rln = rsqrtf(pnx * pnx + pny * pny + 1.f);
    r.m_t = pl[7 * hw] / rln;
    const float d_den = pl[12 * hw];
    r.s_pix = fabsf(d_den) > 1e-20f ? -g[7 * hw] * rln / d_den : 0.f;
  }
  return r;
}

// Adds pair (q0..q3)'s terms at pixel `x` to d (payload columns) and steps
// the pixel's T, where `on` (the pixel applies the pair). It runs for every
// pixel of the quad without a branch, the terms of a pixel that does not
// apply the pair selected away (its alpha, expp may be anything), so that
// the compiler interleaves the four pixels' dependent chains.
template <bool DEPTH>
__device__ __forceinline__ void apply_pair(const BwdParams& p, Pixel& x, bool on,
                                           float4 q0, float4 q1, float4 q2,
                                           float4 q3, float alpha, float expp,
                                           float dx, float dy, float (&d)[kF]) {
  const float one_m = 1.f - alpha;
  const float inv_m = 1.f / one_m;
  const float wt = alpha * x.T;
  const float q = q1.z * x.gc0 + q1.w * x.gc1 + q2.x * x.gc2 + q3.y * x.gn0 +
                  q3.z * x.gn1 + q3.w * x.gn2;
  const float wq = x.wq + wt * q;
  float d_a = x.T * q - (x.s_q - wq + x.tf_gamma) * inv_m;
  float d_tp = 0.f, d_rs = 0.f;
  if (DEPTH) {
    // implicit median term (render_pallas._median_model, :925-941), where
    // the pixel's median is in range (s_pix != 0)
    const float rsig = q3.x;
    const float t_val = q2.y * dx + q2.z * dy + q2.w;
    const float gap = x.m_t - t_val;
    const float delta = gap * rsig;
    const float hg = rsig > 0.f ? expf(-0.5f * delta * delta) : 0.f;
    const float half_r = 0.5f / fmaxf(1.f - alpha * hg, 1e-12f);
    const bool behind = x.m_t > t_val;
    const bool med = on && x.s_pix != 0.f;
    d_a += med ? x.s_pix * (behind ? half_r * hg - inv_m : -half_r * hg) : 0.f;
    const float dlf_dg = (behind ? half_r : -half_r) * alpha;
    d_tp = med ? x.s_pix * dlf_dg * hg * delta * rsig : 0.f;
    // d/d(rsig) = s dlf_dg (-hg delta^2 / rsig), delta^2 / rsig = delta gap
    d_rs = med && rsig > 0.f ? x.s_pix * dlf_dg * (-hg * delta * gap) : 0.f;
  }
  // chain alpha -> power / opacity (:966-970), power -> payload; every term
  // is linear in d_a, w or d_tp, zero where the pixel does not apply the pair
  d_a = on ? d_a : 0.f;
  const float w = on ? wt : 0.f;
  const bool notclamped = on && q1.y * expp < p.alpha_clamp;
  const float d_pow = notclamped ? d_a * alpha : 0.f;
  d[5] += notclamped ? d_a * expp : 0.f;
  d[12] += d_rs;
  d[0] += -d_pow * (q0.z * dx + q0.w * dy) + d_tp * q2.y;
  d[1] += -d_pow * (q1.x * dy + q0.w * dx) + d_tp * q2.z;
  d[2] += -0.5f * d_pow * dx * dx;
  d[3] += -d_pow * dx * dy;
  d[4] += -0.5f * d_pow * dy * dy;
  d[6] += w * x.gc0;
  d[7] += w * x.gc1;
  d[8] += w * x.gc2;
  d[9] += d_tp * dx;
  d[10] += d_tp * dy;
  d[11] += d_tp;
  d[13] += w * x.gn0;
  d[14] += w * x.gn1;
  d[15] += w * x.gn2;
  x.wq = on ? wq : x.wq;
  x.T = on ? x.T * one_m : x.T;
}

template <bool DEPTH, bool PROFILE>
__global__ void __launch_bounds__(kThreads, 2)
blend_bwd_kernel(const BwdParams p) {
  __shared__ bwd::Window win;
  __shared__ int s_max;
  bwd::Profile<PROFILE> prof;
  prof.start();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_id = blockIdx.y * p.tiles_x + blockIdx.x;
  const int start = p.tile_start[tile_id];
  const int count = min(p.tile_count[tile_id], p.max_per_tile);
  // the quad's top-left pixel: warp w's patch, then the lane's quad in it
  const int x0 = blockIdx.x * kTile + (warp & 1) * 16 + (lane & 7) * 2;
  const int y0 = blockIdx.y * kTile + (warp >> 1) * 8 + (lane >> 3) * 2;

  Pixel px[kQuad];
  int my_n = 0;
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    px[k] = load_pixel<DEPTH>(p, x0 + (k & 1), y0 + (k >> 1), count);
    my_n = max(my_n, px[k].n);
  }
  const int warp_n = __reduce_max_sync(bwd::kAll, my_n);
  const int nmax = block_max(my_n, &s_max);
  const float fx0 = static_cast<float>(x0), fy0 = static_cast<float>(y0);
  prof.lap(bwd::kCyclesSetup);

  // --- front-to-back re-traversal, a window at a time ----------------------
  for (int b0 = 0; b0 < nmax; b0 += bwd::kWin) {
    const int n = min(bwd::kWin, nmax - b0);
    __syncthreads();                    // the previous window is summed
    bwd::stage_window(p.feats, win, start, b0, n, tid);
    __syncthreads();
    prof.lap(bwd::kCyclesStage);
    unsigned long long mask = 0;
    const int jn = min(n, warp_n - b0);   // uniform over the warp
    for (int j = 0; j < jn; ++j) {
      const float4 q0 = win.pairs[j][0], q1 = win.pairs[j][1];
      float alpha[kQuad], expp[kQuad], dx[kQuad], dy[kQuad];
      bool on[kQuad];
      int applied = 0;
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        // blend_common.cuh:pair_alpha's test, without its early exit
        dx[k] = q0.x - (fx0 + (k & 1));
        dy[k] = q0.y - (fy0 + (k >> 1));
        const float power = pair_power(q0, q1, dx[k], dy[k]);
        expp[k] = expf(power);
        alpha[k] = fminf(p.alpha_clamp, q1.y * expp[k]);
        on[k] = b0 + j < px[k].n && !(power > 0.f) && alpha[k] >= p.alpha_min;
        applied += on[k];
      }
      const unsigned act = __ballot_sync(bwd::kAll, applied > 0);
      prof.pair(act, applied);
      prof.lap(bwd::kCyclesAlpha);
      if (!act) continue;
      mask |= 1ull << j;
      const float4 q2 = win.pairs[j][2], q3 = win.pairs[j][3];
      float d[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) d[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kQuad; ++k)
        apply_pair<DEPTH>(p, px[k], on[k], q0, q1, q2, q3, alpha[k], expp[k], dx[k],
                          dy[k], d);
      prof.lap(bwd::kCyclesApply);
      bwd::put_partial(win, warp, j, lane, bwd::warp_reduce_16(d, lane));
      prof.lap(bwd::kCyclesReduce);
    }
    if (lane == 0) win.mask[warp] = mask;
    __syncthreads();
    prof.lap(bwd::kCyclesStage);
    // the block's sum: pair tid / 4, columns 4 (tid % 4) .. + 3
    const int j = tid >> 2, c4 = (tid & 3) * 4;
    if (j < n)
      *reinterpret_cast<float4*>(p.d_feats + (static_cast<size_t>(start) + b0 + j) * kF +
                                 c4) = bwd::window_sum(win, j, c4);
    prof.lap(bwd::kCyclesReduce);
  }
  prof.flush(p.counters, lane);
}

template <bool DEPTH>
int launch(const BwdParams& p, dim3 grid, cudaStream_t stream) {
  if (p.counters != nullptr)
    blend_bwd_kernel<DEPTH, true><<<grid, kThreads, 0, stream>>>(p);
  else
    blend_bwd_kernel<DEPTH, false><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a tile other than 32.
extern "C" int gsjax_blend_bwd(const float* feats, const int* tile_start,
                               const int* tile_count, const float* planes,
                               const float* grad, const float* bg,
                               float* d_feats, void* counters, int width,
                               int height, int tiles_x, int tiles_y, int tile,
                               float fx, float fy, int max_per_tile,
                               int require_depth, float alpha_clamp,
                               float alpha_min, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{feats, tile_start, tile_count, planes, grad, bg, d_feats,
                    static_cast<unsigned long long*>(counters), width, height,
                    tiles_x, max_per_tile, fx, fy, alpha_clamp, alpha_min};
  const dim3 grid(tiles_x, tiles_y);
  const auto st = static_cast<cudaStream_t>(stream);
  return require_depth ? launch<true>(p, grid, st) : launch<false>(p, grid, st);
}

// The median-depth search shared by the forward blend (blend_fwd.cu, B1) and
// the point query (sample_fwd.cu, B3; its model term also serves the point
// integrate, B4), from render_pallas.py:_median_search
// (the 5-sigma chunk cull left out): the root of log T(t) = log 1/2 of the
// half-gaussian-CDF transmittance model over one thread's applied pairs,
// found by safeguarded Newton, with dlogT/dt at the root (what a backward
// pass reads). Each evaluation re-walks the tile's list, staged in shared
// memory, only up to the largest n_contrib among the block's threads that
// still need a root.
#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace blend {

// render_pallas.py uses 7 iterations without the progress test below; on
// dense scenes that leaves ~0.5% of pixels short of the root (bracket still
// up to 0.3 wide), 12 with the test converge on every pixel measured.
constexpr int kNewtonIters = 12;
constexpr float kLogHalf = -0.69314718055994531f;

// One thread's query: its tile's pair list and where the pairs are evaluated
// (a pixel centre in B1, a continuous point in B3).
struct Query {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  int start;                // first pair of the tile's list
  float px, py;
  float alpha_clamp, alpha_min;
};

// One applied pair's term of log T(t) in the half-gaussian-CDF model
// (render_pallas.py:_median_model): the pair with opacity `alpha`
// (l1m = log1p(-alpha)), depth peak `t_peak` and inverse depth sigma `rsig`,
// at ray distance t; with WANT_D also its d/dt in `dlf`. The median search
// (B1, B3) sums it at trial depths, the point integrate (B4) at the point's
// own ray distance.
template <bool WANT_D>
__device__ __forceinline__ float half_cdf_log_factor(float alpha, float l1m,
                                                     float t, float t_peak,
                                                     float rsig, float& dlf) {
  const float delta = (t - t_peak) * rsig;
  const float hg = rsig > 0.f ? expf(-0.5f * delta * delta) : 0.f;
  const float om = fmaxf(1.f - alpha * hg, 1e-12f);
  const float hl = 0.5f * logf(om);
  const bool behind = t > t_peak;
  if (WANT_D) {
    const float d = 0.5f * (alpha / om) * (-hg * delta * rsig);
    dlf = behind ? d : -d;
  }
  return behind ? l1m - hl : hl;
}

// log T(ts[k]) of the half-gaussian-CDF model over this thread's applied
// pairs (index < my_n), for NPTS depths in one sweep of the tile's list; with
// WANT_D also d(log T)/dt. `nmax` (the block's largest my_n) bounds the
// staging and is uniform over the block.
template <int NPTS, bool WANT_D>
__device__ void model_sweep(const Query& q, Batch& s, int nmax, int my_n,
                            const float* ts, float* lt, float* dlt) {
#pragma unroll
  for (int k = 0; k < NPTS; ++k) {
    lt[k] = 0.f;
    dlt[k] = 0.f;
  }
  for (int b0 = 0; b0 < nmax; b0 += kBatch) {
    __syncthreads();                    // the previous batch is consumed
    const int n = min(kBatch, nmax - b0);
    stage(q.feats, s, q.start, b0, n);
    __syncthreads();
    const int jn = min(n, my_n - b0);
    for (int j = 0; j < jn; ++j) {
      float alpha, expp, dx, dy;
      if (!pair_alpha(q.alpha_clamp, q.alpha_min, s[j][0], s[j][1], q.px, q.py,
                      alpha, expp, dx, dy))
        continue;
      const float4 q2 = s[j][2];
      const float rsig = s[j][3].x;
      const float t_peak = q2.y * dx + q2.z * dy + q2.w;
      const float l1m = log1pf(-alpha);
#pragma unroll
      for (int k = 0; k < NPTS; ++k) {
        float dlf = 0.f;
        lt[k] += half_cdf_log_factor<WANT_D>(alpha, l1m, ts[k], t_peak, rsig, dlf);
        if (WANT_D) dlt[k] += dlf;
      }
    }
  }
}

__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) > 1e-20f ? d : 1e-20f;
}

struct Median {
  float m_t;        // the root (ray distance); 0 unless in_range
  float d_denom;    // dlogT/dt at the root; read only where in_range
  bool in_range;    // the root is bracketed by md_init -+ sample_range
};

// Every thread of the block must call it. `cand`: the thread's march ended
// with T <= min_transmittance; n_contrib, md_init: from its march.
__device__ Median median_search(const Query& q, Batch& s, int* s_max,
                                bool cand, int n_contrib, float md_init,
                                float sample_range) {
  Median r{0.f, 0.f, false};
  const int nmax = block_max(cand ? n_contrib : 0, s_max);
  if (nmax == 0) return r;
  float lo = fmaxf(md_init - sample_range, 0.f);
  float hi = fmaxf(md_init + sample_range, 0.f);
  float ts[2] = {lo, hi}, lt[2], dl[2];
  model_sweep<2, false>(q, s, nmax, cand ? n_contrib : 0, ts, lt, dl);
  float t_lo = expf(lt[0]), t_hi = expf(lt[1]);
  r.in_range = cand && t_lo >= 0.5f && t_hi <= 0.5f;
  const int my_n = r.in_range ? n_contrib : 0;
  const int nmax2 = block_max(my_n, s_max);
  if (nmax2 == 0) return r;
  // the first iterate is the log-linear secant through the bracket
  const float w0 = fminf(fmaxf(
      (lt[0] - kLogHalf) / safe_den(lt[0] - lt[1]), 0.f), 1.f);
  float t = lo + w0 * (hi - lo);
  float last_step = hi - lo;
  for (int it = 0; it < kNewtonIters; ++it) {
    float l, d;
    model_sweep<1, true>(q, s, nmax2, my_n, &t, &l, &d);
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
    // Newton only while it stays in the bracket and at least halves the
    // previous step (rtsafe's progress test); else bisect
    const bool newton = ok && t_n > lo && t_n < hi &&
                        2.f * fabsf(step) <= fabsf(last_step);
    last_step = newton ? step : 0.5f * (hi - lo);
    t = newton ? t_n : 0.5f * (lo + hi);
  }
  const float w = fminf(fmaxf((t_lo - 0.5f) / safe_den(t_lo - t_hi), 0.f), 1.f);
  float t_star = w * hi + (1.f - w) * lo;
  // dlogT/dt at the root, which also buys a last Newton refinement
  float l_star;
  model_sweep<1, true>(q, s, nmax2, my_n, &t_star, &l_star, &r.d_denom);
  const bool ok = r.d_denom < -1e-20f;
  const float t_ref = t_star - (l_star - kLogHalf) / (ok ? r.d_denom : -1.f);
  if (ok && t_ref > lo && t_ref < hi) t_star = t_ref;
  if (r.in_range) r.m_t = t_star;
  return r;
}

}  // namespace blend

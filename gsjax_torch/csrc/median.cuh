// The median-depth search shared by the forward blend (blend_fwd.cu, B1) and
// the point query (sample_fwd.cu, B3; the point integrate, integrate_fwd.cu,
// B4, takes its model term in product form), from
// render_pallas.py:_median_search: the root of
// log T(t) = log 1/2 of the half-gaussian-CDF transmittance model over one
// thread's applied pairs, found by safeguarded Newton, with dlogT/dt at the
// root (what a backward pass reads).
//
// What bounds it on an H100: the special-function rate and barriers, not
// bytes. Each term of the model costs an exp, a log and a division, which the
// card issues at a fraction of its fp32 rate; re-walking the tile's list for
// each evaluation also repeats the alpha test (an exp per marched pair) and
// log1p(-alpha), and stages the list through shared memory with two
// __syncthreads per 256 pairs, up to the block's longest list.
//
// Design: fold each pixel's pairs against its bracket once, then run Newton
// on what is left, in shared memory, one thread on its own.
//   - The fold. A pair whose delta = (t - t_peak) rsig is >= kFoldCut at the
//     bracket's low end lies behind every depth of the bracket: its term is
//     the constant log1p(-alpha), added to the thread's constant. A pair with
//     delta <= -kFoldCut at the high end lies ahead of it: its term is 0. A
//     pair with rsig <= 0 (a step, hg = 0) folds by side the same way. Every
//     other pair is "varying" and goes to the thread's slots in dynamic
//     shared memory: alpha, t_peak and rsig, 12 bytes (struct Slots).
//   - The fold is exact, not a cull. Premise: the kernels are built without
//     -use_fast_math and without flush-to-zero (_build.py). For |delta| >= 6
//     and alpha <= 1, alpha hg <= expf(-18) = 1.5e-8 < 2^-25, so
//     1.f - alpha * hg rounds to exactly 1 and 0.5f * logf(om) is exactly 0:
//     the term is exactly log1p(-alpha) behind and exactly 0 ahead, at every
//     depth of the bracket (every later evaluation lies inside it). Only d/dt
//     drops terms, each below 0.5 * 6 * 1.5e-8 * rsig = 4.6e-8 rsig (the cut
//     at which d/dt is exact too is 14.5: expf(-105.1) is 0 in float32). If
//     the build flags change, check the premise again
//     (tests/test_torch_median_fold.py).
//   - The first sweep walks the staged list once, as the march does, and
//     evaluates log T at both bracket ends (whether the root is in range)
//     and at its middle (which half holds it: Newton starts from a bracket
//     of half the width), folding as it goes.
//   - A thread whose varying set fits its slots runs Newton over them: no
//     staging, no barrier, no alpha test, no log1p. Each evaluation also
//     folds its slots again against the bracket, which only narrows, so the
//     set shrinks as Newton converges. It leaves the loop once the iterate
//     (or the Newton step) moves by at most kStepTol (2-4 ulps of t where t
//     is far), or after kNewtonIters evaluations, and evaluates dlogT/dt at
//     the root on its slots too.
//   - Overflow: a thread whose varying set does not fit (every thread that
//     has varying pairs, with no slots) re-walks the staged list for its next
//     evaluation, with the same terms and the same exit, after the slot
//     threads are done and only while such a thread remains, up to the
//     longest such list. Each re-walk folds against the bracket as it is then;
//     once the set fits, the thread goes on in its slots.
// Every thread of the block calls median_search; its barriers sit outside any
// branch that only some threads take.
#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace blend {

// render_pallas.py uses 7 iterations without the progress test below; on
// dense scenes that leaves ~0.5% of pixels short of the root (bracket still
// up to 0.3 wide), 12 with the test converge on every pixel measured.
constexpr int kNewtonIters = 12;
// Leave Newton once the iterate moves by at most this (ray distance); the
// twin's 8-way x 5-round bisection resolves 0.8 / 8^5 = 2.4e-5. Far away the
// tolerance is relative: kStepRel |t| (two float32 epsilons, 2-4 ulps of t),
// since from t = 256 on an ulp exceeds 2 kStepTol and a step between the
// absolute tolerance and half an ulp rounds onto the bracket end.
constexpr float kStepTol = 1e-5f;
constexpr float kStepRel = 2.f * 1.1920928955078125e-7f;
constexpr float kFoldCut = 6.f;           // exact value fold (see above)
constexpr float kWideCut = 14.5f;         // exact value and d/dt (counted only)
constexpr float kLogHalf = -0.69314718055994531f;

// Search counters, filled where the caller passes a buffer (int32, zeroed;
// render_cuda.SEARCH_COUNTERS names them). Threads and pairs are those whose
// root is in range; varying pairs are counted at the first sweep's bracket.
enum Counter {
  kCandidates = 0,    // threads with T_final <= min_transmittance
  kSlotThreads,       // in range, in their slots from the first sweep
  kWalkThreads,       // in range, re-walking at least once
  kIterSum,           // Newton evaluations (the final one not counted)
  kIterMax,
  kVaryingSum,        // varying pairs at kFoldCut
  kVaryingMax,
  kFoldedSum,         // applied pairs folded at kFoldCut
  kAppliedSum,        // applied pairs
  kWideSum,           // varying pairs at kWideCut
  kWideMax,
  kWalkSweeps,        // re-walk sweeps, summed over blocks
  kWalkThreadSweeps,  // re-walks, summed over threads
  kCyclesMarch,       // warp cycles / 1024 in the march before the search,
  kCyclesFold,        // the first sweep,
  kCyclesSlots,       // Newton in the slots,
  kCyclesWalk,        // and the re-walks, summed over warps
  kHist = 20,         // [kHistBins] threads by varying pairs at kFoldCut
};
constexpr int kHistBins = 256;            // the last bin holds >= 255
constexpr int kCounters = kHist + 2 * kHistBins;   // then the same at kWideCut

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
// (B1, B3) sums it at trial depths.
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

// Whether a pair lies behind (every depth of [lo, hi] is past it by at least
// `cut` sigmas) or ahead of the whole bracket; rsig <= 0 is a step at t_peak.
__device__ __forceinline__ bool fold_behind(float lo, float t_peak, float rsig,
                                            float cut) {
  return rsig > 0.f ? (lo - t_peak) * rsig >= cut : lo > t_peak;
}
__device__ __forceinline__ bool fold_ahead(float hi, float t_peak, float rsig,
                                           float cut) {
  return rsig > 0.f ? (hi - t_peak) * rsig <= -cut : hi <= t_peak;
}

// A thread's slots: three float planes of `cap` slots each in dynamic shared
// memory, alpha, t_peak and rsig of slot k at base[(plane * cap + k) *
// kThreads], `base` the block's buffer plus the thread's index (a warp reads
// 128 contiguous bytes). log1p(-alpha) is recomputed where a term needs it,
// so a slot takes 12 bytes.
struct Slots {
  float* base;
  int cap;
  __device__ __forceinline__ float& at(int plane, int k) const {
    return base[(plane * cap + k) * kThreads];
  }
};

// What a sweep of the list leaves a thread: the folded constant and its
// varying pairs (the first `cap` of them in its slots).
struct Fold {
  float konst;
  int varying, applied, wide;
};

// log T(ts[k]) of the half-gaussian-CDF model over this thread's applied
// pairs (index < my_n), for NPTS depths inside [lo, hi] in one sweep of the
// staged list; with WANT_D also d(log T)/dt. Folds each pair against
// [lo, hi] (module note) and keeps the varying ones in this thread's `slots`
// up to their capacity; with `count` also counts the varying pairs at
// kWideCut. `nmax` (the block's largest my_n) bounds the staging and is
// uniform over the block.
template <int NPTS, bool WANT_D>
__device__ Fold walk_sweep(const Query& q, Batch& s, int nmax, int my_n,
                           const float* ts, float* lt, float* dlt, float lo,
                           float hi, const Slots& slots, bool count) {
  Fold f{0.f, 0, 0, 0};
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
      ++f.applied;
      if (count)
        f.wide += !fold_behind(lo, t_peak, rsig, kWideCut) &&
                  !fold_ahead(hi, t_peak, rsig, kWideCut);
      if (fold_ahead(hi, t_peak, rsig, kFoldCut)) continue;
      const float l1m = log1pf(-alpha);
      if (fold_behind(lo, t_peak, rsig, kFoldCut)) {
        f.konst += l1m;
        continue;
      }
#pragma unroll
      for (int k = 0; k < NPTS; ++k) {
        float dlf = 0.f;
        lt[k] += half_cdf_log_factor<WANT_D>(alpha, l1m, ts[k], t_peak, rsig, dlf);
        if (WANT_D) dlt[k] += dlf;
      }
      if (f.varying < slots.cap) {
        slots.at(0, f.varying) = alpha;
        slots.at(1, f.varying) = t_peak;
        slots.at(2, f.varying) = rsig;
      }
      ++f.varying;
    }
  }
#pragma unroll
  for (int k = 0; k < NPTS; ++k) lt[k] += f.konst;
  return f;
}

__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) > 1e-20f ? d : 1e-20f;
}

// Safeguarded Newton on log T(t) = log 1/2 inside a bracket: the log-linear
// secant start, rtsafe's progress test, bisection where Newton would leave
// the bracket, the convergence exit, and the final secant + refinement.
struct Newton {
  float lo, hi, t_lo, t_hi;     // bracket and T at its ends
  float t, last_step;           // the next depth to evaluate, the last step
  int iters;
  bool done;

  __device__ void start(float lo0, float hi0, float l_lo, float l_hi) {
    lo = lo0;
    hi = hi0;
    t_lo = expf(l_lo);
    t_hi = expf(l_hi);
    const float w0 = fminf(fmaxf((l_lo - kLogHalf) / safe_den(l_lo - l_hi), 0.f), 1.f);
    t = lo + w0 * (hi - lo);
    last_step = hi - lo;
    iters = 0;
    done = false;
  }

  // Take log T = l and its d/dt at t; set the next t.
  __device__ void update(float l, float d) {
    const float tv = expf(l);
    if (tv >= 0.5f) {                     // the root is at t or right
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
    const float t_next = newton ? t_n : 0.5f * (lo + hi);
    // converged: the iterate stands still, or the Newton step is below the
    // tolerance (once it is below an ulp of t, t_n rounds onto the bracket
    // end t and the bracket test alone would send it to bisection)
    const float tol = fmaxf(kStepTol, kStepRel * fabsf(t));
    done = ++iters >= kNewtonIters || fabsf(t_next - t) <= tol ||
           (ok && fabsf(step) <= tol);
    t = t_next;
  }

  // The secant through the bracket ends, where the last evaluation runs.
  __device__ float root() const {
    const float w = fminf(fmaxf((t_lo - 0.5f) / safe_den(t_lo - t_hi), 0.f), 1.f);
    return w * hi + (1.f - w) * lo;
  }

  // A last Newton step from t_star (log T = l_star, d/dt = d_star there),
  // kept only inside the bracket.
  __device__ float refine(float t_star, float l_star, float d_star) const {
    const bool ok = d_star < -1e-20f;
    const float t_ref = t_star - (l_star - kLogHalf) / (ok ? d_star : -1.f);
    return ok && t_ref > lo && t_ref < hi ? t_ref : t_star;
  }
};

// log T(t) and d(log T)/dt over a thread's `n` slots and its constant, folding
// the slots again against [lo, hi] (the bracket that holds t and every later
// evaluation): a folded slot leaves the set, its exact term joins `konst`.
// The slots keep their order.
__device__ __forceinline__ void slot_eval(const Slots& slots, int& n,
                                          float& konst, float lo, float hi,
                                          float t, float& l, float& d) {
  float acc = 0.f;
  d = 0.f;
  int m = 0;
  for (int k = 0; k < n; ++k) {
    const float alpha = slots.at(0, k), t_peak = slots.at(1, k),
                rsig = slots.at(2, k);
    if (fold_ahead(hi, t_peak, rsig, kFoldCut)) continue;
    if (fold_behind(lo, t_peak, rsig, kFoldCut)) {
      konst += log1pf(-alpha);
      continue;
    }
    // log1p(-alpha) enters only behind t_peak
    const float l1m = t > t_peak ? log1pf(-alpha) : 0.f;
    float dlf;
    acc += half_cdf_log_factor<true>(alpha, l1m, t, t_peak, rsig, dlf);
    d += dlf;
    if (m != k) {
      slots.at(0, m) = alpha;
      slots.at(1, m) = t_peak;
      slots.at(2, m) = rsig;
    }
    ++m;
  }
  n = m;
  l = konst + acc;
}

// Newton in a thread's slots from `nw` to the root: the root (m_t) and
// dlogT/dt there.
__device__ __forceinline__ void slot_newton(const Slots& slots, int n,
                                            float konst, Newton& nw,
                                            float& m_t, float& d_denom) {
  float l;
  while (!nw.done) {
    float d;
    slot_eval(slots, n, konst, nw.lo, nw.hi, nw.t, l, d);
    nw.update(l, d);
  }
  const float t_star = nw.root();
  slot_eval(slots, n, konst, nw.lo, nw.hi, t_star, l, d_denom);
  m_t = nw.refine(t_star, l, d_denom);
}

struct Median {
  float m_t;        // the root (ray distance); 0 unless in_range
  float d_denom;    // dlogT/dt at the root; read only where in_range
  bool in_range;    // the root is bracketed by md_init -+ sample_range
};

// Adds the warp's cycles since `since` to counter `i` (in units of 1024), and
// returns the clock; every lane of the warp calls it.
__device__ __forceinline__ long long lap(int* c, int i, long long since, int lane) {
  __syncwarp();
  const long long now = clock64();
  if (lane == 0) atomicAdd(c + i, static_cast<int>((now - since) >> 10));
  return now;
}

// Adds this thread's search to the counters; every lane of the warp calls it.
__device__ void record(int* c, int lane, bool cand, bool on_slots, bool walked,
                       int iters, int walks, const Fold& f) {
  const unsigned all = 0xffffffffu;
  const bool searched = on_slots || walked;
  const auto add = [&](int i, int v) {
    v = __reduce_add_sync(all, v);
    if (lane == 0 && v) atomicAdd(c + i, v);
  };
  const auto top = [&](int i, int v) {
    v = __reduce_max_sync(all, v);
    if (lane == 0 && v) atomicMax(c + i, v);
  };
  add(kCandidates, cand);
  add(kSlotThreads, on_slots);
  add(kWalkThreads, walked);
  add(kIterSum, searched ? iters : 0);
  top(kIterMax, searched ? iters : 0);
  add(kVaryingSum, searched ? f.varying : 0);
  top(kVaryingMax, searched ? f.varying : 0);
  add(kFoldedSum, searched ? f.applied - f.varying : 0);
  add(kAppliedSum, searched ? f.applied : 0);
  add(kWideSum, searched ? f.wide : 0);
  top(kWideMax, searched ? f.wide : 0);
  add(kWalkThreadSweeps, walks);
  const int bins[2] = {min(f.varying, kHistBins - 1), min(f.wide, kHistBins - 1)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bin = searched ? bins[h] : -1;
    const unsigned peers = __match_any_sync(all, bin);
    if (searched && lane == __ffs(peers) - 1)
      atomicAdd(c + kHist + h * kHistBins + bin, __popc(peers));
  }
}

// Every thread of the block must call it. `cand`: the thread's march ended
// with T <= min_transmittance; n_contrib, md_init: from its march. `slots`:
// this thread's slots; `counters`: nullptr, or the buffer of Counter above;
// `tid`: the thread's index in the block; `t_start`: clock64() at the
// kernel's start (read with counters only).
__device__ Median median_search(const Query& q, Batch& s, int* s_max,
                                const Slots& slots, int* counters, int tid,
                                long long t_start, bool cand, int n_contrib,
                                float md_init, float sample_range) {
  Median r{0.f, 0.f, false};
  const int lane = tid & 31;
  long long tc = 0;
  if (counters != nullptr) tc = lap(counters, kCyclesMarch, t_start, lane);
  const int nmax = block_max(cand ? n_contrib : 0, s_max);
  if (nmax == 0) return r;                // uniform over the block
  const float lo = fmaxf(md_init - sample_range, 0.f);
  const float hi = fmaxf(md_init + sample_range, 0.f);
  // the bracket ends and its middle (md_init, unless clamped at 0), which
  // halves the bracket before Newton starts
  const float ts[3] = {lo, fminf(fmaxf(md_init, lo), hi), hi};
  float lt[3], unused[3];
  const Fold f = walk_sweep<3, false>(q, s, nmax, cand ? n_contrib : 0, ts, lt,
                                      unused, lo, hi, slots, counters != nullptr);
  r.in_range = cand && expf(lt[0]) >= 0.5f && expf(lt[2]) <= 0.5f;
  const bool upper = expf(lt[1]) >= 0.5f;     // the root is in [md, hi]
  Newton nw;
  nw.start(upper ? ts[1] : lo, upper ? hi : ts[1], upper ? lt[1] : lt[0],
           upper ? lt[2] : lt[1]);
  const bool on_slots = r.in_range && f.varying <= slots.cap;
  if (counters != nullptr) tc = lap(counters, kCyclesFold, tc, lane);
  if (on_slots) slot_newton(slots, f.varying, f.konst, nw, r.m_t, r.d_denom);
  if (counters != nullptr) tc = lap(counters, kCyclesSlots, tc, lane);

  // overflow: re-walk the list while a thread's set does not fit its slots
  bool walk = r.in_range && !on_slots;
  const bool walked = walk;
  int sweeps = 0, walks = 0;
  for (;;) {
    const int nm = block_max(walk ? n_contrib : 0, s_max);
    if (nm == 0) break;
    const bool last = nw.done;            // this walk evaluates at the root
    const float t = last ? nw.root() : nw.t;
    float l, d;
    const Fold g = walk_sweep<1, true>(q, s, nm, walk ? n_contrib : 0, &t, &l, &d,
                                       nw.lo, nw.hi, slots, false);
    ++sweeps;
    if (!walk) continue;
    ++walks;
    if (last) {
      r.d_denom = d;
      r.m_t = nw.refine(t, l, d);
      walk = false;
    } else {
      nw.update(l, d);
      if (g.varying <= slots.cap) {       // the narrowed set fits: go on there
        slot_newton(slots, g.varying, g.konst, nw, r.m_t, r.d_denom);
        walk = false;
      }
    }
  }

  if (counters != nullptr) {
    lap(counters, kCyclesWalk, tc, lane);
    record(counters, lane, cand, on_slots, walked, nw.iters, walks, f);
    if (tid == 0 && sweeps) atomicAdd(counters + kWalkSweeps, sweeps);
  }
  return r;
}

}  // namespace blend

// Point integrate (B4) for NVIDIA Hopper (sm_90a): the transmittance of the
// half-gaussian-CDF model at each query point's own ray distance.
//
// Replaces the TPU kernel `gsjax/ops/raster/sample_pallas.py:_sfwd_kernel`
// in integrate mode (reached through `integrate_pallas`; the reference's
// evaluateTransmittanceCUDA, sample_forward.cu:55-169). Each query point, at
// continuous pixel coordinates (px, py) of one view and ray distance t,
// marches its tile's depth-sorted pair list as a pixel does in the blend
// (alpha test, stop for good before T would fall below 1e-4; T, n_contrib,
// md_init) and multiplies, over the pairs the march applies, each pair's
// factor of T(t) in the half-gaussian-CDF model (the exp of
// median.cuh:half_cdf_log_factor, the term the median search sums).
//
// Input: the pair payload [K, 16] of the view in binning order with its tile
// ranges; the points [Q, 2] (px, py) and their ray distances [Q], sorted by
// tile and within a tile by the Z order of their pixel (ops/sample.py:
// prepare_points with pixel_order); a block table [NB, 3] (tile, first
// sorted point, count <= 256). Output [5, Q] float32 in sorted order: 0
// T(point), 1 covered (= 1), 2 n_contrib, 3 md_init, 4 T_final.
//
// What bounds it on an H100: operations. A block reads its tile's pairs once
// (64 bytes each); each (pair, point) the march reaches costs the alpha test
// (~16 fp32 operations and an exp), each applied pair the model's factor (an
// exp and a reciprocal square root where the pair is near the point). The
// work is sparse: on a sphere's tetra points 19% of the marched (pair,
// point) tests pass the alpha test, and most applied pairs lie 6 sigmas or
// more in front of or behind the point.
//
// Design: one thread per point, one block per (tile, up to 256 of its
// points), the block staging its tile's list in shared memory in batches of
// 256 pairs (48 + 16 bytes each), as B3 does; then three skips, each exact:
//   - The warp's list. The points of a warp lie within a few pixels of each
//     other (the Z order), and a pair's alpha test passes only inside the
//     ellipse where its exponent reaches the cut-off below. Each warp keeps,
//     in order, the staged pairs whose ellipse reaches the box around its 32
//     points (the minimum of the conic over the box, from terms staged once
//     per pair), as byte indices in shared memory, and its lanes march only
//     those. The ellipse is grown by 2% and 1e-3 in d^T C d, far beyond the
//     float32 rounding of the exponent, and a pair with an ill-conditioned
//     conic (det < 1e-4 ca cc) is always kept.
//   - The cut-off. alpha = min(clamp, op exp(power)) >= alpha_min needs
//     power >= ln(alpha_min / op); the block computes that once per staged
//     pair less a margin of 0.01, and a lane whose exponent lies below it
//     skips the exp. The margin is 4 orders of magnitude above expf's and
//     logf's errors, so no alpha test changes its outcome.
//   - The band. A pair delta = (t - t_peak) rsig >= 6 sigmas in front of the
//     point contributes exactly the march's own factor 1 - alpha; one 6
//     sigmas or more behind it exactly 1: there 1 - alpha hg rounds to 1 in
//     float32 (alpha hg <= expf(-18) < 2^-25; the kernels are built without
//     fast math or flush-to-zero, _build.py; median.cuh's fold rests on the
//     same premise). Only a pair within 6 sigmas pays for hg and the half
//     CDF: (1 - alpha) / sqrt(1 - alpha hg) behind its peak, sqrt(1 - alpha
//     hg) ahead of it. A step (rsig <= 0) contributes 1 - alpha behind its
//     peak and 1 ahead. T(point) is the product of the factors: each is at
//     least 1 - alpha, so the product stays above T_final >= 1e-4.
// tests/test_torch_integrate_band.py holds the band's premise in float32 and
// runs this loop, skips included, against the twin and gsjax on the CPU.
//
// Each lane branches on its own. A launch with `counters` runs a second
// instance of the kernel, in which the warp steps through its list together
// (a vote at each pair) so that its clock64 laps fall where every lane is:
// the same values and the same counts (sample_cuda.INTEGRATE_COUNTERS), at
// about twice the time.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr float kBand = 6.f;              // sigmas: the band (module note)
constexpr float kCutMargin = 0.01f;       // below ln(alpha_min / op)
constexpr float kDetRel = 1e-4f;          // ill-conditioned conics are kept
constexpr float kReachGrow = 1.02f;       // the ellipse in d^T C d, grown
constexpr float kReachPad = 1e-3f;

// Profile counters, filled where the caller passes a buffer (int64, zeroed;
// sample_cuda.INTEGRATE_COUNTERS names them). A warp-pair is one warp's step
// over one pair of its list; cycles are warp cycles (clock64), summed over
// warps.
enum Counter {
  kBlocks = 0,
  kPoints,            // active threads
  kPairsStaged,       // pairs staged, summed over blocks
  kPairsKept,         // pairs in the warps' lists, summed over warps
  kWarpPairs,         // warp-pairs walked
  kWarpPairsTested,   // of which some lane passes the cut-off (an exp)
  kWarpPairsActive,   // of which some lane applies the pair
  kWarpPairsNear,     // of which some lane computes the near factor
  kLanePairs,         // marching lanes, summed over warp-pairs
  kLanePairsStopped,  // lanes with a point that has stopped, likewise
  kAppliedFront,      // applied pairs >= 6 sigmas in front of the point,
  kAppliedBehind,     // >= 6 sigmas behind it,
  kAppliedNear,       // within 6 sigmas,
  kAppliedStep,       // and steps (rsig <= 0)
  kCyclesSetup,       // the point loads, the warp's box and the writes
  kCyclesStage,       // staging a batch and the block's barriers
  kCyclesFilter,      // the warp's list
  kCyclesAlpha,       // the cut-off, the alpha test, the stop and the skips
  kCyclesApply,       // the applied pairs' factors
  kCounters
};

// One warp's counters in registers (lane 0's are published, but for the
// applied pairs, which each lane counts). ON = false compiles every call
// away.
template <bool ON>
struct Profile {
  unsigned long long v[kCounters];
  long long t;

  __device__ __forceinline__ void start() {
    if constexpr (ON) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k) v[k] = 0;
      __syncwarp();
      t = clock64();
    }
  }
  // Adds the cycles since the last lap to counter k; every lane of the warp
  // calls it.
  __device__ __forceinline__ void lap(int k) {
    if constexpr (ON) {
      __syncwarp();
      const long long now = clock64();
      v[k] += static_cast<unsigned long long>(now - t);
      t = now;
    }
  }
  __device__ __forceinline__ void add(int k, unsigned long long x) {
    if constexpr (ON) v[k] += x;
  }
  __device__ __forceinline__ void flush(unsigned long long* c, int lane) {
    if constexpr (ON) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k) {
        const unsigned long long x =
            k >= kAppliedFront && k <= kAppliedStep
                ? __reduce_add_sync(kAll, static_cast<unsigned>(v[k]))
                : v[k];
        if (lane == 0 && x) atomicAdd(c + k, x);
      }
    }
  }
};

// v over the warp in the profiled instance (every lane takes the branch if
// one does), v per lane in the plain one.
template <bool WARP>
__device__ __forceinline__ bool any(bool v) {
  if constexpr (WARP) return __any_sync(kAll, v);
  return v;
}

// A staged batch, per pair: what the alpha test reads (a, b), what an
// applied pair reads (c), and what the warps' lists read (a, b.x, d).
struct Staged {
  float4 a[kBatch];   // gx, gy, ca, cb
  float4 b[kBatch];   // cc, opacity, cut-off, rsigma
  float4 c[kBatch];   // ray-depth plane rp0, rp1, tc
  float4 d[kBatch];   // -cb / cc, -cb / ca, reach (grown r^2, inf: keep)
};

struct IntegrateParams {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* pts;         // [Q, 2] (px, py), sorted (module note)
  const float* t_eval;      // [Q] ray distance of each point
  const int* blocks;        // [NB, 3] tile, first point, point count
  float* out;               // [5, Q]
  unsigned long long* counters;   // Counter, or nullptr
  int q, max_per_tile;
  float alpha_clamp, alpha_min, t_min;
};

__device__ __forceinline__ float conic(float ca, float cb, float cc, float dx,
                                       float dy) {
  return ca * dx * dx + 2.f * cb * dx * dy + cc * dy * dy;
}

// Whether staged pair (a, cc = b.x, d) reaches its cut-off somewhere in
// `box` (x0, y0, x1, y1): the least d^T C d over the box (d = mean2d - p),
// where the centre lies outside it, is on an edge, at the edge's own
// minimiser clamped to the edge.
__device__ __forceinline__ bool reaches(float4 a, float cc, float4 d, float4 box) {
  const float x0 = a.x - box.z, x1 = a.x - box.x;
  const float y0 = a.y - box.w, y1 = a.y - box.y;
  if (x0 <= 0.f && x1 >= 0.f && y0 <= 0.f && y1 >= 0.f) return true;
  const float ca = a.z, cb = a.w;
  float q = fminf(conic(ca, cb, cc, x0, fminf(fmaxf(d.x * x0, y0), y1)),
                  conic(ca, cb, cc, x1, fminf(fmaxf(d.x * x1, y0), y1)));
  q = fminf(q, conic(ca, cb, cc, fminf(fmaxf(d.y * y0, x0), x1), y0));
  q = fminf(q, conic(ca, cb, cc, fminf(fmaxf(d.y * y1, x0), x1), y1));
  return !(q > d.z);                    // NaN keeps the pair
}

// An applied pair's factor of T at the point's ray distance t (module note),
// om1 = 1 - alpha; `band` is 0 in front, 1 behind, 2 near, 3 a step.
__device__ __forceinline__ float band_factor(float alpha, float om1, float t,
                                             float t_peak, float rsig, int& band) {
  const bool behind = t > t_peak;
  if (rsig > 0.f) {
    const float delta = (t - t_peak) * rsig;
    if (delta >= kBand) {
      band = 0;
      return om1;
    }
    if (delta <= -kBand) {
      band = 1;
      return 1.f;
    }
    band = 2;
    const float om = fmaxf(1.f - alpha * expf(-0.5f * delta * delta), 1e-12f);
    const float r = rsqrtf(om);
    return behind ? om1 * r : om * r;
  }
  band = 3;
  return behind ? om1 : 1.f;
}

template <bool PROFILE>
__global__ void __launch_bounds__(kThreads)
integrate_kernel(const IntegrateParams p) {
  __shared__ Staged s;
  __shared__ unsigned char s_list[kWarps][kBatch];
  Profile<PROFILE> prof;
  prof.start();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* blk = p.blocks + 3 * blockIdx.x;
  const int tile = blk[0];
  const int qi = blk[1] + tid;
  const bool active = tid < blk[2];
  const int start = p.tile_start[tile];
  const int count = min(p.tile_count[tile], p.max_per_tile);
  float px = 0.f, py = 0.f, et = 0.f;
  if (active) {
    px = p.pts[2 * static_cast<size_t>(qi)];
    py = p.pts[2 * static_cast<size_t>(qi) + 1];
    et = p.t_eval[qi];
  }
  // the box of the warp's points (empty for a warp without one)
  const float inf = __int_as_float(0x7f800000);
  float4 box = active ? make_float4(px, py, px, py) : make_float4(inf, inf, -inf, -inf);
  for (int o = 16; o > 0; o >>= 1) {
    box.x = fminf(box.x, __shfl_xor_sync(kAll, box.x, o));
    box.y = fminf(box.y, __shfl_xor_sync(kAll, box.y, o));
    box.z = fmaxf(box.z, __shfl_xor_sync(kAll, box.z, o));
    box.w = fmaxf(box.w, __shfl_xor_sync(kAll, box.w, o));
  }
  if (PROFILE) {
    if (tid == 0) prof.add(kBlocks, 1);
    prof.add(kPoints, __popc(__ballot_sync(kAll, active)));
  }
  prof.lap(kCyclesSetup);

  float T = 1.f, md_init = 0.f, tp = 1.f;
  int last = -1;
  bool done = !active;
  int applied[4] = {0, 0, 0, 0};        // by band, counted when profiled
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier before the batch buffer is overwritten
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, count - b0);
    if (tid < n) {
      const float4* src = reinterpret_cast<const float4*>(
          p.feats + (static_cast<size_t>(start) + b0 + tid) * kF);
      const float4 q0 = src[0], q1 = src[1], q2 = src[2];
      const float ca = q0.z, cb = q0.w, cc = q1.x;
      const float cut = logf(p.alpha_min / q1.y) - kCutMargin;
      const float det = ca * cc - cb * cb;
      const bool conditioned = cut < 0.f && ca > 0.f && cc > 0.f && det > kDetRel * ca * cc;
      s.a[tid] = q0;
      s.b[tid] = make_float4(cc, q1.y, cut, src[3].x);
      s.c[tid] = make_float4(q2.y, q2.z, q2.w, 0.f);
      s.d[tid] = make_float4(-cb / cc, -cb / ca,
                             conditioned ? -2.f * cut * kReachGrow + kReachPad : inf, 0.f);
    }
    __syncthreads();
    if (PROFILE && tid == 0) prof.add(kPairsStaged, n);
    prof.lap(kCyclesStage);
    if (__all_sync(kAll, done)) continue;

    // the warp's list: the staged pairs that reach its box, in list order
    int m = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool keep = i < n && reaches(s.a[i], s.b[i].x, s.d[i], box);
      const unsigned bal = __ballot_sync(kAll, keep);
      if (keep)
        s_list[warp][m + __popc(bal & ((1u << lane) - 1u))] = static_cast<unsigned char>(i);
      m += __popc(bal);
    }
    __syncwarp();
    if (PROFILE) prof.add(kPairsKept, m);
    prof.lap(kCyclesFilter);

    // --- the march (evaluateTransmittanceCUDA, sample_forward.cu:55-169) --
    for (int k = 0; k < m; ++k) {
      if (PROFILE ? __all_sync(kAll, done) : done) break;
      const int j = s_list[warp][k];
      const float4 qa = s.a[j], qb = s.b[j];
      const float dx = qa.x - px, dy = qa.y - py;
      const float power = pair_power(qa, qb, dx, dy);
      const bool hit = !done && power <= 0.f && power >= qb.z;
      if (PROFILE) {
        const unsigned live = __ballot_sync(kAll, !done);
        prof.add(kWarpPairs, 1);
        prof.add(kLanePairs, __popc(live));
        prof.add(kLanePairsStopped, __popc(__ballot_sync(kAll, active) & ~live));
      }
      if (!any<PROFILE>(hit)) {
        prof.lap(kCyclesAlpha);
        continue;
      }
      // the alpha test (blend_common.cuh:pair_alpha, past its power > 0 test)
      float alpha = 0.f;
      if (hit) alpha = fminf(p.alpha_clamp, qb.y * expf(power));
      bool on = hit && alpha >= p.alpha_min;
      if (PROFILE) prof.add(kWarpPairsTested, 1);
      if (!any<PROFILE>(on)) {
        prof.lap(kCyclesAlpha);
        continue;
      }
      const float om1 = 1.f - alpha;
      const float test_t = T * om1;
      if (on && test_t < p.t_min) {
        done = true;
        if (!PROFILE) break;
        on = false;
      }
      if (PROFILE) prof.add(kWarpPairsActive, __any_sync(kAll, on));
      prof.lap(kCyclesAlpha);
      // the pair is applied: median-depth init (the last applied pair whose
      // preceding T > 0.5) and its factor of T at the point
      bool near = false;
      if (on) {
        const float4 qc = s.c[j];
        const float t_peak = qc.x * dx + qc.y * dy + qc.z;
        if (T > 0.5f) md_init = t_peak;
        int band;
        tp *= band_factor(alpha, om1, et, t_peak, qb.w, band);
        if (PROFILE) ++applied[band];
        near = band == 2;
        last = b0 + j;
        T = test_t;
      }
      if (PROFILE) prof.add(kWarpPairsNear, __any_sync(kAll, near));
      prof.lap(kCyclesApply);
    }
  }
  if (PROFILE) {
#pragma unroll
    for (int b = 0; b < 4; ++b) prof.add(kAppliedFront + b, applied[b]);
  }
  if (active) {
    const size_t qs = static_cast<size_t>(p.q);
    float* o = p.out + qi;
    o[0] = tp;
    o[qs] = 1.f;
    o[2 * qs] = static_cast<float>(last + 1);
    o[3 * qs] = md_init;
    o[4 * qs] = T;
  }
  prof.lap(kCyclesSetup);
  prof.flush(p.counters, lane);
}

}  // namespace

// Launch on `stream` with `counters` (nullptr, or kCounters zeroed int64s
// the profiled instance adds to); returns cudaGetLastError() (0 = launched).
extern "C" int gsjax_integrate_fwd(const float* feats, const int* tile_start,
                                   const int* tile_count, const float* pts,
                                   const float* t_eval, const int* blocks,
                                   float* out, void* counters, int n_blocks, int q,
                                   int max_per_tile, float alpha_clamp,
                                   float alpha_min, float t_min, void* stream) {
  const IntegrateParams p{feats, tile_start, tile_count, pts, t_eval, blocks, out,
                          static_cast<unsigned long long*>(counters), q,
                          max_per_tile, alpha_clamp, alpha_min, t_min};
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.counters != nullptr)
    integrate_kernel<true><<<n_blocks, kThreads, 0, st>>>(p);
  else
    integrate_kernel<false><<<n_blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

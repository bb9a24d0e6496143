// Pieces shared by the backward kernels, the blend VJP (blend_bwd.cu, B2)
// and the point-query VJP (sample_bwd.cu, B5): the reduction of each pair's
// 16 payload-column terms over a block's pixels or points, and the profile
// counters that show where a warp's cycles go.
//
// The reduction, per window of kWin staged pairs (module note of each
// kernel for what a term is):
//   - each thread sums its own pixels' or point's terms in registers;
//   - the warp sums its 32 lanes by recursive halving (warp_reduce_16): 16
//     shuffles, column c landing on lanes 2c and 2c + 1, and an even lane
//     stores it in the warp's slot of the window's `part`;
//   - after one barrier the block adds the 8 warps' slots in a fixed order
//     (window_sum), one float4 of 4 columns a thread, and writes each pair's
//     row once. A warp that applied a pair sets its bit in `mask`; a slot
//     whose bit is clear is never read, so it needs no zeros.
// Every order is fixed, so the result is the same bit for bit from run to run.
#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace bwd {

using blend::kF;
using blend::kThreads;

constexpr int kWarps = kThreads / 32;
constexpr int kWin = 64;                  // pairs per window (the mask's bits)
constexpr unsigned kAll = 0xffffffffu;

// A window's shared memory: its pairs (4 KB) and each warp's sums (32 KB).
struct Window {
  float4 pairs[kWin][4];
  float4 part[kWarps][kWin][kF / 4];
  unsigned long long mask[kWarps];
};

// Pairs [b0, b0 + n) of the list starting at `start` into w.pairs, one float4
// a thread (n <= kWin: the block's 256 threads load the 4 KB coalesced).
__device__ __forceinline__ void stage_window(const float* feats, Window& w, int start,
                                             int b0, int n, int tid) {
  if (tid < 4 * n)
    (&w.pairs[0][0])[tid] = reinterpret_cast<const float4*>(
        feats + (static_cast<size_t>(start) + b0) * kF)[tid];
}

// One halving step with partner lane ^ H: of its live columns v[0, H) a lane
// keeps the upper half where its bit H is set and the lower half where it is
// clear, in v[0, H / 2), sends the other half and adds what its partner sent.
template <int H>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  constexpr int m = H / 2;
  const bool up = lane & H;
#pragma unroll
  for (int k = 0; k < m; ++k) {
    const float keep = up ? v[k + m] : v[k];
    const float send = up ? v[k] : v[k + m];
    v[k] = keep + __shfl_xor_sync(kAll, send, H);
  }
}

// Sums v[16] over the warp's lanes by recursive halving (H = 16, 8, 4, 2:
// 8 + 4 + 2 + 1 shuffles), then lanes 2c and 2c + 1 swap their one column
// (1 more). Column c = lane >> 1 is returned, the sum of all 32 lanes', by
// both of its lanes. v is consumed.
__device__ __forceinline__ float warp_reduce_16(float (&v)[16], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  return v[0] + __shfl_xor_sync(kAll, v[0], 1);
}

// The warp's sum of pair j's columns (warp_reduce_16) into its slot.
__device__ __forceinline__ void put_partial(Window& w, int warp, int j, int lane,
                                            float col_sum) {
  if (!(lane & 1)) reinterpret_cast<float*>(w.part[warp][j])[lane >> 1] = col_sum;
}

// Columns c4..c4+3 of pair j summed over the warps that applied it, in warp
// order.
__device__ __forceinline__ float4 window_sum(const Window& w, int j, int c4) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (!((w.mask[k] >> j) & 1)) continue;
    const float4 v = w.part[k][j][c4 / 4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

// Profile counters, filled where the caller passes a buffer (int64, zeroed;
// render_cuda.BWD_COUNTERS names them). A warp-pair is one warp's step over
// one staged pair; cycles are warp cycles (clock64), summed over warps.
enum Counter {
  kWarpPairs = 0,     // warp-pairs walked
  kWarpPairsActive,   // of which some lane applies the pair
  kLanesActive,       // applying lanes, summed over active warp-pairs
  kApplied,           // applied (pair, pixel or point) interactions
  kCyclesSetup,       // per-pixel / per-point setup and the block's list length
  kCyclesStage,       // staging the pairs and the block's barriers
  kCyclesAlpha,       // the alpha test and the skip of an inactive warp-pair
  kCyclesApply,       // the applied math: blend, median term, chain
  kCyclesReduce,      // the reduction over pixels / points and its writes
  kCounters
};

// One warp's counters in registers (lane 0's are published). ON = false
// compiles every call away: the kernels are templated on it, so the
// instance launched without a buffer carries no profiling code.
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
  // One warp-pair: `act` the lanes that apply it, `applied` this lane's
  // applied interactions; every lane of the warp calls it.
  __device__ __forceinline__ void pair(unsigned act, int applied) {
    if constexpr (ON) {
      const int total = __reduce_add_sync(kAll, applied);
      v[kWarpPairs] += 1;
      v[kWarpPairsActive] += act != 0;
      v[kLanesActive] += __popc(act);
      v[kApplied] += total;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* c, int lane) {
    if constexpr (ON) {
      if (lane != 0) return;
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (v[k]) atomicAdd(c + k, v[k]);
    }
  }
};

}  // namespace bwd

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
// What bounds it on an H100: operations, as in the forward. Each pair is
// read once per 16x16 block (64 bytes) and evaluated against every pixel of
// the block; a (pair, pixel) interaction costs the alpha test (~16 fp32
// operations with one exp) and, where the pair is applied, ~60 more for the
// blend and chain terms and ~30 with an exp for the median term. The reduce
// over pixels is the design's own cost: 16 warp sums (5 shuffles each) and
// 16 atomicAdds per (warp, pair) where any lane of the warp contributes.
//
// Design (the reference CUDA rasterizer's own form, render_backward.cu
// :716-1069, not the Pallas layout):
//   - one thread per pixel, a 32x32 binning tile as four 16x16 blocks; each
//     block walks its tile's list up to the largest n_contrib among its
//     pixels, staging 256 pairs at a time in shared memory (16 KB);
//   - each pixel re-derives its own T front to back (the forward's
//     multiplicative order) and applies the pairs before its n_contrib that
//     pass the alpha test, so a stopped pixel stays stopped;
//   - per pair, a warp with any contributing lane reduces its 16 columns with
//     __shfl_down_sync and lane 0 adds them into d_payload with atomicAdd
//     (zeroed by the caller); a warp with none skips the pair (__any_sync).
// Block-level reduction in shared memory and fewer atomics are later work.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

struct BwdParams {
  const float* feats;       // [K, 16] pair payload, tile-major, front to back
  const int* tile_start;    // [T] first pair of each tile
  const int* tile_count;    // [T] pairs of each tile (clamped here)
  const float* planes;      // [16, H, W] forward output
  const float* grad;        // [16, H, W] its cotangent (rows 0-7 read)
  const float* bg;          // [3]
  float* d_feats;           // [K, 16], zeroed by the caller
  int width, height, tiles_x, tile, max_per_tile, require_depth;
  float fx, fy, alpha_clamp, alpha_min;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const BwdParams p) {
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

  // --- per-pixel residuals and cotangent (render_pallas.py:856-894) --------
  int my_n = 0;
  float gc0 = 0.f, gc1 = 0.f, gc2 = 0.f, gn0 = 0.f, gn1 = 0.f, gn2 = 0.f;
  float s_q = 0.f, tf_gamma = 0.f, s_pix = 0.f, m_t = 0.f;
  if (inside) {
    const size_t hw = static_cast<size_t>(p.height) * p.width;
    const size_t o = static_cast<size_t>(pyi) * p.width + pxi;
    const float* r = p.planes + o;
    const float* g = p.grad + o;
    const float t_final = r[10 * hw];
    my_n = min(static_cast<int>(r[8 * hw]), count);
    const float has = r[8 * hw] > 0.f ? 1.f : 0.f;
    const float om = fmaxf(1.f - t_final, 1e-12f);
    const float inv_om = 1.f / om;
    gc0 = g[0];
    gc1 = g[hw];
    gc2 = g[2 * hw];
    const float g3 = g[3 * hw] * has, g4 = g[4 * hw] * has, g5 = g[5 * hw] * has;
    gn0 = g3 * inv_om;
    gn1 = g4 * inv_om;
    gn2 = g5 * inv_om;
    const float na0 = r[3 * hw] * om, na1 = r[4 * hw] * om, na2 = r[5 * hw] * om;
    const float ca0 = r[0] - t_final * p.bg[0];
    const float ca1 = r[hw] - t_final * p.bg[1];
    const float ca2 = r[2 * hw] - t_final * p.bg[2];
    const float gamma = -g[6 * hw] + p.bg[0] * gc0 + p.bg[1] * gc1 +
                        p.bg[2] * gc2 +
                        inv_om * inv_om * (g3 * na0 + g4 * na1 + g5 * na2);
    s_q = gc0 * ca0 + gc1 * ca1 + gc2 * ca2 + gn0 * na0 + gn1 * na1 + gn2 * na2;
    tf_gamma = t_final * gamma;
    if (p.require_depth && r[11 * hw] > 0.f) {
      const float pnx = (px - (p.width - 1.f) * 0.5f) / p.fx;
      const float pny = (py - (p.height - 1.f) * 0.5f) / p.fy;
      const float rln = rsqrtf(pnx * pnx + pny * pny + 1.f);
      m_t = r[7 * hw] / rln;
      const float d_den = r[12 * hw];
      s_pix = fabsf(d_den) > 1e-20f ? -g[7 * hw] * rln / d_den : 0.f;
    }
  }
  const int nmax = block_max(my_n, &s_max);
  const int lane = (threadIdx.y * kSide + threadIdx.x) & 31;

  // --- front-to-back re-traversal -------------------------------------------
  float T = 1.f, wq = 0.f;
  for (int b0 = 0; b0 < nmax; b0 += kBatch) {
    __syncthreads();                    // the previous batch is consumed
    const int n = min(kBatch, nmax - b0);
    stage(p.feats, s, start, b0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float d[kF];
#pragma unroll
      for (int k = 0; k < kF; ++k) d[k] = 0.f;
      float alpha, expp, dx, dy;
      const float4 q0 = s[j][0], q1 = s[j][1];
      const bool on = b0 + j < my_n &&
                      pair_alpha(p.alpha_clamp, p.alpha_min, q0, q1, px, py,
                                 alpha, expp, dx, dy);
      if (!__any_sync(0xffffffffu, on)) continue;
      if (on) {
        const float4 q2 = s[j][2], q3 = s[j][3];
        const float one_m = 1.f - alpha;
        const float w = alpha * T;
        const float q = q1.z * gc0 + q1.w * gc1 + q2.x * gc2 +
                        q3.y * gn0 + q3.z * gn1 + q3.w * gn2;
        wq += w * q;
        float d_a = T * q - (s_q - wq + tf_gamma) / one_m;
        float d_tp = 0.f;
        if (s_pix != 0.f) {
          // implicit median term (render_pallas._median_model, :925-941)
          const float rsig = q3.x;
          const float t_val = q2.y * dx + q2.z * dy + q2.w;
          const float delta = (m_t - t_val) * rsig;
          const float hg = rsig > 0.f ? expf(-0.5f * delta * delta) : 0.f;
          const float half_r = 0.5f / fmaxf(1.f - alpha * hg, 1e-12f);
          const bool behind = m_t > t_val;
          d_a += s_pix * (behind ? -1.f / one_m + half_r * hg : -half_r * hg);
          const float dlf_dg = (behind ? half_r : -half_r) * alpha;
          d_tp = s_pix * dlf_dg * hg * delta * rsig;
          d[12] = rsig > 0.f ? s_pix * dlf_dg * (-hg * delta * delta) / rsig : 0.f;
        }
        // chain alpha -> power / opacity (:966-970), power -> payload
        const bool notclamped = q1.y * expp < p.alpha_clamp;
        const float d_pow = notclamped ? d_a * alpha : 0.f;
        d[5] = notclamped ? d_a * expp : 0.f;
        d[0] = -d_pow * (q0.z * dx + q0.w * dy) + d_tp * q2.y;
        d[1] = -d_pow * (q1.x * dy + q0.w * dx) + d_tp * q2.z;
        d[2] = -0.5f * d_pow * dx * dx;
        d[3] = -d_pow * dx * dy;
        d[4] = -0.5f * d_pow * dy * dy;
        d[6] = w * gc0;
        d[7] = w * gc1;
        d[8] = w * gc2;
        d[9] = d_tp * dx;
        d[10] = d_tp * dy;
        d[11] = d_tp;
        d[13] = w * gn0;
        d[14] = w * gn1;
        d[15] = w * gn2;
        T *= one_m;
      }
      float* dst = p.d_feats + (static_cast<size_t>(start) + b0 + j) * kF;
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        const float v = warp_sum(d[k]);
        if (lane == 0 && v != 0.f) atomicAdd(dst + k, v);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsjax_blend_bwd(const float* feats, const int* tile_start,
                               const int* tile_count, const float* planes,
                               const float* grad, const float* bg,
                               float* d_feats, int width, int height,
                               int tiles_x, int tiles_y, int tile, float fx,
                               float fy, int max_per_tile, int require_depth,
                               float alpha_clamp, float alpha_min,
                               void* stream) {
  const BwdParams p{feats, tile_start, tile_count, planes, grad, bg, d_feats,
                    width, height, tiles_x, tile, max_per_tile, require_depth,
                    fx, fy, alpha_clamp, alpha_min};
  const int nsub = tile / kSide;
  const dim3 grid(tiles_x * nsub, tiles_y * nsub);
  const dim3 block(kSide, kSide);
  blend_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Bilinear samples of an image at warped tap positions, with their
// derivatives, for NVIDIA Hopper (sm_90a): the neighbour taps of the
// patch-warped NCC.
//
// Replaces the TPU kernel `gsjax/ops/warp_sample.py:_kernel` (reached through
// `_sample_call` / `warp_sample`). For each tap position (u, v) of [K, H, W]
// it returns, as [3, K, H, W] float32 planes, the bilinear sample of the
// [Hn, Wn] image and its derivatives d/du, d/dv, with the semantics of
// gsjax's off-TPU sampler `ncc._bilinear` (ncc.py:39-58): corner indices
// clamped to the image one by one, weights from the unclamped coordinate,
// and the derivative that autodiff of that formula gives (the floor has zero
// gradient, so a corner pair clamped to one pixel gives zero). No `ok` plane:
// the caller masks taps outside the image (ncc.py:165-167).
//
// The same kernel replaces the TPU kernel's second entry point,
// `warp_sample_blocks` (warp_sample.py:230), which runs that `pallas_call` on
// the taps [B, K, 256] of compacted 16x16 pixel blocks: positions of any
// shape reach it as n flat taps (`ops/warp_sample.py:warp_sample_blocks`).
//
// What bounds it on an H100: bytes. Each output element reads its two
// coordinates (8 bytes) and writes three values (12 bytes) for ~30 fp32
// operations; the four corner reads hit the image, which is small (8 MB at
// 1080p) and stays in the 50 MB L2.
//
// Design: one thread per (tap, pixel), a direct fp32 gather of the four
// corners. The TPU kernel's hat-weight contractions on the MXU over a bf16
// [48, 256] window exist because a TPU has no vector gather; a GPU gathers.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
warp_sample_kernel(const float* __restrict__ img, int h, int w,
                   const float* __restrict__ u, const float* __restrict__ v,
                   float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float uu = u[i], vv = v[i];
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float wu = uu - u0, wv = vv - v0;
  const float wmax = static_cast<float>(w - 1), hmax = static_cast<float>(h - 1);
  const int u0i = static_cast<int>(fminf(fmaxf(u0, 0.f), wmax));
  const int u1i = static_cast<int>(fminf(fmaxf(u0 + 1.f, 0.f), wmax));
  const int v0i = static_cast<int>(fminf(fmaxf(v0, 0.f), hmax));
  const int v1i = static_cast<int>(fminf(fmaxf(v0 + 1.f, 0.f), hmax));
  const float* r0 = img + static_cast<size_t>(v0i) * w;
  const float* r1 = img + static_cast<size_t>(v1i) * w;
  const float c00 = __ldg(r0 + u0i), c01 = __ldg(r0 + u1i);
  const float c10 = __ldg(r1 + u0i), c11 = __ldg(r1 + u1i);
  out[i] = (1.f - wv) * ((1.f - wu) * c00 + wu * c01) +
           wv * ((1.f - wu) * c10 + wu * c11);
  out[n + i] = (1.f - wv) * (c01 - c00) + wv * (c11 - c10);
  out[2 * n + i] = (1.f - wu) * (c10 - c00) + wu * (c11 - c01);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsjax_warp_sample(const float* img, int h, int w, const float* u,
                                 const float* v, float* out, long long n,
                                 void* stream) {
  const long long blocks = (n + 255) / 256;
  warp_sample_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(img, h, w, u, v,
                                                            out, n);
  return static_cast<int>(cudaGetLastError());
}

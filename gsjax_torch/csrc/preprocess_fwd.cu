// Per-gaussian preprocess forward, for NVIDIA Hopper (sm_90a): projection,
// 2D covariance with the Mip-Splatting dilation, RaDe-GS ray plane and
// normal, SH + SG colour and the tile footprint of every row, the twelve
// fields of `gsjax_torch/ops/raster/preprocess.py:Preprocessed`.
//
// Replaces no TPU kernel: gsjax's preprocess (`gsjax/ops/raster/
// preprocess.py`) is an XLA stage, which fuses it. In PyTorch the plain twin
// (`preprocess_ref`) runs as ~440 launches a view with 7 SG lobes and
// ~1,100-1,350 with its autograd VJP (`preprocess_bwd.cu` replaces that),
// which is why it is written by hand here.
//
// What bounds it on an H100: bytes. Each row is read once (means, scales,
// rotation, opacity and the alive flag: 45 B; SH: 12 B a band; SG: 28 B a
// lobe) and written once (93 B: 17 floats, 6 int32, one bool); ~400 fp32
// operations a row. tnt_truck (2^21 rows, SH 3): 2^21 x 330 B = 0.69 GB,
// 0.21 ms at 3.35 TB/s; m360_bicycle (2^22 rows, SH 2 + 7 lobes): 2^22 x
// 442 B = 1.85 GB, 0.55 ms.
//
// Design: one thread per row, nothing shared between rows and no atomics,
// so a launch on a shard of the rows gives the full launch's bits on those
// rows (the multi-device step's sharded preprocess). The arithmetic is the
// twin's op for op (`preprocess_common.cuh`), so the integer fields
// (radius, tile rect, tiles touched, valid) and every clamp and `where`
// come out on the twin's side. SH degree (0-3) and active SG lobes (0-7)
// are template parameters, chosen by the wrapper from the configuration.

#include "preprocess_common.cuh"

namespace {

struct FwdArgs {
  const float *means, *scales, *rots, *opac, *shs, *sg_axis, *sg_sharp, *sg_color;
  const unsigned char* alive;      // nullptr: every row alive
  float *mean2d, *depth, *conic, *opacity, *color, *ray_plane, *normal;
  int *radius, *rect_min, *rect_wh, *tiles_touched;
  unsigned char* valid;
  int n, bands, lobes;             // rows; SH bands and SG lobes stored per row
  pp::CamArgs cam;
};

template <int SH, int SG>
__global__ void __launch_bounds__(pp::kThreads) preprocess_fwd_kernel(const FwdArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const pp::Cam k = pp::load_cam(a.cam);
  const size_t row = i;
  pp::Row<SH> r;
  const bool alive = a.alive == nullptr || a.alive[i] != 0;
  pp::forward<SH, SG>(r, k, a.means + 3 * row, a.scales + 3 * row, a.rots + 4 * row,
                      a.opac + row, a.shs + row * a.bands * 3,
                      SG ? a.sg_axis + row * a.lobes * 3 : nullptr,
                      SG ? a.sg_sharp + row * a.lobes : nullptr,
                      SG ? a.sg_color + row * a.lobes * 3 : nullptr, alive);
  a.mean2d[2 * row] = r.px;
  a.mean2d[2 * row + 1] = r.py;
  a.depth[row] = r.valid ? r.tc : __int_as_float(0x7f800000);
  a.radius[row] = r.valid ? static_cast<int>(r.radius_f) : 0;
  for (int j = 0; j < 3; ++j) a.conic[3 * row + j] = r.conic[j];
  a.opacity[row] = pp::mul(r.op, r.mip);
  for (int c = 0; c < 3; ++c) a.color[3 * row + c] = pp::clamp_min(r.tcol[c], 0.0f);
  a.ray_plane[4 * row] = pp::mul(pp::mul(r.plane0, r.factor), k.rfx);
  a.ray_plane[4 * row + 1] = pp::mul(pp::mul(r.plane1, r.factor), k.rfy);
  a.ray_plane[4 * row + 2] = r.tc;
  a.ray_plane[4 * row + 3] = r.rsigma;
  for (int j = 0; j < 3; ++j) a.normal[3 * row + j] = r.normal[j];
  a.rect_min[2 * row] = r.rx_min;
  a.rect_min[2 * row + 1] = r.ry_min;
  a.rect_wh[2 * row] = r.rect_w;
  a.rect_wh[2 * row + 1] = r.rect_h;
  a.tiles_touched[row] = r.valid ? r.rect_w * r.rect_h : 0;
  a.valid[row] = r.valid;
}

template <int SH, int SG>
int launch(const FwdArgs& a, cudaStream_t s) {
  const int blocks = (a.n + pp::kThreads - 1) / pp::kThreads;
  preprocess_fwd_kernel<SH, SG><<<blocks, pp::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const FwdArgs&, cudaStream_t);
#define PP_ROW(S) {launch<S, 0>, launch<S, 1>, launch<S, 2>, launch<S, 3>, \
                   launch<S, 4>, launch<S, 5>, launch<S, 6>, launch<S, 7>}
const Launch kLaunch[4][8] = {PP_ROW(0), PP_ROW(1), PP_ROW(2), PP_ROW(3)};
#undef PP_ROW

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a degree the kernel has no instance of.
extern "C" int gsjax_preprocess_fwd(
    const float* means, const float* scales, const float* rots, const float* opac,
    const float* shs, const float* sg_axis, const float* sg_sharp, const float* sg_color,
    const unsigned char* alive, float* mean2d, float* depth, int* radius, float* conic,
    float* opacity, float* color, float* ray_plane, float* normal, int* rect_min,
    int* rect_wh, int* tiles_touched, unsigned char* valid, int n, int bands, int lobes,
    int sh_degree, int sg_degree, PP_CAM_PARAMS, void* stream) {
  if (sh_degree < 0 || sh_degree > 3 || sg_degree < 0 || sg_degree > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const FwdArgs a{means, scales, rots, opac, shs, sg_axis, sg_sharp, sg_color, alive,
                  mean2d, depth, conic, opacity, color, ray_plane, normal,
                  radius, rect_min, rect_wh, tiles_touched, valid, n, bands, lobes,
                  PP_CAM_ARGS};
  return kLaunch[sh_degree][sg_degree](a, static_cast<cudaStream_t>(stream));
}

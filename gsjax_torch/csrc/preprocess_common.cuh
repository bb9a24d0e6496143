// Per-gaussian preprocess, one row's forward, shared by `preprocess_fwd.cu`
// (which writes it) and `preprocess_bwd.cu` (which recomputes it from the
// inputs and differentiates it). The arithmetic is the plain twin's,
// `gsjax_torch/ops/raster/preprocess.py:preprocess_ref`, op for op as
// PyTorch runs it on the card, so that every integer field and every branch
// predicate comes out on the twin's side:
//   - one rounding per PyTorch op (`__fmul_rn`, `__fadd_rn`, ...: nvcc never
//     contracts these into an FMA, as it would `a * b + c`);
//   - a sum over a last axis of 3 is (x0 + x2) + x1, one of 4 (x0 + x2) +
//     (x1 + x3), and one over a middle axis (x0 + x1) + x2; a 2-norm of 3 is
//     sqrt((x0^2 + x2^2) + x1^2) and one of 4 sqrt((x0^2 + x2^2) + (x1^2 +
//     x3^2)): the orders of PyTorch's CUDA reduction (two lanes split a row
//     of 3 or 4; measured against torch 2.11 + cu128 on the H100);
//   - `scalar / tensor` is PyTorch's reciprocal times the scalar, and
//     `tensor / scalar` the tensor times the scalar's float reciprocal.
// The spherical-Gaussian dot products and lobe sums are cuBLAS products in
// the twin: their rounding is not reproduced (they feed only the colour).

#pragma once

#include <cuda_runtime.h>

namespace pp {

constexpr int kThreads = 128;

// The camera: its matrices stay on the device (no host read per call);
// every thread loads them through the read-only cache.
struct CamArgs {
  const float *world_view, *full_proj, *campos;   // [4, 4], [4, 4], [3]
  float fx, fy, limx, limy;   // limx = float(1.3 * tan_fovx), as torch.clamp takes it
  float near_plane, kernel_size, scale_modifier;
  float width, height, tile, tiles_x, tiles_y;
  float rfx, rfy;             // float(1 / fx): torch's tensor / scalar multiplies by it
};

struct Cam {
  float R[3][3], T[3];      // world_view[:3, :3], world_view[:3, 3]
  float F[4][3], Ft[4];     // full_proj[:, :3], full_proj[:, 3]
  float campos[3];
  float fx, fy, limx, limy, near_plane, kernel_size, scale_modifier;
  float width, height, tile, tiles_x, tiles_y, rfx, rfy;
};

__device__ __forceinline__ Cam load_cam(const CamArgs& c) {
  Cam k;
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) k.R[r][j] = __ldg(c.world_view + 4 * r + j);
    k.T[r] = __ldg(c.world_view + 4 * r + 3);
  }
  for (int r = 0; r < 4; ++r) {
    for (int j = 0; j < 3; ++j) k.F[r][j] = __ldg(c.full_proj + 4 * r + j);
    k.Ft[r] = __ldg(c.full_proj + 4 * r + 3);
  }
  for (int j = 0; j < 3; ++j) k.campos[j] = __ldg(c.campos + j);
  k.fx = c.fx; k.fy = c.fy; k.limx = c.limx; k.limy = c.limy;
  k.near_plane = c.near_plane; k.kernel_size = c.kernel_size;
  k.scale_modifier = c.scale_modifier; k.width = c.width; k.height = c.height;
  k.tile = c.tile; k.tiles_x = c.tiles_x; k.tiles_y = c.tiles_y;
  k.rfx = c.rfx; k.rfy = c.rfy;
  return k;
}

// the C entry points' camera arguments, in this order
#define PP_CAM_PARAMS const float *world_view, const float *full_proj, const float *campos, \
    float fx, float fy, float limx, float limy, float near_plane, float kernel_size,   \
    float scale_modifier, int width, int height, int tile, int tiles_x, int tiles_y
#define PP_CAM_ARGS pp::CamArgs{world_view, full_proj, campos, fx, fy, limx, limy,        \
    near_plane, kernel_size, scale_modifier, static_cast<float>(width),                 \
    static_cast<float>(height), static_cast<float>(tile), static_cast<float>(tiles_x),  \
    static_cast<float>(tiles_y), 1.0f / fx, 1.0f / fy}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, c), b); }
__device__ __forceinline__ float sum3_mid(float a, float b, float c) { return add(add(a, b), c); }
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return add(add(a, c), add(b, d));
}
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqr(add(add(mul(a, a), mul(c, c)), mul(b, b)));
}
__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return sqr(add(add(mul(a, a), mul(c, c)), add(mul(b, b), mul(d, d))));
}
// torch.clamp_min / torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// rowwise.affine: ((x0 m0 + x1 m1) + x2 m2) + t
__device__ __forceinline__ float affine(const float* x, const float* m, float t) {
  return add(add(add(mul(x[0], m[0]), mul(x[1], m[1])), mul(x[2], m[2])), t);
}

// the SH constants as the twin's Python floats, rounded to float
#define PP_F(x) static_cast<float>(x)
__device__ __forceinline__ float shc0() { return PP_F(0.28209479177387814); }
__device__ __forceinline__ float shc1() { return PP_F(0.4886025119029199); }
__device__ __forceinline__ float shc2(int i) {
  return i == 0 ? PP_F(1.0925484305920792) : i == 1 ? PP_F(-1.0925484305920792)
       : i == 2 ? PP_F(0.31539156525252005) : i == 3 ? PP_F(-1.0925484305920792)
       : PP_F(0.5462742152960396);
}
__device__ __forceinline__ float shc3(int i) {
  return i == 0 ? PP_F(-0.5900435899266435) : i == 1 ? PP_F(2.890611442640554)
       : i == 2 ? PP_F(-0.4570457994644658) : i == 3 ? PP_F(0.3731763325901154)
       : i == 4 ? PP_F(-0.4570457994644658) : i == 5 ? PP_F(1.445305721320277)
       : PP_F(-0.5900435899266435);
}
#undef PP_F

// One row's forward: every value the outputs and the VJP read.
template <int SH>
struct Row {
  // inputs
  float x[3], rot[4], sc[3], op;
  // projection
  float pv[3], tz, ph0, ph1, den, pp0, pp1, tz_s, tc;
  float u_raw, v_raw, u, v, txc, tyc, l;
  bool in_front;
  // covariance
  float qn, qd, q[4], Rg[3][3], s[3], ss[3], RS[3][3], Sc[3][3], V[3][3], Si[3][3];
  float rtz, j00, j11, tz2, num02, j02, num12, j12, sa0[3], sa1[3];
  float cxx, cxy, cyy, draw_pre, det_raw, covx, covy, covz, det, det_dil, mip;
  bool det_ok;
  float det_s, conic[3], radius_f, px, py;
  int rx_min, ry_min, rect_w, rect_h;
  bool valid;
  // ray plane and normal
  float mv[3], vb, vb_s, rl2, factor, p0n, plane0, p1n, plane1, w, rsigma;
  float rnv0, rnv1, n[3], nn, nd, normal[3];
  // appearance
  float dv[3], dn, dd, dirs[3], f[16], tcol[3];
};

// rect of the twin: clamp(floor(v / tile), 0, hi) to int32 (NaN -> 0)
__device__ __forceinline__ int rect(float v, float tile, float hi) {
  return static_cast<int>(clamp(floorf(mul(v, 1.0f / tile)), 0.0f, hi));
}

// SH basis factors as the twin forms them (`f[k]` multiplies sh[:, k]; the
// sign of bands 1 and 3 is the twin's subtraction)
template <int SH>
__device__ __forceinline__ void sh_factors(const float* d, float* f) {
  f[0] = shc0();
  if (SH > 0) {
    const float x = d[0], y = d[1], z = d[2];
    f[1] = mul(shc1(), y);
    f[2] = mul(shc1(), z);
    f[3] = mul(shc1(), x);
    if (SH > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      f[4] = mul(shc2(0), xy);
      f[5] = mul(shc2(1), yz);
      f[6] = mul(shc2(2), sub(sub(mul(2.0f, zz), xx), yy));
      f[7] = mul(shc2(3), xz);
      f[8] = mul(shc2(4), sub(xx, yy));
      if (SH > 2) {
        f[9] = mul(mul(shc3(0), y), sub(mul(3.0f, xx), yy));
        f[10] = mul(mul(shc3(1), xy), z);
        f[11] = mul(mul(shc3(2), y), sub(sub(mul(4.0f, zz), xx), yy));
        f[12] = mul(mul(shc3(3), z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
        f[13] = mul(mul(shc3(4), x), sub(sub(mul(4.0f, zz), xx), yy));
        f[14] = mul(mul(shc3(5), z), sub(xx, yy));
        f[15] = mul(mul(shc3(6), x), sub(xx, mul(3.0f, yy)));
      }
    }
  }
}

// eval_sh for one channel: the twin's left-to-right sums
template <int SH>
__device__ __forceinline__ float sh_channel(const float* f, const float* sh, int c) {
  float r = mul(f[0], __ldg(sh + c));
  if (SH > 0) {
    r = sub(add(sub(r, mul(f[1], __ldg(sh + 3 + c))), mul(f[2], __ldg(sh + 6 + c))),
            mul(f[3], __ldg(sh + 9 + c)));
    if (SH > 1) {
#pragma unroll
      for (int k = 4; k < 9; ++k) r = add(r, mul(f[k], __ldg(sh + 3 * k + c)));
      if (SH > 2) {
#pragma unroll
        for (int k = 9; k < 16; ++k) r = add(r, mul(f[k], __ldg(sh + 3 * k + c)));
      }
    }
  }
  return r;
}

// One SG lobe exp(sharpness (axis . dirs - 1)), with explicit FMAs so that
// the forward and the VJP's recomputation give the same bits.
__device__ __forceinline__ float sg_lobe(const float* axis, float sharp, const float* dirs,
                                         float& cosg) {
  cosg = fmaf(__ldg(axis + 2), dirs[2], fmaf(__ldg(axis + 1), dirs[1], mul(__ldg(axis), dirs[0])));
  return expf(mul(sharp, sub(cosg, 1.0f)));
}

// The whole forward of row `i`. `sg_*` point at the row's first lobe.
template <int SH, int SG>
__device__ __forceinline__ void forward(Row<SH>& r, const Cam& k, const float* means,
                                        const float* scales, const float* rots,
                                        const float* opac, const float* shs,
                                        const float* sg_axis, const float* sg_sharp,
                                        const float* sg_color, bool alive) {
  for (int j = 0; j < 3; ++j) r.x[j] = __ldg(means + j);
  for (int j = 0; j < 3; ++j) r.sc[j] = __ldg(scales + j);
  for (int j = 0; j < 4; ++j) r.rot[j] = __ldg(rots + j);
  r.op = __ldg(opac);

  // --- view / clip transforms ---------------------------------------------
  for (int a = 0; a < 3; ++a) r.pv[a] = affine(r.x, k.R[a], k.T[a]);
  r.tz = r.pv[2];
  r.in_front = r.tz > k.near_plane;
  r.ph0 = affine(r.x, k.F[0], k.Ft[0]);
  r.ph1 = affine(r.x, k.F[1], k.Ft[1]);
  const float pw = affine(r.x, k.F[3], k.Ft[3]);
  r.den = add(pw, 1e-7f);
  r.pp0 = dvd(r.ph0, r.den);
  r.pp1 = dvd(r.ph1, r.den);
  r.tz_s = r.in_front ? r.tz : 1.0f;
  r.tc = norm3(r.pv[0], r.pv[1], r.pv[2]);
  r.u_raw = dvd(r.pv[0], r.tz_s);
  r.v_raw = dvd(r.pv[1], r.tz_s);
  r.u = clamp(r.u_raw, -k.limx, k.limx);
  r.v = clamp(r.v_raw, -k.limy, k.limy);
  r.txc = mul(r.u, r.tz_s);
  r.tyc = mul(r.v, r.tz_s);
  r.l = sqr(add(add(mul(r.txc, r.txc), mul(r.tyc, r.tyc)), mul(r.tz_s, r.tz_s)));

  // --- world covariance and camera-frame inverse ----------------------------
  r.qn = norm4(r.rot[0], r.rot[1], r.rot[2], r.rot[3]);
  r.qd = clamp_min(r.qn, 1e-12f);
  for (int j = 0; j < 4; ++j) r.q[j] = dvd(r.rot[j], r.qd);
  {
    const float w = r.q[0], x = r.q[1], y = r.q[2], z = r.q[3];
    r.Rg[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
    r.Rg[0][1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
    r.Rg[0][2] = mul(2.0f, add(mul(x, z), mul(w, y)));
    r.Rg[1][0] = mul(2.0f, add(mul(x, y), mul(w, z)));
    r.Rg[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
    r.Rg[1][2] = mul(2.0f, sub(mul(y, z), mul(w, x)));
    r.Rg[2][0] = mul(2.0f, sub(mul(x, z), mul(w, y)));
    r.Rg[2][1] = mul(2.0f, add(mul(y, z), mul(w, x)));
    r.Rg[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  }
  for (int j = 0; j < 3; ++j) {
    r.s[j] = mul(r.sc[j], k.scale_modifier);
    r.ss[j] = clamp_min(r.s[j], 1e-12f);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.RS[i][j] = mul(r.Rg[i][j], r.s[j]);
  float Sw[3][3], tmp[3][3];
  for (int i = 0; i < 3; ++i)
    for (int m = 0; m < 3; ++m)
      Sw[i][m] = sum3(mul(r.RS[i][0], r.RS[m][0]), mul(r.RS[i][1], r.RS[m][1]),
                      mul(r.RS[i][2], r.RS[m][2]));
  for (int a = 0; a < 3; ++a)
    for (int i = 0; i < 3; ++i)
      tmp[a][i] = sum3(mul(k.R[a][0], Sw[i][0]), mul(k.R[a][1], Sw[i][1]),
                       mul(k.R[a][2], Sw[i][2]));
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      r.Sc[a][b] = sum3(mul(tmp[a][0], k.R[b][0]), mul(tmp[a][1], k.R[b][1]),
                        mul(tmp[a][2], k.R[b][2]));
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 3; ++j)
      r.V[a][j] = dvd(sum3_mid(mul(k.R[a][0], r.Rg[0][j]), mul(k.R[a][1], r.Rg[1][j]),
                               mul(k.R[a][2], r.Rg[2][j])), r.ss[j]);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      r.Si[a][b] = sum3(mul(r.V[a][0], r.V[b][0]), mul(r.V[a][1], r.V[b][1]),
                        mul(r.V[a][2], r.V[b][2]));

  // --- 2D covariance by the EWA Jacobian at the fov-clamped point ------------
  r.rtz = __frcp_rn(r.tz_s);
  r.j00 = mul(r.rtz, k.fx);
  r.j11 = mul(r.rtz, k.fy);
  r.tz2 = mul(r.tz_s, r.tz_s);
  r.num02 = mul(-k.fx, r.txc);
  r.j02 = dvd(r.num02, r.tz2);
  r.num12 = mul(-k.fy, r.tyc);
  r.j12 = dvd(r.num12, r.tz2);
  const float A0[3] = {r.j00, 0.0f, r.j02}, A1[3] = {0.0f, r.j11, r.j12};
  for (int a = 0; a < 3; ++a) {
    r.sa0[a] = sum3(mul(r.Sc[a][0], A0[0]), mul(r.Sc[a][1], A0[1]), mul(r.Sc[a][2], A0[2]));
    r.sa1[a] = sum3(mul(r.Sc[a][0], A1[0]), mul(r.Sc[a][1], A1[1]), mul(r.Sc[a][2], A1[2]));
  }
  r.cxx = sum3(mul(A0[0], r.sa0[0]), mul(A0[1], r.sa0[1]), mul(A0[2], r.sa0[2]));
  r.cxy = sum3(mul(A0[0], r.sa1[0]), mul(A0[1], r.sa1[1]), mul(A0[2], r.sa1[2]));
  r.cyy = sum3(mul(A1[0], r.sa1[0]), mul(A1[1], r.sa1[1]), mul(A1[2], r.sa1[2]));
  r.draw_pre = sub(mul(r.cxx, r.cyy), mul(r.cxy, r.cxy));
  r.det_raw = clamp_min(r.draw_pre, 1e-6f);
  r.covx = add(r.cxx, k.kernel_size);
  r.covy = r.cxy;
  r.covz = add(r.cyy, k.kernel_size);
  r.det = sub(mul(r.covx, r.covz), mul(r.covy, r.covy));
  r.det_dil = clamp_min(r.det, 1e-6f);
  r.mip = sqr(dvd(r.det_raw, r.det_dil));
  r.det_ok = r.det > 0.0f;
  r.det_s = r.det_ok ? r.det : 1.0f;
  r.conic[0] = dvd(r.covz, r.det_s);
  r.conic[1] = dvd(-r.covy, r.det_s);
  r.conic[2] = dvd(r.covx, r.det_s);

  // --- screen footprint -----------------------------------------------------
  const float mid = mul(0.5f, add(r.covx, r.covz));
  const float lam = add(mid, sqr(clamp_min(sub(mul(mid, mid), r.det_s), 0.1f)));
  r.radius_f = ceilf(mul(3.0f, sqr(lam)));
  r.px = mul(sub(mul(add(r.pp0, 1.0f), k.width), 1.0f), 0.5f);
  r.py = mul(sub(mul(add(r.pp1, 1.0f), k.height), 1.0f), 0.5f);
  r.rx_min = rect(sub(r.px, r.radius_f), k.tile, k.tiles_x);
  r.ry_min = rect(sub(r.py, r.radius_f), k.tile, k.tiles_y);
  const int rx_max = rect(sub(add(add(r.px, r.radius_f), k.tile), 1.0f), k.tile, k.tiles_x);
  const int ry_max = rect(sub(add(add(r.py, r.radius_f), k.tile), 1.0f), k.tile, k.tiles_y);
  r.rect_w = rx_max - r.rx_min;
  r.rect_h = ry_max - r.ry_min;
  r.valid = r.in_front && r.det_ok && (r.rect_w * r.rect_h > 0) && alive;

  // --- RaDe-GS ray plane and normal -------------------------------------------
  for (int a = 0; a < 3; ++a)
    r.mv[a] = sum3(mul(r.Si[a][0], r.u), mul(r.Si[a][1], r.v), mul(r.Si[a][2], 1.0f));
  r.vb = sum3(mul(r.mv[0], r.u), mul(r.mv[1], r.v), mul(r.mv[2], 1.0f));
  r.vb_s = fabsf(r.vb) > 1e-20f ? r.vb : 1e-20f;
  r.rl2 = add(add(mul(r.u, r.u), mul(r.v, r.v)), 1.0f);
  r.factor = dvd(r.l, r.rl2);
  r.p0n = sub(mul(add(mul(r.v, r.v), 1.0f), r.mv[0]), mul(mul(r.u, r.v), r.mv[1]));
  r.plane0 = dvd(r.p0n, r.vb_s);
  r.p1n = add(mul(mul(-r.u, r.v), r.mv[0]), mul(add(mul(r.u, r.u), 1.0f), r.mv[1]));
  r.plane1 = dvd(r.p1n, r.vb_s);
  const bool vb_pos = r.vb > 0.0f;
  r.w = dvd(vb_pos ? r.vb : 1.0f, r.rl2);
  r.rsigma = vb_pos ? sqr(r.w) : 0.0f;
  r.rnv0 = mul(-r.plane0, r.factor);
  r.rnv1 = mul(-r.plane1, r.factor);
  r.n[0] = add(dvd(r.rnv0, r.tz_s), dvd(r.txc, r.tz2));
  r.n[1] = add(dvd(r.rnv1, r.tz_s), dvd(r.tyc, r.tz2));
  r.n[2] = dvd(sub(add(mul(r.rnv0, r.txc), mul(r.rnv1, r.tyc)), r.tz_s), r.l);
  r.nn = norm3(r.n[0], r.n[1], r.n[2]);
  r.nd = clamp_min(r.nn, 1e-12f);
  for (int j = 0; j < 3; ++j) r.normal[j] = dvd(r.n[j], r.nd);

  // --- appearance -------------------------------------------------------------
  for (int j = 0; j < 3; ++j) r.dv[j] = sub(r.x[j], k.campos[j]);
  r.dn = norm3(r.dv[0], r.dv[1], r.dv[2]);
  r.dd = clamp_min(r.dn, 1e-12f);
  for (int j = 0; j < 3; ++j) r.dirs[j] = dvd(r.dv[j], r.dd);
  sh_factors<SH>(r.dirs, r.f);
  float sgc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < SG; ++g) {
    float cosg;
    const float lobe = sg_lobe(sg_axis + 3 * g, __ldg(sg_sharp + g), r.dirs, cosg);
    for (int c = 0; c < 3; ++c) sgc[c] = fmaf(lobe, __ldg(sg_color + 3 * g + c), sgc[c]);
  }
  for (int c = 0; c < 3; ++c) {
    float col = sh_channel<SH>(r.f, shs, c);
    if (SG > 0) col = add(col, sgc[c]);
    r.tcol[c] = add(col, 0.5f);
  }
}

}  // namespace pp

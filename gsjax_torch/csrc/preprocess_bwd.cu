// VJP of the per-gaussian preprocess (`preprocess_fwd.cu`), for NVIDIA
// Hopper (sm_90a): the cotangents of mean2d, depth, conic, opacity, colour,
// ray plane and normal -> the gradients of means, scales, rotations,
// opacities, SH coefficients and the SG axes, sharpness and colours, each
// written once.
//
// Replaces no TPU kernel: gsjax takes this VJP by XLA autodiff of its
// preprocess stage; the port's plain twin takes it by torch autograd, most of
// the twin's ~1,900-2,150 small launches a training step, on the autograd
// engine's thread.
//
// What bounds it on an H100: bytes. Each row reads its inputs (as the
// forward) and its 17 cotangents (68 B) and writes its gradients (as many
// bytes as its inputs but the alive flag); ~1,500 fp32 operations a row.
// tnt_truck (2^21 rows, SH 3): 2^21 x 541 B = 1.13 GB, 0.34 ms at 3.35 TB/s;
// m360_bicycle (2^22 rows, SH 2 + 7 lobes): 2^22 x 765 B = 3.21 GB, 0.96 ms.
//
// Design: one thread per row, no atomics, nothing shared between rows. The
// thread recomputes the row's forward from the inputs in registers with the
// forward's own code (`preprocess_common.cuh`), so the autograd Function
// keeps only the inputs, not the twin's [N, 3, 3] temporaries. A dead row
// (alive false) and a row whose cotangents are all zero write exact zeros.
//
// The contract: autograd's support, not only its values. Adam's first
// update moves every element whose gradient is not exactly zero by a whole
// learning rate, so this VJP cuts the chain exactly where the twin's graph
// cuts it, with the predicate torch's backward uses, on forward values that
// carry the twin's bits:
//   - torch.clamp passes the gradient where lo <= x <= hi (the u and v clamps
//     at +-1.3 tan(fov)); torch.clamp_min where x >= lo (the scales'
//     1e-12, det_raw's and det_dil's 1e-6, the norms' 1e-12, the colour's 0
//     per channel);
//   - `where`: tz_safe (in front), det_safe (det > 0), vb_safe (|vb| > 1e-20),
//     rsigma (vb > 0), depth (valid);
//   - a norm's own backward is zero where the norm is zero;
//   - lam's clamp and the tile rect carry no gradient (ceil, floor);
//   - the SH bands past the degree and the SG lobes past the active count
//     get exact zeros, as slices the twin's graph never reads.
// Past those predicates, the chains that reach the scales, the rotation
// and the opacity replay autograd's graph of the twin bit for bit (see the
// kernel): a rotation gradient that is round-off alone, as along the
// in-plane turn of a gaussian with two equal scales, has the twin's zeros
// only if it has the twin's bits. The means and the colour leaves follow
// autograd's local formulas in plain float32: their gradients are no
// round-off, so their zeros are the predicates' alone.

#include "preprocess_common.cuh"

namespace {

struct Cot {
  const float* p;
  long long row, col;   // strides in elements (a column slice of the payload's gradient)
};

struct BwdArgs {
  const float *means, *scales, *rots, *opac, *shs, *sg_axis, *sg_sharp, *sg_color;
  const unsigned char* alive;
  Cot g_mean2d, g_depth, g_conic, g_opacity, g_color, g_ray_plane, g_normal;
  float *d_means, *d_scales, *d_rots, *d_rots_norm, *d_opac, *d_shs, *d_sg_axis, *d_sg_sharp,
      *d_sg_color;
  int n, bands, lobes;
  pp::CamArgs cam;
};

__device__ __forceinline__ void load(const Cot& c, size_t row, int w, float* out) {
  for (int j = 0; j < w; ++j) out[j] = c.p ? c.p[row * c.row + j * c.col] : 0.0f;
}

__device__ __forceinline__ void put(float* p, size_t off, const float* v, int w) {
  if (p)
    for (int j = 0; j < w; ++j) p[off + j] = v[j];
}

__device__ __forceinline__ void zero(float* p, size_t off, int w) {
  if (p)
    for (int j = 0; j < w; ++j) p[off + j] = 0.0f;
}

__device__ void write_zeros(const BwdArgs& a, size_t row) {
  zero(a.d_means, 3 * row, 3);
  zero(a.d_scales, 3 * row, 3);
  zero(a.d_rots, 4 * row, 4);
  zero(a.d_rots_norm, 4 * row, 4);
  zero(a.d_opac, row, 1);
  zero(a.d_shs, row * a.bands * 3, a.bands * 3);
  zero(a.d_sg_axis, row * a.lobes * 3, a.lobes * 3);
  zero(a.d_sg_sharp, row * a.lobes, a.lobes);
  zero(a.d_sg_color, row * a.lobes * 3, a.lobes * 3);
}

template <int SH, int SG>
__global__ void __launch_bounds__(pp::kThreads) preprocess_bwd_kernel(const BwdArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t row = i;
  float gm[2], gd[1], gcn[3], gop[1], gc[3], grp[4], gn[3];
  load(a.g_mean2d, row, 2, gm);
  load(a.g_depth, row, 1, gd);
  load(a.g_conic, row, 3, gcn);
  load(a.g_opacity, row, 1, gop);
  load(a.g_color, row, 3, gc);
  load(a.g_ray_plane, row, 4, grp);
  load(a.g_normal, row, 3, gn);
  const bool alive = a.alive == nullptr || a.alive[i] != 0;
  const bool any = gm[0] != 0.f || gm[1] != 0.f || gd[0] != 0.f || gcn[0] != 0.f ||
                   gcn[1] != 0.f || gcn[2] != 0.f || gop[0] != 0.f || gc[0] != 0.f ||
                   gc[1] != 0.f || gc[2] != 0.f || grp[0] != 0.f || grp[1] != 0.f ||
                   grp[2] != 0.f || grp[3] != 0.f || gn[0] != 0.f || gn[1] != 0.f ||
                   gn[2] != 0.f;
  if (!alive || !any) {
    write_zeros(a, row);
    return;
  }
  const pp::Cam k = pp::load_cam(a.cam);
  const float* shs = a.shs + row * a.bands * 3;
  const float* sg_axis = SG ? a.sg_axis + row * a.lobes * 3 : nullptr;
  const float* sg_sharp = SG ? a.sg_sharp + row * a.lobes : nullptr;
  const float* sg_color = SG ? a.sg_color + row * a.lobes * 3 : nullptr;
  pp::Row<SH> r;
  pp::forward<SH, SG>(r, k, a.means + 3 * row, a.scales + 3 * row, a.rots + 4 * row,
                      a.opac + row, shs, sg_axis, sg_sharp, sg_color, alive);

  float g_x[3] = {0.f, 0.f, 0.f};

  // --- appearance: colour = clamp_min(sh + sg + 0.5, 0) ------------------------
  float gcol[3];
  for (int c = 0; c < 3; ++c) gcol[c] = r.tcol[c] >= 0.0f ? gc[c] : 0.0f;
  float g_dirs[3] = {0.f, 0.f, 0.f};
  if (a.d_shs) {
    const size_t o = row * a.bands * 3;
    constexpr int used = (SH + 1) * (SH + 1);
#pragma unroll
    for (int b = 0; b < used; ++b)
      for (int c = 0; c < 3; ++c)   // bands 1 and 3 enter the twin's sum with a minus sign
        a.d_shs[o + 3 * b + c] = gcol[c] * ((b == 1 || b == 3) ? -r.f[b] : r.f[b]);
    zero(a.d_shs, o + 3 * used, 3 * (a.bands - used));
  }
  if (SH > 0) {
    float w[16];
    for (int b = 1; b < (SH + 1) * (SH + 1); ++b)
      w[b] = gcol[0] * __ldg(shs + 3 * b) + gcol[1] * __ldg(shs + 3 * b + 1)
             + gcol[2] * __ldg(shs + 3 * b + 2);
    const float x = r.dirs[0], y = r.dirs[1], z = r.dirs[2];
    const float c1 = pp::shc1();
    g_dirs[1] -= c1 * w[1];
    g_dirs[2] += c1 * w[2];
    g_dirs[0] -= c1 * w[3];
    if (SH > 1) {
      const float c20 = pp::shc2(0), c21 = pp::shc2(1), c22 = pp::shc2(2), c23 = pp::shc2(3),
                  c24 = pp::shc2(4);
      g_dirs[0] += w[4] * c20 * y + w[6] * c22 * (-2.f * x) + w[7] * c23 * z + w[8] * c24 * 2.f * x;
      g_dirs[1] += w[4] * c20 * x + w[5] * c21 * z + w[6] * c22 * (-2.f * y) - w[8] * c24 * 2.f * y;
      g_dirs[2] += w[5] * c21 * y + w[6] * c22 * 4.f * z + w[7] * c23 * x;
      if (SH > 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float c30 = pp::shc3(0), c31 = pp::shc3(1), c32 = pp::shc3(2), c33 = pp::shc3(3),
                    c34 = pp::shc3(4), c35 = pp::shc3(5), c36 = pp::shc3(6);
        g_dirs[0] += w[9] * c30 * 6.f * x * y + w[10] * c31 * y * z
                     + w[11] * c32 * (-2.f * x * y) + w[12] * c33 * (-6.f * x * z)
                     + w[13] * c34 * (4.f * zz - 3.f * xx - yy) + w[14] * c35 * 2.f * x * z
                     + w[15] * c36 * (3.f * xx - 3.f * yy);
        g_dirs[1] += w[9] * c30 * (3.f * xx - 3.f * yy) + w[10] * c31 * x * z
                     + w[11] * c32 * (4.f * zz - xx - 3.f * yy) + w[12] * c33 * (-6.f * y * z)
                     + w[13] * c34 * (-2.f * x * y) + w[14] * c35 * (-2.f * y * z)
                     + w[15] * c36 * (-6.f * x * y);
        g_dirs[2] += w[10] * c31 * x * y + w[11] * c32 * 8.f * y * z
                     + w[12] * c33 * (6.f * zz - 3.f * xx - 3.f * yy) + w[13] * c34 * 8.f * x * z
                     + w[14] * c35 * (xx - yy);
      }
    }
  }
  if (SG > 0) {
#pragma unroll
    for (int g = 0; g < SG; ++g) {
      const float ax[3] = {__ldg(sg_axis + 3 * g), __ldg(sg_axis + 3 * g + 1),
                           __ldg(sg_axis + 3 * g + 2)};
      const float sharp = __ldg(sg_sharp + g);
      float cosg;
      const float lobe = pp::sg_lobe(sg_axis + 3 * g, sharp, r.dirs, cosg);
      const float col[3] = {__ldg(sg_color + 3 * g), __ldg(sg_color + 3 * g + 1),
                            __ldg(sg_color + 3 * g + 2)};
      const float gl = gcol[0] * col[0] + gcol[1] * col[1] + gcol[2] * col[2];
      const float darg = gl * lobe;
      const float dcos = darg * sharp;
      if (a.d_sg_color) {
        const float v[3] = {gcol[0] * lobe, gcol[1] * lobe, gcol[2] * lobe};
        put(a.d_sg_color, (row * a.lobes + g) * 3, v, 3);
      }
      if (a.d_sg_sharp) a.d_sg_sharp[row * a.lobes + g] = darg * (cosg - 1.0f);
      if (a.d_sg_axis) {
        const float v[3] = {dcos * r.dirs[0], dcos * r.dirs[1], dcos * r.dirs[2]};
        put(a.d_sg_axis, (row * a.lobes + g) * 3, v, 3);
      }
      for (int j = 0; j < 3; ++j) g_dirs[j] += dcos * ax[j];
    }
  }
  for (int g = SG; g < a.lobes; ++g) {
    zero(a.d_sg_color, (row * a.lobes + g) * 3, 3);
    zero(a.d_sg_sharp, row * a.lobes + g, 1);
    zero(a.d_sg_axis, (row * a.lobes + g) * 3, 3);
  }
  {  // dirs = dv / clamp_min(|dv|, 1e-12)
    float d_dd = 0.f;
    for (int j = 0; j < 3; ++j) {
      g_x[j] += g_dirs[j] / r.dd;
      d_dd -= g_dirs[j] * (r.dirs[j] / r.dd);
    }
    if (r.dn >= 1e-12f && r.dn != 0.f)
      for (int j = 0; j < 3; ++j) g_x[j] += d_dd * (r.dv[j] / r.dn);
  }

  // --- the covariance, ray-plane and normal chains and the rotation ----------
  // Autograd's graph of the twin replayed op by op: one rounding per op, the
  // local forms of torch's derivative formulas, the sums of a broadcast
  // gradient in PyTorch's CUDA order (`pp::sum3_mid` over a middle axis,
  // `pp::sum3` / `pp::sum4` over a last one), and a tensor's gradients added
  // in the engine's order, its latest consumer's first. The comments name the
  // twin's nodes ("Mul#n": the n-th of its forward, as `grad_fn`'s sequence
  // numbers give them). A gaussian with two equal scales has no gradient
  // along its in-plane turn, and one on the ground plane (quaternion (w, 0,
  // 0, z)) none in w and z: round-off is all there is there, and only these
  // bits give it the twin's zeros.
  using pp::add;
  using pp::dvd;
  using pp::mul;
  using pp::sum3;
  using pp::sum3_mid;
  // opacity = opacities * mip (Mul#376), mip = sqrt(det_raw / det_dil)
  const float d_op = mul(gop[0], r.mip);
  const float d_ratio = dvd(mul(gop[0], r.op), mul(2.f, r.mip));
  const float d_draw = r.draw_pre >= 1e-6f ? dvd(d_ratio, r.det_dil) : 0.f;
  const float d_ddil =
      r.det >= 1e-6f ? mul(-d_ratio, dvd(dvd(r.det_raw, r.det_dil), r.det_dil)) : 0.f;
  // conic = (covz, -covy, covx) / det_s (Div#161, #163, #164); det_s gets #164's first
  const float g161 = dvd(gcn[0], r.det_s), g163 = dvd(gcn[1], r.det_s),
              g164 = dvd(gcn[2], r.det_s);
  const float d_dets = add(add(mul(-gcn[2], dvd(r.conic[2], r.det_s)),
                               mul(-gcn[1], dvd(r.conic[1], r.det_s))),
                           mul(-gcn[0], dvd(r.conic[0], r.det_s)));
  const float d_det = r.det_ok ? d_dets : 0.f;                 // Where#160
  // covx: Div#164, Mul#157 (det), Mul#151 (det_dil); covz: Div#161, #157, #151
  const float d_covx = add(add(g164, mul(d_det, r.covz)), mul(d_ddil, r.covz));
  const float d_covz = add(add(g161, mul(d_det, r.covx)), mul(d_ddil, r.covx));
  const float d_cxx = add(d_covx, mul(d_draw, r.cyy));        // Add#149, Mul#145
  const float d_cyy = add(d_covz, mul(d_draw, r.cxx));        // Add#150, Mul#145
  // cxy: Neg#162 (conic), then Mul#158, #152, #146 (each cxy * cxy: twice)
  const float a158 = mul(-d_det, r.cxy), a152 = mul(-d_ddil, r.cxy),
              a146 = mul(-d_draw, r.cxy);
  const float d_cxy = add(add(add(add(add(add(-g163, a158), a158), a152), a152), a146), a146);

  // the EWA product: cxx = sum(A0 sa0), cxy = sum(A0 sa1), cyy = sum(A1 sa1),
  // sa0 = Sc A0, sa1 = Sc A1
  const float A0[3] = {r.j00, 0.f, r.j02}, A1[3] = {0.f, r.j11, r.j12};
  float dsa0[3], dsa1[3], dSc[3][3];
  for (int m = 0; m < 3; ++m) {
    dsa0[m] = mul(d_cxx, A0[m]);                                 // Mul#139
    dsa1[m] = add(mul(d_cyy, A1[m]), mul(d_cxy, A0[m]));         // Mul#143, #141
  }
  for (int p = 0; p < 3; ++p)
    for (int m = 0; m < 3; ++m)
      dSc[p][m] = add(mul(dsa1[p], A1[m]), mul(dsa0[p], A0[m]));  // Mul#137, #134
  // Sc = sum_i tmp[a][i] R[b][i] (Mul#110), tmp = sum_k R[a][k] Sw[i][k]
  // (Mul#107), Sw = sum_j RS[i][j] RS[m][j] (Mul#104)
  float dtmp[3][3], dSw[3][3], dRS[3][3];
  for (int p = 0; p < 3; ++p)
    for (int i = 0; i < 3; ++i)
      dtmp[p][i] = sum3_mid(mul(dSc[p][0], k.R[0][i]), mul(dSc[p][1], k.R[1][i]),
                            mul(dSc[p][2], k.R[2][i]));
  for (int i = 0; i < 3; ++i)
    for (int q = 0; q < 3; ++q)
      dSw[i][q] = sum3_mid(mul(dtmp[0][i], k.R[0][q]), mul(dtmp[1][i], k.R[1][q]),
                           mul(dtmp[2][i], k.R[2][q]));
  for (int x = 0; x < 3; ++x)
    for (int j = 0; j < 3; ++j)   // RS[:, None] (Unsqueeze#103) first, then RS[:, :, None]
      dRS[x][j] = add(sum3_mid(mul(dSw[0][x], r.RS[0][j]), mul(dSw[1][x], r.RS[1][j]),
                               mul(dSw[2][x], r.RS[2][j])),
                      sum3_mid(mul(dSw[x][0], r.RS[0][j]), mul(dSw[x][1], r.RS[1][j]),
                               mul(dSw[x][2], r.RS[2][j])));

  // normal = nvec / nd (Div#269), nd = clamp_min(|nvec|, 1e-12)
  const float d_nd = sum3(mul(-gn[0], dvd(r.normal[0], r.nd)),
                          mul(-gn[1], dvd(r.normal[1], r.nd)),
                          mul(-gn[2], dvd(r.normal[2], r.nd)));
  const float d_nn = r.nn >= 1e-12f ? d_nd : 0.f;
  float dn[3];
  for (int j = 0; j < 3; ++j)   // Div#269, then the norm: g (nvec / |nvec|), 0 at 0
    dn[j] = add(dvd(gn[j], r.nd), r.nn == 0.f ? 0.f : mul(d_nn, dvd(r.n[j], r.nn)));
  // n2 = N2n / l (Div#265), N2n = rnv0 txc + rnv1 tyc - tz_s; n0 = rnv0 / tz_s + ...
  const float d_n2n = dvd(dn[2], r.l);
  const float d_rnv0 = add(mul(d_n2n, r.txc), dvd(dn[0], r.tz_s));   // Mul#261, Div#253
  const float d_rnv1 = add(mul(d_n2n, r.tyc), dvd(dn[1], r.tz_s));   // Mul#262, Div#257
  // plane: Neg#249 (rnv0 = -plane0 factor), then Mul#244 (ray_plane[0] fx = plane0 factor)
  const float g245 = mul(grp[0], k.rfx), g247 = mul(grp[1], k.rfy);
  const float d_plane0 = add(-mul(d_rnv0, r.factor), mul(g245, r.factor));
  const float d_plane1 = add(-mul(d_rnv1, r.factor), mul(g247, r.factor));
  // plane = p_n / vb_s (Div#229, #239); vb_s gets #239's first
  const float d_p0n = dvd(d_plane0, r.vb_s), d_p1n = dvd(d_plane1, r.vb_s);
  const float d_vbs = add(mul(-d_plane1, dvd(r.plane1, r.vb_s)),
                          mul(-d_plane0, dvd(r.plane0, r.vb_s)));
  // rsigma = where(vb > 0, sqrt(w), 0), w = where(vb > 0, vb, 1) / rl2
  const bool vb_pos = r.vb > 0.f;
  const float d_sq = vb_pos ? grp[3] : 0.f;
  const float d_w = dvd(d_sq, mul(2.f, pp::sqr(r.w)));
  const float d_vbp = dvd(d_w, r.rl2);
  // vb: Where#240 (rsigma) first, then Where#215 (vb_s)
  const float d_vb = add(vb_pos ? d_vbp : 0.f, fabsf(r.vb) > 1e-20f ? d_vbs : 0.f);
  // mv: the selects of p1n (mv1, mv0) and p0n (mv1, mv0), then vb = sum(mv uvh)
  const float uu1 = add(mul(r.u, r.u), 1.f), vv1 = add(mul(r.v, r.v), 1.f);
  const float uv = mul(r.u, r.v), nuv = mul(-r.u, r.v);
  const float d_mv[3] = {add(add(mul(d_p1n, nuv), mul(d_p0n, vv1)), mul(d_vb, r.u)),
                         add(add(mul(d_p1n, uu1), mul(-d_p0n, uv)), mul(d_vb, r.v)),
                         mul(d_vb, 1.f)};
  // mv = sum Si uvh (Mul#210); Si = sum_j V[a][j] V[b][j] (Mul#119): V[:, None]
  // (Unsqueeze#118) first; V = W / ss (Div#116), W = sum_k R[a][k] Rg[k][j] (Mul#113)
  const float uvh[3] = {r.u, r.v, 1.f};
  float dW[3][3], dss[3][3], dRg[3][3];
  for (int x = 0; x < 3; ++x)
    for (int j = 0; j < 3; ++j) {
      float t118[3], t117[3];
      for (int m = 0; m < 3; ++m) {
        t118[m] = mul(mul(d_mv[m], uvh[x]), r.V[m][j]);
        t117[m] = mul(mul(d_mv[x], uvh[m]), r.V[m][j]);
      }
      const float dV = add(sum3_mid(t118[0], t118[1], t118[2]),
                           sum3_mid(t117[0], t117[1], t117[2]));
      dW[x][j] = dvd(dV, r.ss[j]);
      dss[x][j] = mul(-dV, dvd(r.V[x][j], r.ss[j]));
    }
  // Rg: W's (Unsqueeze#112) first, then RS's (Mul#101); s: RS's, then ss's
  float d_s[3];
  for (int j = 0; j < 3; ++j) {
    for (int m = 0; m < 3; ++m)
      dRg[m][j] = add(sum3_mid(mul(dW[0][j], k.R[0][m]), mul(dW[1][j], k.R[1][m]),
                               mul(dW[2][j], k.R[2][m])),
                      mul(dRS[m][j], r.s[j]));
    d_s[j] = add(sum3_mid(mul(dRS[0][j], r.Rg[0][j]), mul(dRS[1][j], r.Rg[1][j]),
                          mul(dRS[2][j], r.Rg[2][j])),
                 r.s[j] >= 1e-12f ? sum3_mid(dss[0][j], dss[1][j], dss[2][j]) : 0.f);
  }

  // Rg(q): each entry's chain (Stack#97 .. Mul#55), and q's components
  // summed over their consumers, latest first
  float dr, dx, dy, dz;
  {
    const float w = r.q[0], x = r.q[1], y = r.q[2], z = r.q[3];
    const float (&G)[3][3] = dRg;
    const float d57 = mul(-G[0][0], 2.f), d62 = mul(G[0][1], 2.f), d66 = mul(G[0][2], 2.f);
    const float d71 = mul(G[1][0], 2.f), d75 = mul(-G[1][1], 2.f), d80 = mul(G[1][2], 2.f);
    const float d85 = mul(G[2][0], 2.f), d89 = mul(G[2][1], 2.f), d93 = mul(-G[2][2], 2.f);
    // r: Mul#88 (r x), #84 (r y), #79 (r x), #70 (r z), #65 (r y), #61 (r z)
    dr = add(add(add(add(add(mul(d89, x), mul(-d85, y)), mul(-d80, x)), mul(d71, z)),
                 mul(d66, y)), mul(-d62, z));
    // x: #91 (x x), #88, #83 (x z), #79, #73 (x x), #69 (x y), #64 (x z), #60 (x y)
    const float x91 = mul(d93, x), x73 = mul(d75, x);
    dx = add(add(add(add(add(add(add(add(add(x91, x91), mul(d89, w)), mul(d85, z)),
                                 mul(-d80, w)), x73), x73), mul(d71, y)), mul(d66, z)),
             mul(d62, y));
    // y: #92 (y y), #87 (y z), #84, #78 (y z), #69, #65, #60, #55 (y y)
    const float y92 = mul(d93, y), y55 = mul(d57, y);
    dy = add(add(add(add(add(add(add(add(add(y92, y92), mul(d89, z)), mul(-d85, w)),
                                 mul(d80, z)), mul(d71, x)), mul(d66, w)), mul(d62, x)),
                 y55), y55);
    // z: #87, #83, #78, #74 (z z), #70, #64, #61, #56 (z z)
    const float z74 = mul(d75, z), z56 = mul(d57, z);
    dz = add(add(add(add(add(add(add(add(add(mul(d89, y), mul(d85, x)), mul(d80, y)), z74),
                                 z74), mul(d71, w)), mul(d66, x)), mul(-d62, w)), z56), z56);
  }
  // q = rot / qd (Div#50), qd = clamp_min(|rot|, 1e-12): rot gets #50's
  // part, then the norm's (#48). The two parts are written apart, for the
  // autograd engine to add to the leaf as it adds the twin's, after any
  // later view's parts.
  const float dq[4] = {dr, dx, dy, dz};
  const float d_qd = pp::sum4(mul(-dq[0], dvd(r.q[0], r.qd)), mul(-dq[1], dvd(r.q[1], r.qd)),
                              mul(-dq[2], dvd(r.q[2], r.qd)), mul(-dq[3], dvd(r.q[3], r.qd)));
  const float d_qn = r.qn >= 1e-12f ? d_qd : 0.f;
  float d_rot[4], d_rot_norm[4];
  for (int j = 0; j < 4; ++j) {
    d_rot[j] = dvd(dq[j], r.qd);
    d_rot_norm[j] = r.qn == 0.f ? 0.f : mul(d_qn, dvd(r.rot[j], r.qn));
  }

  // --- the projection: the means, in plain float32 (their gradient is no
  // round-off anywhere, so its rounding does not move its zeros) -------------
  float d_tz_s = 0.f, d_txc = 0.f, d_tyc = 0.f, d_u = 0.f, d_v = 0.f;
  {  // A0 / A1 -> the Jacobian's entries
    float dA0[3], dA1[3];
    for (int m = 0; m < 3; ++m) {
      dA0[m] = d_cxy * r.sa1[m] + d_cxx * r.sa0[m];
      dA1[m] = d_cyy * r.sa1[m];
      for (int p = 0; p < 3; ++p) {
        dA0[m] += dsa0[p] * r.Sc[p][m];
        dA1[m] += dsa1[p] * r.Sc[p][m];
      }
    }
    const float d_rtz = dA0[0] * k.fx + dA1[1] * k.fy;
    d_tz_s -= d_rtz * (r.rtz * r.rtz);
    d_txc += dA0[2] / r.tz2 * -k.fx;
    d_tyc += dA1[2] / r.tz2 * -k.fy;
    d_tz_s -= 2.f * r.tz_s * (dA0[2] * (r.j02 / r.tz2) + dA1[2] * (r.j12 / r.tz2));
  }
  // normal: n0 = rnv0 / tz_s + txc / tz2, n1 likewise, n2 = N2n / l
  const float d_factor = g245 * r.plane0 + g247 * r.plane1 - d_rnv0 * r.plane0
                         - d_rnv1 * r.plane1;
  float d_l = -dn[2] * (r.n[2] / r.l) + d_factor / r.rl2;
  const float d_rl2 = -d_w * (r.w / r.rl2) - d_factor * (r.factor / r.rl2);
  d_txc += d_n2n * r.rnv0 + dn[0] / r.tz2;
  d_tyc += d_n2n * r.rnv1 + dn[1] / r.tz2;
  d_tz_s -= d_n2n + dn[0] * (r.rnv0 / r.tz_s / r.tz_s) + dn[1] * (r.rnv1 / r.tz_s / r.tz_s)
            + 2.f * r.tz_s * (dn[0] * (r.txc / r.tz2 / r.tz2) + dn[1] * (r.tyc / r.tz2 / r.tz2));
  // u, v: p0n, p1n, rl2, vb and mv = Si (u, v, 1)
  d_u += -d_p0n * r.mv[1] * r.v - d_p1n * r.mv[0] * r.v + 2.f * r.u * (d_p1n * r.mv[1])
         + 2.f * r.u * d_rl2 + d_vb * r.mv[0];
  d_v += 2.f * r.v * (d_p0n * r.mv[0]) - d_p0n * r.mv[1] * r.u - d_p1n * r.mv[0] * r.u
         + 2.f * r.v * d_rl2 + d_vb * r.mv[1];
  for (int p = 0; p < 3; ++p) {
    d_u += d_mv[p] * r.Si[p][0];
    d_v += d_mv[p] * r.Si[p][1];
  }
  float d_tc = grp[2] + (r.valid ? gd[0] : 0.f);
  {
    const float d_L2 = d_l / (2.f * r.l);
    d_txc += 2.f * r.txc * d_L2;
    d_tyc += 2.f * r.tyc * d_L2;
    d_tz_s += 2.f * r.tz_s * d_L2;
  }
  d_u += d_txc * r.tz_s;
  d_v += d_tyc * r.tz_s;
  d_tz_s += d_txc * r.u + d_tyc * r.v;
  const float d_uraw = (r.u_raw >= -k.limx && r.u_raw <= k.limx) ? d_u : 0.f;
  const float d_vraw = (r.v_raw >= -k.limy && r.v_raw <= k.limy) ? d_v : 0.f;
  float d_pv[3];
  d_pv[0] = d_uraw / r.tz_s;
  d_pv[1] = d_vraw / r.tz_s;
  d_tz_s -= d_uraw * (r.u_raw / r.tz_s) + d_vraw * (r.v_raw / r.tz_s);
  d_pv[2] = r.in_front ? d_tz_s : 0.f;
  if (r.tc != 0.f)
    for (int j = 0; j < 3; ++j) d_pv[j] += d_tc * (r.pv[j] / r.tc);
  const float d_pp0 = gm[0] * 0.5f * k.width, d_pp1 = gm[1] * 0.5f * k.height;
  const float d_ph0 = d_pp0 / r.den, d_ph1 = d_pp1 / r.den;
  const float d_pw = -(d_pp0 * (r.pp0 / r.den) + d_pp1 * (r.pp1 / r.den));
  for (int j = 0; j < 3; ++j)
    g_x[j] += d_pv[0] * k.R[0][j] + d_pv[1] * k.R[1][j] + d_pv[2] * k.R[2][j]
              + d_ph0 * k.F[0][j] + d_ph1 * k.F[1][j] + d_pw * k.F[3][j];

  put(a.d_means, 3 * row, g_x, 3);
  if (a.d_scales) {
    const float v[3] = {mul(d_s[0], k.scale_modifier), mul(d_s[1], k.scale_modifier),
                        mul(d_s[2], k.scale_modifier)};
    put(a.d_scales, 3 * row, v, 3);
  }
  put(a.d_rots, 4 * row, d_rot, 4);
  put(a.d_rots_norm, 4 * row, d_rot_norm, 4);
  if (a.d_opac) a.d_opac[row] = d_op;
}

template <int SH, int SG>
int launch(const BwdArgs& a, cudaStream_t s) {
  const int blocks = (a.n + pp::kThreads - 1) / pp::kThreads;
  preprocess_bwd_kernel<SH, SG><<<blocks, pp::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const BwdArgs&, cudaStream_t);
#define PP_ROW(S) {launch<S, 0>, launch<S, 1>, launch<S, 2>, launch<S, 3>, \
                   launch<S, 4>, launch<S, 5>, launch<S, 6>, launch<S, 7>}
const Launch kLaunch[4][8] = {PP_ROW(0), PP_ROW(1), PP_ROW(2), PP_ROW(3)};
#undef PP_ROW

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a degree the kernel has no instance of. A
// cotangent pointer may be null (a zero cotangent), as may a gradient's (not
// wanted); each cotangent comes with its row and column strides in elements.
// The rotation's gradient comes in its two parts: `d_rots` through the
// normalised quaternion, `d_rots_norm` through the quaternion's norm.
#define PP_COT(name) const float *g_##name, long long r_##name, long long c_##name
extern "C" int gsjax_preprocess_bwd(
    const float* means, const float* scales, const float* rots, const float* opac,
    const float* shs, const float* sg_axis, const float* sg_sharp, const float* sg_color,
    const unsigned char* alive, PP_COT(mean2d), PP_COT(depth), PP_COT(conic),
    PP_COT(opacity), PP_COT(color), PP_COT(ray_plane), PP_COT(normal),
    float* d_means, float* d_scales, float* d_rots, float* d_rots_norm, float* d_opac,
    float* d_shs, float* d_sg_axis, float* d_sg_sharp, float* d_sg_color,
    int n, int bands, int lobes, int sh_degree, int sg_degree, PP_CAM_PARAMS,
    void* stream) {
  if (sh_degree < 0 || sh_degree > 3 || sg_degree < 0 || sg_degree > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
#define PP_C(name) Cot{g_##name, r_##name, c_##name}
  const BwdArgs a{means, scales, rots, opac, shs, sg_axis, sg_sharp, sg_color, alive,
                  PP_C(mean2d), PP_C(depth), PP_C(conic), PP_C(opacity), PP_C(color),
                  PP_C(ray_plane), PP_C(normal),
                  d_means, d_scales, d_rots, d_rots_norm, d_opac, d_shs, d_sg_axis, d_sg_sharp,
                  d_sg_color, n, bands, lobes, PP_CAM_ARGS};
#undef PP_C
  return kLaunch[sh_degree][sg_degree](a, static_cast<cudaStream_t>(stream));
}
#undef PP_COT

"""Patch-warped NCC photometric consistency (port of `gsjax/ops/ncc.py`:
the dense `warp_patch_ncc` and the block-compacted `warp_patch_ncc_blocks`;
the reference's `warp-patch-ncc` CUDA submodule,
warp_patch_ncc_impl.cu:18-255).

For each reference pixel with a depth and a normal, the plane-induced
homography

    H = K_n (R - T n^T / distance) K_r^{-1},  distance = -n . (depth K_r^{-1} uv)

warps a (2R+1)^2 patch at half-pixel steps into the neighbour view, and the
squared normalised cross-correlation of the reference and neighbour patches
is taken. Reference taps sit on a regular grid, so each is a fixed blend of
integer-shifted, edge-padded copies of the reference image (edge padding is
the CUDA kernel's index clamping). Neighbour taps go through the sampler
`warp_sample.WarpSample` (kernel B6 for CUDA tensors, its twin for CPU
tensors, or the twin on any device when asked). The gradient to depth and
normal is torch autograd through the homography and the sampler's d/du,
d/dv.

The statistics are summed tap by tap in gsjax's order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsjax_torch.core import rowwise
from gsjax_torch.ops import warp_sample as ws
from gsjax_torch.utils import spans

BLK = 16              # pixel block side of the compacted NCC
P = BLK * BLK         # pixels a block


def _offsets(radius: int) -> list[float]:
    """Tap offsets along one axis: half-pixel steps (the reference's)."""
    return [i * 0.5 for i in range(-radius, radius + 1)]


def _homography(u, v, depth, normal, rel_rot, rel_t, intr_r, intr_n):
    """Per-pixel homographies [*L, 3, 3] and their images of the pixels
    themselves [*L, 3], for pixels (u, v) [*L] with a depth [*L] and a normal
    [*L, 3]."""
    fx_r, fy_r, cx_r, cy_r = intr_r
    fx_n, fy_n, cx_n, cy_n = intr_n
    dev = depth.device
    pn = torch.stack([(u - cx_r) / fx_r, (v - cy_r) / fy_r, torch.ones_like(u)], -1)
    distance = -(pn * normal).sum(-1) * depth
    dist_safe = torch.where(distance.abs() > 1e-12, distance,
                            torch.full_like(distance, 1e-12))

    # H = K_n (R - T n^T / distance) K_r^{-1}, per pixel
    outer = rel_t[None, None, :, None] * normal[:, :, None, :]
    hn_mat = rel_rot[None, None] - outer / dist_safe[..., None, None]
    k_n = torch.tensor([[fx_n, 0, cx_n], [0, fy_n, cy_n], [0, 0, 1.0]], device=dev)
    k_r_inv = torch.tensor([[1 / fx_r, 0, -cx_r / fx_r],
                            [0, 1 / fy_r, -cy_r / fy_r], [0, 0, 1.0]], device=dev)
    # rowwise in float64, rounded once: a band of pixels gets the whole
    # frame's bits, and the chain's float32 rounding stays below the NCC's
    # sensitivity to the homography (module docstring of tests/test_torch_ncc.py)
    d = torch.float64
    hmat = rowwise.matmul3(rowwise.matmul3(k_n.to(d), hn_mat.to(d)), k_r_inv.to(d))
    h_uc = rowwise.matvec3(hmat, torch.stack([u, v, torch.ones_like(u)], -1).to(d))
    hmat, h_uc = hmat.float(), h_uc.float()
    return hmat, h_uc


def _project_taps(hmat, h_uc, radius: int, k_dim: int):
    """Positions (un, vn) in the neighbour image of every patch tap, with the
    tap axis K = (2 radius + 1)^2 (gsjax's tap order) inserted at `k_dim` of
    the pixels' [*L] (the homography applied per tap, divided per tap as
    warp_patch_ncc_impl.cu:90-110)."""
    offs = _offsets(radius)
    kshape = [1] * h_uc.dim()
    kshape[k_dim] = -1
    du_k = torch.tensor([du for dv in offs for du in offs], device=h_uc.device).reshape(kshape)
    dv_k = torch.tensor([dv for dv in offs for du in offs], device=h_uc.device).reshape(kshape)
    lift = lambda x: x.unsqueeze(k_dim)
    num_u = lift(h_uc[..., 0]) + du_k * lift(hmat[..., 0, 0]) + dv_k * lift(hmat[..., 0, 1])
    num_v = lift(h_uc[..., 1]) + du_k * lift(hmat[..., 1, 0]) + dv_k * lift(hmat[..., 1, 1])
    den = lift(h_uc[..., 2]) + du_k * lift(hmat[..., 2, 0]) + dv_k * lift(hmat[..., 2, 1])
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    return num_u / den, num_v / den


def neighbour_taps(depth: torch.Tensor, normal: torch.Tensor, rel_rot: torch.Tensor,
                   rel_t: torch.Tensor, intr_r, intr_n, radius: int = 3,
                   row_offset: int = 0):
    """Positions (un, vn) [K,Hs,W] in the neighbour image of every patch tap
    of every reference pixel, K = (2 radius + 1)^2 in gsjax's tap order.
    Arguments as `warp_patch_ncc`."""
    h, w = depth.shape
    dev = depth.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = (torch.arange(h, device=dev) + row_offset).to(torch.float32)[:, None].expand(h, w)
    hmat, h_uc = _homography(u, v, depth, normal, rel_rot, rel_t, intr_r, intr_n)
    return _project_taps(hmat, h_uc, radius, k_dim=0)


def _ref_tap_weights(du: float, dv: float):
    """The <= 4 (row offset, column offset, weight) corners whose sum is the
    reference image's bilinear sample at a constant offset (du, dv), in
    gsjax's order (ncc.py:315-323)."""
    u0, fu = math.floor(du), du - math.floor(du)
    v0, fv = math.floor(dv), dv - math.floor(dv)
    return [(iv, iu, wv_ * wu_) for iv, wv_ in ((v0, 1.0 - fv), (v0 + 1, fv))
            for iu, wu_ in ((u0, 1.0 - fu), (u0 + 1, fu)) if wv_ * wu_ != 0.0]


def _ncc2(c_r_taps, c_n_taps):
    """Squared NCC and the two patch variances from the taps (iterables of
    [*L] tensors), summed tap by tap in gsjax's order."""
    s_r = s_n = s_r2 = s_n2 = s_rn = 0.0
    n = 0
    for c_r, c_n in zip(c_r_taps, c_n_taps):
        s_r = s_r + c_r
        s_n = s_n + c_n
        s_r2 = s_r2 + c_r * c_r
        s_n2 = s_n2 + c_n * c_n
        s_rn = s_rn + c_r * c_n
        n += 1
    total = float(n)
    cross = s_rn - s_r * s_n / total
    var_r = s_r2 - s_r * s_r / total
    var_n = s_n2 - s_n * s_n / total
    return cross * cross / (var_r * var_n + 1e-8), var_r, var_n


@spans.spanned("mv.ncc")
def warp_patch_ncc(depth: torch.Tensor, normal: torch.Tensor, gray_r: torch.Tensor,
                   gray_n: torch.Tensor, rel_rot: torch.Tensor, rel_t: torch.Tensor,
                   intr_r, intr_n, radius: int = 3, sample_fn=ws.warp_sample,
                   row_offset: int = 0):
    """Dense NCC^2 over the reference image, or over a band of its rows.

    Args:
      depth: [Hs,W] z-depth in the reference view; normal: [Hs,W,3]
        camera-space unit normals (reference view): the frame's rows
        row_offset .. row_offset + Hs (gsjax ncc.py:72-99; the whole frame
        by default).
      gray_r / gray_n: [H,W] / [Hn,Wn] luma images, whole frames (the patch
        taps read across the band's edges).
      rel_rot: [3,3] reference-camera -> neighbour-camera rotation; rel_t: [3].
      intr_r / intr_n: (fx, fy, cx, cy) as floats.
      sample_fn: the neighbour-tap sampler, `warp_sample.warp_sample` (the
        kernel on CUDA tensors, the twin on the CPU) or its twin
        `warp_sample.bilinear_ref` on any device.

    Returns (ncc [Hs,W] squared correlation in [0,1], valid [Hs,W] bool)."""
    hs, w = depth.shape
    h = gray_r.shape[0]
    hn, wn = gray_n.shape
    rf = radius * 0.5
    offs = _offsets(radius)
    un_k, vn_k = neighbour_taps(depth, normal, rel_rot, rel_t, intr_r, intr_n, radius,
                                row_offset)

    # reference taps: a fixed blend of integer-shifted copies of the image
    pad = int(math.ceil(rf)) + 1
    gr_pad = F.pad(gray_r[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    r0 = pad + row_offset

    def c_r_tap(du, dv):
        out = 0.0
        for iv, iu, wt in _ref_tap_weights(du, dv):
            out = out + wt * gr_pad[r0 + iv:r0 + iv + hs, pad + iu:pad + iu + w]
        return out

    u = torch.arange(w, device=depth.device)[None, :]
    v = torch.arange(hs, device=depth.device)[:, None] + row_offset
    all_inside = (u - rf > 0) & (u + rf < w - 1) & (v - rf > 0) & (v + rf < h - 1)
    inside_k = (un_k - rf > 0) & (un_k + rf < wn - 1) & (vn_k - rf > 0) & (vn_k + rf < hn - 1)
    all_inside = all_inside & inside_k.all(0)

    with spans.span("ncc.sample"):
        c_n_k = ws.WarpSample.apply(gray_n.contiguous(), un_k.contiguous(),
                                    vn_k.contiguous(), sample_fn)
    ncc, var_r, var_n = _ncc2((c_r_tap(du, dv) for dv in offs for du in offs), c_n_k)
    valid = all_inside & (var_r > 5e-6) & (var_n > 5e-6)
    return torch.where(valid, ncc, torch.zeros_like(ncc)), valid


def compact_blocks(sel_mask: torch.Tensor):
    """The 16x16 pixel blocks of an [H,W] mask that hold a selected pixel, in
    gsjax's block order (row-major over the frame's blocks). Returns (sel [B]
    block indices, u [B,P], v [B,P] integer pixel coordinates, in_img [B,P]:
    the pixel lies in the frame, not in the padding of a partial edge block,
    flat [B,P]: its index into the flattened frame, 0 where not in_img)."""
    h, w = sel_mask.shape
    hb, wb = -(-h // BLK), -(-w // BLK)
    dev = sel_mask.device
    mpad = torch.zeros(hb * BLK, wb * BLK, dtype=torch.bool, device=dev)
    mpad[:h, :w] = sel_mask
    blk_any = mpad.reshape(hb, BLK, wb, BLK).any(3).any(1).reshape(-1)
    sel = torch.nonzero(blk_any).squeeze(1)
    lane = torch.arange(P, device=dev)
    u_i = (sel % wb)[:, None] * BLK + (lane % BLK)[None, :]
    v_i = (sel // wb)[:, None] * BLK + (lane // BLK)[None, :]
    in_img = (u_i < w) & (v_i < h)
    flat = torch.where(in_img, v_i * w + u_i, torch.zeros_like(u_i))
    return sel, u_i, v_i, in_img, flat


def _block_taps(u_i, v_i, in_img, flat, depth, normal, rel_rot, rel_t, intr_r, intr_n,
                radius):
    """Tap positions (un, vn) [B,K,P] in the neighbour image of the
    compacted pixels, from their depth and normal. Dead lanes (pixels past a
    partial edge block's frame edge) compute pixel 0's taps, which the dense
    form computes too, so they are finite and the `where` below passes no inf
    or NaN to autograd; they are pinned to the block's smallest live tap, as
    gsjax's (ncc.py:344-357), so that the tap positions equal gsjax's."""
    dep = depth.reshape(-1)[flat]
    nrm = normal.reshape(-1, 3)[flat]                                      # [B,P,3]
    hmat, h_uc = _homography(u_i.to(torch.float32), v_i.to(torch.float32), dep, nrm,
                             rel_rot, rel_t, intr_r, intr_n)
    un_raw, vn_raw = _project_taps(hmat, h_uc, radius, k_dim=1)
    live3 = in_img[:, None, :]
    inf = torch.full((), math.inf, device=depth.device)

    def pinned(t):
        pin = torch.where(live3, t, inf).amin(dim=(1, 2))    # a block has a live lane
        return torch.where(live3, t, pin[:, None, None])

    return pinned(un_raw), pinned(vn_raw)


def block_neighbour_taps(depth, normal, sel_mask, rel_rot, rel_t, intr_r, intr_n,
                         radius: int = 3):
    """Tap positions (un, vn) [B,K,P] of the compacted blocks of `sel_mask`
    in the neighbour image, as `warp_patch_ncc_blocks` samples them."""
    _, u_i, v_i, in_img, flat = compact_blocks(sel_mask)
    un_k, vn_k = _block_taps(u_i, v_i, in_img, flat, depth, normal, rel_rot, rel_t,
                             intr_r, intr_n, radius)
    return un_k.contiguous(), vn_k.contiguous()


@spans.spanned("mv.ncc")
def warp_patch_ncc_blocks(depth: torch.Tensor, normal: torch.Tensor, gray_r: torch.Tensor,
                          gray_n: torch.Tensor, rel_rot: torch.Tensor, rel_t: torch.Tensor,
                          intr_r, intr_n, sel_mask: torch.Tensor, weights: torch.Tensor,
                          ncc_threshold: float = 0.9, radius: int = 3,
                          sample_fn=ws.warp_sample_blocks):
    """Block-compacted NCC loss terms (port of gsjax's `warp_patch_ncc_blocks`,
    ncc.py:204-393): the homography, the taps and the statistics run only on
    the 16x16 pixel blocks that hold a `sel_mask` pixel.

    Arguments as `warp_patch_ncc`, plus `sel_mask` [H,W] bool (the PGSR
    d_mask) and `weights` [H,W] (> 0 exactly on the mask; not
    differentiated). `sample_fn` is `warp_sample.warp_sample_blocks` (kernel
    B6 on CUDA tensors, the twin on the CPU) or `warp_sample.bilinear_ref`.

    Differences from gsjax's, none of which changes a loss term:
      - no block capacity: the blocks are compacted to their real count, so
        gsjax's truncation past `block_capacity` has no counterpart;
      - no dense [H, W, K] stack of reference taps: the edge-padded
        reference image is gathered once at each compacted pixel's 5x5
        neighbourhood, and each tap adds its <= 4 weighted corners from it
        in the order of gsjax's dense blend, so every tap equals it bit for
        bit;
      - the sampler takes every tap exactly (no TPU window), so `win_rej`
        is 0, as on gsjax's off-TPU path (ncc.py:368-371).
    The statistics are summed tap by tap in gsjax's order, as the dense
    form sums them, so autograd adds their gradients in the dense form's
    order too. The homography of a compacted pixel may contract in another
    order than the dense [H,W] form's, so tap positions may differ from the
    dense path's at the ulp level.

    Returns (ncc_sum, ncc_cnt, win_rej, n_blocks): the weighted sum of
    clip(1 - ncc^2, 0, 2) over mask pixels whose NCC is valid and below
    `ncc_threshold` (a scalar tensor), their count (a scalar tensor), 0, and
    the number of selected blocks (a Python int)."""
    h, w = depth.shape
    hn, wn = gray_n.shape
    rf = radius * 0.5
    offs = _offsets(radius)
    zero = torch.zeros((), device=depth.device)
    sel, u_i, v_i, in_img, flat = compact_blocks(sel_mask)
    un_k, vn_k = _block_taps(u_i, v_i, in_img, flat, depth, normal, rel_rot, rel_t,
                             intr_r, intr_n, radius)
    wgt = weights.detach().reshape(-1)[flat]

    u = u_i.to(torch.float32)
    v = v_i.to(torch.float32)
    all_inside = (u - rf > 0) & (u + rf < w - 1) & (v - rf > 0) & (v + rf < h - 1)
    inside_k = (un_k - rf > 0) & (un_k + rf < wn - 1) & (vn_k - rf > 0) & (vn_k + rf < hn - 1)
    all_inside = all_inside & inside_k.all(1)

    # reference taps: each compacted pixel's n x n neighbourhood of the
    # edge-padded image, gathered once; each tap adds its <= 4 weighted
    # corners from it in gsjax's order, for all taps at once (an absent
    # corner adds 0 x a finite value)
    pad = int(math.ceil(rf)) + 1
    gr_pad = F.pad(gray_r[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    wp = w + 2 * pad
    lo, hi = math.floor(-rf), math.floor(rf) + 1
    span = torch.arange(lo, hi + 1, device=depth.device)
    hood = (span[:, None] * wp + span[None, :]).reshape(-1)
    base = (v_i.clamp(max=h - 1) + pad) * wp + u_i.clamp(max=w - 1) + pad
    c_hood = gr_pad.reshape(-1)[base[..., None] + hood]
    corners = [_ref_tap_weights(du, dv) for dv in offs for du in offs]
    c_r = 0.0
    for c in range(4):
        pick = [(cs[c][0] - lo) * (hi - lo + 1) + cs[c][1] - lo if c < len(cs) else 0
                for cs in corners]
        wts = [cs[c][2] if c < len(cs) else 0.0 for cs in corners]
        c_r = c_r + torch.tensor(wts, device=depth.device) * \
            c_hood[..., torch.tensor(pick, device=depth.device)]
    c_r = c_r.transpose(1, 2)                                              # [B,K,P]

    with spans.span("ncc.sample"):
        c_n = ws.WarpSample.apply(gray_n.contiguous(), un_k.contiguous(),
                                  vn_k.contiguous(), sample_fn)            # [B,K,P]
    ncc2, var_r, var_n = _ncc2(c_r.unbind(1), c_n.unbind(1))
    valid = all_inside & (var_r > 5e-6) & (var_n > 5e-6) & in_img
    nccv = torch.clamp(1.0 - torch.where(valid, ncc2, zero), 0.0, 2.0)
    ncc_mask = ((nccv < ncc_threshold) & valid & (wgt > 0)).detach()
    ncc_sum = torch.where(ncc_mask, nccv * wgt, zero).sum()
    return ncc_sum, ncc_mask.sum(), 0, int(sel.shape[0])

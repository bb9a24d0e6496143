"""Patch-warped NCC photometric consistency (port of `gsjax/ops/ncc.py`,
the dense `warp_patch_ncc`; the reference's `warp-patch-ncc` CUDA submodule,
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

The statistics are summed tap by tap in gsjax's order. The block-compacted
variant (`warp_patch_ncc_blocks`) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsjax_torch.ops import warp_sample as ws


def _offsets(radius: int) -> list[float]:
    """Tap offsets along one axis: half-pixel steps (the reference's)."""
    return [i * 0.5 for i in range(-radius, radius + 1)]


def neighbour_taps(depth: torch.Tensor, normal: torch.Tensor, rel_rot: torch.Tensor,
                   rel_t: torch.Tensor, intr_r, intr_n, radius: int = 3):
    """Positions (un, vn) [K,H,W] in the neighbour image of every patch tap of
    every reference pixel, K = (2 radius + 1)^2 in gsjax's tap order (the
    homography applied per tap, divided per tap as warp_patch_ncc_impl.cu
    :90-110). Arguments as `warp_patch_ncc`."""
    h, w = depth.shape
    fx_r, fy_r, cx_r, cy_r = intr_r
    fx_n, fy_n, cx_n, cy_n = intr_n
    dev = depth.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
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
    hmat = torch.einsum("ij,hwjk,kl->hwil", k_n, hn_mat, k_r_inv)
    h_uc = torch.einsum("hwij,hwj->hwi", hmat, torch.stack([u, v, torch.ones_like(u)], -1))

    offs = _offsets(radius)
    du_k = torch.tensor([du for dv in offs for du in offs], device=dev)[:, None, None]
    dv_k = torch.tensor([dv for dv in offs for du in offs], device=dev)[:, None, None]
    num_u = h_uc[None, ..., 0] + du_k * hmat[None, ..., 0, 0] + dv_k * hmat[None, ..., 0, 1]
    num_v = h_uc[None, ..., 1] + du_k * hmat[None, ..., 1, 0] + dv_k * hmat[None, ..., 1, 1]
    den = h_uc[None, ..., 2] + du_k * hmat[None, ..., 2, 0] + dv_k * hmat[None, ..., 2, 1]
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    return num_u / den, num_v / den


def warp_patch_ncc(depth: torch.Tensor, normal: torch.Tensor, gray_r: torch.Tensor,
                   gray_n: torch.Tensor, rel_rot: torch.Tensor, rel_t: torch.Tensor,
                   intr_r, intr_n, radius: int = 3, sample_fn=ws.warp_sample):
    """Dense NCC^2 over the reference image.

    Args:
      depth: [H,W] z-depth in the reference view; normal: [H,W,3]
        camera-space unit normals (reference view).
      gray_r / gray_n: [H,W] / [Hn,Wn] luma images.
      rel_rot: [3,3] reference-camera -> neighbour-camera rotation; rel_t: [3].
      intr_r / intr_n: (fx, fy, cx, cy) as floats.
      sample_fn: the neighbour-tap sampler, `warp_sample.warp_sample` (the
        kernel on CUDA tensors, the twin on the CPU) or its twin
        `warp_sample.bilinear_ref` on any device.

    Returns (ncc [H,W] squared correlation in [0,1], valid [H,W] bool)."""
    h, w = depth.shape
    hn, wn = gray_n.shape
    rf = radius * 0.5
    offs = _offsets(radius)
    un_k, vn_k = neighbour_taps(depth, normal, rel_rot, rel_t, intr_r, intr_n, radius)

    # reference taps: a fixed blend of integer-shifted copies of the image
    pad = int(math.ceil(rf)) + 1
    gr_pad = F.pad(gray_r[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]

    def c_r_tap(du, dv):
        u0, fu = math.floor(du), du - math.floor(du)
        v0, fv = math.floor(dv), dv - math.floor(dv)
        out = 0.0
        for iv, wv_ in ((v0, 1.0 - fv), (v0 + 1, fv)):
            for iu, wu_ in ((u0, 1.0 - fu), (u0 + 1, fu)):
                if wv_ * wu_ != 0.0:
                    out = out + (wv_ * wu_) * gr_pad[pad + iv:pad + iv + h,
                                                     pad + iu:pad + iu + w]
        return out

    u = torch.arange(w, device=depth.device)[None, :]
    v = torch.arange(h, device=depth.device)[:, None]
    all_inside = (u - rf > 0) & (u + rf < w - 1) & (v - rf > 0) & (v + rf < h - 1)
    inside_k = (un_k - rf > 0) & (un_k + rf < wn - 1) & (vn_k - rf > 0) & (vn_k + rf < hn - 1)
    all_inside = all_inside & inside_k.all(0)

    c_n_k = ws.WarpSample.apply(gray_n.contiguous(), un_k.contiguous(),
                                vn_k.contiguous(), sample_fn)

    s_r = s_n = s_r2 = s_n2 = s_rn = 0.0
    k = 0
    for dv in offs:
        for du in offs:
            c_r = c_r_tap(du, dv)
            c_n = c_n_k[k]
            k += 1
            s_r = s_r + c_r
            s_n = s_n + c_n
            s_r2 = s_r2 + c_r * c_r
            s_n2 = s_n2 + c_n * c_n
            s_rn = s_rn + c_r * c_n

    total = float(len(offs) ** 2)
    cross = s_rn - s_r * s_n / total
    var_r = s_r2 - s_r * s_r / total
    var_n = s_n2 - s_n * s_n / total
    ncc = cross * cross / (var_r * var_n + 1e-8)
    valid = all_inside & (var_r > 5e-6) & (var_n > 5e-6)
    return torch.where(valid, ncc, torch.zeros_like(ncc)), valid

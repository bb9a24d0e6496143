# Frozen copy of gsjax_torch/train/multiview.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""PGSR multi-view losses: geometric reprojection + patch-warped NCC.

Port of `gsjax/train/multiview.py` (the reference's `PatchMatch.__call__`,
utils/loss_utils.py:140-267):

  1. backproject the rendered median depth to world points;
  2. sample the neighbour view's median depth along each point's ray,
     differentiably (`ops.sample.sample_depth`: kernels B3 / B5);
  3. reproject the sampled points into the reference view: the pixel error
     is the geometric loss (weights exp(-err), masked at pixel_noise_th);
  4. NCC^2 of plane-warped 7x7 half-step patches between the two luma
     images (`ops.ncc.warp_patch_ncc`: kernel B6 samples the neighbour),
     masked where 1 - ncc >= 0.9 or the geometry is inconsistent.

The geometric queries are compacted to the pixels that can contribute: a
rendered depth > 0 and a projection inside the neighbour's frustum (gsjax's
`_geo_terms_compact`, its default). That pre-mask is a superset of the
loss's own mask, so the losses and gradients are those of the dense form.
The port compacts to the real count, so it needs no query capacity.

With `ncc_compact` the NCC runs only on the 16x16 pixel blocks that hold a
pixel of the geometric mask (`ops.ncc.warp_patch_ncc_blocks`: kernel B6
launched as `warp_sample_blocks`), gsjax's `GSJAX_NCC_COMPACT=1`
(multiview.py:212-222); its blocks are compacted to their real count too.

`patchmatch_terms` returns the masked sums and counts for a band of rows at
`row_offset` (the multi-device step sums them over ranks; dense NCC only,
as gsjax's sharded step); `patchmatch_losses` divides them for one device.
"""

from __future__ import annotations

import torch

from gsbench.reference import rowwise
from gsbench.reference import ncc as ncc_ops
from gsbench.reference import warp as ws
from gsbench.reference.camera import Camera
from gsbench.reference.config import RasterConfig
from gsbench.reference.sample import _project_points, sample_depth


def _invert_rigid(wv: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a [4,4] rigid world->cam matrix."""
    r = wv[:3, :3]
    inv = torch.eye(4, dtype=wv.dtype, device=wv.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ wv[:3, 3]
    return inv


def _geo_terms(pts_world, median_depth, means3d, scales, rotations, opacities,
               alive, ref_cam: Camera, near_cam: Camera, cfg: RasterConfig,
               pixel_noise_th, row_offset=0):
    """Geometric terms over the compacted queries of a band of rows at
    `row_offset`. Returns (geo_sum, geo_cnt, d_mask [Hs,W], weights [Hs,W],
    n_queries, the neighbour's largest tile list)."""
    h, w = median_depth.shape
    pw = pts_world.reshape(-1, 3)
    dep = median_depth.detach().reshape(-1)
    _, _, _, in_near = _project_points(pw.detach(), near_cam, cfg)
    sel = torch.nonzero((dep > 0) & in_near).squeeze(1)
    res = sample_depth(pw[sel], means3d, scales, rotations, opacities, near_cam, cfg,
                       alive)
    pts_near = res["point_cam"]                                   # [n, 3]

    rel = ref_cam.world_view @ _invert_rigid(near_cam.world_view)  # near -> ref
    pts_ref = rowwise.affine(pts_near, rel[:3, :3], rel[:3, 3])
    z = torch.clamp_min(pts_ref[:, 2], 1e-7)
    u = pts_ref[:, 0] / z * ref_cam.fx + ref_cam.cx
    v = pts_ref[:, 1] / z * ref_cam.fy + ref_cam.cy
    uu = (sel % w).to(torch.float32)
    vv = (sel // w + row_offset).to(torch.float32)
    pixel_noise = torch.sqrt((u - uu) ** 2 + (v - vv) ** 2 + 1e-12)

    with torch.no_grad():
        d_mask_c = (res["inside"] & (pts_near[:, 2] > 0.2) & (pts_ref[:, 2] > 0.2)
                    & (pixel_noise < pixel_noise_th))      # depth > 0: the pre-mask
        weights_c = torch.where(d_mask_c, torch.exp(-pixel_noise),
                                torch.zeros_like(pixel_noise))
        # full-frame weights for the NCC mask (weights > 0 <=> d_mask)
        weights = torch.zeros(h * w, device=dep.device)
        weights[sel] = weights_c
        weights = weights.reshape(h, w)
    geo_sum = torch.where(d_mask_c, weights_c * pixel_noise,
                          torch.zeros_like(pixel_noise)).sum()
    return (geo_sum, d_mask_c.sum(), weights > 0, weights, int(sel.shape[0]),
            res["max_tile_count"])


def backproject(median_depth: torch.Tensor, cam: Camera, row_offset: int = 0) -> torch.Tensor:
    """World points [Hs,W,3] of an [Hs,W] median depth rendered by `cam`, the
    frame's rows from `row_offset` (loss_utils.py:146-159)."""
    h, w = median_depth.shape
    dev = median_depth.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - cam.cx) / cam.fx
    ys = ((torch.arange(h, device=dev) + row_offset).to(torch.float32) - cam.cy) / cam.fy
    pts_cam = torch.stack([median_depth * xs[None, :], median_depth * ys[:, None],
                           median_depth], -1)
    inv_r = _invert_rigid(cam.world_view)
    return rowwise.affine(pts_cam, inv_r[:3, :3], inv_r[:3, 3])


def patchmatch_terms(median_depth: torch.Tensor, normal: torch.Tensor,
                     means3d, scales, rotations, opacities, alive,
                     ref_cam: Camera, near_cam: Camera,
                     gray_r: torch.Tensor, gray_n: torch.Tensor,
                     cfg: RasterConfig, pixel_noise_th: float = 1.0,
                     patch_size: int = 3, row_offset: int = 0,
                     ncc_compact: bool = False):
    """PGSR terms of a band of the reference view against one neighbour
    (gsjax multiview.py:156-235).

    median_depth / normal: [Hs,W(,3)] rows row_offset .. row_offset + Hs of
    the reference view's render; gray_r / gray_n: [H,W] luma images of the
    two views, whole frames. The gaussian arguments are those of
    `sample_depth`. `cfg.backend` picks kernels or twins as for the blend.
    `ncc_compact` runs the block-compacted NCC (whole frames only).

    Returns (ncc_sum, ncc_cnt, geo_sum, geo_cnt, n_queries,
    near_max_tile_count, n_blocks): the masked sums and counts (scalar
    tensors; the counts carry no gradient), the number of geometric queries
    (pixels with a depth that project inside the neighbour's frustum), the
    neighbour view's largest tile list and the NCC's selected 16x16 blocks
    (0 without `ncc_compact`), the last three Python ints."""
    if ncc_compact and (row_offset or median_depth.shape[0] != gray_r.shape[0]):
        raise ValueError("the block-compacted NCC takes whole frames; a band "
                         "of rows runs the dense NCC")
    dev = median_depth.device
    fx, fy, cx, cy = ref_cam.fx, ref_cam.fy, ref_cam.cx, ref_cam.cy

    # 1. backproject the median depth -> world points
    pts_world = backproject(median_depth, ref_cam, row_offset)

    # 2+3. the neighbour's median depth along each point's ray, reprojected
    geo_sum, geo_cnt, d_mask, weights, n_queries, near_mtc = _geo_terms(
        pts_world, median_depth, means3d, scales, rotations, opacities, alive,
        ref_cam, near_cam, cfg, pixel_noise_th, row_offset)

    # 4. NCC over the masked pixels (loss_utils.py:227-267); the double
    # `where` keeps the gradient finite at zero normals (empty pixels)
    nrm2 = (normal * normal).sum(-1, keepdim=True)
    good = nrm2 > 1e-20
    nrm = torch.where(good, normal * torch.rsqrt(torch.where(good, nrm2, 1.0)),
                      torch.zeros_like(normal))
    rel_rn = near_cam.world_view @ _invert_rigid(ref_cam.world_view)  # ref -> near
    ncc_args = (median_depth, nrm, gray_r, gray_n, rel_rn[:3, :3], rel_rn[:3, 3],
                (fx, fy, cx, cy), (near_cam.fx, near_cam.fy, near_cam.cx, near_cam.cy))
    n_blocks = 0
    if ncc_compact:
        sample_fn = ws.bilinear_ref
        ncc_sum, ncc_cnt, _, n_blocks = ncc_ops.warp_patch_ncc_blocks(
            *ncc_args, d_mask, weights, radius=patch_size, sample_fn=sample_fn)
    else:
        sample_fn = ws.bilinear_ref
        cc, cc_valid = ncc_ops.warp_patch_ncc(*ncc_args, radius=patch_size,
                                              sample_fn=sample_fn, row_offset=row_offset)
        ncc = torch.clamp(1.0 - cc, 0.0, 2.0)
        ncc_mask = ((ncc < 0.9) & cc_valid & d_mask).detach()
        ncc_sum = torch.where(ncc_mask, ncc * weights, torch.zeros_like(ncc)).sum()
        ncc_cnt = ncc_mask.sum()
    return ncc_sum, ncc_cnt, geo_sum, geo_cnt, n_queries, near_mtc, n_blocks


def patchmatch_losses(median_depth: torch.Tensor, normal: torch.Tensor,
                      means3d, scales, rotations, opacities, alive,
                      ref_cam: Camera, near_cam: Camera,
                      gray_r: torch.Tensor, gray_n: torch.Tensor,
                      cfg: RasterConfig, pixel_noise_th: float = 1.0,
                      patch_size: int = 3, ncc_compact: bool = False):
    """PGSR losses of one reference view against one neighbour, from
    `patchmatch_terms` over the whole frame (arguments as there).

    Returns (ncc_loss, geo_loss, n_queries, near_max_tile_count, n_blocks):
    two scalar tensors and the three Python ints of `patchmatch_terms`."""
    ncc_sum, ncc_cnt, geo_sum, geo_cnt, n_queries, near_mtc, n_blocks = patchmatch_terms(
        median_depth, normal, means3d, scales, rotations, opacities, alive, ref_cam,
        near_cam, gray_r, gray_n, cfg, pixel_noise_th, patch_size, ncc_compact=ncc_compact)
    any_mask = geo_cnt > 0
    zero = torch.zeros((), device=median_depth.device)
    return (torch.where(any_mask, ncc_sum / torch.clamp_min(ncc_cnt, 1), zero),
            torch.where(any_mask, geo_sum / torch.clamp_min(geo_cnt, 1), zero),
            n_queries, near_mtc, n_blocks)

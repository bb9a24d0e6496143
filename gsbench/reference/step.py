# Frozen copy of gsjax_torch/train/step.py:train_step at commit 95f6082, without
# the appearance models and the NaN probe (no cell trains them), on the twins.
"""One training step of the reference: render -> losses -> grads -> Adam."""

from __future__ import annotations

import dataclasses

import torch

from gsbench.reference import gaussians as gm
from gsbench.reference import losses, multiview, precision
from gsbench.reference.api import render
from gsbench.reference.camera import Camera
from gsbench.reference.config import RasterConfig


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (OptimizationParams, arguments/__init__.py:106-118)."""
    lambda_dssim: float = 0.2
    lambda_depth_normal: float = 0.05
    lambda_mv_ncc: float = 0.6
    lambda_mv_geo: float = 0.02
    reg_on: bool = False
    mv_on: bool = False
    pixel_noise_th: float = 1.0
    patch_size: int = 3


def train_step(params: gm.GaussianParams, aux: gm.GaussianAux, adam: gm.AdamState,
               camera: Camera, gt_image, bg, lrs: dict, cfg: RasterConfig,
               loss_cfg: LossConfig, near_cam: Camera | None = None,
               gray_r=None, gray_n=None):
    """One step; `params` and `adam` are updated in place. Returns (params,
    aux, adam, metrics) as the port's, or metrics["overflowed"] = True and
    nothing changed where the frame's largest tile list exceeds the cap."""
    tap = torch.zeros(params.capacity, 2, device=params.xyz.device, requires_grad=True)
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    st = lambda x: precision.stage(x, cfg)
    xyz, rot, scales, opac = st(params.xyz), st(params.rotation), st(scales), st(opac)
    out = render(xyz, scales, rot, opac, st(gm.get_features(params)), camera, cfg, bg,
                 sg_axis=st(gm.get_sg_axis(params)),
                 sg_sharpness=st(gm.get_sg_sharpness(params)), sg_color=st(params.sg_color),
                 alive=aux.alive, mean2d_offset=tap, skip_overflow=True)
    counts = dict(num_pairs=out["num_pairs"], num_live_pairs=out["num_live_pairs"],
                  max_tile_count=out["max_tile_count"])
    if out["max_tile_count"] > cfg.max_per_tile:
        return params, aux, adam, dict(counts, overflowed=True)

    img = out["render"]
    ll1 = losses.l1_loss(img, gt_image)
    ssim_val = losses.ssim(img, gt_image)
    rgb_loss = (1 - loss_cfg.lambda_dssim) * ll1 + loss_cfg.lambda_dssim * (1 - ssim_val)
    dn_loss = torch.zeros((), device=img.device)
    if loss_cfg.reg_on and loss_cfg.lambda_depth_normal > 0 and cfg.require_depth:
        dnormal, valid = losses.depth_to_normal(out["median_depth"], camera.fx,
                                                camera.fy, camera.cx, camera.cy)
        dn_loss = losses.depth_normal_loss(out["normal"], dnormal, valid)
    ncc_loss = geo_loss = torch.zeros((), device=img.device)
    mv = dict(mv_queries=0, mv_max_tile_count=0, mv_blocks=0)
    if (loss_cfg.reg_on and loss_cfg.mv_on and cfg.require_depth
            and (loss_cfg.lambda_mv_ncc > 0 or loss_cfg.lambda_mv_geo > 0)):
        ncc_loss, geo_loss, mv["mv_queries"], mv["mv_max_tile_count"], mv["mv_blocks"] = \
            multiview.patchmatch_losses(
                out["median_depth"], out["normal"], xyz, scales, rot, opac, aux.alive,
                camera, near_cam, gray_r, gray_n, cfg, loss_cfg.pixel_noise_th,
                loss_cfg.patch_size)
    total = (rgb_loss + loss_cfg.lambda_depth_normal * dn_loss
             + loss_cfg.lambda_mv_ncc * ncc_loss + loss_cfg.lambda_mv_geo * geo_loss)

    leaves = [getattr(params, k) for k in gm.PARAM_FIELDS]
    g_all = torch.autograd.grad(total, leaves + [tap], allow_unused=True)
    g_leaves, g2d = g_all[:len(leaves)], g_all[len(leaves)]

    def mask(g, like):
        if g is None:
            return torch.zeros_like(like)
        m = aux.alive.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(m, g, torch.zeros_like(g))

    grads = {k: st(mask(g, p)) for k, g, p in zip(gm.PARAM_FIELDS, g_leaves, leaves)}
    g2d = mask(g2d, tap)
    with torch.no_grad():
        vis = out["visibility"]
        aux = gm.add_densification_stats(aux, g2d, vis, camera.width, camera.height)
        aux = dataclasses.replace(aux, max_radii=torch.maximum(
            aux.max_radii, torch.where(vis, out["radii"], torch.zeros_like(out["radii"]))))
        gm.adam_update(params, grads, adam, lrs)
        loss, l1v, ssv, dnv, nccv, geov = torch.stack(
            [s.float() for s in (total, ll1, ssim_val, dn_loss, ncc_loss, geo_loss)]).tolist()
    images = {k: out[k].detach() for k in ("render", "alpha", "normal", "median_depth")}
    return params, aux, adam, dict(counts, overflowed=False, loss=loss, l1=l1v, ssim=ssv,
                                   dn_loss=dnv, ncc_loss=nccv, geo_loss=geov, images=images,
                                   **mv)

"""One training step: render -> losses -> grads -> Adam -> stats.

Port of `gsjax/train/step.py` (the hot loop of `train.py:89-263`, loss
assembly at :169-191). The gradient is torch autograd through the losses,
the blend (`render_cuda.Blend`: B2 on the card) and preprocess. Adam and
the densification statistics update the model in place.

Once regularisation is on and the caller gives a neighbour view, the PGSR
multi-view losses (`train.multiview`: the point-query kernels B3 / B5 and
the NCC sampler B6 on the card) join the loss. The decoupled appearance
models are a later slice: asking for them raises.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import render
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.train import losses, multiview


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (OptimizationParams, arguments/__init__.py:106-118)."""
    lambda_dssim: float = 0.2
    lambda_depth_normal: float = 0.05
    lambda_mv_ncc: float = 0.6
    lambda_mv_geo: float = 0.02
    reg_on: bool = False          # iteration >= regularization_from_iter
    mv_on: bool = False           # a neighbour view is given
    pixel_noise_th: float = 1.0
    patch_size: int = 3
    appearance: str = "no"        # no | gs | pgsr | gof (only "no" ported)


def train_step(params: gm.GaussianParams, aux: gm.GaussianAux, adam: gm.AdamState,
               camera: Camera, gt_image: torch.Tensor, bg: torch.Tensor,
               lrs: dict[str, float], cfg: RasterConfig, loss_cfg: LossConfig,
               near_cam: Camera | None = None, gray_r: torch.Tensor | None = None,
               gray_n: torch.Tensor | None = None):
    """One optimisation step. Returns (params, aux, adam, metrics).

    With `loss_cfg.mv_on`, `near_cam` is the neighbour view's camera and
    `gray_r` / `gray_n` the [H,W] luma frames of the two views.

    `params` and `adam` are updated in place (the same objects come back);
    `aux` is replaced. When the frame's largest tile list exceeds
    `cfg.max_per_tile` the blend would train on truncated lists: the step
    then stops after the forward, changes nothing and returns
    metrics["overflowed"] = True, so the caller can raise the cap and retry
    the same view (gsjax's loss-free overflow retry)."""
    if loss_cfg.appearance != "no":
        raise NotImplementedError(
            f"appearance model {loss_cfg.appearance!r} is not ported to "
            "gsjax_torch yet (a later slice); use --use_decoupled_appearance 0")

    tap = torch.zeros(params.capacity, 2, device=params.xyz.device, requires_grad=True)
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    out = render(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                 camera, cfg, bg, sg_axis=gm.get_sg_axis(params),
                 sg_sharpness=gm.get_sg_sharpness(params), sg_color=params.sg_color,
                 alive=aux.alive, mean2d_offset=tap)
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
    mv = dict(mv_queries=0, mv_max_tile_count=0)
    if (loss_cfg.reg_on and loss_cfg.mv_on and cfg.require_depth
            and (loss_cfg.lambda_mv_ncc > 0 or loss_cfg.lambda_mv_geo > 0)):
        ncc_loss, geo_loss, mv["mv_queries"], mv["mv_max_tile_count"] = \
            multiview.patchmatch_losses(
                out["median_depth"], out["normal"], params.xyz, scales,
                params.rotation, opac, aux.alive, camera, near_cam, gray_r, gray_n,
                cfg, loss_cfg.pixel_noise_th, loss_cfg.patch_size)
    total = (rgb_loss + loss_cfg.lambda_depth_normal * dn_loss
             + loss_cfg.lambda_mv_ncc * ncc_loss + loss_cfg.lambda_mv_geo * geo_loss)

    leaves = [getattr(params, k) for k in gm.PARAM_FIELDS]
    *g_leaves, g2d = torch.autograd.grad(total, leaves + [tap], allow_unused=True)
    # dead-slot math (norms at zero, etc.) can give NaN gradients; those
    # slots carry no loss, so their true gradient is zero
    def mask(g, like):
        if g is None:
            return torch.zeros_like(like)
        m = aux.alive.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(m, g, torch.zeros_like(g))

    grads = {k: mask(g, p) for k, g, p in zip(gm.PARAM_FIELDS, g_leaves, leaves)}
    g2d = mask(g2d, tap)
    with torch.no_grad():
        vis = out["visibility"]
        aux = gm.add_densification_stats(aux, g2d, vis, camera.width, camera.height)
        aux = dataclasses.replace(aux, max_radii=torch.maximum(
            aux.max_radii, torch.where(vis, out["radii"], torch.zeros_like(out["radii"]))))
        gm.adam_update(params, grads, adam, lrs)
        loss, l1v, ssv, dnv, nccv, geov = torch.stack(
            [total, ll1, ssim_val, dn_loss, ncc_loss, geo_loss]).tolist()
    # ncc_win_rej: gsjax's count of taps lost to its TPU sampler's window;
    # the port samples every tap
    return params, aux, adam, dict(counts, overflowed=False, loss=loss, l1=l1v,
                                   ssim=ssv, dn_loss=dnv, ncc_loss=nccv, geo_loss=geov,
                                   ncc_win_rej=0, **mv)

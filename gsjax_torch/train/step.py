"""One training step: render -> losses -> grads -> Adam -> stats.

Port of `gsjax/train/step.py` (the hot loop of `train.py:89-263`, loss
assembly at :169-191). The gradient is torch autograd through the losses,
the blend (`render_cuda.Blend`: B2 on the card) and preprocess
(`preprocess.Preprocess`: its VJP kernel on the card). Adam and
the densification statistics update the model in place.

Once regularisation is on and the caller gives a neighbour view, the PGSR
multi-view losses (`train.multiview`: the point-query kernels B3 / B5 and
the NCC sampler B6 on the card, on every pixel or, with
`LossConfig.ncc_compact`, on the compacted 16x16 blocks of the geometric
mask) join the loss. A decoupled appearance model (`model.appearance`: gs,
pgsr or gof) maps the render before its L1 term (gsjax/train/step.py:83-91);
the step returns the gradients of the view's embedding and of the GOF net,
and the caller owns their optimiser.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.model import appearance as app_lib
from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import render
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.train import losses, multiview
from gsjax_torch.utils import spans


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
    appearance: str = "no"        # no | gs | pgsr | gof
    ncc_compact: bool = False     # the block-compacted NCC (GSJAX_NCC_COMPACT)
    # the NaN probe (GSJAX_NAN_PROBE): metrics["nonfinite"] counts, per
    # field, the alive gaussians with a non-finite gradient or updated value
    nan_stats: bool = False


def train_step(params: gm.GaussianParams, aux: gm.GaussianAux, adam: gm.AdamState,
               camera: Camera, gt_image: torch.Tensor, bg: torch.Tensor,
               lrs: dict[str, float], cfg: RasterConfig, loss_cfg: LossConfig,
               near_cam: Camera | None = None, gray_r: torch.Tensor | None = None,
               gray_n: torch.Tensor | None = None,
               app_embedding: torch.Tensor | None = None,
               app_net: app_lib.GofNet | None = None):
    """One optimisation step. Returns (params, aux, adam, metrics).

    With `loss_cfg.mv_on`, `near_cam` is the neighbour view's camera and
    `gray_r` / `gray_n` the [H,W] luma frames of the two views. With an
    appearance model, `app_embedding` is the view's row of its table and,
    for gof, `app_net` its CNN; metrics["app_grad"] is d(loss)/d(row) and
    metrics["app_net_grad"] the net's {layer: {"w", "b"}} gradients (None
    without the model / the net).

    `params` and `adam` are updated in place (the same objects come back);
    `aux` is replaced. With `loss_cfg.nan_stats`, metrics["nonfinite"] is
    gsjax's {"grad": {field: n}, "param": {field: n}}: the alive gaussians
    with any non-finite element in the masked gradient / the updated
    parameter, read in the step's one host read. When the frame's largest tile list exceeds
    `cfg.max_per_tile` the blend would train on truncated lists: the step
    then stops after the forward, changes nothing and returns
    metrics["overflowed"] = True, so the caller can raise the cap and retry
    the same view (gsjax's loss-free overflow retry)."""
    kind = loss_cfg.appearance
    if kind not in app_lib.KINDS:
        raise ValueError(f"unknown appearance model {kind!r}; one of {app_lib.KINDS}")
    app_leaves = []
    if kind != "no":
        app_embedding = app_embedding.detach().requires_grad_(True)
        app_leaves = [app_embedding]
    if kind == "gof":
        net_tree = app_net.tree()
        app_leaves += [p for layer in net_tree.values() for p in layer.values()]

    tap = torch.zeros(params.capacity, 2, device=params.xyz.device, requires_grad=True)
    with spans.span("model.activate"):
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
        shs, sg_axis = gm.get_features(params), gm.get_sg_axis(params)
        sg_sharpness = gm.get_sg_sharpness(params)
    out = render(params.xyz, scales, params.rotation, opac, shs, camera, cfg, bg,
                 sg_axis=sg_axis, sg_sharpness=sg_sharpness, sg_color=params.sg_color,
                 alive=aux.alive, mean2d_offset=tap)
    counts = dict(num_pairs=out["num_pairs"], num_live_pairs=out["num_live_pairs"],
                  max_tile_count=out["max_tile_count"])
    if out["max_tile_count"] > cfg.max_per_tile:
        return params, aux, adam, dict(counts, overflowed=True)

    img = out["render"]
    with spans.span("loss.image"):
        if kind == "gs":
            ll1 = losses.l1_appearance_gs(img, gt_image, app_embedding)
        elif kind == "pgsr":
            ll1 = losses.l1_appearance_pgsr(img, gt_image, app_embedding)
        elif kind == "gof":
            ll1 = app_lib.l1_appearance_gof(img, gt_image, app_net, app_embedding)
        else:
            ll1 = losses.l1_loss(img, gt_image)
        ssim_val = losses.ssim(img, gt_image)
        rgb_loss = (1 - loss_cfg.lambda_dssim) * ll1 + loss_cfg.lambda_dssim * (1 - ssim_val)
    dn_loss = torch.zeros((), device=img.device)
    if loss_cfg.reg_on and loss_cfg.lambda_depth_normal > 0 and cfg.require_depth:
        with spans.span("loss.depth_normal"):
            dnormal, valid = losses.depth_to_normal(out["median_depth"], camera.fx,
                                                    camera.fy, camera.cx, camera.cy)
            dn_loss = losses.depth_normal_loss(out["normal"], dnormal, valid)
    ncc_loss = geo_loss = torch.zeros((), device=img.device)
    mv = dict(mv_queries=0, mv_max_tile_count=0, mv_blocks=0)
    if (loss_cfg.reg_on and loss_cfg.mv_on and cfg.require_depth
            and (loss_cfg.lambda_mv_ncc > 0 or loss_cfg.lambda_mv_geo > 0)):
        ncc_loss, geo_loss, mv["mv_queries"], mv["mv_max_tile_count"], mv["mv_blocks"] = \
            multiview.patchmatch_losses(
                out["median_depth"], out["normal"], params.xyz, scales,
                params.rotation, opac, aux.alive, camera, near_cam, gray_r, gray_n,
                cfg, loss_cfg.pixel_noise_th, loss_cfg.patch_size,
                ncc_compact=loss_cfg.ncc_compact)
    total = (rgb_loss + loss_cfg.lambda_depth_normal * dn_loss
             + loss_cfg.lambda_mv_ncc * ncc_loss + loss_cfg.lambda_mv_geo * geo_loss)

    leaves = [getattr(params, k) for k in gm.PARAM_FIELDS]
    with spans.span("step.backward"):
        g_all = torch.autograd.grad(total, leaves + [tap] + app_leaves, allow_unused=True)
    g_leaves, g2d, g_app = g_all[:len(leaves)], g_all[len(leaves)], g_all[len(leaves) + 1:]
    app_grad = g_app[0] if kind != "no" else None
    app_net_grad = None
    if kind == "gof":
        g_net = iter(g_app[1:])
        app_net_grad = {layer: {k: next(g_net) for k in p} for layer, p in net_tree.items()}
    # dead-slot math (norms at zero, etc.) can give NaN gradients; those
    # slots carry no loss, so their true gradient is zero
    def mask(g, like):
        if g is None:
            return torch.zeros_like(like)
        m = aux.alive.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(m, g, torch.zeros_like(g))

    with spans.span("step.update"), torch.no_grad():
        grads = {k: mask(g, p) for k, g, p in zip(gm.PARAM_FIELDS, g_leaves, leaves)}
        g2d = mask(g2d, tap)
        vis = out["visibility"]
        aux = gm.add_densification_stats(aux, g2d, vis, camera.width, camera.height)
        aux = dataclasses.replace(aux, max_radii=torch.maximum(
            aux.max_radii, torch.where(vis, out["radii"], torch.zeros_like(out["radii"]))))
        gm.adam_update(params, grads, adam, lrs)
    with spans.span("step.readback"), torch.no_grad():
        scalars = [total, ll1, ssim_val, dn_loss, ncc_loss, geo_loss]
        if loss_cfg.nan_stats:
            scalars += [nonfinite_count(t, aux.alive) for t in
                        [grads[k] for k in gm.PARAM_FIELDS]
                        + [getattr(params, k) for k in gm.PARAM_FIELDS]]
        loss, l1v, ssv, dnv, nccv, geov, *bad = torch.stack(
            [s.float() for s in scalars]).tolist()
    nonfinite = {}
    if loss_cfg.nan_stats:
        n = len(gm.PARAM_FIELDS)
        nonfinite = {"nonfinite": {
            kind: {k: int(c) for k, c in zip(gm.PARAM_FIELDS, bad[i * n:(i + 1) * n])}
            for i, kind in enumerate(("grad", "param"))}}
    return params, aux, adam, dict(counts, overflowed=False, loss=loss, l1=l1v,
                                   ssim=ssv, dn_loss=dnv, ncc_loss=nccv, geo_loss=geov,
                                   app_grad=app_grad, app_net_grad=app_net_grad, **mv,
                                   **nonfinite)


def nonfinite_count(t: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The alive rows of `t` [N, ...] with any non-finite element."""
    bad = ~torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
    return (bad & alive).sum()

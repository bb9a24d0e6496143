# Frozen copy of gsjax_torch/ops/raster/api.py (`render`) and of the autograd
# Function gsjax_torch/ops/raster/render_cuda.py:Blend at commit 95f6082, with
# the blend's plain twins in the kernels' place.
"""Rasterizer facade of the reference: preprocess -> binning -> tile blend."""

from __future__ import annotations

import dataclasses

import torch

from gsbench.reference import precision, render_ref
from gsbench.reference.binning import bin_gaussians
from gsbench.reference.camera import Camera
from gsbench.reference.config import RasterConfig
from gsbench.reference.preprocess import preprocess


class Blend(torch.autograd.Function):
    """planes = blend_planes(feats, ...), d(feats) = blend_bwd_planes(...)."""

    @staticmethod
    def forward(ctx, feats, tile_start, tile_count, width, height, fx, fy, bg, cfg):
        planes = render_ref.blend_planes(feats, tile_start, tile_count, width, height,
                                         fx, fy, bg, cfg)
        ctx.save_for_backward(feats, tile_start, tile_count, planes, bg)
        ctx.args = (width, height, fx, fy, cfg)
        return planes

    @staticmethod
    def backward(ctx, grad_planes):
        feats, tile_start, tile_count, planes, bg = ctx.saved_tensors
        width, height, fx, fy, cfg = ctx.args
        g = torch.zeros_like(planes)
        g[:8] = grad_planes[:8]          # rows 8-15 are not differentiable
        d_feats = render_ref.blend_bwd_planes(feats, tile_start, tile_count, planes, g,
                                              width, height, fx, fy, bg, cfg)
        return (d_feats,) + (None,) * 8


def render(means3d, scales, rotations, opacities, shs, camera: Camera, cfg: RasterConfig,
           bg, sg_axis=None, sg_sharpness=None, sg_color=None, alive=None,
           mean2d_offset=None, skip_overflow=False) -> dict:
    """The port's `render()` on the twins (arguments and keys as there).
    With `skip_overflow` (the benchmark's edit), a frame whose largest tile
    list exceeds `cfg.max_per_tile` returns its counts alone, unblended: the
    training step discards such a frame's images."""
    prep = preprocess(means3d, scales, rotations, opacities, shs,
                      sg_axis, sg_sharpness, sg_color, camera, cfg, alive)
    if mean2d_offset is not None:
        prep = dataclasses.replace(prep, mean2d=prep.mean2d + mean2d_offset)
    binning = bin_gaussians(prep, cfg, camera.width, camera.height)
    if skip_overflow and binning.max_tile_count > cfg.max_per_tile:
        return {"num_pairs": binning.num_pairs, "num_live_pairs": binning.num_live,
                "max_tile_count": binning.max_tile_count}
    feats = precision.stage(render_ref.prepare_pairs(prep, binning), cfg)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=feats.device).reshape(3).contiguous()
    planes = Blend.apply(feats, binning.tile_start, binning.tile_count, camera.width,
                         camera.height, camera.fx, camera.fy, bg, cfg)
    images = render_ref.planes_to_images(precision.stage(planes, cfg))
    return {
        "render": images["color"],
        "alpha": images["alpha"],
        "normal": images["normal"],
        "median_depth": images["median_depth"],
        "n_contrib": images["n_contrib"],
        "radii": prep.radius,
        "visibility": prep.radius > 0,
        "num_pairs": binning.num_pairs,
        "num_live_pairs": binning.num_live,
        "max_tile_count": binning.max_tile_count,
    }

"""Rasterizer facade: preprocess -> binning -> tile blend.

Port of `gsjax/ops/raster/api.py` (`GaussianRasterizer.forward` + `render()`,
diff_gaussian_rasterization/__init__.py:272-483), returning the same dict of
channels-last images. The blend runs through the autograd Function
`render_cuda.Blend` with `blend_fwd` / `blend_bwd` (the hand-written Hopper
kernels B1 / B2 for CUDA tensors, their plain twins for CPU tensors) or,
with `cfg.backend == "torch"`, with the twins on any device. `render` is
differentiable in its float inputs through preprocess (its kernel pair's VJP
on the card, torch autograd through its twin on the CPU), torch autograd
(the pair gather) and B2 (the blend); `mean2d_offset` is a zero gradient tap on
the projected centres for the densification statistics
(gsjax/ops/raster/api.py:107-108).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.ops.raster import render_cuda, render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.ops.raster.preprocess import preprocess
from gsjax_torch.utils import spans

BACKENDS = ("auto", "cuda", "torch")


def select(cfg: RasterConfig, device: torch.device, kernels, twins):
    """The pair of functions `cfg.backend` runs on `device`: `twins` for
    "torch", else `kernels` (wrappers that launch the kernels for CUDA
    tensors and run the twins for CPU tensors); "cuda" needs CUDA tensors."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown raster backend {cfg.backend!r}; one of {BACKENDS}")
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors; got tensors on {device}")
    return twins if cfg.backend == "torch" else kernels


def _blend(feats, binning, camera: Camera, cfg: RasterConfig, bg):
    fwd, bwd = select(cfg, feats.device,
                      (render_cuda.blend_fwd, render_cuda.blend_bwd),
                      (render_ref.blend_planes, render_ref.blend_bwd_planes))
    return render_cuda.Blend.apply(feats, binning.tile_start, binning.tile_count,
                                   camera.width, camera.height, camera.fx,
                                   camera.fy, bg, cfg, fwd, bwd)


def mark_visible(means3d: torch.Tensor, camera: Camera,
                 cfg: RasterConfig = RasterConfig()) -> torch.Tensor:
    """[N] bool frustum visibility of gaussian centres (`markVisible`,
    rasterizer_impl.cu:214-233: view-space z > near_plane)."""
    wv = camera.world_view
    z = means3d @ wv[2, :3] + wv[2, 3]
    return z > cfg.near_plane


@spans.spanned("raster.render")
def render(means3d: torch.Tensor,
           scales: torch.Tensor,
           rotations: torch.Tensor,
           opacities: torch.Tensor,
           shs: torch.Tensor,
           camera: Camera,
           cfg: RasterConfig,
           bg: torch.Tensor,
           sg_axis: torch.Tensor | None = None,
           sg_sharpness: torch.Tensor | None = None,
           sg_color: torch.Tensor | None = None,
           alive: torch.Tensor | None = None,
           mean2d_offset: torch.Tensor | None = None) -> dict:
    """Render one view; differentiable in every float input.

    Args:
      means3d: [N,3]; scales/opacities post-activation (3D-filtered);
      rotations: [N,4] raw quaternions; shs: [N,M,3].
      camera, cfg: the camera (on the tensors' device) and the config.
      bg: [3] background colour.
      alive: [N] bool mask for padded model slots.
      mean2d_offset: [N,2] added to the projected centres (zeros that
        require grad: the densification statistics' gradient tap).

    Returns dict:
      render [H,W,3], alpha [H,W], normal [H,W,3], median_depth [H,W],
      n_contrib [H,W] int32, radii [N], visibility [N] bool, num_pairs,
      num_live_pairs, max_tile_count (Python ints).
    """
    prep = preprocess(means3d, scales, rotations, opacities, shs,
                      sg_axis, sg_sharpness, sg_color, camera, cfg, alive)
    if mean2d_offset is not None:
        prep = dataclasses.replace(prep, mean2d=prep.mean2d + mean2d_offset)
    binning = bin_gaussians(prep, cfg, camera.width, camera.height)
    feats = render_ref.prepare_pairs(prep, binning)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=feats.device).reshape(3).contiguous()
    images = render_ref.planes_to_images(_blend(feats, binning, camera, cfg, bg))
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

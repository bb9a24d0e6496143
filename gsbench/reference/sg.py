# Frozen copy of gsjax_torch/core/sg.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""Spherical-Gaussian appearance term (port of `gsjax/core/sg.py`).

Each of `degree` active lobes adds `color_g * exp(sharpness_g * (axis_g . dir - 1))`
(the SG loop of `computeColorFromSHSG`, render_forward.cu:62-70).
"""

from __future__ import annotations

import torch


def eval_sg(degree: int, sg_axis: torch.Tensor, sg_sharpness: torch.Tensor,
            sg_color: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sg_axis [N,G,3] unit axes, sg_sharpness [N,G] (post-softplus),
    sg_color [N,G,3], dirs [N,3] -> [N,3] colour contribution."""
    if degree <= 0:
        return torch.zeros_like(dirs)
    axis = sg_axis[:, :degree]
    sharp = sg_sharpness[:, :degree]
    color = sg_color[:, :degree]
    cos = torch.einsum("ngk,nk->ng", axis, dirs)
    lobe = torch.exp(sharp * (cos - 1.0))
    return torch.einsum("ng,ngk->nk", lobe, color)

# Frozen copy of gsjax_torch/ops/warp_sample.py at commit 95f6082: the twin
# `bilinear_ref` and `WarpSample`, without the kernel's wrappers.
"""B6's twin and its autograd Function (the NCC's neighbour-tap sampler)."""

from __future__ import annotations

import torch


def bilinear_ref(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Twin of B6: [3, *u.shape] (value, d/du, d/dv) of `img` [H, W] at (u, v)."""
    h, w = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    wu = u - u0
    wv = v - v0
    # clamp in float, then convert: the same index as gsjax's int-then-clip
    # for every finite coordinate, with no integer overflow for far taps
    u0i = torch.clamp(u0, 0, w - 1).to(torch.int64)
    u1i = torch.clamp(u0 + 1.0, 0, w - 1).to(torch.int64)
    v0i = torch.clamp(v0, 0, h - 1).to(torch.int64)
    v1i = torch.clamp(v0 + 1.0, 0, h - 1).to(torch.int64)
    c00 = img[v0i, u0i]
    c01 = img[v0i, u1i]
    c10 = img[v1i, u0i]
    c11 = img[v1i, u1i]
    val = (1 - wv) * ((1 - wu) * c00 + wu * c01) + wv * ((1 - wu) * c10 + wu * c11)
    du = (1 - wv) * (c01 - c00) + wv * (c11 - c10)
    dv = (1 - wu) * (c10 - c00) + wu * (c11 - c01)
    return torch.stack([val, du, dv])


class WarpSample(torch.autograd.Function):
    """Differentiable bilinear sample: value = fn(img, u, v)[0], with
    d(u) = d(value) fn[1] and d(v) = d(value) fn[2]."""

    @staticmethod
    def forward(ctx, img, u, v, fn):
        out = fn(img, u, v)
        ctx.save_for_backward(out[1], out[2])
        return out[0]

    @staticmethod
    def backward(ctx, d_val):
        du, dv = ctx.saved_tensors
        return None, d_val * du, d_val * dv, None

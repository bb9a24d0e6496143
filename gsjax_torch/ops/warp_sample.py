"""Bilinear samples of an image at warped tap positions: the neighbour taps
of the patch-warped NCC.

`warp_sample` wraps the CUDA kernel `csrc/warp_sample.cu` (B6), which
replaces the TPU kernel `gsjax/ops/warp_sample.py:_kernel`. It samples an
[Hn, Wn] image at positions (u, v) [K, H, W] and returns [3, K, H, W]
float32 planes: the value, d/du and d/dv. For tensors on the CPU it runs its
plain-PyTorch twin `bilinear_ref`; for CUDA tensors it launches the kernel
or raises. `warp_sample.launches` counts kernel launches.

`warp_sample_blocks` is the same kernel launched on the taps of compacted
16x16 pixel blocks, [B, K, 256] (gsjax's `warp_sample_blocks`, which runs
the same `pallas_call` on pre-blocked taps), with its own count
`warp_sample_blocks.launches`, so that a run can tell the dense and the
block-compacted NCC apart. gsjax's `ok` plane flags taps outside the TPU
kernel's bf16 window; the port samples every tap exactly, so it has none.

The semantics are those of gsjax's off-TPU sampler `ncc._bilinear`
(ncc.py:39-58): corner indices clamped to the image one by one, weights from
the unclamped coordinate, and the derivative that autodiff of that formula
gives (the floor has zero gradient, so a corner pair clamped to one pixel
gives zero). Taps outside the image are the caller's to mask.

`WarpSample` is the differentiable sampler, as gsjax's `custom_vjp`
`warp_sample`: d(u) = d(value) d/du, d(v) = d(value) d/dv, and the image
gets no gradient (the NCC never differentiates the images).
"""

from __future__ import annotations

import torch

from gsjax_torch import _build
from gsjax_torch.ops.raster.render_cuda import _check


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


def _launch(name: str, img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """B6 on CUDA tensors: [3, *u.shape] planes, and whether it launched (an
    empty set of taps launches nothing)."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    _check("img", img, torch.float32, (img.shape[0], img.shape[1]), dev)
    _check("u", u, torch.float32, tuple(u.shape), dev)
    _check("v", v, torch.float32, tuple(u.shape), dev)
    if img.numel() == 0:
        raise ValueError(f"{name} needs a non-empty image")
    out = torch.empty((3,) + tuple(u.shape), device=dev)
    n = u.numel()
    if n == 0:
        return out, False
    fn = _build.load("warp_sample").gsjax_warp_sample
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(img.data_ptr(), img.shape[0], img.shape[1], u.data_ptr(), v.data_ptr(),
                out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out, True


def warp_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[3, K, H, W] float32 (value, d/du, d/dv) of `img` [Hn, Wn] float32 at
    tap positions u, v [K, H, W] float32, all on one device."""
    if img.device.type == "cpu":
        return bilinear_ref(img, u, v)
    out, launched = _launch("warp_sample", img, u, v)
    warp_sample.launches += launched
    return out


warp_sample.launches = 0


def warp_sample_blocks(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[3, B, K, P] float32 (value, d/du, d/dv) of `img` [Hn, Wn] float32 at
    the tap positions u, v [B, K, P] float32 of B compacted pixel blocks
    (P = 256 pixels a block, K taps a pixel), all on one device."""
    if img.device.type == "cpu":
        return bilinear_ref(img, u, v)
    out, launched = _launch("warp_sample_blocks", img, u, v)
    warp_sample_blocks.launches += launched
    return out


warp_sample_blocks.launches = 0


class WarpSample(torch.autograd.Function):
    """Differentiable bilinear sample: value = fn(img, u, v)[0], with
    d(u) = d(value) fn[1] and d(v) = d(value) fn[2]; `fn` is `warp_sample`
    or `warp_sample_blocks` (the kernel on CUDA tensors, the twin on the
    CPU) or `bilinear_ref` on any device. Only u and v get gradients (gsjax's
    `_ws_bwd`, which is also `warp_sample_blocks`' `_wsb_bwd`)."""

    @staticmethod
    def forward(ctx, img, u, v, fn):
        out = fn(img, u, v)
        ctx.save_for_backward(out[1], out[2])
        return out[0]

    @staticmethod
    def backward(ctx, d_val):
        du, dv = ctx.saved_tensors
        return None, d_val * du, d_val * dv, None

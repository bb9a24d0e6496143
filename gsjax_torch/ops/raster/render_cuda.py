"""Forward tile blend: wrapper of the CUDA kernel `csrc/blend_fwd.cu`.

The kernel replaces the TPU kernel `gsjax/ops/raster/render_pallas.py:
_fwd_kernel` + `_median_search`. `blend_fwd` takes the pair payload of a
frame in binning order and returns its [16, H, W] planes (rows as in
`render_ref`). For a tensor on the CPU it runs the plain-PyTorch twin
`render_ref.blend_planes`; for a CUDA tensor it launches the kernel or
raises. `blend_fwd.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from gsjax_torch import _build
from gsjax_torch.ops.raster import render_ref
from gsjax_torch.ops.raster.config import RasterConfig

_SIDE = 16  # pixels per side of the kernel's thread block


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def blend_fwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
              tile_count: torch.Tensor, width: int, height: int, fx: float,
              fy: float, bg: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """Blend every tile of a frame -> [16, H, W] float32 planes.

    feats_pairs [K, 16] float32 (render_ref.prepare_pairs), tile_start /
    tile_count [T] int32, bg [3] float32, all on one device."""
    if feats_pairs.device.type == "cpu":
        return render_ref.blend_planes(feats_pairs, tile_start, tile_count,
                                       width, height, fx, fy, bg, cfg)
    dev = feats_pairs.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cuda or cpu tensors, not {dev}")
    if cfg.tile % _SIDE:
        raise ValueError(f"the CUDA blend needs a tile size divisible by {_SIDE}, "
                         f"got {cfg.tile}")
    tiles_x, tiles_y = cfg.grid(width, height)
    n_tiles = tiles_x * tiles_y
    _check("feats_pairs", feats_pairs, torch.float32,
           (feats_pairs.shape[0], render_ref.N_PLANES), dev)
    _check("tile_start", tile_start, torch.int32, (n_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (n_tiles,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    if feats_pairs.data_ptr() % 16:
        raise ValueError("feats_pairs must be 16-byte aligned (float4 loads)")
    if feats_pairs.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 pairs do not fit int32 tile offsets")

    out = torch.empty(render_ref.N_PLANES, height, width, device=dev)
    if n_tiles == 0:
        return out
    fn = _build.load("blend_fwd").gsjax_blend_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(),
                tile_count.data_ptr(), bg.data_ptr(), out.data_ptr(),
                width, height, tiles_x, tiles_y, cfg.tile, fx, fy,
                cfg.max_per_tile, int(cfg.require_depth), cfg.alpha_clamp,
                cfg.alpha_min, cfg.transmittance_min, cfg.sample_range,
                cfg.min_transmittance, stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {rc}")
    blend_fwd.launches += 1
    return out


blend_fwd.launches = 0

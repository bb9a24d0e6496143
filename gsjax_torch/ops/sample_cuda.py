"""Point-query kernels: wrappers of `csrc/sample_fwd.cu` (B3, and B4 in its
integrate mode) and `csrc/sample_bwd.cu` (B5), and the autograd Function
that pairs B3 and B5.

B3 replaces the TPU kernel `gsjax/ops/raster/sample_pallas.py:_sfwd_kernel`
in depth mode, B4 the same kernel in integrate mode, B5 its backward
`_sbwd_kernel`. `sample_fwd` takes a view's pair payload in binning order,
points sorted by tile and their block table (`sample_ref` for the layout) and
returns the [6, Q] rows; `integrate_fwd` takes the same and the points' ray
distances and returns the [5, Q] rows (forward only, as gsjax and the
reference's evaluateTransmittance); `sample_bwd` takes B3's rows and the
cotangent of row 0 (m_t) and returns d(payload) [K, 16] and d(points) [Q, 2].
For tensors on the CPU each runs its plain-PyTorch twin
(`sample_ref.sample_fwd_rows`, `integrate_rows`, `sample_bwd_rows`); for CUDA
tensors each launches its kernel or raises. `sample_fwd.launches`,
`integrate_fwd.launches` and `sample_bwd.launches` count kernel launches.
`sample_fwd` takes B1's median-search arguments `slots` and `counters`
(`render_cuda.blend_fwd`); B4 runs no search; `sample_bwd` takes B2's
profile `counters` (`render_cuda.blend_bwd`).

`SampleDepth` is the differentiable query, as gsjax's `custom_vjp`
`sample_depth_pallas`: its forward keeps the payload, the points, the lists
and the rows; its backward runs the matching backward on the cotangent of
row 0 (rows 1-5 are not differentiable).
"""

from __future__ import annotations

import torch

from gsjax_torch import _build
from gsjax_torch.ops import sample_ref
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.ops.raster.render_cuda import (SLOTS, _check, check_bwd_counters,
                                                check_search_args)


def _check_launch(name, feats_pairs, tile_start, tile_count, pts, blocks):
    """Argument checks shared by both kernels."""
    dev = feats_pairs.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    n_tiles = tile_start.shape[0]
    _check("feats_pairs", feats_pairs, torch.float32, (feats_pairs.shape[0], 16), dev)
    _check("tile_start", tile_start, torch.int32, (n_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (n_tiles,), dev)
    _check("pts", pts, torch.float32, (pts.shape[0], 2), dev)
    _check("blocks", blocks, torch.int32, (blocks.shape[0], 3), dev)
    if feats_pairs.data_ptr() % 16:
        raise ValueError("feats_pairs must be 16-byte aligned (float4 loads)")
    if feats_pairs.shape[0] >= 2 ** 31 or pts.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 pairs or points do not fit int32 offsets")


def sample_fwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
               tile_count: torch.Tensor, pts: torch.Tensor, blocks: torch.Tensor,
               cfg: RasterConfig, slots: int = SLOTS,
               counters: torch.Tensor | None = None) -> torch.Tensor:
    """Median ray distance at each point -> [6, Q] float32 rows, sorted order.

    feats_pairs [K, 16] float32, tile_start / tile_count [T] int32, pts
    [Q, 2] float32 sorted by tile, blocks [NB, 3] int32 (tile, first point,
    count <= 256), all on one device. `slots`, `counters`: the median
    search's, as `render_cuda.blend_fwd`'s."""
    ctr = check_search_args("sample_fwd", slots, counters, feats_pairs.device)
    if feats_pairs.device.type == "cpu":
        return sample_ref.sample_fwd_rows(feats_pairs, tile_start, tile_count, pts,
                                          blocks, cfg)
    _check_launch("sample_fwd", feats_pairs, tile_start, tile_count, pts, blocks)
    q = pts.shape[0]
    out = torch.zeros(sample_ref.N_ROWS, q, device=pts.device)
    if blocks.shape[0] == 0:
        return out
    fn = _build.load("sample_fwd").gsjax_sample_fwd
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                pts.data_ptr(), blocks.data_ptr(), out.data_ptr(), ctr, blocks.shape[0],
                q, cfg.max_per_tile, slots, cfg.alpha_clamp, cfg.alpha_min,
                cfg.transmittance_min, cfg.sample_range, cfg.min_transmittance,
                stream)
    if rc != 0:
        raise RuntimeError(f"sample_fwd kernel launch failed: cudaError {rc}")
    sample_fwd.launches += 1
    return out


sample_fwd.launches = 0


def integrate_fwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, pts: torch.Tensor, t_eval: torch.Tensor,
                  blocks: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """Transmittance at each point's own ray distance -> [5, Q] float32 rows,
    sorted order (row 0 T(point), 1 covered, 2-4 n_contrib, md_init,
    T_final).

    t_eval [Q] float32: the sorted points' ray distances; other arguments
    as `sample_fwd`."""
    if feats_pairs.device.type == "cpu":
        return sample_ref.integrate_rows(feats_pairs, tile_start, tile_count, pts,
                                         t_eval, blocks, cfg)
    _check_launch("integrate_fwd", feats_pairs, tile_start, tile_count, pts, blocks)
    q = pts.shape[0]
    _check("t_eval", t_eval, torch.float32, (q,), pts.device)
    out = torch.zeros(sample_ref.N_ROWS_INTEGRATE, q, device=pts.device)
    if blocks.shape[0] == 0:
        return out
    fn = _build.load("integrate_fwd").gsjax_integrate_fwd
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                pts.data_ptr(), t_eval.data_ptr(), blocks.data_ptr(), out.data_ptr(),
                blocks.shape[0], q, cfg.max_per_tile, cfg.alpha_clamp, cfg.alpha_min,
                cfg.transmittance_min, stream)
    if rc != 0:
        raise RuntimeError(f"integrate_fwd kernel launch failed: cudaError {rc}")
    integrate_fwd.launches += 1
    return out


integrate_fwd.launches = 0


def sample_bwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
               tile_count: torch.Tensor, pts: torch.Tensor, blocks: torch.Tensor,
               res: torch.Tensor, g: torch.Tensor, cfg: RasterConfig,
               counters: torch.Tensor | None = None):
    """VJP of `sample_fwd`'s m_t -> (d_feats [K, 16], d_pts [Q, 2]) float32.

    res [6, Q]: `sample_fwd`'s output for these arguments; g [Q]: the
    cotangent of its row 0; `counters`: None, or a
    `render_cuda.bwd_counters` buffer the kernel fills. Other arguments as
    `sample_fwd`."""
    ctr = check_bwd_counters("sample_bwd", counters, feats_pairs.device)
    if feats_pairs.device.type == "cpu":
        return sample_ref.sample_bwd_rows(feats_pairs, tile_start, tile_count, pts,
                                          blocks, res, g, cfg)
    _check_launch("sample_bwd", feats_pairs, tile_start, tile_count, pts, blocks)
    dev = pts.device
    q = pts.shape[0]
    _check("res", res, torch.float32, (sample_ref.N_ROWS, q), dev)
    _check("g", g, torch.float32, (q,), dev)
    d_feats = torch.zeros_like(feats_pairs)
    d_pts = torch.zeros_like(pts)
    if blocks.shape[0] == 0 or feats_pairs.shape[0] == 0:
        return d_feats, d_pts
    fn = _build.load("sample_bwd").gsjax_sample_bwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                pts.data_ptr(), blocks.data_ptr(), res.data_ptr(), g.data_ptr(),
                d_feats.data_ptr(), d_pts.data_ptr(), ctr, blocks.shape[0], q,
                cfg.max_per_tile, cfg.alpha_clamp, cfg.alpha_min, stream)
    if rc != 0:
        raise RuntimeError(f"sample_bwd kernel launch failed: cudaError {rc}")
    sample_bwd.launches += 1
    return d_feats, d_pts


sample_bwd.launches = 0


class SampleDepth(torch.autograd.Function):
    """Differentiable point query: rows = fwd(feats, ..., pts, ...), with
    (d(feats), d(pts)) = bwd(..., rows, d(rows[0])). `fwd` / `bwd` are
    `sample_fwd` / `sample_bwd` (kernels on CUDA tensors, twins on the CPU)
    or the twins `sample_ref.sample_fwd_rows` / `sample_bwd_rows` on any
    device."""

    @staticmethod
    def forward(ctx, feats, pts, tile_start, tile_count, blocks, cfg, fwd, bwd):
        res = fwd(feats, tile_start, tile_count, pts, blocks, cfg)
        ctx.save_for_backward(feats, pts, tile_start, tile_count, blocks, res)
        ctx.args = (cfg, bwd)
        return res

    @staticmethod
    def backward(ctx, grad_res):
        feats, pts, tile_start, tile_count, blocks, res = ctx.saved_tensors
        cfg, bwd = ctx.args
        d_feats, d_pts = bwd(feats, tile_start, tile_count, pts, blocks, res,
                             grad_res[0].contiguous(), cfg)
        return (d_feats, d_pts) + (None,) * 6

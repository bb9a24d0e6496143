"""Tile blend kernels: wrappers of `csrc/blend_fwd.cu` (B1) and
`csrc/blend_bwd.cu` (B2), and the autograd Function that pairs them.

B1 replaces the TPU kernel `gsjax/ops/raster/render_pallas.py:_fwd_kernel` +
`_median_search`, B2 its backward `_bwd_kernel`. `blend_fwd` takes the pair
payload of a frame in binning order and returns its [16, H, W] planes (rows
as in `render_ref`); `blend_bwd` takes those planes and their cotangent and
returns d(payload) [K, 16]. For tensors on the CPU each runs its plain-PyTorch
twin (`render_ref.blend_planes`, `render_ref.blend_bwd_planes`); for CUDA
tensors each launches its kernel or raises. `blend_fwd.launches` and
`blend_bwd.launches` count kernel launches.

Both take an optional tile-row list `tile_rows` (the TPU kernels' tile
subset): they then run only those rows of tiles, a band of the frame on the
multi-device path (`gsjax_torch.parallel`), on band-local planes
[16, len(tile_rows) * tile, W] whose rows follow the list (`band_height`).
On every listed tile the band launch gives the full-frame launch's bits.

B1's median search (`csrc/median.cuh`, shared with B3) keeps each pixel's
varying pairs in `slots` slots of shared memory and re-walks the list
for a pixel whose set does not fit; `slots=0` sends every pixel down that
re-walk. An optional int32 `counters` buffer (`search_counters`) is filled
by the kernel with how the search went, read by `search_stats`. B2 (and B5,
`sample_cuda.sample_bwd`) takes an optional int64 `counters` buffer
(`bwd_counters`) of where its warp cycles go, read by `bwd_stats`; B2 takes
the binning tile of 32 only (one block a tile).

`Blend` is the differentiable blend, as gsjax's `custom_vjp` `blend_pallas`:
its forward runs a forward blend and keeps the payload, the lists and the
planes; its backward runs the matching backward blend on the cotangent of
rows 0-7 (rows 8-15 are not differentiable).
"""

from __future__ import annotations

import torch

from gsjax_torch import _build
from gsjax_torch.ops.raster import render_ref
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.utils import spans

_SIDE = 16  # pixels per side of B1's thread block
_BWD_TILE = 32  # B2 runs one block per 32x32 binning tile

# Median slots per pixel or point (12 B each, 256 threads a block, so
# slots x 3 KB of shared memory a block; 32 leave two blocks an SM), chosen
# on the card (PERF.md).
SLOTS = 32
MAX_SLOTS = 64            # with the 16 KB staging buffer, within 227 KB
# The search counters, in the order of median.cuh:Counter (the cycles are
# warp cycles / 1024 summed over warps, read with clock64); then two
# histograms of searched threads by varying pairs, at the fold cut (6 sigma)
# and at the wide cut (14.5 sigma), the last bin holding the rest.
SEARCH_COUNTERS = ("candidates", "slot_threads", "walk_threads", "iter_sum",
                   "iter_max", "varying_sum", "varying_max", "folded_sum",
                   "applied_sum", "wide_sum", "wide_max", "walk_sweeps",
                   "walk_thread_sweeps", "cycles_march", "cycles_fold", "cycles_slots",
                   "cycles_walk")
_HIST, HIST_BINS = 20, 256
N_COUNTERS = _HIST + 2 * HIST_BINS
# The backward kernels' profile counters (B2, B5), in the order of
# bwd_common.cuh:Counter, int64: warp-pairs walked (one warp's step over one
# staged pair), those where some lane applies the pair, the applying lanes
# and the applied interactions summed over those, and warp cycles (clock64,
# summed over warps) in the setup, the staging and barriers, the alpha test
# and skip, the applied math, and the reduction with its writes.
BWD_COUNTERS = ("warp_pairs", "warp_pairs_active", "lanes_active", "applied",
                "cycles_setup", "cycles_stage", "cycles_alpha", "cycles_apply",
                "cycles_reduce")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def band_height(tile_rows, height: int, cfg: RasterConfig) -> int:
    """Rows of the planes a blend writes: the frame's height, or
    len(tile_rows) tiles for a tile-row list."""
    return height if tile_rows is None else len(tile_rows) * cfg.tile


def rows_tensor(tile_rows, width: int, height: int, cfg: RasterConfig,
                device) -> torch.Tensor | None:
    """A tile-row list (a sequence of ints) checked against the frame's
    grid -> int32 tensor on `device`; None stays None (every row)."""
    if tile_rows is None:
        return None
    if torch.is_tensor(tile_rows):
        tile_rows = tile_rows.tolist()
    rows = [int(r) for r in tile_rows]
    _, tiles_y = cfg.grid(width, height)
    if any(not 0 <= r < tiles_y for r in rows):
        raise ValueError(f"tile rows {rows} outside the frame's {tiles_y} rows")
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _check_launch(name, feats_pairs, tile_start, tile_count, bg, width, height,
                  cfg: RasterConfig) -> tuple[int, int]:
    """Argument checks shared by both kernels; returns (tiles_x, tiles_y)."""
    dev = feats_pairs.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
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
    return tiles_x, tiles_y


def search_counters(device) -> torch.Tensor:
    """A zeroed counters buffer for `blend_fwd` / `sample_cuda.sample_fwd`."""
    return torch.zeros(N_COUNTERS, dtype=torch.int32, device=device)


def check_search_args(name, slots, counters, device):
    """Checks the median search's `slots` and `counters` -> counters' address
    (0 for none), the buffer zeroed. The twins have no slots or counters:
    on the CPU `counters` must be None."""
    if not 0 <= slots <= MAX_SLOTS:
        raise ValueError(f"{name}: slots must be in [0, {MAX_SLOTS}], got {slots}")
    if counters is None:
        return 0
    if device.type != "cuda":
        raise ValueError(f"{name}: search counters come from the kernel, on cuda")
    _check("counters", counters, torch.int32, (N_COUNTERS,), device)
    counters.zero_()
    return counters.data_ptr()


def bwd_counters(device) -> torch.Tensor:
    """A zeroed profile buffer for `blend_bwd` / `sample_cuda.sample_bwd`."""
    return torch.zeros(len(BWD_COUNTERS), dtype=torch.int64, device=device)


def check_bwd_counters(name, counters, device):
    """Checks a backward kernel's `counters` -> its address (0 for none), the
    buffer zeroed. The twins have no counters: on the CPU it must be None."""
    if counters is None:
        return 0
    if device.type != "cuda":
        raise ValueError(f"{name}: profile counters come from the kernel, on cuda")
    _check("counters", counters, torch.int64, (len(BWD_COUNTERS),), device)
    counters.zero_()
    return counters.data_ptr()


def bwd_stats(counters: torch.Tensor) -> dict:
    """A filled `bwd_counters` buffer -> where the backward's warp cycles
    went: warp-pairs walked, the share with an applying lane, applying lanes
    and interactions per such warp-pair, the cycle shares by part, and
    cycles per warp-pair (alpha) or per active warp-pair (apply, reduce)."""
    n = dict(zip(BWD_COUNTERS, (int(x) for x in counters.cpu())))
    parts = [k[len("cycles_"):] for k in BWD_COUNTERS if k.startswith("cycles_")]
    cycles = sum(n[f"cycles_{k}"] for k in parts)
    walked, active = n["warp_pairs"], n["warp_pairs_active"]
    per = lambda v, d: v / d if d else 0.0
    return {"warp_pairs": walked, "warp_pairs_active": active, "applied": n["applied"],
            "active_share": per(active, walked),
            "lanes_per_active": per(n["lanes_active"], active),
            "applied_per_active": per(n["applied"], active),
            "warp_cycles": cycles,
            "cycle_shares": {k: per(n[f"cycles_{k}"], cycles) for k in parts},
            "cycles_per_warp_pair": {"alpha": per(n["cycles_alpha"], walked),
                                     "apply": per(n["cycles_apply"], active),
                                     "reduce": per(n["cycles_reduce"], active)}}


def search_stats(counters: torch.Tensor) -> dict:
    """A filled counters buffer -> how the median search went: threads
    searched (root in range) on each path, Newton evaluations per searched
    thread, varying pairs per searched thread (percentiles from the
    histogram, exact up to its last bin) at both cuts, the share of applied
    pairs folded, re-walk sweeps (per block), the shares of warp cycles in
    the march, the first sweep, the slots and the re-walks, and both
    histograms trimmed after their last non-empty bin."""
    c = [int(x) for x in counters.cpu()]
    n = dict(zip(SEARCH_COUNTERS, c))
    searched = n["slot_threads"] + n["walk_threads"]

    def trim(h):
        last = max((i for i, v in enumerate(h) if v), default=-1)
        return h[:last + 1]

    def pct(h, q):
        acc, need = 0, q * sum(h)
        for i, v in enumerate(h):
            acc += v
            if acc >= need and acc:
                return i
        return 0

    cycles = sum(n[f"cycles_{k}"] for k in ("march", "fold", "slots", "walk"))
    hist = c[_HIST:_HIST + HIST_BINS]
    wide = c[_HIST + HIST_BINS:]
    per = lambda k: n[k] / searched if searched else 0.0
    return {"candidates": n["candidates"], "searched": searched,
            "slot_share": per("slot_threads"), "walk_share": per("walk_threads"),
            "iters_mean": per("iter_sum"), "iters_max": n["iter_max"],
            "varying_mean": per("varying_sum"), "varying_p50": pct(hist, 0.5),
            "varying_p99": pct(hist, 0.99), "varying_max": n["varying_max"],
            "wide_mean": per("wide_sum"), "wide_p50": pct(wide, 0.5),
            "wide_p99": pct(wide, 0.99), "wide_max": n["wide_max"],
            "folded_share": n["folded_sum"] / n["applied_sum"] if n["applied_sum"] else 0.0,
            "walk_sweeps": n["walk_sweeps"],
            "walks_per_walker": n["walk_thread_sweeps"] / n["walk_threads"]
            if n["walk_threads"] else 0.0,
            "cycle_shares": {k: n[f"cycles_{k}"] / cycles if cycles else 0.0
                             for k in ("march", "fold", "slots", "walk")},
            "hist": trim(hist), "hist_wide": trim(wide)}


def blend_fwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
              tile_count: torch.Tensor, width: int, height: int, fx: float,
              fy: float, bg: torch.Tensor, cfg: RasterConfig, slots: int = SLOTS,
              counters: torch.Tensor | None = None, tile_rows=None) -> torch.Tensor:
    """Blend every tile of a frame -> [16, H, W] float32 planes.

    feats_pairs [K, 16] float32 (render_ref.prepare_pairs), tile_start /
    tile_count [T] int32, bg [3] float32, all on one device. `slots`: the
    median search's slots per pixel; `counters`: None, or a
    `search_counters` buffer the kernel fills; `tile_rows`: None, or the
    tile rows to blend (-> [16, len(tile_rows) * tile, W], zero past the
    frame's height)."""
    ctr = check_search_args("blend_fwd", slots, counters, feats_pairs.device)
    if feats_pairs.device.type == "cpu":
        return render_ref.blend_planes(feats_pairs, tile_start, tile_count,
                                       width, height, fx, fy, bg, cfg,
                                       tile_rows=tile_rows)
    tiles_x, tiles_y = _check_launch("blend_fwd", feats_pairs, tile_start,
                                     tile_count, bg, width, height, cfg)
    dev = feats_pairs.device
    rows = rows_tensor(tile_rows, width, height, cfg, dev)
    out_h = band_height(tile_rows, height, cfg)
    alloc = torch.empty if rows is None else torch.zeros
    out = alloc(render_ref.N_PLANES, out_h, width, device=dev)
    if tiles_x * out_h == 0:
        return out
    fn = _build.load("blend_fwd").gsjax_blend_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(),
                tile_count.data_ptr(), 0 if rows is None else rows.data_ptr(),
                0 if rows is None else rows.numel(), bg.data_ptr(), out.data_ptr(), ctr,
                width, height, tiles_x, tiles_y, cfg.tile, fx, fy,
                cfg.max_per_tile, int(cfg.require_depth), slots, cfg.alpha_clamp,
                cfg.alpha_min, cfg.transmittance_min, cfg.sample_range,
                cfg.min_transmittance, stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {rc}")
    blend_fwd.launches += 1
    return out


blend_fwd.launches = 0


def blend_bwd(feats_pairs: torch.Tensor, tile_start: torch.Tensor,
              tile_count: torch.Tensor, planes: torch.Tensor,
              grad_planes: torch.Tensor, width: int, height: int, fx: float,
              fy: float, bg: torch.Tensor, cfg: RasterConfig,
              counters: torch.Tensor | None = None, tile_rows=None) -> torch.Tensor:
    """VJP of `blend_fwd` w.r.t. the pair payload -> d_feats [K, 16] float32.

    planes [16, H, W]: `blend_fwd`'s output for these arguments; grad_planes
    [16, H, W]: its cotangent (rows 0-7 read); `counters`: None, or a
    `bwd_counters` buffer the kernel fills; `tile_rows`: None, or the tile
    rows to run, with band-local planes and cotangent [16, len(tile_rows) *
    tile, W]. Other arguments as `blend_fwd`."""
    ctr = check_bwd_counters("blend_bwd", counters, feats_pairs.device)
    if feats_pairs.device.type == "cpu":
        return render_ref.blend_bwd_planes(feats_pairs, tile_start, tile_count,
                                           planes, grad_planes, width, height,
                                           fx, fy, bg, cfg, tile_rows=tile_rows)
    tiles_x, tiles_y = _check_launch("blend_bwd", feats_pairs, tile_start,
                                     tile_count, bg, width, height, cfg)
    if cfg.tile != _BWD_TILE:
        raise ValueError(f"the CUDA blend backward takes {_BWD_TILE}x{_BWD_TILE} "
                         f"tiles, got {cfg.tile}")
    dev = feats_pairs.device
    rows = rows_tensor(tile_rows, width, height, cfg, dev)
    out_h = band_height(tile_rows, height, cfg)
    _check("planes", planes, torch.float32, (render_ref.N_PLANES, out_h, width), dev)
    _check("grad_planes", grad_planes, torch.float32,
           (render_ref.N_PLANES, out_h, width), dev)
    d_feats = torch.zeros_like(feats_pairs)
    if tiles_x * out_h == 0 or feats_pairs.shape[0] == 0:
        return d_feats
    fn = _build.load("blend_bwd").gsjax_blend_bwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats_pairs.data_ptr(), tile_start.data_ptr(),
                tile_count.data_ptr(), 0 if rows is None else rows.data_ptr(),
                0 if rows is None else rows.numel(), planes.data_ptr(),
                grad_planes.data_ptr(),
                bg.data_ptr(), d_feats.data_ptr(), ctr, width, height, tiles_x,
                tiles_y, cfg.tile, fx, fy, cfg.max_per_tile,
                int(cfg.require_depth), cfg.alpha_clamp, cfg.alpha_min, stream)
    if rc != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {rc}")
    blend_bwd.launches += 1
    return d_feats


blend_bwd.launches = 0


class Blend(torch.autograd.Function):
    """Differentiable blend of a frame: planes = fwd(feats, ...), with
    d(feats) = bwd(feats, ..., planes, d(planes)). `fwd` / `bwd` are
    `blend_fwd` / `blend_bwd` (kernels on CUDA tensors, twins on the CPU) or
    the twins `render_ref.blend_planes` / `blend_bwd_planes` on any device.
    With `tile_rows`, both run on that band of tile rows. Only `feats` gets a
    gradient."""

    @staticmethod
    @spans.spanned("raster.blend")
    def forward(ctx, feats, tile_start, tile_count, width, height, fx, fy, bg,
                cfg, fwd, bwd, tile_rows=None):
        planes = fwd(feats, tile_start, tile_count, width, height, fx, fy, bg, cfg,
                     tile_rows=tile_rows)
        ctx.save_for_backward(feats, tile_start, tile_count, planes, bg)
        ctx.args = (width, height, fx, fy, cfg, bwd, tile_rows)
        return planes

    @staticmethod
    @spans.spanned("raster.blend_bwd")
    def backward(ctx, grad_planes):
        feats, tile_start, tile_count, planes, bg = ctx.saved_tensors
        width, height, fx, fy, cfg, bwd, tile_rows = ctx.args
        g = torch.zeros_like(planes)
        g[:8] = grad_planes[:8]          # rows 8-15 are not differentiable
        d_feats = bwd(feats, tile_start, tile_count, planes, g, width, height,
                      fx, fy, bg, cfg, tile_rows=tile_rows)
        return (d_feats,) + (None,) * 11

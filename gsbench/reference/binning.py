# Frozen copy of gsjax_torch/ops/raster/binning.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port).
"""Tile binning: duplicate gaussians into (tile, depth)-sorted pair lists.

Port of `gsjax/ops/raster/binning.py` (`duplicateWithKeys` + radix sort +
`identifyTileRanges`, rasterizer_impl.cu:70-161). The lists match gsjax's
entry for entry, so the port reproduces exactly what fixes their order:

  - pairs are enumerated gaussian-major, then row-major inside each
    gaussian's tile rect (binning.py:113-153);
  - the exact ellipse-tile cull drops pairs whose box-minimum power cannot
    reach alpha_min, with the same 1e-3 margin (:155-199);
  - the fused sort key `tile << depth_bits | (float_bits(depth) >> tile_bits)`
    (:201-219) is sorted with a STABLE sort, so depth ties below the key's
    resolution keep enumeration order, as `lax.sort` does.

The layout differs: gsjax re-lays each tile's slice on a 128-aligned
boundary inside static-capacity buffers (for Mosaic DMA windows); the port
keeps one dense [K] list of live pairs sized by the real count. Tile t's
list is `gauss_idx[tile_start[t] : tile_start[t] + min(tile_count[t],
max_per_tile)]`: the blend clamps each count at `max_per_tile` as gsjax's
kernels do (binning.py:260-265).

Row bands (`row_lo` / `row_hi`, and a second band `row_lo2` / `row_hi2`
at or after the first; binning.py:53-57, :93-110): each gaussian's tile rect
is clipped to the band or bands before enumeration, so a rank of the
multi-device path (`gsjax_torch.parallel`) enumerates, culls and sorts only
its own pairs, and tiles outside the bands report count 0. A tile's list is
the full binning's list for that tile, entry for entry: its pairs keep their
gaussian-major order and their keys.

`continuous_coords` (binning.py:73-78): the blend evaluates pairs at pixel
centres, so the cull's box spans [tile*t, tile*t + t - 1]; the point queries
(ops/sample.py) evaluate at continuous coordinates, which can sit in the
strip past a tile's last pixel centre, so there the box runs to tile*t + t.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gsbench.reference.config import RasterConfig
from gsbench.reference.preprocess import Preprocessed


@dataclasses.dataclass(frozen=True)
class Binning:
    gauss_idx: torch.Tensor    # [K] int64 gaussian per live pair, tile-major, front to back
    tile_start: torch.Tensor   # [T] int32 offset of each tile's list in gauss_idx
    tile_count: torch.Tensor   # [T] int32 live pairs of each tile (unclamped)
    num_pairs: int             # pairs enumerated from the tile rects (before the cull)
    num_live: int              # pairs after the cull (== K)
    max_tile_count: int        # largest tile_count (max_per_tile monitoring)


def bin_gaussians(prep: Preprocessed, cfg: RasterConfig, width: int,
                  height: int, continuous_coords: bool = False,
                  row_lo: int | None = None, row_hi: int | None = None,
                  row_lo2: int | None = None, row_hi2: int | None = None) -> Binning:
    """Bin the gaussians of `prep` into per-tile lists; with `row_lo` /
    `row_hi` (and `row_lo2` / `row_hi2`, a second band starting at or after
    row_hi) only the tile rows [row_lo, row_hi) (and [row_lo2, row_hi2))."""
    tiles_x, tiles_y = cfg.grid(width, height)
    num_tiles = tiles_x * tiles_y
    dev = prep.depth.device
    touched = prep.tiles_touched.to(torch.int64)
    n = touched.shape[0]
    y0 = prep.rect_min[:, 1].to(torch.int64)
    y1 = y0 + prep.rect_wh[:, 1].to(torch.int64)
    rect_w = prep.rect_wh[:, 0].to(torch.int64).clamp_min(1)
    rows1 = (y1 - y0).clamp_min(0)
    y0b = torch.zeros_like(y0)
    if row_lo is not None:
        if row_lo2 is not None and row_lo2 < row_hi:
            raise ValueError(f"second band [{row_lo2}, {row_hi2}) starts before "
                             f"the first ends ({row_hi})")
        # clip each rect to the band(s); culled gaussians keep touched == 0
        y0 = y0.clamp(row_lo, row_hi)
        rows1 = (y1.clamp(row_lo, row_hi) - y0).clamp_min(0)
        rows2 = torch.zeros_like(rows1)
        if row_lo2 is not None:
            y0b = prep.rect_min[:, 1].to(torch.int64).clamp(row_lo2, row_hi2)
            rows2 = (y1.clamp(row_lo2, row_hi2) - y0b).clamp_min(0)
        touched = torch.where(touched > 0, rect_w * (rows1 + rows2),
                              torch.zeros_like(touched))

    # pair p -> (source gaussian g, rank j inside g's (clipped) tile rect);
    # the rank walks the first band's rows, then the second's
    g = torch.repeat_interleave(torch.arange(n, device=dev), touched)
    total = g.shape[0]
    starts_exc = torch.cumsum(touched, 0) - touched
    j = torch.arange(total, device=dev) - starts_exc[g]
    w = rect_w[g]
    jr = j // w
    r1 = rows1[g]
    ty = torch.where(jr < r1, y0[g] + jr, y0b[g] + (jr - r1))
    tx = prep.rect_min[g, 0].to(torch.int64) + j % w
    tile = ty * tiles_x + tx

    # exact ellipse-tile cull: the pair is dead iff the minimum over the
    # tile's pixel box of q(dx,dy) = 0.5 ca dx^2 + cb dx dy + 0.5 cc dy^2
    # exceeds ln(op / alpha_min) (gsjax binning.py:155-199)
    gx, gy = prep.mean2d[g, 0], prep.mean2d[g, 1]
    ca, cb, cc = prep.conic[g, 0], prep.conic[g, 1], prep.conic[g, 2]
    op = prep.opacity[g]
    txp = (tx * cfg.tile).to(torch.float32)
    typ = (ty * cfg.tile).to(torch.float32)
    box_hi = cfg.tile if continuous_coords else cfg.tile - 1
    ax = gx - (txp + box_hi)
    bx = gx - txp
    ay = gy - (typ + box_hi)
    by = gy - typ
    ca_s = ca.clamp_min(1e-12)
    cc_s = cc.clamp_min(1e-12)

    def q_at(dx, dy):
        return 0.5 * ca * dx * dx + cb * dx * dy + 0.5 * cc * dy * dy

    def edge_x(dxf):
        return q_at(dxf, torch.minimum(torch.maximum(-cb * dxf / cc_s, ay), by))

    def edge_y(dyf):
        return q_at(torch.minimum(torch.maximum(-cb * dyf / ca_s, ax), bx), dyf)

    inside = (ax <= 0) & (bx >= 0) & (ay <= 0) & (by >= 0)
    q_min = torch.where(inside, torch.zeros_like(ax), torch.minimum(
        torch.minimum(edge_x(ax), edge_x(bx)),
        torch.minimum(edge_y(ay), edge_y(by))))
    thr = torch.log(op.clamp_min(1e-12)) - math.log(cfg.alpha_min)
    live = q_min <= thr + 1e-3

    tile, g = tile[live], g[live]
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = 32 - tile_bits
    dbits = prep.depth[g].clamp_min(0.0).view(torch.int32).to(torch.int64)
    key = (tile << depth_bits) | (dbits >> tile_bits)
    key, order = torch.sort(key, stable=True)
    gauss_idx = g[order]

    sorted_tile = key >> depth_bits
    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev, dtype=torch.int64))
    tile_count = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return Binning(
        gauss_idx=gauss_idx,
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=tile_count,
        num_pairs=int(total),
        num_live=int(gauss_idx.shape[0]),
        max_tile_count=int(tile_count.max()) if num_tiles else 0,
    )

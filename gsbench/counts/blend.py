"""Operations and bytes the tile blend needs, forward (B1, `csrc/blend_fwd.cu`)
and backward (B2, `csrc/blend_bwd.cu`), for one launch's inputs.

Frozen copies of chip_smoke.py's `applied_pairs`, `kernel_bound_ms` and
`bwd_bound_ms` at commit 95f6082 (their OPS_* constants with them), over the
launch's own tensors in place of the port's `Binning`. Work is counted as
these inputs need it, whatever the kernel does: a pixel marches its tile's
clamped list up to its last contributor (the whole list where T_final >=
1e-2 shows it never stopped), blends the pairs that pass the alpha test,
brackets the median where T_final <= min_transmittance and runs the search's
evaluations where the root is in range. Transcendentals count one operation,
at the fp32 rate.
"""

from __future__ import annotations

import torch

from gsbench.reference import render_ref

OPS_ALPHA = 16        # pair_alpha(): every marched pair
OPS_APPLY = 16        # an applied pair: weight, 3 colour + 3 normal FMAs, T update, stop test
OPS_PAIR_MEDIAN = 6   # t_peak (ray-depth plane) and log1p(-alpha)
OPS_DEPTH = 14        # the model's term at one depth
OPS_DERIV = 8         # its d/dt
MEDIAN_BRACKET = 2
MEDIAN_NEWTON = 8
OPS_BWD_APPLY = 65
OPS_BWD_MEDIAN = 38
OPS_BWD_PIXEL = 40


def applied_pairs(feats, tile_start, tile_count, n_contrib, cfg, width, height):
    """[H, W] pairs each pixel applied: those of its tile's list before its
    n_contrib that pass the alpha test, counted with the twin's own test."""
    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    n_tiles = tiles_x * tiles_y
    nc = torch.zeros(tiles_y * t, tiles_x * t, dtype=torch.int64, device=feats.device)
    nc[:height, :width] = n_contrib.to(torch.int64)
    nc = nc.reshape(tiles_y, t, tiles_x, t).permute(0, 2, 1, 3).reshape(n_tiles, t * t)
    feats_pad = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    out = torch.zeros_like(nc)
    for i in range(0, n_tiles, cfg.tile_batch):
        ids = torch.arange(i, min(i + cfg.tile_batch, n_tiles), device=feats.device)
        px, py = render_ref._tile_pixels(ids, tiles_x, cfg)
        starts = tile_start[ids].to(torch.int64)
        lim = nc[ids]
        limit = lim.amax(1)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, valid = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
            _, passes, _, _ = render_ref._alpha_terms(f, px, py, cfg, valid)
            out[ids] += (passes & (rel[None, :, None] < lim[:, None, :])).sum(1)
    out = out.reshape(tiles_y, tiles_x, t, t).permute(0, 2, 1, 3)
    return out.reshape(tiles_y * t, tiles_x * t)[:height, :width]


def fwd_needs(planes, feats, tile_start, tile_count, cfg, width, height, applied=None):
    """(bytes, operations) of B1 on one frame; `applied` may be passed in
    when the caller has it."""
    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    counts = tile_count.clamp_max(cfg.max_per_tile).to(torch.float64)
    per_pix = counts.reshape(tiles_y, tiles_x).repeat_interleave(t, 0) \
        .repeat_interleave(t, 1)[:height, :width]
    n_contrib = planes[8].to(torch.float64)
    t_final = planes[10]
    marched = torch.where(t_final >= 1e-2, per_pix, n_contrib)
    if applied is None:
        applied = applied_pairs(feats, tile_start, tile_count, planes[8], cfg, width, height)
    applied = applied.to(torch.float64)
    ops = float((marched * OPS_ALPHA + applied * OPS_APPLY).sum())
    if cfg.require_depth:
        cand = applied * (t_final <= cfg.min_transmittance)
        in_range = applied * (planes[11] > 0)
        ops += float((cand * (OPS_PAIR_MEDIAN + MEDIAN_BRACKET * OPS_DEPTH)
                      + in_range * MEDIAN_NEWTON * (OPS_DEPTH + OPS_DERIV)).sum())
    nbytes = (feats.shape[0] * 16 * 4 + counts.numel() * 2 * 4 + 3 * 4
              + 16 * width * height * 4)
    return float(nbytes), ops


def bwd_needs(planes, feats, tile_start, tile_count, cfg, width, height, applied=None):
    """(bytes, operations) of B2 on one frame."""
    n_contrib = planes[8].to(torch.float64)
    if applied is None:
        applied = applied_pairs(feats, tile_start, tile_count, planes[8], cfg, width, height)
    applied = applied.to(torch.float64)
    median = applied * (planes[11] > 0) if cfg.require_depth else torch.zeros_like(applied)
    ops = float((n_contrib * OPS_ALPHA + applied * OPS_BWD_APPLY
                 + median * OPS_BWD_MEDIAN).sum()) + OPS_BWD_PIXEL * width * height
    nbytes = (2 * feats.shape[0] * 16 * 4 + tile_count.numel() * 2 * 4 + 3 * 4
              + (13 + 8) * width * height * 4)
    return float(nbytes), ops

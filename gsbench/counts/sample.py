"""Operations and bytes the point query needs, forward (B3,
`csrc/sample_fwd.cu`) and backward (B5, `csrc/sample_bwd.cu`), and the NCC
sampler (B6, `csrc/warp_sample.cu`), for one launch's inputs.

Frozen copies of chip_smoke.py's `point_interactions`, `sample_bounds` and
B6's byte count (`phase_timing_mv`) at commit 95f6082, over the launch's own
tensors in place of the port's `Query`. B3 charges OPS_ALPHA per marched
(pair, point), OPS_POINT_APPLY per applied one and the median search as B1;
B5 charges OPS_ALPHA per pair before n_contrib of a point with a non-zero
cotangent, OPS_SBWD_APPLY per applied one and OPS_SBWD_POINT per point; B6
OPS_WARP per tap, its bytes the taps' coordinates read and three outputs
written (4 B each) and the image read once.
"""

from __future__ import annotations

import torch

from gsbench.counts.blend import (MEDIAN_BRACKET, MEDIAN_NEWTON, OPS_ALPHA, OPS_DEPTH,
                                  OPS_DERIV, OPS_PAIR_MEDIAN)
from gsbench.reference import render_ref, sample_ref

OPS_POINT_APPLY = 8
OPS_SBWD_APPLY = 75
OPS_SBWD_POINT = 10
OPS_WARP = 30


def point_interactions(feats, tile_start, tile_count, pts, blocks, res, cfg):
    """Per sorted point: the pairs its march tested (its tile's clamped list
    up to n_contrib, or the whole list where T_final >= 1e-2) and the pairs
    it applied (before n_contrib, passing the alpha test)."""
    feats_pad = torch.cat([feats, feats.new_zeros(1, 16)])
    n_contrib = res[2].to(torch.int64)
    applied = torch.zeros_like(n_contrib)
    for ids, starts, counts in sample_ref._batches(tile_start, tile_count, blocks, cfg):
        idx, px, py, valid = sample_ref._block_points(pts, blocks, ids)
        lim = torch.where(valid, n_contrib[idx], 0)
        limit = lim.amax(1)
        acc = torch.zeros_like(lim)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, vld = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
            _, passes, _, _ = render_ref._alpha_terms(f, px, py, cfg, vld)
            acc += (passes & (rel[None, :, None] < lim[:, None, :])).sum(1)
        applied[idx[valid]] = acc[valid]
    tile = torch.repeat_interleave(blocks[:, 0].to(torch.int64), blocks[:, 2].to(torch.int64))
    count = tile_count.to(torch.int64).clamp_max(cfg.max_per_tile)[tile]
    marched = torch.where(res[4] >= 1e-2, count, n_contrib)
    return marched.to(torch.float64), applied.to(torch.float64)


def fwd_needs(feats, tile_start, tile_count, pts, blocks, res, cfg, inter=None):
    """(bytes, operations) of B3 on one query."""
    marched, applied = inter or point_interactions(feats, tile_start, tile_count, pts,
                                                   blocks, res, cfg)
    cand = (res[4] <= cfg.min_transmittance).to(torch.float64)
    in_range = (res[1] > 0).to(torch.float64)
    ops = float((marched * OPS_ALPHA + applied * OPS_POINT_APPLY
                 + cand * applied * (OPS_PAIR_MEDIAN + MEDIAN_BRACKET * OPS_DEPTH)
                 + in_range * applied * MEDIAN_NEWTON * (OPS_DEPTH + OPS_DERIV)).sum())
    k, q = feats.shape[0], pts.shape[0]
    lists = 2 * 4 * tile_count.numel() + 12 * blocks.shape[0]
    return float(k * 64 + lists + q * 8 + 6 * q * 4), ops


def bwd_needs(feats, tile_start, tile_count, pts, blocks, res, g, cfg, inter=None):
    """(bytes, operations) of B5 on one query; `g` is the cotangent of the
    median row."""
    _, applied = inter or point_interactions(feats, tile_start, tile_count, pts,
                                             blocks, res, cfg)
    in_range = (res[1] > 0).to(torch.float64)
    live = in_range * (g != 0).to(torch.float64) * (res[5].abs() > 1e-20).to(torch.float64)
    n_contrib = res[2].to(torch.float64)
    ops = float((live * (n_contrib * OPS_ALPHA + applied * OPS_SBWD_APPLY)).sum()) \
        + OPS_SBWD_POINT * pts.shape[0]
    k, q = feats.shape[0], pts.shape[0]
    lists = 2 * 4 * tile_count.numel() + 12 * blocks.shape[0]
    return float(2 * k * 64 + lists + q * 8 + 4 * q * 4 + q * 4 + q * 8), ops


def warp_needs(img_shape, taps: int):
    """(bytes, operations) of B6 on `taps` coordinates of an image."""
    h, w = img_shape
    return float(5 * taps * 4 + h * w * 4), float(OPS_WARP * taps)

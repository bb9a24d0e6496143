"""Point queries in plain PyTorch: the twins of the CUDA kernels
`csrc/sample_fwd.cu` (B3, and B4 in its integrate mode) and
`csrc/sample_bwd.cu` (B5).

Port of the math of gsjax's point path: the march and bisection of
`gsjax/ops/sample.py` (`_march_rounds`, `_rounds_xla` with
`render_ref.bisect_batch`) and the VJP of
`gsjax/ops/raster/sample_pallas.py:_sbwd_kernel`. The points come sorted by
tile with the kernels' block table `blocks` [NB, 3] int32 (tile, first
sorted point, count <= BLOCK); the twins run the blocks in batches of as
many lanes as the blend twin's tile batches, heaviest tile lists first.

`sample_fwd_rows`: each point marches its tile's depth-sorted pair list at
its continuous (px, py) exactly as a pixel does in the blend
(`render_ref._chunk_blend`: the alpha test, and a stop for good before T
would fall below 1e-4), then the median ray distance, the root of
T(t) = 0.5 of the half-gaussian-CDF model, is bisected
(`render_ref.bisect_batch`) and dlogT/dt taken there. It returns [6, Q] rows
in sorted order: 0 m_t (ray distance; 0 out of range), 1 in_range,
2 n_contrib, 3 md_init, 4 T_final, 5 dlogT/dt at the root (0 out of range);
rows 0-5 of gsjax's `sample_depth_pallas`.

`integrate_rows`: the same march, then the half-gaussian-CDF model of
`render_ref._log_t_model` over the pairs the march applied (before n_contrib,
passing the alpha test: with the stop for good, exactly the applied ones) at
each point's own ray distance (gsjax's `_march_rounds` with `etr`). It
returns [5, Q] rows: 0 T(point), 1 covered (= 1), 2-4 as above; rows 0-4 of
gsjax's `integrate_pallas`.

`sample_bwd_rows`: the VJP of m_t, read from those rows (the forward is not
re-run). By the implicit function, dm/dtheta = -(dlogT/dtheta)/(dlogT/dt):
with s = -g / (dlogT/dt) for a point in range, each pair the point applied
(before its n_contrib, passing the alpha test) adds s d(log T(m_t))/d(its
alpha, ray-depth plane, rsigma), chained to the payload columns 0-5 and
9-12; the point's d(px), d(py) are minus the sums of its mean2d terms
(dx = gx - px). The forward's dtype is kept, so a test can run both in
float64.
"""

from __future__ import annotations

import torch

from gsjax_torch.ops.raster import render_ref
from gsjax_torch.ops.raster.config import RasterConfig

BLOCK = 256    # points per block: the kernels' thread block
N_ROWS = 6
N_ROWS_INTEGRATE = 5


def _batches(tile_start, tile_count, blocks, cfg: RasterConfig):
    """Yield (block ids [B], list starts [B], clamped counts [B]) in batches,
    heaviest tile lists first."""
    tiles = blocks[:, 0].to(torch.int64)
    counts = torch.clamp_max(tile_count.to(torch.int64), cfg.max_per_tile)[tiles]
    starts = tile_start.to(torch.int64)[tiles]
    order = torch.argsort(-counts, stable=True)
    batch = max(cfg.tile_batch * cfg.pixels_per_tile // BLOCK, 1)
    for i in range(0, blocks.shape[0], batch):
        ids = order[i:i + batch]
        yield ids, starts[ids], counts[ids]


def _block_points(pts, blocks, ids):
    """Sorted point index [B, BLOCK] of each lane of blocks `ids`, the lanes'
    (px, py) (0 on empty lanes) and the lane mask."""
    lane = torch.arange(BLOCK, device=pts.device)
    valid = lane[None, :] < blocks[ids, 2:3].to(torch.int64)
    idx = torch.where(valid, blocks[ids, 1:2].to(torch.int64) + lane, 0)
    xy = torch.where(valid[..., None], pts[idx], torch.zeros_like(pts[idx]))
    return idx, xy[..., 0], xy[..., 1], valid


def _march(feats_pad, starts, counts, px, py, cfg: RasterConfig):
    """The blend's march of a batch of blocks -> (T_final, n_contrib,
    md_init), each [B, P]."""
    b, p = px.shape
    z = lambda *s: torch.zeros(b, p, *s, dtype=px.dtype, device=px.device)
    carry = (z(), z(3), z(3), torch.full((b, p), -1, device=px.device), z(),
             torch.zeros(b, p, dtype=torch.bool, device=px.device))
    for base in range(0, int(counts.max()), cfg.chunk):
        f, rel, valid = render_ref._gather_chunk(feats_pad, starts, counts, base,
                                                 cfg.chunk)
        carry = render_ref._chunk_blend(carry, f, rel, valid, px, py, cfg)
    log_t, _, _, last_idx, md_init, _ = carry
    return torch.exp(log_t), last_idx + 1, md_init


def _fwd_batch(feats_pad, starts, counts, px, py, cfg: RasterConfig):
    """[B, 6, P] rows of a batch of blocks (module docstring)."""
    z = lambda: torch.zeros_like(px)
    t_final, n_contrib, md_init = _march(feats_pad, starts, counts, px, py, cfg)
    m_t, in_range = render_ref.bisect_batch(feats_pad, starts, n_contrib, md_init,
                                            t_final, px, py, cfg)
    _, d_denom = render_ref._log_t_model(feats_pad, starts, n_contrib, px, py,
                                         m_t[..., None], cfg, want_d=True)
    return torch.stack([m_t, in_range.to(px.dtype), n_contrib.to(px.dtype), md_init,
                        t_final, torch.where(in_range, d_denom[..., 0], z())], 1)


def sample_fwd_rows(feats_pairs, tile_start, tile_count, pts, blocks,
                    cfg: RasterConfig) -> torch.Tensor:
    """Twin of B3 -> [6, Q] rows in sorted point order.

    feats_pairs [K, 16] (render_ref.prepare_pairs), tile_start / tile_count
    [T] int32, pts [Q, 2] (px, py) sorted by tile, blocks [NB, 3] int32."""
    out = pts.new_zeros(N_ROWS, pts.shape[0])
    feats_pad = torch.cat([feats_pairs, feats_pairs.new_zeros(1, render_ref._F)])
    for ids, starts, counts in _batches(tile_start, tile_count, blocks, cfg):
        idx, px, py, valid = _block_points(pts, blocks, ids)
        rows = _fwd_batch(feats_pad, starts, counts, px, py, cfg)
        out[:, idx[valid]] = rows.transpose(0, 1)[:, valid]
    return out


def integrate_rows(feats_pairs, tile_start, tile_count, pts, t_eval, blocks,
                   cfg: RasterConfig) -> torch.Tensor:
    """Twin of B4 -> [5, Q] rows in sorted point order (module docstring).

    t_eval [Q]: each sorted point's ray distance; other arguments as
    `sample_fwd_rows`."""
    out = pts.new_zeros(N_ROWS_INTEGRATE, pts.shape[0])
    feats_pad = torch.cat([feats_pairs, feats_pairs.new_zeros(1, render_ref._F)])
    for ids, starts, counts in _batches(tile_start, tile_count, blocks, cfg):
        idx, px, py, valid = _block_points(pts, blocks, ids)
        t_final, n_contrib, md_init = _march(feats_pad, starts, counts, px, py, cfg)
        et = torch.where(valid, t_eval[idx], torch.zeros_like(px))
        log_tp, _ = render_ref._log_t_model(feats_pad, starts, n_contrib, px, py,
                                            et[..., None], cfg)
        rows = torch.stack([torch.exp(log_tp[..., 0]), torch.ones_like(px),
                            n_contrib.to(px.dtype), md_init, t_final], 1)
        out[:, idx[valid]] = rows.transpose(0, 1)[:, valid]
    return out


def sample_bwd_rows(feats_pairs, tile_start, tile_count, pts, blocks, res, g,
                    cfg: RasterConfig):
    """Twin of B5 -> (d_feats [K, 16], d_pts [Q, 2]).

    res [6, Q]: `sample_fwd_rows`' (or B3's) output for these arguments; g
    [Q]: the cotangent of its row 0 (m_t). Other arguments as
    `sample_fwd_rows`."""
    feats_pad = torch.cat([feats_pairs, feats_pairs.new_zeros(1, render_ref._F)])
    d_pad = torch.zeros_like(feats_pad)
    d_pts = torch.zeros_like(pts)
    k_pad = feats_pairs.shape[0]
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    for ids, starts, counts in _batches(tile_start, tile_count, blocks, cfg):
        idx, px, py, valid = _block_points(pts, blocks, ids)
        r = res[:, idx]                                      # [6, B, P]
        m_t, d_den = r[0], r[5]
        ok = valid & (r[1] > 0) & (d_den.abs() > 1e-20)
        s = torch.where(ok, -g[idx] / torch.where(ok, d_den, 1.0), zero)
        n_contrib = torch.where(s != 0, torch.minimum(r[2].to(torch.int64),
                                                      counts[:, None]), 0)
        limit = n_contrib.amax(1)
        dpx = torch.zeros_like(px)
        dpy = torch.zeros_like(py)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, vld = render_ref._gather_chunk(feats_pad, starts, limit, base,
                                                   cfg.chunk)
            a, passes, dx, dy = render_ref._alpha_terms(f, px, py, cfg, vld)
            applied = passes & (rel[None, :, None] < n_contrib[:, None, :])
            a = torch.where(applied, a, zero)
            # the implicit median term (sample_pallas.py:326-341), in full
            rsig = f[..., 12:13]
            t_val = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
            mt = m_t[:, None, :]
            delta = (mt - t_val) * rsig
            hg = torch.where(rsig > 0, torch.exp(-0.5 * delta * delta), zero)
            half_r = 0.5 / torch.clamp_min(1.0 - a * hg, 1e-12)
            behind = mt > t_val
            sp = torch.where(applied, s[:, None, :], zero)
            d_a = sp * torch.where(behind, -1.0 / (1.0 - a) + half_r * hg, -half_r * hg)
            dlf_dg = torch.where(behind, half_r, -half_r) * a
            d_tp = sp * dlf_dg * hg * delta * rsig
            d_rsig = torch.where(rsig > 0, sp * dlf_dg * (-hg * delta * delta)
                                 / torch.where(rsig > 0, rsig, 1.0), zero)
            # chain alpha = min(clamp, op exp(power)) -> power, opacity
            expp = torch.exp(torch.clamp_max(render_ref._power(f, dx, dy), 0.0))
            notclamped = f[..., 5:6] * expp < cfg.alpha_clamp
            d_pow = torch.where(notclamped, d_a * a, zero)
            ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
            gx_t = d_pow * -(ca * dx + cb * dy) + d_tp * f[..., 9:10]
            gy_t = d_pow * -(cc * dy + cb * dx) + d_tp * f[..., 10:11]
            none = torch.zeros_like(d_a)
            cols = [gx_t, gy_t, d_pow * (-0.5 * dx * dx), d_pow * (-dx * dy),
                    d_pow * (-0.5 * dy * dy), torch.where(notclamped, d_a * expp, zero),
                    none, none, none, d_tp * dx, d_tp * dy, d_tp, d_rsig,
                    none, none, none]
            d_all = torch.stack([c.sum(-1) for c in cols], -1)  # [B, C, 16]
            pair = torch.where(vld, starts[:, None] + rel[None, :], k_pad)
            d_pad.index_add_(0, pair.reshape(-1), d_all.reshape(-1, render_ref._F))
            dpx = dpx - gx_t.sum(1)
            dpy = dpy - gy_t.sum(1)
        d_pts[idx[valid]] = torch.stack([dpx, dpy], -1)[valid]
    return d_pad[:-1], d_pts

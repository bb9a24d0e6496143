# Frozen copy of gsjax_torch/ops/raster/render_ref.py at commit 95f6082 (the benchmark's plain
# reference; edited only where it named a kernel or another module of the port,
# and to end a batch's blend once every pixel in it has stopped).
"""Tile blend in plain PyTorch: the twin of the CUDA kernels
`csrc/blend_fwd.cu` (forward, B1) and `csrc/blend_bwd.cu` (backward, B2).

Port of `gsjax/ops/raster/render_ref.py` with the same semantics
(render_forward.cu:391-671):
  - skip a pair if power > 0 or alpha < 1/255, alpha = min(0.99, op exp(power));
  - stop (freeze T) before the pair that would take T below 1e-4;
  - colour = accum + T_final bg, alpha = 1 - T_final, normal = accum_normal /
    (1 - T_final) where some gaussian contributed;
  - median depth: init at the last pair applied while T > 0.5, then the
    SPLIT=8-way bisection (5 rounds) of the half-gaussian-CDF transmittance
    model T(t) = 0.5, returned as z-depth via the ray->z factor rln.

As in gsjax, the sequential transmittance recurrence is a cumulative sum of
log(1 - alpha) over a [chunk] slice of a tile's list, for tiles processed in
count-sorted batches. This is the CPU path of `render` and, on the card, the
oracle the kernel is held against.

Both paths return the same per-pixel planes, [16, H, W] float32:
  0-2 colour, 3-5 normal, 6 alpha, 7 median z-depth, 8 n_contrib,
  9 md_init, 10 T_final, 11 in_range, 12 dlogT/dt at the median, 13-15 zero
(the rows of gsjax's Pallas forward, render_pallas.py:32-36; 9-12 are what
a backward pass reads). The twin evaluates row 12 at its bisection root.

`blend_bwd_planes` is the VJP of the blend w.r.t. the pair payload, read from
those residual planes as B2 reads them: the blend part front to back from
the totals, and the median depth's implicit-function term.

Both take the kernels' tile-row list `tile_rows`: only those rows of tiles,
on band-local planes [16, len(tile_rows) * tile, W] (zero past the frame's
height), each tile blended as in the full frame.
"""

from __future__ import annotations

import math

import torch

from gsbench.reference.binning import Binning
from gsbench.reference.config import RasterConfig
from gsbench.reference.preprocess import Preprocessed

# payload layout: mean2d(2) conic(3) opacity(1) color(3) ray_plane(4) normal(3)
_F = 16
N_PLANES = 16


def pack_features(prep: Preprocessed) -> torch.Tensor:
    """[N, 16] per-gaussian blend payload (gsjax `_pack_features`)."""
    return torch.cat([prep.mean2d, prep.conic, prep.opacity[:, None],
                      prep.color, prep.ray_plane, prep.normal], dim=-1)


def prepare_pairs(prep: Preprocessed, binning: Binning) -> torch.Tensor:
    """[K, 16] contiguous payload of every live pair, in binning order."""
    return pack_features(prep)[binning.gauss_idx].contiguous()


def _tile_pixels(tile_ids, tiles_x, cfg: RasterConfig):
    """[B] tile ids -> pixel centre coordinates px, py [B, P]."""
    t = cfg.tile
    lin = torch.arange(t * t, device=tile_ids.device)
    px = (tile_ids[:, None] % tiles_x) * t + lin % t
    py = (tile_ids[:, None] // tiles_x) * t + lin // t
    return px.to(torch.float32), py.to(torch.float32)


def _gather_chunk(feats_pad, starts, limit, base, chunk):
    """Rows [base, base+chunk) of each tile's list -> ([B,C,16], rel [C],
    in-list mask [B,C]); slots past `limit` read the zero pad row."""
    rel = base + torch.arange(chunk, device=starts.device)
    valid = rel[None, :] < limit[:, None]
    idx = torch.where(valid, starts[:, None].to(torch.int64) + rel[None, :],
                      feats_pad.shape[0] - 1)
    return feats_pad[idx], rel, valid


def _power(f, dx, dy):
    """Gaussian exponent at offsets dx, dy [B,C,P] from payload f [B,C,16]."""
    ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
    return -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy


def _alpha_terms(f, px, py, cfg: RasterConfig, entry_valid):
    """f [B,C,16]; px, py [B,P] -> alpha (0 where skipped), passes, dx, dy [B,C,P]."""
    dx = f[..., 0:1] - px[:, None, :]
    dy = f[..., 1:2] - py[:, None, :]
    power = _power(f, dx, dy)
    alpha = torch.clamp_max(f[..., 5:6] * torch.exp(torch.clamp_max(power, 0.0)),
                            cfg.alpha_clamp)
    passes = (power <= 0.0) & (alpha >= cfg.alpha_min) & entry_valid[..., None]
    return torch.where(passes, alpha, torch.zeros_like(alpha)), passes, dx, dy


def _chunk_blend(carry, f, rel, valid, px, py, cfg: RasterConfig):
    """Blend one [chunk] slice of each tile's list into the per-pixel carry
    (the sequential loop as a cumulative log-transmittance). `done` carries
    the stop across chunks: a pixel whose march stopped stays stopped, as in
    the CUDA loop (render_forward.cu:498-501). gsjax's chunked paths carry
    only the kept transmittance, so there a stopped pixel resumes at the
    next chunk; the two agree whenever a tile's list fits one chunk."""
    log_t, c_acc, n_acc, last_idx, md_init, done = carry
    a, passes, dx, dy = _alpha_terms(f, px, py, cfg, valid)
    log1m = torch.log1p(-a)
    l_incl = log_t[:, None, :] + torch.cumsum(log1m, dim=1)
    keep = (l_incl >= math.log(cfg.transmittance_min)) & ~done[:, None, :]
    l_prev = l_incl - log1m
    w = a * torch.exp(l_prev) * keep
    c_acc = c_acc + (w[..., None] * f[:, :, None, 6:9]).sum(1)
    n_acc = n_acc + (w[..., None] * f[:, :, None, 13:16]).sum(1)
    # median-depth init: last applied gaussian whose preceding T > 0.5
    t_val = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
    applied = passes & keep
    cond = applied & (torch.exp(l_prev) > 0.5)
    k_ids = torch.arange(f.shape[1], device=f.device)[None, :, None]
    best = torch.where(cond, k_ids, -1).amax(dim=1)                # [B,P]
    md_chunk = torch.gather(t_val, 1, best.clamp_min(0)[:, None, :])[:, 0]
    md_init = torch.where(best >= 0, md_chunk, md_init)
    last_idx = torch.maximum(
        last_idx, torch.where(applied, rel[None, :, None], -1).amax(dim=1))
    log_t = log_t + (log1m * keep).sum(1)
    done = done | (passes & ~keep).any(dim=1)
    return log_t, c_acc, n_acc, last_idx, md_init, done


def _log_t_model(feats_pad, starts, n_contrib, px, py, ts, cfg: RasterConfig,
                 want_d=False):
    """log T(ts) of the half-gaussian-CDF model (render_forward.cu:610-620)
    over each pixel's applied pairs, at depths ts [B,P,S]; with `want_d`
    also d(log T)/dt. Returns two [B,P,S] tensors (the second None without
    want_d)."""
    limit = n_contrib.amax(dim=1)
    log_tp = torch.zeros_like(ts)
    d_tp = torch.zeros_like(ts) if want_d else None
    chunk = cfg.chunk
    for base in range(0, int(limit.max()), chunk):
        f, rel, valid = _gather_chunk(feats_pad, starts, limit, base, chunk)
        a, passes, dx, dy = _alpha_terms(f, px, py, cfg, valid)
        applied = passes & (rel[None, :, None] < n_contrib[:, None, :])
        a = torch.where(applied, a, torch.zeros_like(a))[..., None]  # [B,C,P,1]
        t_peak = (f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12])[..., None]
        rsig = f[..., 12:13, None]                                  # [B,C,1,1]
        tss = ts[:, None]                                           # [B,1,P,S]
        delta = (tss - t_peak) * rsig
        hg = torch.where(rsig > 0, torch.exp(-0.5 * delta * delta), torch.zeros_like(delta))
        one_minus = torch.clamp_min(1.0 - a * hg, 1e-12)
        behind = tss > t_peak
        lf = torch.where(behind, torch.log1p(-a) - 0.5 * torch.log(one_minus),
                         0.5 * torch.log(one_minus))
        mask = applied[..., None]
        log_tp = log_tp + (lf * mask).sum(1)
        if want_d:
            sgn = torch.where(behind, 1.0, -1.0)
            dlf = sgn * 0.5 * (a / one_minus) * (-hg * delta * rsig)
            d_tp = d_tp + (dlf * mask).sum(1)
    return log_tp, d_tp


def bisect_batch(feats_pad, starts, n_contrib, md_init, t_final, px, py,
                 cfg: RasterConfig):
    """SPLIT-way bisection of T(t*) = 0.5 (render_forward.cu:535-645).
    Returns (median ray distance [B,P], in_range [B,P] bool)."""
    s_pts = cfg.split + 1
    in_range = t_final <= cfg.min_transmittance
    d_min = torch.clamp_min(md_init - cfg.sample_range, 0.0)
    d_max = torch.clamp_min(md_init + cfg.sample_range, 0.0)
    steps = torch.arange(s_pts, device=md_init.device, dtype=torch.float32)
    t0 = t1 = None
    for it in range(cfg.split_iterations):
        interval = (d_max - d_min) / cfg.split
        ts = d_min[..., None] + interval[..., None] * steps
        log_tp, _ = _log_t_model(feats_pad, starts, n_contrib, px, py, ts, cfg)
        tp = torch.exp(log_tp)
        if it == 0:
            in_range = in_range & (tp[..., 0] >= 0.5) & (tp[..., cfg.split] <= 0.5)
        # last s in [1, SPLIT-1] with T >= 0.5, else 0 (render_forward.cu:627-631)
        sid = torch.zeros_like(n_contrib)
        for s in range(1, cfg.split):
            sid = torch.where(tp[..., s] >= 0.5, s, sid)
        d_max = d_min + (sid + 1).to(torch.float32) * interval
        d_min = d_min + sid.to(torch.float32) * interval
        t0 = torch.gather(tp, -1, sid[..., None].to(torch.int64))[..., 0]
        t1 = torch.gather(tp, -1, (sid + 1)[..., None].to(torch.int64))[..., 0]
    denom = t0 - t1
    w_max = torch.clamp((t0 - 0.5) / torch.where(denom.abs() > 1e-20, denom,
                                                 torch.full_like(denom, 1e-20)), 0.0, 1.0)
    m_depth = torch.where(in_range, w_max * d_max + (1.0 - w_max) * d_min,
                          torch.zeros_like(d_min))
    return m_depth, in_range


def _ray_to_z(px, py, width, height, fx, fy):
    """Ray-distance -> z-depth factor of each pixel (render_pallas._ray_to_z)."""
    pnx = (px - (width - 1) / 2.0) / fx
    pny = (py - (height - 1) / 2.0) / fy
    return torch.rsqrt(pnx * pnx + pny * pny + 1.0)


def blend_tiles_batch(feats_pad, tile_ids, starts, counts, tiles_x,
                      cfg: RasterConfig, bg, width, height, fx, fy):
    """Blend a batch of tiles; counts are already clamped at max_per_tile.
    Returns [B, 16, P] planes (module docstring for the rows)."""
    b, p = tile_ids.shape[0], cfg.pixels_per_tile
    dev = feats_pad.device
    px, py = _tile_pixels(tile_ids, tiles_x, cfg)
    carry = (torch.zeros(b, p, device=dev), torch.zeros(b, p, 3, device=dev),
             torch.zeros(b, p, 3, device=dev),
             torch.full((b, p), -1, dtype=torch.int64, device=dev),
             torch.zeros(b, p, device=dev),
             torch.zeros(b, p, dtype=torch.bool, device=dev))
    for base in range(0, int(counts.max()) if b else 0, cfg.chunk):
        f, rel, valid = _gather_chunk(feats_pad, starts, counts, base, cfg.chunk)
        carry = _chunk_blend(carry, f, rel, valid, px, py, cfg)
        if base % (16 * cfg.chunk) == 0 and bool(carry[5].all()):
            break    # every pixel stopped: later chunks add nothing (benchmark's edit)
    log_t, c_acc, n_acc, last_idx, md_init, _ = carry
    t_final = torch.exp(log_t)
    has = (last_idx >= 0)[..., None]
    normal = torch.where(
        has, n_acc / torch.clamp_min(1.0 - t_final, 1e-12)[..., None],
        torch.zeros_like(n_acc))
    n_contrib = last_idx + 1
    out = torch.zeros(b, N_PLANES, p, device=dev)
    out[:, 0:3] = (c_acc + t_final[..., None] * bg).transpose(1, 2)
    out[:, 3:6] = normal.transpose(1, 2)
    out[:, 6] = 1.0 - t_final
    out[:, 8] = n_contrib.to(torch.float32)
    out[:, 9] = md_init
    out[:, 10] = t_final
    if cfg.require_depth:
        m_depth, in_range = bisect_batch(feats_pad, starts, n_contrib, md_init,
                                         t_final, px, py, cfg)
        # dlogT/dt at the root, the backward's implicit-function denominator
        _, d_denom = _log_t_model(feats_pad, starts, n_contrib, px, py,
                                  m_depth[..., None], cfg, want_d=True)
        out[:, 7] = m_depth * _ray_to_z(px, py, width, height, fx, fy)
        out[:, 11] = in_range.to(torch.float32)
        out[:, 12] = torch.where(in_range, d_denom[..., 0], torch.zeros_like(m_depth))
    return out


def band_tiles(tile_rows, width, height, cfg: RasterConfig, device):
    """Tile ids [R * tiles_x] of the tile rows `tile_rows` (None: every row),
    row by row, and the row count R."""
    tiles_x, tiles_y = cfg.grid(width, height)
    rows = torch.arange(tiles_y, device=device) if tile_rows is None else \
        torch.as_tensor(tile_rows, dtype=torch.int64, device=device).reshape(-1)
    ids = rows[:, None] * tiles_x + torch.arange(tiles_x, device=device)[None, :]
    return ids.reshape(-1), int(rows.shape[0])


def blend_planes(feats_pairs, tile_start, tile_count, width, height, fx, fy,
                 bg, cfg: RasterConfig, tile_rows=None) -> torch.Tensor:
    """Blend every tile of a frame -> [16, H, W] planes.

    feats_pairs [K,16] (prepare_pairs), tile_start/tile_count [T] int32,
    bg [3] float32 on the same device. `tile_rows`: None, or the tile rows
    to blend -> [16, len(tile_rows) * tile, W], zero past the frame's
    height."""
    tiles_x, _ = cfg.grid(width, height)
    dev = feats_pairs.device
    tile_ids, n_rows = band_tiles(tile_rows, width, height, cfg, dev)
    n_tiles = tile_ids.shape[0]
    feats_pad = torch.cat([feats_pairs, feats_pairs.new_zeros(1, _F)])
    counts = torch.clamp_max(tile_count.to(torch.int64)[tile_ids], cfg.max_per_tile)
    # heavy tiles first so each batch is roughly homogeneous in count
    order = torch.argsort(-counts, stable=True)
    tiles = torch.empty(n_tiles, N_PLANES, cfg.pixels_per_tile, device=dev)
    for i in range(0, n_tiles, cfg.tile_batch):
        slot = order[i:i + cfg.tile_batch]
        ids = tile_ids[slot]
        tiles[slot] = blend_tiles_batch(
            feats_pad, ids, tile_start[ids].to(torch.int64), counts[slot],
            tiles_x, cfg, bg, width, height, fx, fy)
    t = cfg.tile
    img = tiles.reshape(n_rows, tiles_x, N_PLANES, t, t)
    img = img.permute(2, 0, 3, 1, 4).reshape(N_PLANES, n_rows * t, tiles_x * t)
    if tile_rows is None:
        return img[:, :height, :width].contiguous()
    img = img[:, :, :width].contiguous()
    # rows past the frame's height: zero, as the kernel leaves them
    y = (torch.as_tensor(tile_rows, dtype=torch.int64, device=dev).reshape(-1, 1) * t
         + torch.arange(t, device=dev)).reshape(-1)
    img[:, y >= height] = 0.0
    return img


def _to_tiles(img, cfg: RasterConfig, width, height, tile_rows=None):
    """[C, H, W] planes (or a band's [C, R * tile, W]) -> [T, C, P] per-tile
    pixel rows (inverse of the assembly at the end of `blend_planes`)."""
    tiles_x, tiles_y = cfg.grid(width, height)
    n_rows = tiles_y if tile_rows is None else len(tile_rows)
    t = cfg.tile
    c = img.shape[0]
    pad = img.new_zeros(c, n_rows * t, tiles_x * t)
    pad[:, :img.shape[1], :width] = img
    return pad.reshape(c, n_rows, t, tiles_x, t).permute(1, 3, 0, 2, 4) \
        .reshape(n_rows * tiles_x, c, t * t)


def bwd_tiles_batch(feats_pad, d_pad, tile_ids, starts, counts, tiles_x, res, g,
                    cfg: RasterConfig, bg, width, height, fx, fy):
    """Add the pair gradients of a batch of tiles into d_pad [K+1, 16] (the
    last row takes the pad slots). res, g: [B, 16, P] forward planes and
    their cotangent. The math of `render_pallas._bwd_kernel` (:856-988)."""
    px, py = _tile_pixels(tile_ids, tiles_x, cfg)
    t_final = res[:, 10]
    n_contrib = torch.minimum(res[:, 8].to(torch.int64), counts[:, None])
    has = (n_contrib > 0).to(torch.float32)[:, None]
    om = torch.clamp_min(1.0 - t_final, 1e-12)
    inv_om = 1.0 / om
    gc = g[:, 0:3]                                   # dL/dcolour [B,3,P]
    gn_raw = g[:, 3:6] * has
    gn = gn_raw * inv_om[:, None]                    # dL/d(accumulated normal)
    n_acc = res[:, 3:6] * om[:, None]
    c_acc = res[:, 0:3] - t_final[:, None] * bg[None, :, None]
    # total dL/dT_final through colour (bg), alpha and the normal's 1/(1-T)
    gamma = -g[:, 6] + (bg[None, :, None] * gc).sum(1) + \
        inv_om * inv_om * (gn_raw * n_acc).sum(1)
    s_q = (gc * c_acc).sum(1) + (gn * n_acc).sum(1)  # sum_j w_j q_j
    tf_gamma = t_final * gamma
    if cfg.require_depth:
        # implicit function: dm/dtheta = -(dlogT/dtheta) / (dlogT/dt)
        rln = _ray_to_z(px, py, width, height, fx, fy)
        m_t = res[:, 7] / rln
        d_den = res[:, 12]
        ok = (res[:, 11] > 0) & (d_den.abs() > 1e-20)
        s_pix = torch.where(ok, -g[:, 7] * rln / torch.where(ok, d_den, 1.0),
                            torch.zeros_like(d_den))

    limit = n_contrib.amax(dim=1)
    log_t = torch.zeros_like(t_final)
    wq = torch.zeros_like(t_final)
    k_pad = d_pad.shape[0] - 1
    for base in range(0, int(limit.max()) if len(tile_ids) else 0, cfg.chunk):
        f, rel, valid = _gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
        a, passes, dx, dy = _alpha_terms(f, px, py, cfg, valid)
        applied = passes & (rel[None, :, None] < n_contrib[:, None, :])
        a = torch.where(applied, a, torch.zeros_like(a))
        log1m = torch.log1p(-a)
        t_prev = torch.exp(log_t[:, None, :] + torch.cumsum(log1m, dim=1) - log1m)
        w = a * t_prev
        q = torch.einsum("bck,bkp->bcp", f[..., 6:9], gc) + \
            torch.einsum("bck,bkp->bcp", f[..., 13:16], gn)
        wq_incl = wq[:, None, :] + torch.cumsum(w * q, dim=1)
        d_a = t_prev * q - (s_q[:, None] - wq_incl + tf_gamma[:, None]) / (1.0 - a)
        d_a = torch.where(applied, d_a, torch.zeros_like(d_a))
        rsig = f[..., 12:13]
        d_tp = torch.zeros_like(d_a)
        d_rsig = torch.zeros_like(d_a)
        if cfg.require_depth:
            # the full half-gaussian-CDF term (render_pallas._median_model);
            # the TPU kernel's 5-sigma skip is not copied
            t_val = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
            mt = m_t[:, None, :]
            delta = (mt - t_val) * rsig
            hg = torch.where(rsig > 0, torch.exp(-0.5 * delta * delta), torch.zeros_like(delta))
            half_r = 0.5 / torch.clamp_min(1.0 - a * hg, 1e-12)
            behind = mt > t_val
            sp = torch.where(applied, s_pix[:, None, :], torch.zeros_like(d_a))
            d_a = d_a + sp * torch.where(behind, -1.0 / (1.0 - a) + half_r * hg, -half_r * hg)
            dlf_dg = torch.where(behind, half_r, -half_r) * a
            d_tp = sp * dlf_dg * hg * delta * rsig
            d_rsig = torch.where(rsig > 0, sp * dlf_dg * (-hg * delta * delta)
                                 / torch.where(rsig > 0, rsig, 1.0), torch.zeros_like(d_a))
        # chain alpha = min(clamp, op exp(power)) -> power, opacity
        expp = torch.exp(torch.clamp_max(_power(f, dx, dy), 0.0))
        notclamped = f[..., 5:6] * expp < cfg.alpha_clamp
        d_pow = torch.where(notclamped, d_a * a, torch.zeros_like(d_a))
        d_op = torch.where(notclamped, d_a * expp, torch.zeros_like(d_a))
        ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        rp0, rp1 = f[..., 9:10], f[..., 10:11]
        d_cols = [
            d_pow * -(ca * dx + cb * dy) + d_tp * rp0,        # mean2d x
            d_pow * -(cc * dy + cb * dx) + d_tp * rp1,        # mean2d y
            d_pow * (-0.5 * dx * dx), d_pow * (-dx * dy),     # conic a, b
            d_pow * (-0.5 * dy * dy), d_op,                   # conic c, opacity
        ]
        d_all = torch.cat([
            torch.stack([c.sum(-1) for c in d_cols], -1),
            torch.einsum("bcp,bkp->bck", w, gc),              # colour
            torch.stack([(d_tp * dx).sum(-1), (d_tp * dy).sum(-1), d_tp.sum(-1),
                         d_rsig.sum(-1)], -1),                # ray plane
            torch.einsum("bcp,bkp->bck", w, gn),              # normal
        ], dim=-1)
        idx = torch.where(valid, starts[:, None] + rel[None, :], k_pad)
        d_pad.index_add_(0, idx.reshape(-1), d_all.reshape(-1, _F))
        log_t = log_t + log1m.sum(1)
        wq = wq_incl[:, -1]


def blend_bwd_planes(feats_pairs, tile_start, tile_count, planes, grad_planes,
                     width, height, fx, fy, bg, cfg: RasterConfig,
                     tile_rows=None) -> torch.Tensor:
    """VJP of `blend_planes` w.r.t. the pair payload -> d_feats [K, 16].

    `planes` [16, H, W] are the forward's output (B1's or the twin's), read as
    the residuals B2 reads: n_contrib (row 8), T_final (10), the median
    z-depth (7), in_range (11) and dlogT/dt at the root (12); the forward is
    not re-run. `grad_planes` [16, H, W] is the cotangent of rows 0-7 (rows
    8-15 are not differentiable and are ignored). A pixel's applied pairs are
    those of its list before n_contrib that pass the alpha test, so a
    stopped pixel stays stopped (the port's semantics, not gsjax's chunked
    resume). With `tile_rows`, only those rows of tiles, from band-local
    planes and cotangent [16, len(tile_rows) * tile, W]."""
    tiles_x, _ = cfg.grid(width, height)
    tile_ids, _ = band_tiles(tile_rows, width, height, cfg, feats_pairs.device)
    n_tiles = tile_ids.shape[0]
    feats_pad = torch.cat([feats_pairs, feats_pairs.new_zeros(1, _F)])
    d_pad = torch.zeros_like(feats_pad)
    res = _to_tiles(planes, cfg, width, height, tile_rows)
    g = _to_tiles(grad_planes, cfg, width, height, tile_rows)
    counts = torch.clamp_max(tile_count.to(torch.int64)[tile_ids], cfg.max_per_tile)
    # heavy tiles first, as in blend_planes
    order = torch.argsort(-res[:, 8].amax(1), stable=True)
    for i in range(0, n_tiles, cfg.tile_batch):
        slot = order[i:i + cfg.tile_batch]
        ids = tile_ids[slot]
        bwd_tiles_batch(feats_pad, d_pad, ids, tile_start[ids].to(torch.int64),
                        counts[slot], tiles_x, res[slot], g[slot], cfg, bg, width,
                        height, fx, fy)
    return d_pad[:-1]


def planes_to_images(planes: torch.Tensor) -> dict:
    """[16, H, W] planes -> the image dict of `render` ([H, W(, C)])."""
    return {
        "color": planes[0:3].permute(1, 2, 0),
        "normal": planes[3:6].permute(1, 2, 0),
        "alpha": planes[6],
        "median_depth": planes[7],
        "n_contrib": planes[8].to(torch.int32),
    }


def render_tiles(prep: Preprocessed, binning: Binning, camera,
                 cfg: RasterConfig, bg: torch.Tensor) -> dict:
    """Blend all tiles with the twin. Returns the dict of [H, W(, C)] images."""
    planes = blend_planes(prepare_pairs(prep, binning), binning.tile_start,
                          binning.tile_count, camera.width, camera.height,
                          camera.fx, camera.fy, bg, cfg)
    return planes_to_images(planes)

"""Multi-device data parallelism: tile rows sharded over ranks (port of
`gsjax/parallel/shard.py` on `torch.distributed`).

The layout is gsjax's (shard.py:1-20), one process per rank:
  - the gaussians are replicated on every rank;
  - tile ROWS are sharded: each rank bins (`bin_gaussians` with row bands)
    and blends (B1 / B2 on a tile-row list) only its own band or bands;
  - the band images are all-gathered (`collectives.all_gather`), so SSIM
    and the other non-local losses see the whole frame, and the gather's
    backward sums the image cotangents over ranks and hands each rank its
    band's slice;
  - every loss term is a band partial over a global denominator; each rank
    differentiates only its own partial, and the parameter, mean2d-tap and
    appearance gradients are then summed over ranks;
  - Adam and densification run replicated on every rank, from identical
    random streams, so the ranks' models stay bit-equal.

A partition is a host-side numpy array of tile-row bounds: [n+1] (rank d
owns rows [b[d], b[d+1])) or [2n+1] (rank d owns two bands: d and 2n-1-d,
or the pair `band_pair[d]`). `equal_band_bounds` .. `paired_balance_bounds`
are gsjax's choosers, copied; any valid partition gives the same losses and
gradients, only the work moves. The port's bands have no static capacity:
a rank's band-local buffers are as tall as its rows, padded only for the
all-gather to the tallest rank's.

Serving: `render_sharded` renders one frame split into bands;
`render_views_sharded` renders whole views round-robin over ranks and hands
every rank every view.

Collectives use the default group unless a `group` is given; every rank must
call these functions together, with the same arguments (save its own data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.model import appearance as app_lib
from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import render_cuda, render_ref
from gsjax_torch.ops.raster.api import render, select
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.ops.raster.config import RasterConfig
from gsjax_torch.ops.raster.preprocess import Preprocessed, preprocess
from gsjax_torch.parallel.collectives import all_gather, all_sum, all_sum_many, world
from gsjax_torch.train import losses, multiview
from gsjax_torch.train.step import LossConfig, nonfinite_count
from gsjax_torch.utils import spans

IMAGE_PLANES = 8   # the blend's differentiable planes: colour, normal, alpha, depth


# --- band choosers (numpy, copied from gsjax shard.py:131-287) -------------

def equal_band_bounds(tiles_y: int, n_dev: int) -> np.ndarray:
    """Equal tile-row partition boundaries: device d owns rows [b[d], b[d+1])."""
    rows_per = -(-tiles_y // n_dev)
    return np.minimum(np.arange(n_dev + 1) * rows_per, tiles_y).astype(np.int32)


def balance_band_bounds(row_pairs, n_dev: int,
                        rows_per_max: int) -> np.ndarray:
    """Equal-PAIR contiguous tile-row partition (gsjax shard.py:137): the
    bands' pair counts approach total / n_dev, each band at most
    rows_per_max rows, covering [0, tiles_y) (bands may be empty)."""
    row_pairs = np.asarray(row_pairs, np.float64)
    tiles_y = row_pairs.shape[0]
    if n_dev * rows_per_max < tiles_y:
        raise ValueError(
            f"rows_per_max={rows_per_max} x {n_dev} devices cannot cover "
            f"{tiles_y} tile rows")
    w = row_pairs + 1e-3                      # keep empty rows assignable
    cum = np.concatenate([[0.0], np.cumsum(w)])
    total = cum[-1]
    b = np.zeros(n_dev + 1, np.int64)
    b[n_dev] = tiles_y
    for d in range(1, n_dev):
        q = int(np.searchsorted(cum, total * d / n_dev, side="left"))
        lo = max(b[d - 1], tiles_y - (n_dev - d) * rows_per_max)
        hi = min(b[d - 1] + rows_per_max, tiles_y)
        b[d] = min(max(q, lo), hi)
    return b.astype(np.int32)


def dual_balance_bounds(row_pairs, n_dev: int,
                        band_cap: int) -> np.ndarray:
    """Mirrored dual-band partition (gsjax shard.py:174): [2n+1] row bounds
    where device d owns bands d and 2n-1-d; from the greedy equal-pair
    2n-split, interior bounds hill-climb (+-1 row, within band_cap) to
    minimise the largest paired share."""
    w = np.asarray(row_pairs, np.float64) + 1e-3
    nb = 2 * n_dev
    cum = np.concatenate([[0.0], np.cumsum(w)])
    b = balance_band_bounds(row_pairs, nb, band_cap).astype(np.int64)

    def dev_shares(bb):
        band = cum[bb[1:]] - cum[bb[:-1]]
        return band[:n_dev] + band[nb - 1:n_dev - 1:-1]

    cur = dev_shares(b)
    for _ in range(50 * nb):
        best_gain, best = 0.0, None
        worst = cur.max()
        for i in range(1, nb):
            for dlt in (-1, 1):
                v = b[i] + dlt
                if not (b[i - 1] <= v <= b[i + 1]):
                    continue
                if (v - b[i - 1] > band_cap) or (b[i + 1] - v > band_cap):
                    continue
                b2 = b.copy()
                b2[i] = v
                m = dev_shares(b2).max()
                if worst - m > best_gain:
                    best_gain, best = worst - m, b2
        if best is None:
            break
        b = best
        cur = dev_shares(b)
    return b.astype(np.int32)


def pair_bands(shares, band_rows, rows_per_max: int) -> np.ndarray:
    """Greedy matching of 2n bands into n device pairs (gsjax shard.py:215):
    the heaviest unpaired band joins the lightest partner whose combined
    height fits rows_per_max. Returns [n,2] int32, pair[:,0] < pair[:,1]."""
    order = np.argsort(-np.asarray(shares, np.float64))
    unpaired = list(order)
    pairs = []
    while unpaired:
        a = unpaired.pop(0)                     # heaviest remaining
        pick = None
        for j in range(len(unpaired) - 1, -1, -1):   # lightest first
            if band_rows[a] + band_rows[unpaired[j]] <= rows_per_max:
                pick = j
                break
        if pick is None:
            pick = len(unpaired) - 1            # infeasible: least-bad
        b = unpaired.pop(pick)
        pairs.append((min(a, b), max(a, b)))
    return np.asarray(sorted(pairs), np.int32)


def paired_balance_bounds(row_pairs, n_dev: int, rows_per_max: int):
    """Free-paired dual-band partition (gsjax shard.py:242): (bounds [2n+1],
    band_pair [n,2]). Cuts the rows into 2n bands, matches them heavy with
    light (`pair_bands`) and hill-climbs the bounds (+-1 row, re-matching
    after each move) to minimise the largest device share, each device's
    two bands at most rows_per_max rows together.

    The seed is gsjax's 2n equal-pair split capped at rows_per_max // 2
    rows a band wherever that split covers the rows. Where it cannot (gsjax
    raises there, e.g. 9 rows, n = 4, rows_per_max = 3), the seed is the
    n-band equal-pair partition with each band matched to an empty partner:
    it is feasible whenever n * rows_per_max covers the rows, and the climb
    only accepts feasible moves."""
    w = np.asarray(row_pairs, np.float64) + 1e-3
    tiles_y = w.shape[0]
    nb = 2 * n_dev
    cum = np.concatenate([[0.0], np.cumsum(w)])
    half = max(rows_per_max // 2, 1)
    if nb * half >= tiles_y:
        b = balance_band_bounds(row_pairs, nb, half).astype(np.int64)
    else:
        single = balance_band_bounds(row_pairs, n_dev, rows_per_max).astype(np.int64)
        b = np.repeat(single, 2)[1:]            # [0, b1, b1, b2, b2, ..., tiles_y]

    def best_match(bb):
        shares = cum[bb[1:]] - cum[bb[:-1]]
        rows = bb[1:] - bb[:-1]
        pr = pair_bands(shares, rows, rows_per_max)
        dev = shares[pr[:, 0]] + shares[pr[:, 1]]
        hfit = (rows[pr[:, 0]] + rows[pr[:, 1]] <= rows_per_max).all()
        return pr, float(dev.max()) + (0.0 if hfit else 1e18)

    pair, cur = best_match(b)
    for _ in range(30 * nb):
        best_gain, best = 0.0, None
        for i in range(1, nb):
            for dlt in (-1, 1):
                v = b[i] + dlt
                if not (b[i - 1] <= v <= b[i + 1]):
                    continue
                b2 = b.copy()
                b2[i] = v
                pr2, m = best_match(b2)
                if cur - m > best_gain:
                    best_gain, best = cur - m, (b2, pr2, m)
        if best is None:
            break
        b, pair, cur = best
    return b.astype(np.int32), pair


# --- a rank's rows -------------------------------------------------------

def check_partition(row_bounds, band_pair, tiles_y: int, n: int):
    """Validated (bounds int64 [n+1] or [2n+1], band_pair [n,2] or None):
    bounds from 0 to tiles_y, non-decreasing; a [2n+1] partition's pairs
    (default mirrored (d, 2n-1-d)) cover the 2n bands once, a < b."""
    b = np.asarray(row_bounds, np.int64).reshape(-1)
    if b.shape[0] not in (n + 1, 2 * n + 1):
        raise ValueError(f"row_bounds has {b.shape[0]} entries; {n} ranks need "
                         f"{n + 1} or {2 * n + 1}")
    if b[0] != 0 or b[-1] != tiles_y or np.any(np.diff(b) < 0):
        raise ValueError(f"row_bounds {b.tolist()} do not partition {tiles_y} rows")
    if b.shape[0] == n + 1:
        return b, None
    if band_pair is None:
        band_pair = np.stack([np.arange(n), 2 * n - 1 - np.arange(n)], 1)
    pair = np.asarray(band_pair, np.int64).reshape(n, 2)
    if sorted(pair.reshape(-1).tolist()) != list(range(2 * n)) or \
            np.any(pair[:, 0] >= pair[:, 1]):
        raise ValueError(f"band_pair {pair.tolist()} is not a matching of {2 * n} bands")
    return b, pair


def band_intervals(bounds, pair, rank: int) -> tuple:
    """(row_lo, row_hi, row_lo2, row_hi2) of a rank for `bin_gaussians`."""
    if pair is None:
        return int(bounds[rank]), int(bounds[rank + 1]), None, None
    a, b = pair[rank]
    return int(bounds[a]), int(bounds[a + 1]), int(bounds[b]), int(bounds[b + 1])


def band_rows(bounds, pair, rank: int) -> np.ndarray:
    """The tile rows of a rank (gsjax `_my_band_tiles`, shard.py:296): its
    band, or its first band's rows then its second's."""
    lo, hi, lo2, hi2 = band_intervals(bounds, pair, rank)
    rows = np.arange(lo, hi)
    if lo2 is not None:
        rows = np.concatenate([rows, np.arange(lo2, hi2)])
    return rows.astype(np.int64)


def _assembly_index(bounds, pair, n: int, tiles_y: int) -> tuple[np.ndarray, int]:
    """For each of the frame's tile rows, its slot in the all-gathered band
    rows (rank-major, each rank's padded to the tallest rank's), and that
    height (gsjax `_assemble_band_tiles`, shard.py:328)."""
    rows = [band_rows(bounds, pair, r) for r in range(n)]
    rpm = max(len(r) for r in rows)
    idx = np.full(tiles_y, -1, np.int64)
    for r, rr in enumerate(rows):
        idx[rr] = r * rpm + np.arange(len(rr))
    if np.any(idx < 0):
        raise ValueError("the partition leaves tile rows without an owner")
    return idx, rpm


def _gather_bands(planes: torch.Tensor, idx: np.ndarray, rpm: int, height: int,
                  cfg: RasterConfig, group) -> torch.Tensor:
    """Band-local planes [C, R * tile, W] of every rank -> the frame's
    [C, H, W] (differentiable: the backward hands each rank its rows'
    cotangent summed over ranks)."""
    c, _, w = planes.shape
    t = cfg.tile
    pad = rpm * t - planes.shape[1]
    if pad:
        planes = torch.cat([planes, planes.new_zeros(c, pad, w)], 1)
    full = all_gather(planes, dim=1, group=group)            # [C, n*rpm*t, W]
    full = full.reshape(c, -1, t, w)
    full = full.index_select(1, torch.as_tensor(idx, device=planes.device))
    return full.reshape(c, -1, w)[:, :height]


def _images(planes: torch.Tensor) -> dict:
    """The frame's [8, H, W] planes -> {color, normal, alpha, median_depth}
    (`render_ref.planes_to_images` without n_contrib, which is not gathered)."""
    return {"color": planes[0:3].permute(1, 2, 0), "normal": planes[3:6].permute(1, 2, 0),
            "alpha": planes[6], "median_depth": planes[7]}


def _blend_fns(cfg: RasterConfig, device):
    return select(cfg, device, (render_cuda.blend_fwd, render_cuda.blend_bwd),
                  (render_ref.blend_planes, render_ref.blend_bwd_planes))


# --- serving ---------------------------------------------------------------

@torch.no_grad()
def render_sharded(params: gm.GaussianParams, aux: gm.GaussianAux, camera: Camera,
                   cfg: RasterConfig, bg, row_bounds=None, band_pair=None,
                   group=None) -> dict:
    """One frame rendered with its tile rows split over the ranks (gsjax
    shard.py:373): replicated preprocess, band binning, B1 on the band's
    tile rows, all-gather and assembly. Returns {color, normal, alpha,
    median_depth} of the whole frame on every rank. `row_bounds` defaults to
    equal rows."""
    n, rank = world(group)
    tiles_x, tiles_y = cfg.grid(camera.width, camera.height)
    if row_bounds is None:
        row_bounds = equal_band_bounds(tiles_y, n)
    bounds, pair = check_partition(row_bounds, band_pair, tiles_y, n)
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    prep = preprocess(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                      gm.get_sg_axis(params), gm.get_sg_sharpness(params),
                      params.sg_color, camera, cfg, aux.alive)
    lo, hi, lo2, hi2 = band_intervals(bounds, pair, rank)
    binning = bin_gaussians(prep, cfg, camera.width, camera.height, row_lo=lo,
                            row_hi=hi, row_lo2=lo2, row_hi2=hi2)
    feats = render_ref.prepare_pairs(prep, binning)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=feats.device).reshape(3).contiguous()
    fwd, _ = _blend_fns(cfg, feats.device)
    planes = fwd(feats, binning.tile_start, binning.tile_count, camera.width,
                 camera.height, camera.fx, camera.fy, bg, cfg,
                 tile_rows=band_rows(bounds, pair, rank))
    idx, rpm = _assembly_index(bounds, pair, n, tiles_y)
    full = _gather_bands(planes[:IMAGE_PLANES].contiguous(), idx, rpm, camera.height,
                         cfg, group)
    return _images(full)


def stack_cameras(cams) -> list[Camera]:
    """A batch of same-resolution cameras (gsjax shard.py:411 stacks them
    into one pytree; here the list is checked and kept)."""
    cams = list(cams)
    w, h = cams[0].width, cams[0].height
    if any(c.width != w or c.height != h for c in cams):
        raise ValueError("stack_cameras requires a uniform resolution batch")
    return cams


VIEW_KEYS = ("render", "alpha", "normal", "median_depth")


@torch.no_grad()
def render_views_sharded(params: gm.GaussianParams, aux: gm.GaussianAux, cameras,
                         cfg: RasterConfig, bg, group=None) -> dict:
    """Batch serving (gsjax shard.py:423): whole views round-robin over the
    ranks (rank r renders views r, r + n, ...), each with the single-device
    `render`; every rank then gets every view. Returns {render, alpha,
    normal, median_depth} of [B, H, W(, C)] tensors, view b as `render`
    gives it."""
    cams = stack_cameras(cameras)
    n, rank = world(group)
    b = len(cams)
    per = -(-b // n)
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    feats = gm.get_features(params)
    sga, sgs = gm.get_sg_axis(params), gm.get_sg_sharpness(params)
    dev = params.xyz.device
    h, w = cams[0].height, cams[0].width
    mine = torch.zeros(per, h, w, IMAGE_PLANES, device=dev)
    for i, v in enumerate(range(rank, b, n)):
        out = render(params.xyz, scales, params.rotation, opac, feats, cams[v], cfg, bg,
                     sg_axis=sga, sg_sharpness=sgs, sg_color=params.sg_color,
                     alive=aux.alive)
        mine[i] = torch.cat([out["render"], out["alpha"][..., None], out["normal"],
                             out["median_depth"][..., None]], -1)
    allv = all_gather(mine, dim=0, group=group)                # [n*per, ...]
    # rank r's i-th view is view r + i n
    order = torch.as_tensor([(v % n) * per + v // n for v in range(b)], device=dev)
    allv = allv.index_select(0, order)
    return {"render": allv[..., 0:3], "alpha": allv[..., 3], "normal": allv[..., 4:7],
            "median_depth": allv[..., 7]}


# --- training --------------------------------------------------------------

def _preprocess_sharded(p: gm.GaussianParams, scales, opac, aux: gm.GaussianAux,
                        camera: Camera, cfg: RasterConfig, n: int, rank: int,
                        group) -> Preprocessed:
    """Preprocess sharded over GAUSSIANS (gsjax shard.py:586-617): this rank
    projects its ceil(capacity / n) rows and the outputs are all-gathered;
    the gather's backward runs the preprocess VJP on the rank's rows only."""
    cap = p.xyz.shape[0]
    ns = -(-cap // n)
    lo, hi = min(rank * ns, cap), min((rank + 1) * ns, cap)

    def rows(x):
        if x is None:
            return None
        x = x[lo:hi]
        if hi - lo < ns:           # the last ranks' rows, padded to ns
            x = torch.cat([x, x.new_zeros((ns - (hi - lo),) + x.shape[1:])])
        return x

    loc = preprocess(rows(p.xyz), rows(scales), rows(p.rotation), rows(opac),
                     rows(gm.get_features(p)), rows(gm.get_sg_axis(p)),
                     rows(gm.get_sg_sharpness(p)), rows(p.sg_color), camera, cfg,
                     rows(aux.alive))
    # two gathers: the float fields (differentiable) and the integer ones
    fields = [f.name for f in dataclasses.fields(Preprocessed)]
    cols = lambda t: t.reshape(ns, -1)
    floats = [k for k in fields if getattr(loc, k).is_floating_point()]
    ints = [k for k in fields if k not in floats]
    fl = all_gather(torch.cat([cols(getattr(loc, k)) for k in floats], 1), 0, group)[:cap]
    it = all_gather(torch.cat([cols(getattr(loc, k)).to(torch.int32) for k in ints], 1),
                    0, group)[:cap]
    out, i, j = {}, 0, 0
    for k in fields:
        t = getattr(loc, k)
        w = cols(t).shape[1]
        if k in floats:
            out[k] = fl[:, i:i + w].reshape((cap,) + t.shape[1:])
            i += w
        else:
            out[k] = it[:, j:j + w].reshape((cap,) + t.shape[1:]).to(t.dtype)
            j += w
    return Preprocessed(**out)


def _canon_partition(camera, cfg, n, row_bounds, band_pair):
    _, tiles_y = cfg.grid(camera.width, camera.height)
    if row_bounds is None:
        row_bounds = equal_band_bounds(tiles_y, n)
    return check_partition(row_bounds, band_pair, tiles_y, n)


def train_step_sharded(params: gm.GaussianParams, aux: gm.GaussianAux, adam: gm.AdamState,
                       camera: Camera, gt_image: torch.Tensor, bg: torch.Tensor,
                       lrs: dict[str, float], cfg: RasterConfig, loss_cfg: LossConfig,
                       near_cam: Camera | None = None, gray_r: torch.Tensor | None = None,
                       gray_n: torch.Tensor | None = None,
                       app_embedding: torch.Tensor | None = None,
                       app_net: app_lib.GofNet | None = None,
                       row_bounds=None, band_pair=None, group=None):
    """The training step with tile rows sharded over the ranks (gsjax
    shard.py:483-803), in parity with `train.step.train_step`: arguments and
    return (params, aux, adam, metrics) as there, the same on every rank,
    plus the partition (`row_bounds`, `band_pair`; default equal rows) and
    metrics["row_pairs"] (the frame's live pairs per tile row, the input of
    the band choosers), metrics["dev_num_pairs"] (the largest rank's
    enumerated pairs) and metrics["dev_num_live_pairs"].

    Every loss term is a band partial over a global denominator: L1 (every
    appearance kind; GOF's net runs replicated and its crop is banded),
    SSIM (each band's valid windows, the input carrying the window's 10
    halo rows), depth-normal (a 1-row halo each side) and the multi-view
    terms (each rank queries the neighbour for its own rows; the masked
    sums share global counts). Each rank differentiates its partial; the
    gradients are summed over ranks before the masking, the densification
    statistics and Adam, which every rank runs alike. An overflow of
    max_per_tile on any rank returns metrics["overflowed"] = True on every
    rank, the state unchanged (the caller retries on every rank). The
    multi-view NCC is the dense one (gsjax's sharded step turns the
    compacted NCC off, loop.py:418-421)."""
    n, rank = world(group)
    kind = loss_cfg.appearance
    if kind not in app_lib.KINDS:
        raise ValueError(f"unknown appearance model {kind!r}; one of {app_lib.KINDS}")
    if loss_cfg.ncc_compact:
        raise ValueError("the sharded step runs the dense NCC; ncc_compact must be off")
    width, height = camera.width, camera.height
    tiles_x, tiles_y = cfg.grid(width, height)
    bounds, pair = _canon_partition(camera, cfg, n, row_bounds, band_pair)
    dev = params.xyz.device

    app_leaves = []
    if kind != "no":
        app_embedding = app_embedding.detach().requires_grad_(True)
        app_leaves = [app_embedding]
    if kind == "gof":
        net_tree = app_net.tree()
        app_leaves += [p for layer in net_tree.values() for p in layer.values()]

    tap = torch.zeros(params.capacity, 2, device=dev, requires_grad=True)
    with spans.span("model.activate"):
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    prep = _preprocess_sharded(params, scales, opac, aux, camera, cfg, n, rank, group)
    prep = dataclasses.replace(prep, mean2d=prep.mean2d + tap)
    lo, hi, lo2, hi2 = band_intervals(bounds, pair, rank)
    binning = bin_gaussians(prep, cfg, width, height, row_lo=lo, row_hi=hi,
                            row_lo2=lo2, row_hi2=hi2)
    # [num_pairs, num_live, max_tile_count] of every rank, before the blend:
    # an overflow anywhere stops every rank here
    cnt = all_gather(torch.tensor([[binning.num_pairs, binning.num_live,
                                    binning.max_tile_count]], dtype=torch.int64,
                                  device=dev), 0, group).cpu()
    counts = dict(num_pairs=int(cnt[:, 0].sum()), num_live_pairs=int(cnt[:, 1].sum()),
                  max_tile_count=int(cnt[:, 2].max()), dev_num_pairs=int(cnt[:, 0].max()),
                  dev_num_live_pairs=int(cnt[:, 1].max()))
    if counts["max_tile_count"] > cfg.max_per_tile:
        return params, aux, adam, dict(counts, overflowed=True)

    feats = render_ref.prepare_pairs(prep, binning)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).reshape(3).contiguous()
    fwd, bwd = _blend_fns(cfg, dev)
    planes = render_cuda.Blend.apply(feats, binning.tile_start, binning.tile_count,
                                     width, height, camera.fx, camera.fy, bg, cfg,
                                     fwd, bwd, band_rows(bounds, pair, rank))
    idx, rpm = _assembly_index(bounds, pair, n, tiles_y)
    full = _images(_gather_bands(planes[:IMAGE_PLANES], idx, rpm, height,
                                         cfg, group))
    img = full["color"]

    # Each rank's `part` is its band's partial of the global loss: local
    # masked sums over global denominators. Differentiating `part` per rank
    # and summing the gradients gives d(loss)/d(inputs) (gsjax shard.py:
    # 636-643); the metrics come from summed partials, without a gradient.
    bh = -(-height // n)                              # L1 / depth-normal rows
    r0, r1 = min(rank * bh, height), min((rank + 1) * bh, height)
    if kind == "gof":
        mapped, crop_gt = app_lib.gof_mapped(img, gt_image, app_net, app_embedding)
        hc, wc = mapped.shape[0], mapped.shape[1]
        bhc = -(-hc // n)
        c0, c1 = min(rank * bhc, hc), min((rank + 1) * bhc, hc)
        l1_s = torch.abs(mapped[c0:c1] - crop_gt[c0:c1]).sum()
        l1_den = hc * wc * 3
    else:
        img_b = img[r0:r1]
        if kind == "gs":
            img_b = img_b @ app_embedding[:3, :3].T + app_embedding[:3, 3]
        elif kind == "pgsr":
            img_b = torch.exp(app_embedding[0]) * img_b + app_embedding[1]
        l1_s = torch.abs(img_b - gt_image[r0:r1]).sum()
        l1_den = height * width * 3
    hv, wv = height - 10, width - 10                  # SSIM's valid windows
    bv = -(-hv // n)
    v0, v1 = min(rank * bv, hv), min((rank + 1) * bv, hv)
    ssim_s = losses.ssim_partial(img[v0:v1 + 10], gt_image[v0:v1 + 10])
    ssim_den = hv * wv * 3
    lam = loss_cfg.lambda_dssim
    part = (1 - lam) * l1_s / l1_den - lam * ssim_s / ssim_den

    zero = torch.zeros((), device=dev)
    dsum = ncc_s = geo_s = zero
    mv_counts = torch.zeros(2, dtype=torch.int64, device=dev)
    mv = dict(mv_queries=0, mv_max_tile_count=0, mv_blocks=0)
    if loss_cfg.reg_on and loss_cfg.lambda_depth_normal > 0 and cfg.require_depth:
        # a 1-row halo each side (zero past the frame's edges, whose rows are
        # invalid in the full-frame map too)
        dpad = torch.nn.functional.pad(full["median_depth"], (0, 0, 1, 1))
        dn_s, dv_s = losses.depth_to_normal(dpad[r0:r1 + 2], camera.fx, camera.fy,
                                            camera.cx, camera.cy - (r0 - 1))
        err = 1.0 - torch.sum(full["normal"][r0:r1] * dn_s[1:-1], dim=-1)
        dsum = torch.where(dv_s[1:-1], err, torch.zeros_like(err)).sum()
        part = part + loss_cfg.lambda_depth_normal * dsum / (height * width)
    if (loss_cfg.reg_on and loss_cfg.mv_on and cfg.require_depth
            and (loss_cfg.lambda_mv_ncc > 0 or loss_cfg.lambda_mv_geo > 0)):
        ncc_s, ncc_c, geo_s, geo_c, mv["mv_queries"], mv["mv_max_tile_count"], _ = \
            multiview.patchmatch_terms(
                full["median_depth"][r0:r1], full["normal"][r0:r1], params.xyz, scales,
                params.rotation, opac, aux.alive, camera, near_cam, gray_r, gray_n, cfg,
                loss_cfg.pixel_noise_th, loss_cfg.patch_size, row_offset=r0)
        # the counts are masks (no gradient): the global denominators
        mv_counts = all_sum(torch.stack([ncc_c, geo_c]).to(torch.int64), group)
        anyf = (mv_counts[1] > 0).to(torch.float32)
        part = part + loss_cfg.lambda_mv_ncc * anyf * ncc_s / mv_counts[0].clamp_min(1) \
            + loss_cfg.lambda_mv_geo * anyf * geo_s / mv_counts[1].clamp_min(1)

    leaves = [getattr(params, k) for k in gm.PARAM_FIELDS]
    wrt = leaves + [tap] + app_leaves
    with spans.span("step.backward"):
        g_all = torch.autograd.grad(part, wrt, allow_unused=True)
        g_all = all_sum_many([torch.zeros_like(x) if g is None else g
                              for g, x in zip(g_all, wrt)], group)
    g_leaves, g2d, g_app = g_all[:len(leaves)], g_all[len(leaves)], g_all[len(leaves) + 1:]
    app_grad = g_app[0] if kind != "no" else None
    app_net_grad = None
    if kind == "gof":
        g_net = iter(g_app[1:])
        app_net_grad = {layer: {k: next(g_net) for k in p} for layer, p in net_tree.items()}

    def mask(g):
        m = aux.alive.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(m, g, torch.zeros_like(g))

    with spans.span("step.update"), torch.no_grad():
        grads = {k: mask(g) for k, g in zip(gm.PARAM_FIELDS, g_leaves)}
        g2d = mask(g2d)
        vis = prep.radius > 0
        aux = gm.add_densification_stats(aux, g2d, vis, width, height)
        aux = dataclasses.replace(aux, max_radii=torch.maximum(
            aux.max_radii, torch.where(vis, prep.radius, torch.zeros_like(prep.radius))))
        gm.adam_update(params, grads, adam, lrs)
    with spans.span("step.readback"), torch.no_grad():
        # the frame's sums and the per-row live-pair histogram, over ranks
        row_pairs = binning.tile_count.reshape(tiles_y, tiles_x).sum(1).to(torch.float64)
        sums = all_sum(torch.cat([torch.stack([l1_s, ssim_s, dsum, ncc_s, geo_s])
                                  .detach().to(torch.float64),
                                  torch.tensor([float(mv["mv_queries"])], dtype=torch.float64,
                                               device=dev), row_pairs]), group)
        scalars = []
        if loss_cfg.nan_stats:
            scalars = [nonfinite_count(t, aux.alive) for t in
                       [grads[k] for k in gm.PARAM_FIELDS]
                       + [getattr(params, k) for k in gm.PARAM_FIELDS]]
        bad = torch.stack(scalars).tolist() if scalars else []
        s = sums[:6].tolist()
        ncc_c, geo_c = mv_counts.tolist()
    mv["mv_queries"] = int(s[5])
    ll1, ssim_val = s[0] / l1_den, s[1] / ssim_den
    dn_loss = s[2] / (height * width)
    ncc_loss = s[3] / max(ncc_c, 1) if geo_c > 0 else 0.0
    geo_loss = s[4] / max(geo_c, 1) if geo_c > 0 else 0.0
    total = ((1 - lam) * ll1 + lam * (1 - ssim_val) + loss_cfg.lambda_depth_normal * dn_loss
             + loss_cfg.lambda_mv_ncc * ncc_loss + loss_cfg.lambda_mv_geo * geo_loss)
    nonfinite = {}
    if loss_cfg.nan_stats:
        k = len(gm.PARAM_FIELDS)
        nonfinite = {"nonfinite": {
            kd: {f: int(c) for f, c in zip(gm.PARAM_FIELDS, bad[i * k:(i + 1) * k])}
            for i, kd in enumerate(("grad", "param"))}}
    return params, aux, adam, dict(
        counts, overflowed=False, loss=total, l1=ll1, ssim=ssim_val, dn_loss=dn_loss,
        ncc_loss=ncc_loss, geo_loss=geo_loss, app_grad=app_grad, app_net_grad=app_net_grad,
        row_pairs=sums[6:].round().to(torch.int64).cpu().numpy(), **mv, **nonfinite)

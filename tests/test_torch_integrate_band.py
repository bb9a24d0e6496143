"""Kernel B4's per-point loop (`gsjax_torch/csrc/integrate_fwd.cu`),
emulated in float32 on the CPU, against the twin and gsjax.

B4 marches a tile's depth-sorted pairs as the twin does, but it skips work
the result does not need, and the tests hold that the skips change nothing:
- the band: an applied pair at least 6 sigmas in front of the point
  (delta = (t - t_peak) rsig >= 6) contributes exactly the march's own
  factor 1 - alpha, one at least 6 sigmas behind it exactly 1, so only a
  pair within 6 sigmas pays for the half-gaussian-CDF factor (an exp and a
  reciprocal square root). T(point) is the product of the factors. The
  first tests hold the premise bit for bit in float32, in the product form
  and in the twin's log form, for delta from 6 to 20 and alpha from 1/255 to
  the clamp: 1 - alpha hg rounds to exactly 1 there (without fast math);
- the cut-off: a pair's alpha test fails wherever its exponent lies below
  ln(alpha_min / opacity) less a margin of 0.01, which the block computes
  once per staged pair; a lane skips the exp there;
- the warp's list: each warp marches only the staged pairs whose cut-off
  ellipse (d^T C d <= -2 cut-off, grown by 2% and 1e-3) reaches the box of
  its 32 points.
The emulation runs the kernel's loop with those skips, in the kernel's order
of pairs, on `tests/test_torch_integrate.py`'s scene and on the same scene
60 times as far from the camera (gaussians and query points; ray distances
~120-360, where the band test subtracts two large ray distances), and holds
alpha to the twin and to gsjax's XLA `integrate` within that file's 2e-5,
with n_contrib equal to the twin's. It also checks, for every (point, pair)
of every block, that no skipped pair would have passed the alpha test.

The integrate sorts each tile's points by the Z order of their pixel
(`prepare_points(..., pixel_order=True)`), so that a warp's lanes lie close
together: the last tests hold that order's block table and that it gives the
twin's values point for point.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.sample import integrate as jintegrate
from gsjax_torch.ops import sample_cuda, sample_ref
from gsjax_torch.ops.sample import _pixel_keys, _z_order, prepare_points, prepare_view
from tests.test_torch_integrate import N_OUT, W, H, _jcfg, _scene, _tcam, _tcfg
from tests.util import look_at_camera

torch.set_num_threads(1)

BAND = 6.0            # integrate_fwd.cu:kBand
CUT_MARGIN = 0.01     # kCutMargin
DET_REL = 1e-4        # kDetRel
REACH_GROW, REACH_PAD = 1.02, 1e-3   # kReachGrow, kReachPad
BATCH = 256           # blend_common.cuh:kBatch
WARP = 32
FAR = 60.0
F32 = torch.float32


def band_factor(alpha, t, t_peak, rsig):
    """integrate_fwd.cu:band_factor -> (factor, band) in float32; band 0
    in front, 1 behind, 2 near, 3 a step (rsig <= 0)."""
    om1 = 1.0 - alpha
    delta = (t - t_peak) * rsig
    behind = t > t_peak
    om = torch.clamp_min(1.0 - alpha * torch.exp(-0.5 * delta * delta), 1e-12)
    r = torch.rsqrt(om)
    near = torch.where(behind, om1 * r, om * r)
    pos = rsig > 0
    f = torch.where(pos, torch.where(delta >= BAND, om1,
                                     torch.where(delta <= -BAND, torch.ones_like(om1), near)),
                    torch.where(behind, om1, torch.ones_like(om1)))
    band = torch.where(pos, torch.where(delta >= BAND, 0, torch.where(delta <= -BAND, 1, 2)),
                       3)
    return f, band


# --- the band premise ---------------------------------------------------------

@pytest.mark.parametrize("side", [1.0, -1.0], ids=["front", "behind"])
def test_band_premise_is_exact_in_float32(side):
    """At |delta| in [6, 20] the near formula is exactly the banded factor:
    1 - alpha in front of the point, 1 behind it, in the product form B4
    uses and in the log form of the twin (median.cuh:half_cdf_log_factor)."""
    alpha = torch.cat([torch.linspace(1 / 255, 0.99, 97, dtype=F32),
                       torch.tensor([1 / 255, 0.5, 0.99], dtype=F32)])[:, None, None]
    delta = side * torch.linspace(6.0, 20.0, 57, dtype=F32)[None, :, None]
    rsig = torch.tensor([0.5, 3.0, 40.0, 1e3], dtype=F32)[None, None, :]
    t_peak = torch.tensor(4.0, dtype=F32)
    t = t_peak + delta / rsig
    d = (t - t_peak) * rsig           # the delta the kernel computes
    assert bool((d.abs() >= BAND).all())
    hg = torch.exp(-0.5 * d * d)
    om = torch.clamp_min(1.0 - alpha * hg, 1e-12)
    assert bool((om == 1.0).all()), "1 - alpha hg must round to 1"
    om1 = (1.0 - alpha).expand_as(om)
    behind = t > t_peak
    # product form, with the near formula
    near = torch.where(behind, om1 * torch.rsqrt(om), om * torch.rsqrt(om))
    want = om1 if side > 0 else torch.ones_like(om1)
    assert torch.equal(near, want)
    f, band = band_factor(alpha.expand_as(om), t.expand_as(om), t_peak, rsig.expand_as(om))
    assert torch.equal(f, want)
    assert bool((band == (0 if side > 0 else 1)).all())
    # log form
    l1m = torch.log1p(-alpha).expand_as(om)
    hl = 0.5 * torch.log(om)
    term = torch.where(behind, l1m - hl, hl)
    assert torch.equal(term, l1m if side > 0 else torch.zeros_like(l1m))


# --- the emulation ------------------------------------------------------------

def reaches(q, cut, box):
    """integrate_fwd.cu:reaches, with the terms the block stages, for pairs q
    [K, 16] and the box (x0, y0, x1, y1) of a warp's points -> [K] bool."""
    gx, gy, ca, cb, cc = q[:, 0], q[:, 1], q[:, 2], q[:, 3], q[:, 4]
    det = ca * cc - cb * cb
    ok = (cut < 0) & (ca > 0) & (cc > 0) & (det > DET_REL * ca * cc)
    reach = torch.where(ok, -2.0 * cut * REACH_GROW + REACH_PAD, torch.full_like(cut, math.inf))
    kx, ky = -cb / cc, -cb / ca
    x0, x1 = gx - box[2], gx - box[0]
    y0, y1 = gy - box[3], gy - box[1]
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)

    def conic(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    clamp = lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi)
    qmin = torch.minimum(conic(x0, clamp(kx * x0, y0, y1)), conic(x1, clamp(kx * x1, y0, y1)))
    qmin = torch.minimum(qmin, conic(clamp(ky * y0, x0, x1), y0))
    qmin = torch.minimum(qmin, conic(clamp(ky * y1, x0, x1), y1))
    return inside | ~(qmin > reach)


def emulate(qr, t_eval, cfg):
    """B4's loop over its block table -> ([5, Q] rows in sorted order, skip
    counts). Each block stages its tile's list in batches of 256; each warp
    (32 consecutive points of a block) keeps the pairs that reach the box of
    its points, and each of its points marches that list: the cut-off
    pre-test, the exact alpha test (blend_common.cuh:pair_alpha), the stop,
    then the banded factor. Every skip is checked against the exact test on
    every point of the warp."""
    pts, feats = qr.pts, qr.feats
    out = torch.zeros(sample_ref.N_ROWS_INTEGRATE, pts.shape[0], dtype=F32)
    skips = {"staged": 0, "kept": 0, "tests": 0, "cut": 0, "applied": 0, "near": 0}
    for tile, first, count in qr.blocks.tolist():
        start = int(qr.binning.tile_start[tile])
        n_list = min(int(qr.binning.tile_count[tile]), cfg.max_per_tile)
        for w0 in range(first, first + count, WARP):
            w1 = min(w0 + WARP, first + count)
            px, py, et = pts[w0:w1, 0], pts[w0:w1, 1], t_eval[w0:w1]
            box = (px.min(), py.min(), px.max(), py.max())
            T = torch.ones(w1 - w0, dtype=F32)
            tp = torch.ones_like(T)
            md = torch.zeros_like(T)
            last = torch.full((w1 - w0,), -1)
            done = torch.zeros(w1 - w0, dtype=torch.bool)
            for b0 in range(0, n_list, BATCH):
                if bool(done.all()):
                    break
                q = feats[start + b0:start + min(n_list, b0 + BATCH)]
                cut = torch.log(cfg.alpha_min / q[:, 5]) - CUT_MARGIN
                keep = reaches(q, cut, box)
                skips["staged"] += q.shape[0]
                skips["kept"] += int(keep.sum())
                for j in range(q.shape[0]):
                    p = q[j]
                    dx, dy = p[0] - px, p[1] - py
                    power = -0.5 * (p[2] * dx * dx + p[4] * dy * dy) - p[3] * dx * dy
                    alpha = torch.clamp_max(p[5] * torch.exp(power), cfg.alpha_clamp)
                    passes = (power <= 0) & (alpha >= cfg.alpha_min)
                    # no skip drops a pair the exact test passes
                    assert not bool((passes & (power < cut[j])).any())
                    if not keep[j]:
                        assert not bool(passes.any())
                        continue
                    live = ~done
                    skips["tests"] += int(live.sum())
                    hit = live & (power <= 0) & (power >= cut[j])
                    skips["cut"] += int((live & ~hit).sum())
                    on = hit & (alpha >= cfg.alpha_min)
                    om1 = 1.0 - alpha
                    test_t = T * om1
                    stop = on & (test_t < cfg.transmittance_min)
                    done = done | stop
                    on = on & ~stop
                    t_peak = p[9] * dx + p[10] * dy + p[11]
                    md = torch.where(on & (T > 0.5), t_peak, md)
                    f, band = band_factor(alpha, et, t_peak, p[12])
                    tp = torch.where(on, tp * f, tp)
                    T = torch.where(on, test_t, T)
                    last = torch.where(on, b0 + j, last)
                    skips["applied"] += int(on.sum())
                    skips["near"] += int((on & (band == 2)).sum())
            out[:, w0:w1] = torch.stack([tp, torch.ones_like(tp), (last + 1).to(F32), md, T])
    return out, skips


def _far(g):
    """The scene `FAR` times as far: gaussians and the query points inside the
    frustum (the trailing ones stay outside as they are)."""
    pts, means, scales, q, op = (a.copy() for a in g)
    pts[:-N_OUT] *= FAR
    return pts, means * FAR, scales * FAR, q, op


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
def test_emulated_loop_matches_twin_and_gsjax(far):
    g = _far(_scene()) if far else _scene()
    cam, cfg = _tcam(), _tcfg()
    tg = [torch.as_tensor(a) for a in g]
    view = prepare_view(*tg[1:], cam, cfg)
    assert view.binning.max_tile_count <= 128, "one chunk per tile list"
    qr = prepare_points(view, tg[0], cam, cfg, pixel_order=True)
    t_eval = qr.t_ray[qr.sorted_q].contiguous()
    if far:
        assert float(t_eval.min()) > 100.0
    got, skips = emulate(qr, t_eval, cfg)
    want = sample_ref.integrate_rows(qr.feats, qr.binning.tile_start, qr.binning.tile_count,
                                     qr.pts, t_eval, qr.blocks, cfg)
    assert torch.equal(got[2], want[2]), "n_contrib"
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-5, atol=1e-6)
    # the skips are not vacuous on this scene
    assert skips["kept"] < skips["staged"]
    assert 0 < skips["cut"] < skips["tests"]
    assert 0 < skips["near"] < skips["applied"]
    # against gsjax's XLA integrate, point for point
    alpha = np.zeros(tg[0].shape[0], np.float32)
    alpha[qr.sorted_q.numpy()] = 1.0 - got[0].numpy()
    ref = jintegrate(*map(jnp.asarray, g), look_at_camera(W, H), _jcfg("ref"))
    inside = np.asarray(ref["inside"])
    np.testing.assert_array_equal(qr.inside0.numpy(), inside)
    assert inside.sum() > 30 and alpha[inside].max() > 0.5
    np.testing.assert_allclose(alpha, np.asarray(ref["alpha"]), atol=2e-5, rtol=0)


# --- the pixel order ----------------------------------------------------------

def test_z_order_interleaves_bits():
    """x's bits on the even positions, y's on the odd: a 32x32 tile's key
    visits its four 16x16 quarters one after another, each in Z order."""
    x, y = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    want = torch.zeros_like(x)
    for b in range(8):
        want |= ((x >> b) & 1) << (2 * b) | ((y >> b) & 1) << (2 * b + 1)
    key = _z_order(x) + 2 * _z_order(y)
    assert torch.equal(key, want)
    assert torch.equal(torch.sort(key[:32, :32].flatten()).values, torch.arange(1024))
    quarter = key[:32, :32] // 256
    assert torch.equal(quarter, (x[:32, :32] // 16) + 2 * (y[:32, :32] // 16))


@pytest.mark.parametrize("width, height, tile", [(100, 70, 16), (64, 64, 32)])
def test_pixel_keys_table(width, height, tile):
    """The integrate's per-pixel key table: each pixel's tile times tile^2
    plus the Z order of the pixel within the tile, also where the image ends
    inside a tile."""
    keys = _pixel_keys(width, height, tile, torch.device("cpu"))
    assert keys.dtype == torch.int32 and keys.shape == (width * height,)
    y, x = torch.meshgrid(torch.arange(height), torch.arange(width), indexing="ij")
    tile_id = (y // tile) * -(-width // tile) + x // tile
    want = tile_id * tile * tile + _z_order(x % tile) + 2 * _z_order(y % tile)
    assert torch.equal(keys.long(), want.flatten())


def test_pixel_order_blocks_and_values():
    """The integrate's pixel order against the tile order: the same points
    inside, blocks of one tile each with tiles non-decreasing, the pixels
    of each tile in Z order, and the twin's rows equal point for point."""
    g = [torch.as_tensor(a) for a in _scene(seed=5)]
    rng = np.random.default_rng(7)    # more points, so that tiles hold several blocks
    depth = rng.uniform(2.0, 6.0, 3000).astype(np.float32)
    xy = rng.uniform(-0.4, 0.4, (3000, 2)).astype(np.float32)
    pts = torch.as_tensor(np.concatenate([xy * depth[:, None], depth[:, None]], 1))
    cam, cfg = _tcam(), _tcfg()
    view = prepare_view(*g[1:], cam, cfg)
    rows = {}
    for pixel in (False, True):
        qr = prepare_points(view, pts, cam, cfg, pixel_order=pixel)
        b = qr.blocks
        assert int(b[:, 2].sum()) == qr.pts.shape[0] and bool((b[:, 2] <= BATCH).all())
        assert bool((b[1:, 0] >= b[:-1, 0]).all()), "tiles non-decreasing"
        assert bool((b[1:, 1] == b[:-1, 1] + b[:-1, 2]).all())
        tx, ty = (qr.pts[:, 0] // cfg.tile).long(), (qr.pts[:, 1] // cfg.tile).long()
        tile = ty * cfg.grid(W, H)[0] + tx
        blk_tile = torch.repeat_interleave(b[:, 0].long(), b[:, 2].long())
        assert torch.equal(tile, blk_tile), "each block within one tile"
        if pixel:
            assert int((b[1:, 0] == b[:-1, 0]).sum()) > 0, "a tile with several blocks"
            x = qr.pts[:, 0].floor().long() - tx * cfg.tile
            y = qr.pts[:, 1].floor().long() - ty * cfg.tile
            key = tile * cfg.tile ** 2 + _z_order(x) + 2 * _z_order(y)
            assert bool((key[1:] >= key[:-1]).all()), "Z order within each tile"
        r = sample_cuda.integrate_fwd(qr.feats, qr.binning.tile_start, qr.binning.tile_count,
                                      qr.pts, qr.t_ray[qr.sorted_q].contiguous(), qr.blocks,
                                      cfg)
        full = torch.zeros(r.shape[0], pts.shape[0])
        full[:, qr.sorted_q] = r
        rows[pixel] = (full, qr.inside0)
    assert torch.equal(rows[False][1], rows[True][1])
    assert torch.equal(rows[False][0], rows[True][0])


def test_counters_come_from_the_card():
    g = [torch.as_tensor(a) for a in _scene(seed=5)]
    cam, cfg = _tcam(), _tcfg()
    qr = prepare_points(prepare_view(*g[1:], cam, cfg), g[0], cam, cfg, pixel_order=True)
    args = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts,
            qr.t_ray[qr.sorted_q].contiguous(), qr.blocks, cfg)
    with pytest.raises(ValueError):
        sample_cuda.integrate_fwd(*args, counters=torch.zeros(
            len(sample_cuda.INTEGRATE_COUNTERS), dtype=torch.int64))
    assert math.isclose(sum(sample_cuda.integrate_stats(torch.arange(
        len(sample_cuda.INTEGRATE_COUNTERS)))["cycle_shares"].values()), 1.0)

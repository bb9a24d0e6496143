"""The median search of kernels B1 and B3 (`gsjax_torch/csrc/median.cuh`),
emulated in float32 on the CPU, against the twin's median.

The kernel folds each applied pair against the pixel's bracket: a pair at
least 6 sigmas behind every depth of the bracket contributes exactly
log1p(-alpha), one 6 sigmas ahead exactly 0. The fold is exact only because
the kernels are built without fast math or flush-to-zero; the first tests
hold that premise bit for bit in float32. The rest run a float32 PyTorch
emulation of the search as the kernel runs it (the fold into per-pixel slots
up to a capacity, the re-walk of a pixel whose set does not fit and its
switch to the slots once the narrowed set fits, the refold of the slots at
each evaluation, safeguarded Newton from the half bracket with its
convergence exit, all sums in the kernel's order) on the small scene
of tests/test_torch_render.py, and hold its median and in-range flags to
`render_ref`'s within chip_smoke.py's card limits for B1 against its twin
(MD_*: atol 2e-3 / rtol 1e-3 on >= 99.99% of pixels, every pixel within
5e-3; in-range equal on >= 99.99%; dlogT/dt within 1% / 1e-3 on >= 99.9% of
the pixels in range on both sides). Capacities 0 (every pixel re-walks), 4
(both paths) and unbounded agree with each other within the same limits.
"""

import math

import pytest
import torch

from gsjax_torch.ops.raster import RasterConfig, render_ref
from gsjax_torch.ops.raster.binning import bin_gaussians
from gsjax_torch.ops.raster.preprocess import preprocess
from tests.test_torch_render import H, W, _inputs, _tcam

torch.set_num_threads(1)

LOG_HALF = -0.69314718055994531      # median.cuh:kLogHalf
ITERS, STEP_TOL = 12, 1e-5           # kNewtonIters, kStepTol
CUT, WIDE_CUT = 6.0, 14.5            # kFoldCut, kWideCut
MD_ATOL, MD_RTOL, MD_FRAC, MD_MAX = 2e-3, 1e-3, 0.9999, 5e-3
DD_RTOL, DD_ATOL, DD_FRAC = 1e-2, 1e-3, 0.999


def term(alpha, l1m, t, t_peak, rsig):
    """median.cuh:half_cdf_log_factor<true> -> (term, d/dt), float32."""
    delta = (t - t_peak) * rsig
    hg = torch.where(rsig > 0, torch.exp(-0.5 * delta * delta), torch.zeros_like(delta))
    om = torch.clamp_min(1.0 - alpha * hg, 1e-12)
    hl = 0.5 * torch.log(om)
    behind = t > t_peak
    d = 0.5 * (alpha / om) * (-hg * delta * rsig)
    return torch.where(behind, l1m - hl, hl), torch.where(behind, d, -d)


def fold(lo, hi, t_peak, rsig, cut=CUT):
    """median.cuh:fold_behind / fold_ahead."""
    pos = rsig > 0
    behind = torch.where(pos, (lo - t_peak) * rsig >= cut, lo > t_peak)
    ahead = torch.where(pos, (hi - t_peak) * rsig <= -cut, hi <= t_peak)
    return behind, ahead


# --- the fold premise --------------------------------------------------------

def _grid():
    alpha = torch.tensor([1 / 255, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0], dtype=torch.float32)
    rsig = torch.tensor([0.5, 3.0, 40.0, 1e3], dtype=torch.float32)
    return alpha[:, None, None], rsig[None, :, None]


@pytest.mark.parametrize("side", ["behind", "ahead"])
def test_fold_premise_is_exact_in_float32(side):
    """At |delta| >= 6 the term is exactly log1p(-alpha) behind and exactly 0
    ahead; at |delta| >= 14.5 its d/dt is exactly 0 too, and in between it is
    below 4.6e-8 rsig. At |delta| = 5 the term is not folded exactly: the cut
    matters."""
    alpha, rsig = _grid()
    sign = 1.0 if side == "behind" else -1.0
    t_peak = torch.tensor(3.0)
    delta = torch.cat([torch.linspace(6.0, 14.4, 200), torch.linspace(14.5, 60.0, 200)])
    t = t_peak + sign * delta[None, None, :] / rsig
    delta_f = ((t - t_peak) * rsig).expand(alpha.shape[0], -1, -1)   # as the kernel
    keep = delta_f.abs() >= CUT
    l1m = torch.log1p(-torch.clamp_max(alpha, 1 - 1e-7))
    val, d = term(alpha, l1m, t, t_peak, rsig)
    want = torch.where(torch.as_tensor(sign > 0), l1m.expand_as(val), torch.zeros_like(val))
    assert keep.float().mean() > 0.99
    assert torch.equal(val[keep], want[keep]), "the value fold is not exact"
    wide = delta_f.abs() >= WIDE_CUT
    assert torch.equal(d[wide], torch.zeros_like(d[wide])), "d/dt is not 0 past 14.5"
    assert (d[keep].abs() <= 4.6e-8 * rsig.expand_as(d)[keep]).all()
    # the classification the kernel folds by agrees with the premise
    b, a = fold(t, t, t_peak, rsig.expand_as(t))
    assert bool((b if sign > 0 else a).expand_as(keep)[keep].all())
    val5, _ = term(torch.tensor(0.99), torch.log1p(torch.tensor(-0.99)),
                   t_peak + sign * 5.0, t_peak, torch.tensor(1.0))
    assert val5 != (torch.log1p(torch.tensor(-0.99)) if sign > 0 else 0.0)


# --- the search, emulated -----------------------------------------------------

def _sweep(pairs, member, konst, lo, hi, ts):
    """One pass over a pixel's pairs in list order (a walk of the staged list,
    or an evaluation of the slots): the fold against [lo, hi] and the terms at
    depths ts [P, K] of the pairs left, summed in the kernel's order. Returns
    (log T [P, K], d/dt [P, K], kept [P, M], konst [P])."""
    alpha, l1m, t_peak, rsig = pairs
    acc = torch.zeros_like(ts)
    dacc = torch.zeros_like(ts)
    konst = konst.clone()
    kept = torch.zeros_like(member)
    for m in range(alpha.shape[1]):
        on = member[:, m]
        if not bool(on.any()):
            continue
        behind, ahead = fold(lo, hi, t_peak[:, m], rsig[:, m])
        konst = torch.where(on & ~ahead & behind, konst + l1m[:, m], konst)
        vary = on & ~ahead & ~behind
        v, d = term(alpha[:, m, None], l1m[:, m, None], ts, t_peak[:, m, None],
                    rsig[:, m, None])
        acc = torch.where(vary[:, None], acc + v, acc)
        dacc = torch.where(vary[:, None], dacc + d, dacc)
        kept[:, m] = vary
    return acc + konst[:, None], dacc, kept, konst


class _Newton:
    """median.cuh:Newton over pixels, float32."""

    def __init__(self, lo, hi, l_lo, l_hi):
        self.lo, self.hi = lo.clone(), hi.clone()
        self.t_lo, self.t_hi = torch.exp(l_lo), torch.exp(l_hi)
        w0 = torch.clamp((l_lo - LOG_HALF) / _safe(l_lo - l_hi), 0.0, 1.0)
        self.t = lo + w0 * (hi - lo)
        self.last = hi - lo
        self.iters = torch.zeros(lo.shape, dtype=torch.int64)
        self.done = torch.zeros(lo.shape, dtype=torch.bool)

    def update(self, live, l, d):
        tv = torch.exp(l)
        right = tv >= 0.5
        self.lo = torch.where(live & right, self.t, self.lo)
        self.t_lo = torch.where(live & right, tv, self.t_lo)
        self.hi = torch.where(live & ~right, self.t, self.hi)
        self.t_hi = torch.where(live & ~right, tv, self.t_hi)
        ok = d < -1e-20
        step = (l - LOG_HALF) / torch.where(ok, d, torch.full_like(d, -1.0))
        t_n = self.t - step
        newton = ok & (t_n > self.lo) & (t_n < self.hi) & (2.0 * step.abs() <= self.last.abs())
        last = torch.where(newton, step, 0.5 * (self.hi - self.lo))
        t_next = torch.where(newton, t_n, 0.5 * (self.lo + self.hi))
        self.iters = self.iters + live
        done = (self.iters >= ITERS) | ((t_next - self.t).abs() <= STEP_TOL) | \
            (ok & (step.abs() <= STEP_TOL))
        self.done = torch.where(live, done, self.done)
        self.last = torch.where(live, last, self.last)
        self.t = torch.where(live, t_next, self.t)

    def root(self):
        w = torch.clamp((self.t_lo - 0.5) / _safe(self.t_lo - self.t_hi), 0.0, 1.0)
        return w * self.hi + (1.0 - w) * self.lo

    def refine(self, t_star, l, d):
        ok = d < -1e-20
        t_ref = t_star - (l - LOG_HALF) / torch.where(ok, d, torch.full_like(d, -1.0))
        return torch.where(ok & (t_ref > self.lo) & (t_ref < self.hi), t_ref, t_star)


def _safe(d):
    return torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))


def emulate_search(pairs, valid, md_init, cand, cfg, cap):
    """median.cuh:median_search for every pixel: pairs (alpha, l1m, t_peak,
    rsig) [P, M] its applied pairs in list order where `valid`; `cap` slots a
    pixel (None: unbounded). Returns m_t, in_range, d_denom, Newton
    evaluations, first-sweep varying pairs and whether a pixel re-walked."""
    cap = math.inf if cap is None else cap
    p = md_init.shape[0]
    lo = torch.clamp_min(md_init - cfg.sample_range, 0.0)
    hi = torch.clamp_min(md_init + cfg.sample_range, 0.0)
    mid = torch.minimum(torch.maximum(md_init, lo), hi)
    lt, _, kept, konst = _sweep(pairs, valid & cand[:, None], torch.zeros(p), lo, hi,
                                torch.stack([lo, mid, hi], 1))
    n_vary = kept.sum(1)
    in_range = cand & (torch.exp(lt[:, 0]) >= 0.5) & (torch.exp(lt[:, 2]) <= 0.5)
    upper = torch.exp(lt[:, 1]) >= 0.5
    nw = _Newton(torch.where(upper, mid, lo), torch.where(upper, hi, mid),
                 torch.where(upper, lt[:, 1], lt[:, 0]), torch.where(upper, lt[:, 2], lt[:, 1]))
    on_slots = in_range & (n_vary <= cap)
    walked = in_range & ~on_slots
    slots, s_konst = kept & on_slots[:, None], torch.where(on_slots, konst, 0.0)
    finished = ~in_range
    m_t = torch.zeros(p)
    d_denom = torch.zeros(p)
    while not bool(finished.all()):
        final = nw.done & ~finished                     # this pass evaluates at the root
        t = torch.where(final, nw.root(), nw.t)
        # a walk re-reads the list (konst from 0), the slots their own set
        member = torch.where(on_slots[:, None], slots, valid)
        k_in = torch.where(on_slots, s_konst, 0.0)
        l, d, kept, konst = _sweep(pairs, member & ~finished[:, None], k_in, nw.lo, nw.hi,
                                   t[:, None])
        l, d = l[:, 0], d[:, 0]
        m_t = torch.where(final, nw.refine(t, l, d), m_t)
        d_denom = torch.where(final, d, d_denom)
        finished = finished | final
        live = ~finished
        nw.update(live, l, d)
        fits = live & (on_slots | (kept.sum(1) <= cap))
        slots = torch.where(fits[:, None], kept, slots)
        s_konst = torch.where(fits, konst, s_konst)
        on_slots = on_slots | fits
    return {"m_t": torch.where(in_range, m_t, 0.0), "in_range": in_range,
            "d_denom": torch.where(in_range, d_denom, 0.0), "iters": nw.iters,
            "varying": n_vary, "walked": walked}


@pytest.fixture(scope="module")
def scene():
    """The small scene of test_torch_render.py through the twin, and each
    pixel's applied pairs in list order."""
    g, _ = _inputs()
    cam = _tcam()
    cfg = RasterConfig(sh_degree=2, max_per_tile=256, require_depth=True)
    prep = preprocess(*map(torch.as_tensor, g), None, None, None, cam, cfg)
    b = bin_gaussians(prep, cfg, W, H)
    feats = render_ref.prepare_pairs(prep, b)
    planes = render_ref.blend_planes(feats, b.tile_start, b.tile_count, W, H, cam.fx,
                                     cam.fy, torch.zeros(3), cfg)
    tiles_x, tiles_y = cfg.grid(W, H)
    ids = torch.arange(tiles_x * tiles_y)
    px, py = render_ref._tile_pixels(ids, tiles_x, cfg)
    inside = (px < W) & (py < H)
    yy, xx = py.long().clamp_max(H - 1), px.long().clamp_max(W - 1)
    nc = torch.where(inside, planes[8][yy, xx].long(), 0)
    feats_pad = torch.cat([feats, feats.new_zeros(1, 16)])
    counts = b.tile_count.long().clamp_max(cfg.max_per_tile)
    f, rel, valid = render_ref._gather_chunk(feats_pad, b.tile_start.long(), counts, 0,
                                             int(counts.max()))
    alpha, passes, dx, dy = render_ref._alpha_terms(f, px, py, cfg, valid)
    applied = passes & (rel[None, :, None] < nc[:, None, :])
    t_peak = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
    rsig = f[..., 12:13].expand_as(t_peak)
    # [tile, pair, pixel] -> [pixel, applied pairs left-packed in list order]
    flat = lambda x: x.permute(0, 2, 1).reshape(-1, x.shape[1])
    a, tp, rs, ap = flat(alpha), flat(t_peak), flat(rsig), flat(applied)
    order = torch.argsort((~ap).to(torch.int8), dim=1, stable=True)
    m = int(ap.sum(1).max())
    take = lambda x: torch.gather(x, 1, order)[:, :m]
    a, tp, rs, ap = take(a), take(tp), take(rs), take(ap)
    a = torch.where(ap, a, 0.0)
    sel = inside.reshape(-1)
    pix = (yy.reshape(-1)[sel], xx.reshape(-1)[sel])
    pairs = (a[sel], torch.log1p(-a[sel]), tp[sel], rs[sel])
    zfac = render_ref._ray_to_z(px.reshape(-1)[sel], py.reshape(-1)[sel], W, H, cam.fx, cam.fy)
    cand = planes[10][pix] <= cfg.min_transmittance
    return {"pairs": pairs, "valid": ap[sel], "md_init": planes[9][pix], "cand": cand,
            "cfg": cfg, "zfac": zfac, "want_md": planes[7][pix],
            "want_in": planes[11][pix] > 0, "want_dd": planes[12][pix]}


def _run(scene, cap):
    return emulate_search(scene["pairs"], scene["valid"], scene["md_init"], scene["cand"],
                          scene["cfg"], cap)


def _held(md_a, in_a, dd_a, md_b, in_b, dd_b):
    close = torch.isclose(md_a, md_b, atol=MD_ATOL, rtol=MD_RTOL)
    assert close.float().mean() >= MD_FRAC, f"median close on {close.float().mean()}"
    assert (md_a - md_b).abs().max() <= MD_MAX
    assert (in_a == in_b).float().mean() >= MD_FRAC
    both = in_a & in_b
    dd = torch.isclose(dd_a[both], dd_b[both], rtol=DD_RTOL, atol=DD_ATOL)
    assert dd.float().mean() >= DD_FRAC, f"dlogT/dt close on {dd.float().mean()}"


@pytest.mark.parametrize("cap", [0, 4, None])
def test_emulated_search_matches_twin(scene, cap, record_property):
    r = _run(scene, cap)
    searched = r["in_range"]
    assert searched.float().mean() > 0.2, "the scene must exercise the median"
    walked = r["walked"][searched].float().mean()
    if cap == 0:
        assert walked > 0.9
    elif cap == 4:
        assert 0.05 < walked < 0.95, f"both paths must run: {walked} re-walk"
    else:
        assert walked == 0
    _held(r["m_t"] * scene["zfac"], r["in_range"], r["d_denom"], scene["want_md"],
          scene["want_in"], scene["want_dd"])
    # a CPU anchor for the card's reading of the search (chip_smoke's search line)
    iters = r["iters"][searched].double()
    record_property("newton_evaluations_mean", float(iters.mean()))
    print(f"cap {cap}: Newton evaluations mean {float(iters.mean()):.3f}, max "
          f"{int(iters.max())}; varying pairs mean {float(r['varying'][searched].double().mean()):.2f}"
          f"; re-walked {float(walked):.3f}")
    assert int(iters.max()) <= ITERS and float(iters.mean()) < 8


def test_capacities_agree(scene):
    runs = {cap: _run(scene, cap) for cap in (0, 4, None)}
    ref = runs[None]
    for cap in (0, 4):
        r = runs[cap]
        _held(r["m_t"], r["in_range"], r["d_denom"], ref["m_t"], ref["in_range"],
              ref["d_denom"])
        assert torch.equal(r["in_range"], ref["in_range"])

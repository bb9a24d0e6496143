"""The comparison that decides `correct`: the numbers a cell compares between
what the timed path produced and the plain reference, each held to the limit
in `limits/<cell>.json`.

Planes (colour, alpha, normal, median depth) are compared as the share of
pixels outside chip_smoke.py's kernel-versus-twin tolerances (commit 95f6082:
TOL_COLOR, TOL_NORMAL, MD_ATOL / MD_RTOL): float rounding flips a discrete
test on a few pixels, so a share is steady where a largest error swings.
Training numbers follow the step: each step's loss and multi-view terms as a
relative gap, and by the worst leaf the gap between the program's and the
reference's norms of the parameters' change over the checked steps, against
the larger of the reference leaf's norm and the median leaf's, and by the
worst leaf the distance between the two changes themselves over the
reference's change, which follows the gradients' direction (Adam's first
update is about lr * sign(g), so the norm alone misses a gradient of the
wrong sign). A leaf whose reference gradient (from Adam's first moment after
one step) is under a thousandth of the median leaf's moves under Adam by
round-off alone and is left out. The first gradient's norms are not
compared: the geometric leaves' run through the median depth's implicit
gradient, whose denominator Newton (the kernels) and bisection (the twins)
evaluate at roots that differ where T(t) is flat, and swing from seed to
seed (PERF.md section 2).
"""

from __future__ import annotations

import math

import torch

TOL_COLOR = 3e-5
TOL_NORMAL = 2e-4
MD_ATOL, MD_RTOL = 2e-3, 1e-3
NOUGHT_LEAF = 1e-3


PLANES = ("color_far_share", "alpha_far_share", "normal_far_share", "depth_far_share")


def _far(a, b, tol):
    d = (a - b).abs()
    if d.dim() == 3:
        d = d.amax(-1)
    return float((d > tol).float().mean())


def plane_numbers(prog: dict, ref: dict) -> dict:
    """Shares of pixels outside the tolerances, program against reference."""
    md_close = torch.isclose(prog["median_depth"], ref["median_depth"], atol=MD_ATOL,
                             rtol=MD_RTOL)
    return {"color_far_share": _far(prog["render"], ref["render"], TOL_COLOR),
            "alpha_far_share": _far(prog["alpha"], ref["alpha"], TOL_COLOR),
            "normal_far_share": _far(prog["normal"], ref["normal"], TOL_NORMAL),
            "depth_far_share": float(1.0 - md_close.float().mean())}


def worst(rows: list[dict]) -> dict:
    """Key by key the largest of several comparisons' numbers."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def rel_gap(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.norm(t.double())) for k, t in tensors.items()
            if t.numel()}


def moving_leaves(ref: dict, ref_grad: dict) -> list:
    """The leaves of `ref` whose reference gradient is not nought: at least
    a thousandth of the median leaf's."""
    g = sorted(ref_grad.values())
    med_g = g[len(g) // 2] if g else 0.0
    return [k for k in ref if ref_grad.get(k, 0.0) >= NOUGHT_LEAF * med_g]


def leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> dict:
    """Per leaf |prog norm - ref norm| / max(ref norm, median ref norm), over
    the leaves whose reference gradient is not nought."""
    keep = moving_leaves(ref, ref_grad)
    if not keep:
        return {}
    norms = sorted(ref[k] for k in keep)
    med = norms[len(norms) // 2]
    out = {}
    for k in keep:
        p = prog.get(k, math.nan)
        out[k] = abs(p - ref[k]) / max(ref[k], med, 1e-30) if math.isfinite(p) else math.inf
    return out


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's gap (`leaf_gaps`); inf where no leaf is left."""
    gaps = leaf_gaps(prog, ref, ref_grad)
    return max(gaps.values()) if gaps else math.inf


def dir_gaps(prog: dict, ref: dict, ref_grad: dict) -> dict:
    """Per leaf ||prog change - ref change|| / ||ref change||, over the
    leaves whose reference gradient is not nought (the changes are tensors,
    compared on the host in float64)."""
    out = {}
    for k in moving_leaves({k: v for k, v in ref.items() if v.numel()}, ref_grad):
        if k not in prog or prog[k].shape != ref[k].shape:
            out[k] = math.inf
            continue
        r = ref[k].double()
        den = float(torch.linalg.norm(r))
        num = float(torch.linalg.norm(prog[k].double() - r))
        if not math.isfinite(num):
            out[k] = math.inf
        else:
            out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def dir_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's `dir_gaps`; inf where no leaf is left."""
    gaps = dir_gaps(prog, ref, ref_grad)
    return max(gaps.values()) if gaps else math.inf


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [number, limit]}): every number at or under its
    limit; a number without a limit, or not finite, is not correct."""
    lines, ok = {}, True
    for name, v in numbers.items():
        lim = limits.get(name, {}).get("limit")
        good = lim is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        lines[name] = [v, lim]
    for name in limits:
        if name not in numbers:
            ok = False
            lines[name] = [None, limits[name].get("limit")]
    return ok, lines

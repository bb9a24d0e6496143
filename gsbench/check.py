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
round-off alone and is left out. Within the leaves kept, both change checks
leave out every element whose reference gradient in the first checked step
is under a round-off floor of its row, `ROUNDOFF_FLOOR` of the largest |g|
among the same gaussian's elements of that leaf (`above_floor`): Adam's
first update moves such an element by a whole learning rate of its
round-off's sign, or not at all where it is exactly 0, so a sum taken in
another order flips it. The first gradient's norms are not compared: the
geometric leaves' run through the median depth's implicit gradient, whose
denominator Newton (the kernels) and bisection (the twins) evaluate at
roots that differ where T(t) is flat, and swing from seed to seed (PERF.md
section 2).
"""

from __future__ import annotations

import math

import torch

TOL_COLOR = 3e-5
TOL_NORMAL = 2e-4
MD_ATOL, MD_RTOL = 2e-3, 1e-3
NOUGHT_LEAF = 1e-3
# An element whose first reference |g| is under this share of the largest
# |g| of its row (the gaussian's elements of the leaf) is round-off: the
# ground disk's quaternions (w, 0, 0, z) with two equal scales have a w and z
# gradient of 1e-12 to 1e-6 of their row's on the card, float32 round-off of
# sums of the row's terms (PERF.md section 6). The floor sits ten
# times above that band; at most 0.05% of any other leaf's elements with a
# gradient lie under it.
ROUNDOFF_FLOOR = 1e-5


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


def above_floor(grad_abs: dict, floor: float = ROUNDOFF_FLOOR) -> dict:
    """Per leaf, the elements whose first-step reference gradient
    (`grad_abs`: each leaf's |g|, its first axis the gaussians) reaches
    `floor` of the largest of its row. An element under it moves in that
    step by a whole learning rate of its round-off's sign, or not at all
    where it is exactly 0, and a later step only adds to that; an element
    above it moves by its gradient's sign, and Adam's moments carry that
    gradient into every later step. A row whose gradient is 0 throughout
    (a gaussian no checked view's first step reached) keeps its elements:
    0 on both sides, they move by the later steps' gradients alone."""
    out = {}
    for k, a in grad_abs.items():
        top = a.reshape(a.shape[0], -1).amax(1).reshape((-1,) + (1,) * (a.dim() - 1))
        out[k] = a >= floor * top
    return out


def kept(delta: dict, keep: dict) -> dict:
    """Each leaf's change at the elements `keep` marks, flattened, on the
    mask's device; a leaf with no mask, or of another shape than its mask,
    as it is (a shape that differs from the reference's then reads inf in
    `dir_gaps`)."""
    return {k: d.to(keep[k].device)[keep[k]] if k in keep and d.shape == keep[k].shape
            else d for k, d in delta.items()}


def change_gaps(prog_delta: dict, ref_delta: dict, keep: dict,
                ref_grad: dict) -> tuple[float, float]:
    """(`change_norm_gap`, `change_dir_gap`): the worst leaf's gap of the
    change's norms and of the change itself over the reference's, each
    over the elements `keep` marks (`above_floor`)."""
    p, r = kept(prog_delta, keep), kept(ref_delta, keep)
    return leaf_gap(leaf_norms(p), leaf_norms(r), ref_grad), dir_gap(p, r, ref_grad)


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

"""The trace arithmetic (idle union, gaps, launches), the roofline shares and
`mfu` on hand-made traces and counts."""

import pytest

from gsbench import readers
from gsbench import trace as trace_lib
from gsbench.counts import peaks, work


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert trace_lib.union_s(spans) == pytest.approx(4.0)
    assert trace_lib.union_s([]) == 0.0
    assert trace_lib.gaps(spans, 5) == [(4.0, 6.0), (2.0, 3.0)]
    host = [("aten::item", 1.9, 3.1), ("outer", 0.0, 10.0), ("aten::sort", 4.5, 5.5)]
    assert trace_lib.host_op_at(host, 2.5) == "aten::item"
    assert trace_lib.host_op_at(host, 5.0) == "aten::sort"
    assert trace_lib.host_op_at(host, 20.0) == "no host op"


def _ctx(kind="train"):
    kernels = [("blend_fwd_kernel(Params)", 0.0, 0.002), ("Memcpy HtoD", 0.002, 0.003),
               ("elementwise_kernel", 0.004, 0.005), ("blend_fwd_kernel(Params)", 0.006, 0.008),
               ("blend_bwd_kernel(BwdParams)", 0.008, 0.009)]
    trace = {"window_s": 0.01, "busy_s": trace_lib.union_s([(s, e) for _, s, e in kernels]),
             "kernels": kernels}
    launches = [{"name": "blend_fwd", "bytes": 3.35e12 * 1e-3, "ops": 0.0},
                {"name": "blend_fwd", "bytes": 0.0, "ops": 67e12 * 0.5e-3},
                {"name": "blend_bwd", "bytes": 1.0, "ops": 1.0}]
    counts = {"launches": launches, "units": 2, "ops": 67e12 * 0.001, "mv_queries": [10, 20]}
    return {"trace": trace, "counts": counts, "kind": kind}


def test_readers():
    ctx = _ctx()
    assert readers.idle_share(ctx, "train") == pytest.approx(100 * (1 - 0.007 / 0.01))
    assert readers.idle_share(ctx, "render") is None
    assert readers.launches_per_unit(ctx, "train") == 2.0        # 4 kernels, a copy left out
    # B1: bound 1 ms + 0.5 ms over 2 + 2 ms of kernel time
    assert readers.roofline(ctx, "train", "blend_fwd", "blend_fwd_kernel") == \
        pytest.approx(100 * 1.5 / 4)
    assert readers.roofline(ctx, "train", "sample_fwd", "sample_fwd_kernel") is None
    assert readers.mean_counter(ctx, "train", "mv_queries") == 15.0
    assert readers.mfu(ctx, "train") == pytest.approx(10.0)
    ctx["counts"]["launches"] = ctx["counts"]["launches"][:1]     # launches and kernels disagree
    assert readers.roofline(ctx, "train", "blend_fwd", "blend_fwd_kernel") is None


def test_peaks_and_work():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    a = work.step_ops(0.0, 1000, 59, 100, 3, 0, False)
    b = work.step_ops(0.0, 1000, 59, 100, 3, 0, True)
    assert b > a > 0
    assert work.frame_ops(5.0, 10, 2, 7) == 5.0 + work.preprocess_ops(10, 2, 7)


def test_change_direction_gap():
    import torch

    from gsbench import check

    ref = {"a": torch.tensor([1.0, -1.0, 1.0, 0.0]), "b": torch.tensor([0.5, 0.5]),
           "c": torch.zeros(3)}
    grad = {"a": 1.0, "b": 2.0, "c": 0.0}          # c: a nought gradient, left out
    assert check.dir_gap(ref, ref, grad) == 0.0
    flipped = dict(ref, a=-ref["a"])
    assert check.dir_gap(flipped, ref, grad) == pytest.approx(2.0)
    assert check.dir_gap(dict(ref, b=torch.zeros(2)), ref, grad) == pytest.approx(1.0)
    assert set(check.dir_gaps(flipped, ref, grad)) == {"a", "b"}
    # a norm cannot see the sign: the change's norm gap reads 0 where the direction reads 2
    norms = lambda d: check.leaf_norms(d)
    assert check.leaf_gap(norms(flipped), norms(ref), grad) == 0.0
    assert check.dir_gap({"b": ref["b"]}, ref, grad) == float("inf")   # a leaf missing


def _adam_change(g1, g2, lr=1.0, b1=0.9, b2=0.999, eps=1e-15):
    """The change of two fresh Adam steps on gradients g1 then g2 (the
    port's and the reference's `adam_update`)."""
    import torch

    mu, nu, p = torch.zeros_like(g1), torch.zeros_like(g1), torch.zeros_like(g1)
    for t, g in enumerate((g1, g2), 1):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        p = p - lr * (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps)
    return p


def test_roundoff_floor():
    """An element whose first reference gradient is round-off against its
    row's no longer counts where its step differs, zero on one side only or
    of the other sign, even where a later step's gradient is real; a doubled
    gradient above the floor still counts, and so does a row that is small
    throughout."""
    import torch

    from gsbench import check

    # rotation rows (w, x, y, z): the first two gaussians' w and z round-off
    g1 = {"rotation": torch.tensor([[3e-9, 1.0, -0.5, -2e-9], [1e-9, -0.3, 0.2, 4e-10],
                                    [1e-6, -2e-6, 3e-6, 1e-6]]),
          "xyz": torch.tensor([[0.2, -0.7, 0.4]])}
    g2 = {"rotation": torch.tensor([[-1e-9, -0.5, -0.4, 0.6], [2e-9, 0.1, 0.1, 1e-9],
                                    [1e-6, 1e-6, -1e-6, 1e-6]]),
          "xyz": torch.tensor([[0.1, -0.6, 0.5]])}
    ref = {k: _adam_change(g1[k], g2[k]) for k in g1}
    first = {k: g.abs() for k, g in g1.items()}
    grad = check.leaf_norms(g1)
    keep = check.above_floor(first)
    assert keep["rotation"].tolist() == [[False, True, True, False], [False, True, True, False],
                                         [True, True, True, True]]
    assert keep["xyz"].all()
    assert check.change_gaps(ref, ref, keep, grad) == (0.0, 0.0)
    every = {k: torch.ones_like(x, dtype=torch.bool) for k, x in keep.items()}
    for w, z in ((0.0, -2e-9),            # exactly 0 on one side only
                 (3e-9, 2e-9)):           # round-off of the other sign, its next step real
        g = {"rotation": g1["rotation"].clone(), "xyz": g1["xyz"]}
        g["rotation"][0, 0], g["rotation"][0, 3] = w, z
        prog = {k: _adam_change(g[k], g2[k]) for k in g1}
        norm_all, dir_all = check.change_gaps(prog, ref, every, grad)
        assert norm_all > 0.01 and dir_all > 0.3
        assert check.change_gaps(prog, ref, keep, grad) == (0.0, 0.0)
    # the second step's gradient doubled on an element above the floor
    doubled = {"rotation": g2["rotation"].clone(), "xyz": g2["xyz"]}
    doubled["rotation"][0, 1] *= 2
    prog = {k: _adam_change(g1[k], doubled[k]) for k in g1}
    norm_gap, dir_gap = check.change_gaps(prog, ref, keep, grad)
    assert norm_gap > 1e-2 and dir_gap > 1e-2
    # a row small throughout is no round-off: its sign flipped counts
    flipped = {"rotation": g1["rotation"].clone(), "xyz": g1["xyz"]}
    flipped["rotation"][2, 0] *= -1
    prog = {k: _adam_change(flipped[k], g2[k]) for k in g1}
    assert check.change_gaps(prog, ref, keep, grad)[1] > 1e-2
    # a row whose first gradient is 0 throughout keeps its elements
    assert check.above_floor({"a": torch.zeros(2, 3)})["a"].all()

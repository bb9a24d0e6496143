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

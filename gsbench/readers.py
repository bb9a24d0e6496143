"""Arithmetic the per-layer readers under `metrics/` share. Each takes the
run's context: `trace` (trace.traced's reduction of the traced window),
`counts` (each traced launch's bytes and operations from `counts/`, the
units traced, the whole window's operations, the step counters) and `kind`
(the traffic's driver). A reader that finds nothing to read returns None."""

from __future__ import annotations

import statistics

from gsbench import trace as trace_lib
from gsbench.counts.peaks import PEAK_F32_S, bound_s


def idle_share(ctx, kind: str):
    t = ctx.get("trace")
    if ctx.get("kind") != kind or not t or t["window_s"] <= 0 or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_unit(ctx, kind: str):
    t, c = ctx.get("trace"), ctx.get("counts")
    if ctx.get("kind") != kind or not t or not c or not c["units"]:
        return None
    n = sum(1 for name, _, _ in t["kernels"] if trace_lib.is_launch(name))
    return n / c["units"] if n else None


def roofline(ctx, kind: str, wrapper: str, kernel: str):
    """Share of the least time the traced launches of `wrapper` needed in
    the time its kernel (`kernel` in the trace's name) took, in %."""
    t, c = ctx.get("trace"), ctx.get("counts")
    if ctx.get("kind") != kind or not t or not c:
        return None
    need = [bound_s(x["bytes"], x["ops"]) for x in c["launches"] if x["name"] == wrapper]
    took = trace_lib.kernel_times(t["kernels"], kernel)
    if not need or not took or len(need) != len(took):
        return None
    return 100.0 * sum(need) / sum(took)


def mean_counter(ctx, kind: str, key: str):
    c = ctx.get("counts")
    if ctx.get("kind") != kind or not c or not c.get(key):
        return None
    return float(statistics.fmean(c[key]))


def mfu(ctx, kind: str):
    """The operations the traced steps or frames needed over the traced
    window at the fp32 peak, in %."""
    t, c = ctx.get("trace"), ctx.get("counts")
    if ctx.get("kind") != kind or not t or not c or t["window_s"] <= 0 or not c["ops"]:
        return None
    return 100.0 * c["ops"] / (t["window_s"] * PEAK_F32_S)

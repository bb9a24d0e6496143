"""The traced window: torch.profiler over a fixed number of steps or frames,
reduced to what the per-layer readers take.

`union_s` is the arithmetic of gsjax_torch/trace_reg.py:union_ms (commit
95f6082): the device is busy where some kernel runs, so busy time is the
length of the union of the kernels' intervals, and the idle share is one less
busy over the window. Memory copies and sets count as device work.
"""

from __future__ import annotations

import time

MAX_BREAKDOWN = 10


def union_s(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def is_launch(name: str) -> bool:
    """A kernel launch, as opposed to a memory copy or set."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def gaps(spans, top: int):
    """The `top` longest idle gaps [(start, end)] between busy intervals."""
    spans = sorted(spans)
    out, cur_e = [], None
    for s0, e0 in spans:
        if cur_e is not None and s0 > cur_e:
            out.append((cur_e, s0))
        cur_e = e0 if cur_e is None else max(cur_e, e0)
    return sorted(out, key=lambda g: g[0] - g[1])[:top]


def host_op_at(host, t):
    """The innermost host op running at time t (the shortest that spans it)."""
    best = None
    for name, s0, e0 in host:
        if s0 <= t <= e0 and (best is None or e0 - s0 < best[2] - best[1]):
            best = (name, s0, e0)
    return best[0] if best else "no host op"


def traced(run, device) -> dict:
    """Run `run()` under torch.profiler and reduce the trace: {window_s,
    busy_s, kernels: [(name, start_s, end_s)] in time order, device_ops:
    [[name, seconds]] (top by time), idle_gaps: [[host op, seconds]]
    (longest first)}. Times are in seconds on the profiler's clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    dev_ev, host = [], []
    for e in prof.events():
        s0, e0 = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            dev_ev.append((e.name, s0, e0))
        else:
            host.append((e.name, s0, e0))
    dev_ev.sort(key=lambda k: k[1])
    spans = [(s0, e0) for _, s0, e0 in dev_ev]
    by_name = {}
    for name, s0, e0 in dev_ev:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:MAX_BREAKDOWN]
    idle = [[host_op_at(host, 0.5 * (a + b)), b - a] for a, b in gaps(spans, MAX_BREAKDOWN)]
    return {"window_s": window_s, "busy_s": union_s(spans), "kernels": dev_ev,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": idle}


def kernel_times(kernels, fragment: str) -> list[float]:
    """Seconds of each traced kernel whose name holds `fragment`, in order."""
    return [e0 - s0 for name, s0, e0 in kernels if fragment in name]

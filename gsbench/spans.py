"""Device time by program span: each device event of a torch.profiler window
(kernels, copies, sets) goes to one span that the port opens
(`gsjax_torch/utils/spans.py`), by the reader's own list of their names.

1. The event's runtime call (the host event with its correlation and linked
   id: `cudaLaunchKernel`, `cudaMemcpyAsync`, ...) was made on some thread at
   some time; the innermost program span open there gets the event. That is
   the span of the aten op that launched it, and of a ctypes launch's own
   span.
2. Where the innermost range open there is an autograd node (the engine's
   thread, or the caller's on the CPU), the node's `(fwd_thread,
   sequence_nr)` names the forward op it differentiates, and the innermost
   span open at that op gets the event: preprocess's VJP counts to
   `raster.preprocess`.
3. Failing both, the span open on the main thread (the root spans' thread)
   at the call gets it (`step.backward` for the engine's own work), else
   `(none)`.

Idle gaps between device events go to the innermost span open on the main
thread at their midpoint. Nothing here imports the port: a window that
holds no span reads every event as `(none)`.
"""

from __future__ import annotations

from collections import namedtuple

from gsbench import trace as trace_lib

NONE = "(none)"
ROOTS = ("train_step", "raster.render")
NAMES = ROOTS + (
    "train.frames", "train.overflow_retry", "train.filter_refresh", "train.densify",
    "model.activate", "raster.preprocess", "raster.binning", "raster.pairs",
    "raster.blend", "raster.blend_bwd", "loss.image", "loss.depth_normal",
    "mv.patchmatch", "mv.geo", "sample.prepare", "sample.query", "sample.query_bwd",
    "mv.ncc", "ncc.sample", "step.backward", "step.update", "step.readback")

# a host event: start and end in seconds on the profiler's clock; corr and
# link the correlation ids (link > 0 on runtime calls); seq the autograd
# sequence number (-1 if none) and fwd its forward thread (0 on forward ops)
Host = namedtuple("Host", "name thread start end corr link seq fwd")
# a device event (kernel, copy or set) and the runtime call's ids
Dev = namedtuple("Dev", "name start end corr link")


def span_name(name: str) -> str | None:
    """The program span `name` stands for (`train_step 15001` is
    `train_step`), or None."""
    if name.startswith("train_step "):
        return "train_step"
    return name if name in NAMES else None


def events(prof) -> tuple[list[Host], list[Dev]]:
    """The host and device events of a closed torch.profiler window, from
    its raw results (whose device events keep their correlation ids).
    Device-side copies of user annotations are left out."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        s0, e0 = e.start_ns() / 1e9, e.end_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(Dev(e.name(), s0, e0, e.correlation_id(), e.linked_correlation_id()))
        else:
            host.append(Host(e.name(), e.start_thread_id(), s0, e0, e.correlation_id(),
                             e.linked_correlation_id(), e.sequence_nr(), e.fwd_thread_id()))
    return host, dev


def _spans(host):
    """The program spans among the host events, as sweep ranges."""
    return [(h.thread, h.start, h.end, n) for h in host if (n := span_name(h.name))]


def _sweep(ranges, queries):
    """For each query (thread, t, key): the ranges (thread, start, end, item)
    open on its thread at t, innermost first. Ranges on one thread nest."""
    by_thread = {}
    for r in ranges:
        by_thread.setdefault(r[0], []).append(r)
    out = {}
    for thread, qs in _group(queries).items():
        rs = sorted(by_thread.get(thread, ()), key=lambda r: (r[1], -r[2]))
        stack, i = [], 0
        for t, key in sorted(qs):
            while i < len(rs) and rs[i][1] <= t:
                while stack and stack[-1][2] < rs[i][1]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out[key] = [r[3] for r in reversed(stack) if r[2] >= t]
    return out


def _group(queries):
    g = {}
    for thread, t, key in queries:
        g.setdefault(thread, []).append((t, key))
    return g


def attribute(host: list[Host], dev: list[Dev]) -> list[str]:
    """The program span of each device event, in `dev`'s order (`(none)`
    where no rule finds one)."""
    spans = _spans(host)
    nodes = [(h.thread, h.start, h.end, ("node", h.fwd, h.seq)) for h in host
             if h.seq >= 0 and h.fwd > 0 and not span_name(h.name)]
    roots = [s for s in spans if s[3] in ROOTS]
    main = roots[0][0] if roots else None
    runtime = {(h.corr, h.link): h for h in host if h.link > 0}
    calls = []
    for k, d in enumerate(dev):
        r = runtime.get((d.corr, d.link))
        calls.append((r.thread, r.start) if r is not None else (main, d.start))
    open_at = _sweep(spans + nodes, [(th, t, k) for k, (th, t) in enumerate(calls)])
    # the forward ops the nodes differentiate, and the span open at each
    fwd_ops = {(h.thread, h.seq): h.start for h in host
               if h.seq >= 0 and h.fwd == 0 and not span_name(h.name)}
    fwd_span = _sweep(spans, [(th, t, (th, seq)) for (th, seq), t in fwd_ops.items()])
    main_span = _sweep(spans, [(main, t, k) for k, (_, t) in enumerate(calls)])
    out = []
    for k in range(len(dev)):
        name = None
        for item in open_at.get(k, ()):
            if isinstance(item, str):
                name = item
                break
            got = fwd_span.get((item[1], item[2]))
            if got:
                name = got[0]
                break
        if name is None:
            got = main_span.get(k)
            name = got[0] if got else NONE
        out.append(name)
    return out


def reduce(host: list[Host], dev: list[Dev]) -> dict:
    """{spans: {span: [device seconds, launches]}, device_s: all device
    events' seconds, covered: the share of them that went to a span other
    than the roots, idle: {span: seconds of the idle gaps at whose midpoint
    the main thread was in it}}."""
    names = attribute(host, dev)
    per, total, covered = {}, 0.0, 0.0
    for d, name in zip(dev, names):
        s = per.setdefault(name, [0.0, 0])
        s[0] += d.end - d.start
        s[1] += trace_lib.is_launch(d.name)
        total += d.end - d.start
        covered += (d.end - d.start) if name not in ROOTS + (NONE,) else 0.0
    spans = _spans(host)
    roots = [s for s in spans if s[3] in ROOTS]
    idle = {}
    if roots:
        lo, hi = min(s[1] for s in roots), max(s[2] for s in roots)
        gaps = _gaps([(d.start, d.end) for d in dev], lo, hi)
        at = _sweep(spans, [(roots[0][0], 0.5 * (a + b), k) for k, (a, b) in enumerate(gaps)])
        for k, (a, b) in enumerate(gaps):
            name = at[k][0] if at.get(k) else NONE
            idle[name] = idle.get(name, 0.0) + (b - a)
    return {"spans": per, "device_s": total, "covered": covered / total if total else None,
            "idle": idle}


def _gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Every idle gap between the device events' intervals inside [lo, hi]."""
    out, cur = [], lo
    for s0, e0 in sorted(intervals):
        if s0 >= hi:
            break
        if s0 > cur:
            out.append((cur, s0))
        cur = max(cur, e0)
    if cur < hi:
        out.append((cur, hi))
    return out

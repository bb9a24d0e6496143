"""A profiler trace of the full regularised train step, with its top device
ops and the device's idle share (port of gsjax's `scripts/trace_reg.py`).

    python -m gsjax_torch.trace_reg [--iters 2] [--top 40] [--dir DIR]
        [--out JSON] [--device cpu]

The step is bench_reg's (`bench_reg.reg_workload`, gsjax's trace_reg
workload: `init_from_pcd` of 100k points, SH degree 3, `train_step` with the
median depth, the depth-normal and the multi-view terms against the
neighbour pose, the same gray frame for both views, Adam). After two
untimed steps `torch.profiler` records `--iters` steps; gsjax parsed its
TPU's xplane through TensorFlow, the port reads the profiler's events and
needs no TensorFlow. It prints gsjax's `== <device>: X ms total` line and
the `--top` rows of device time per step by kernel name; then the window's
idle share: 1 - (the union of the kernels' device intervals) / (the
window's span on the host clock, the steps' first launch to their last
sync). Kernel intervals do not overlap on one stream, so the total is
serialised device time. On the CPU the table lists CPU ops by their own
time, and no idle share is measured. `--dir` keeps the trace
(`DIR/trace.json`); `--out` writes the table as JSON.

The device is the card unless `--device cpu`; with no card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from gsjax_torch.utils import benchsync


def union_ms(spans) -> float:
    """The length of the union of (start, end) intervals in microseconds,
    in ms."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    return (busy + cur_e - cur_s) / 1e3


def trace_steps(step, iters: int, device, top: int = 40, trace_dir: str = "") -> dict:
    """torch.profiler over `iters` calls of `step` (module docstring) ->
    {device, total_ms, window_ms, busy_ms, idle_share, kernels, top: [{name,
    ms_per_step, calls}], names: every kernel's (op's) name}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    benchsync.sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        benchsync.sync(device)
        window_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    by_name, calls = {}, {}
    if cuda:
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
        busy = union_ms((e.time_range.start, e.time_range.end) for e in kernels)
        name = torch.cuda.get_device_name(device)
    else:
        for e in prof.key_averages():
            by_name[e.key] = e.self_cpu_time_total / 1e3
            calls[e.key] = e.count
        kernels, busy, name = [], None, "cpu"
    total = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"== {name}: {total:.0f} ms total ({iters} iters; "
          f"{'device kernels' if cuda else 'CPU ops, self time'})", flush=True)
    for k, ms in rows:
        print(f"  {ms / iters:8.2f}  {k[:100]}", flush=True)
    idle = None if busy is None else max(0.0, 1.0 - busy / window_ms)
    if cuda:
        print(f"window {window_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
              f"{idle:.3f}", flush=True)
    return {"device": name, "iters": iters, "total_ms": total, "window_ms": window_ms,
            "busy_ms": busy, "idle_share": idle,
            "idle_note": None if cuda else "not measured: no device on the CPU",
            "kernels": len(kernels) if cuda else None,
            "top": [{"name": k, "ms_per_step": ms / iters, "calls": calls[k]}
                    for k, ms in rows],
            "names": sorted(by_name)}


def trace(width: int, height: int, n: int, iters: int, top: int, device,
          trace_dir: str = "") -> dict:
    from gsjax_torch.bench_reg import reg_workload

    params, aux, adam, step = reg_workload(width, height, n, device)
    state = [params, aux, adam]

    def one():
        state[:] = step(*state)[:3]

    one()
    one()
    return trace_steps(one, iters, device, top, trace_dir)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--dir", default="", help="keep the trace here (DIR/trace.json)")
    ap.add_argument("--out", default="", help="write the table as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "trace_reg")
    rec = trace(1920, 1080, 100_000, args.iters, args.top, dev, args.dir)
    rec["nvidia_smi"] = benchsync.smi_line() if dev.type == "cuda" else None
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()

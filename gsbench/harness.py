"""The benchmark's harness, driven by `BENCHMARK.json` and the files it names.

A cell (`workloads` entry) names a configuration (its `file`) and a traffic
mix (`traffic/<traffic>.json`, a data file whose `kind` names its driver, the
module `traffic/<kind>.py`), and has its limits in `limits/<cell>.json`; each
per-layer metric is read by `metrics/<name>.py`, a module with
`read(ctx) -> float | None`, and lists the cells that report it. A cell, a
configuration, a traffic mix, a kind of traffic or a metric is added as new
files and entries; nothing here names one.

A kind module (`traffic/__init__.py` lists what it has) returns a
`drivers.Run`. A kind that runs its cell on several ranks (processes it
spawns, one a card or several sharing one) gathers them into that one
record:
- `memory_peak_bytes` is the fullest device's peak, the largest rank's;
- `rank_modules` lists the JAX and JAX-package modules that any rank loaded,
  each rank calling `forbidden_modules()` itself once its window has
  closed; `run.py` refuses the result when that list, or its own process's,
  is not empty (one-process kinds leave it empty);
- the trace and counts handed to the per-layer readers are one rank's: the
  rank with the most busy device time, the one the step waits for, whose
  `busy_s` and `window_s` the result line carries;
- a planted fault reaches the ranks through `control.replant()`, which each
  rank enters first.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gsjax")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {"workload": w,
            "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
            "limits": load_json(os.path.join(HERE, "limits", name + ".json"))}


def end_to_end(bench: dict, name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def per_layer(bench: dict, name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those whose `workloads`
    list it (every per-layer entry has the list)."""
    return [m for m in bench["per_layer"] if name in m["workloads"]]


def driver(kind: str):
    """The traffic driver `traffic/<kind>.py`."""
    return importlib.import_module(f"gsbench.traffic.{kind}")


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("gsbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`gsjax_torch` is not `gsjax`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def smi() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def result_line(run, entry: dict, bench: dict, trace: bool,
                device_name: str) -> tuple[dict, list[str]]:
    """The last line's object and the stderr lines of the numbers compared."""
    from gsbench import check

    name = entry["workload"]["name"]
    ok, lines = check.judge(run.numbers, entry["limits"])
    ok = ok and run.failed == 0 and run.attempted > 0
    metrics = {}
    if not trace:
        for m in end_to_end(bench, name):
            v = run.values.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = {"trace": run.trace, "counts": run.counts, "kind": entry["traffic"]["kind"]}
        for m in per_layer(bench, name):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if device_name != "cpu" else "cpu", "kind": device_name,
              "count": entry["workload"]["chips"], "memory_peak_bytes": run.memory_peak_bytes,
              "power": smi() if device_name != "cpu" else None}
    out = {"correct": bool(ok), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device, "notes": run.notes}
    if trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    lines["failed_units"] = [run.failed, 0]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in lines.items()}
    return out, [f"check {k}: {v} (limit {lim})" for k, (v, lim) in lines.items()]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             scale: float = 1.0) -> tuple[dict, list[str], list[str]]:
    """Run one cell on `device` and return its result line, its stderr lines
    and the forbidden modules its ranks loaded (`Run.rank_modules`; no look
    for a card here: `run.py` makes it)."""
    import torch

    bench = benchmark()
    entry = cell(bench, name)
    run = driver(entry["traffic"]["kind"]).run(entry["config"], entry["traffic"], seed,
                                                seconds, trace, device, t_start, scale)
    dev = torch.device(device)
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out, err = result_line(run, entry, bench, trace, dev_name)
    return out, err, sorted(run.rank_modules)

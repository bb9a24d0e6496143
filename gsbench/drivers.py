"""What the traffic drivers under `traffic/` share: a run's record, the
device's housekeeping, the kernel build apart from the rest of set-up, the
configuration's options, and each captured launch's bytes and operations.

A driver (`traffic/<kind>.py`) returns a `Run`: set-up seconds, the
end-to-end values, what was attempted and failed, the device's peak memory,
the compared numbers, notes, and, with `trace`, the reduced trace and the
counts the per-layer readers take; a driver that spawns ranks also the
forbidden modules they loaded (`harness.py` states how ranks are gathered).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time

import torch

from gsbench.counts import blend as blend_counts
from gsbench.counts import sample as sample_counts

# configuration keys that describe the scene, its sizes or its source and
# set no option of the program (the generator's keys are `scenes.py`'s)
DESCRIPTIVE = frozenset({"name", "source", "source_sizes", "resolution", "gaussians",
                         "train_views", "precision", "cameras", "generator", "assumed",
                         "reduced", "measured"})


@dataclasses.dataclass
class Run:
    setup_s: float
    values: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: dict
    notes: dict
    trace: dict | None = None
    counts: dict | None = None
    # the JAX and JAX-package modules any spawned rank loaded (harness.py)
    rank_modules: list = dataclasses.field(default_factory=list)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def build_kernels(dev, names) -> dict:
    """Build the port's kernels `names` where `build/gsjax_torch/` lacks
    them (all at once) and return the build's record: its seconds and the
    sources built. The first run in a checkout builds; later runs find every
    library there and read about 0 s. It is part of set-up."""
    if dev.type != "cuda":
        return {"build_s": 0.0, "built": []}
    from gsjax_torch import _build

    t0 = time.perf_counter()
    built = sorted(_build.build_all(names))
    return {"build_s": time.perf_counter() - t0, "built": built}


def options(cfg: dict, applied: dict) -> None:
    """Refuse a configuration with a key that is neither descriptive nor
    applied by the driver, or with a value of an applied key that the
    reference cannot follow. `applied` maps each key the driver applies to
    None (any value) or the tuple of values the reference follows."""
    for key, value in cfg.items():
        if key in DESCRIPTIVE:
            continue
        if key not in applied:
            raise ValueError(f"configuration {cfg.get('name')!r}: key {key!r} is no option "
                             f"this driver applies; one of {sorted(applied)}")
        allowed = applied[key]
        if allowed is not None and value not in allowed:
            raise ValueError(f"configuration {cfg.get('name')!r}: {key}={value!r}; the "
                             f"reference follows only {allowed}")
    if cfg.get("precision", "float32") != "float32":
        raise ValueError(f"configuration {cfg.get('name')!r}: precision "
                         f"{cfg['precision']!r}; the program and the reference run float32")


def environment(cfg: dict) -> None:
    """Set the program's environment switches the configuration states
    (its `environment` map) in this process, before the program runs."""
    for key, value in cfg.get("environment", {}).items():
        os.environ[str(key)] = str(value)


def kept_bytes(records) -> int:
    """The bytes of the distinct tensors the captured `records` keep alive."""
    kept = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            kept[st.data_ptr()] = st.nbytes()
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    for rec in records:
        walk(rec[1:])
    return sum(kept.values())


def reserve(nbytes: int, dev) -> int:
    """Leave the caching allocator a free segment of `nbytes` and return its
    size. A traced window that keeps less splits its blocks from it instead
    of calling cudaMalloc; warm-up alone cannot promise that, since a view
    with more pairs asks for a block larger than any the warm-up freed."""
    if dev.type != "cuda" or nbytes <= 0:
        return 0
    torch.empty(int(nbytes), dtype=torch.uint8, device=dev)   # freed at once; its segment stays
    return int(nbytes)


def step_counts(records) -> list[dict]:
    """(name, bytes, ops) of each captured launch, in launch order."""
    out = []
    applied = {}
    for name, args, kw, res in records:
        if name == "blend_fwd":
            feats, ts, tc, width, height, fx, fy, bg, cfg = args[:9]
            a = blend_counts.applied_pairs(feats, ts, tc, res[8], cfg, width, height)
            applied[id(res)] = a
            b, o = blend_counts.fwd_needs(res, feats, ts, tc, cfg, width, height, a)
        elif name == "blend_bwd":
            feats, ts, tc, planes, g, width, height, fx, fy, bg, cfg = args[:11]
            b, o = blend_counts.bwd_needs(planes, feats, ts, tc, cfg, width, height,
                                          applied.get(id(planes)))
        elif name == "sample_fwd":
            feats, ts, tc, pts, blocks, cfg = args[:6]
            inter = sample_counts.point_interactions(feats, ts, tc, pts, blocks, res, cfg)
            applied[id(res)] = inter
            b, o = sample_counts.fwd_needs(feats, ts, tc, pts, blocks, res, cfg, inter)
        elif name == "sample_bwd":
            feats, ts, tc, pts, blocks, rows, g, cfg = args[:8]
            b, o = sample_counts.bwd_needs(feats, ts, tc, pts, blocks, rows, g, cfg,
                                           applied.get(id(rows)))
        elif name == "warp_sample":
            img, u = args[0], args[1]
            b, o = sample_counts.warp_needs(tuple(img.shape), u.numel())
        else:
            continue
        out.append({"name": name, "bytes": b, "ops": o})
    return out

"""Scaling benchmark: the sharded train step (or batch serving) over 1, 2,
4, ... ranks (port of gsjax's `bench_scaling.py`).

    python3 bench_scaling_torch.py                          # every card
    GSJAX_SCALING_DEVICES=2 python3 bench_scaling_torch.py  # 2 ranks
    GSJAX_SCALING_MODE=views python3 bench_scaling_torch.py
    GSJAX_SCALING_PLATFORM=cpu GSJAX_SCALING_DEVICES=2 GSJAX_BENCH_WIDTH=96 \\
        GSJAX_BENCH_HEIGHT=64 GSJAX_BENCH_N=300 GSJAX_BENCH_ITERS=1 \\
        python3 bench_scaling_torch.py

bench_scaling.py's workload through gsjax_torch: its seeded draws
(`scaling_inputs`, `bench_scaling.py:39-55`) and a model from
`init_from_pcd` with the KNN scales of `ops/knn.mean_knn_dist2`, bench.py's
camera, `RasterConfig(max_per_tile=1 << 11, sh_degree=3,
require_depth=True)`. For each rank count n, `parallel/launch.py` starts n
ranks (one process each, as the port runs across devices; n = 1 too,
because `train_step_sharded` needs a process group). Modes
(GSJAX_SCALING_MODE):
  - `train`: `train_step_sharded` with `LossConfig(reg_on=True)` on equal
    tile-row bands;
  - `train_balanced`: one equal-band step gives `row_pairs`, and the timed
    steps run on `balance_band_bounds(row_pairs, n, rpm)` with gsjax's rpm
    (`:130-141`);
  - `views`: `render_views_sharded` of n views per round, the camera turned
    by 0.02 i about y (`:115-124`).
gsjax's step is functional and times the same step from one state; the
port's updates the model in place, so each step first copies the initial
parameters and Adam moments back (~75 MB at 100k gaussians, a few
hundredths of a millisecond on the card). Each rank runs a warm-up, a
settle call and GSJAX_BENCH_ITERS (default 5) calls between two CUDA events
(the host clock on the CPU); a round's time is the largest over the ranks.

Rank counts: powers of two up to GSJAX_SCALING_DEVICES, or the list in
GSJAX_SCALING_MESHES (those up to the same largest). Unset, the largest is
`torch.cuda.device_count()` (1 on the CPU), as gsjax's is
`len(jax.devices())`. gsjax's virtual mesh on a CPU comes from XLA's forced
host device count; the port's counterpart is GSJAX_SCALING_DEVICES above the
card count: ranks beyond the cards share them over `gloo`, as in the
training CLI. Where ranks share a card or run on the CPU the timings
measure contention, not scaling, so the efficiency T(1) / (n T(n)) (on
frames for `views`) is null, as gsjax's is on a virtual mesh (`:181-196`),
and the line is {"metric": "{mode}_scaling_correctness_{n}dev", "value":
1.0}; otherwise {"metric": "{mode}_scaling_efficiency_{n}dev", "value":
eff, "vs_baseline": eff / 0.80}. The table goes to SCALING_torch.json
(`train`) or SCALING_torch_views.json (other modes, as gsjax names its own)
beside the root script, or in GSJAX_SCALING_DIR. The port has no pair
capacity: GSJAX_BENCH_PAIRS is accepted and the rows'
`dev_pair_capacity` is null.

stderr: gsjax's `n=...` line per rank count and the diagnostics line
(kernel launches summed over every rank of every round, nvidia-smi, the
rows). The device, the watchdog (cancelled once the first round is back;
each round has its own timeout, GSJAX_BENCH_TIMEOUT) and the error paths are
`utils/benchsync.py`'s, with GSJAX_SCALING_PLATFORM (`cpu`) for the device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from gsjax_torch.utils import benchsync

TARGET_EFFICIENCY = 0.80
MODES = ("train", "train_balanced", "views")
LRS = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
           scaling=0.005, rotation=0.001, sg_axis=0.0, sg_sharpness=0.0, sg_color=0.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scaling_inputs(width: int, height: int, n: int, seed: int = 0):
    """bench_scaling.py's numpy draws in its order (`:39-55`): means [n, 3],
    colours [n, 3], then the target [H, W, 3]."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    return means, colors, gt


def rank_counts(cards: int) -> list[int]:
    """The rank counts of a run on a host with `cards` cards (0 on the CPU)."""
    n_max = int(os.environ.get("GSJAX_SCALING_DEVICES", 0)) or max(cards, 1)
    if os.environ.get("GSJAX_SCALING_MESHES"):
        return [d for d in (int(x) for x in os.environ["GSJAX_SCALING_MESHES"].split(","))
                if 1 <= d <= n_max]
    return [1 << i for i in range(n_max.bit_length())]


def _camera(angle, width, height, device):
    from gsjax_torch.ops.raster import Camera

    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return Camera.create(r, np.zeros(3, np.float32), 1.0, 0.66, width, height, device=device)


def rank_round(rank, mode, width, height, n, iters, device_type):
    """One round on one rank of a group (`launch`): the warm-up, settle and
    timed calls of `mode` on the rank's card or the CPU; returns the rank's
    seconds per call, its warm-up seconds, kernel launches, backend and
    bands."""
    import torch.distributed as dist

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.knn import mean_knn_dist2
    from gsjax_torch.ops.raster import RasterConfig
    from gsjax_torch.parallel import shard
    from gsjax_torch.train.step import LossConfig

    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    nd = dist.get_world_size()
    benchsync.reset_launches()
    means, colors, gt = scaling_inputs(width, height, n)
    params, aux = gm.init_from_pcd(means, colors, n, 3, 0, mean_knn_dist2(means),
                                   device=dev)
    adam = gm.adam_init(params)
    cam = _camera(0.0, width, height, dev)
    cfg = RasterConfig(max_per_tile=1 << 11, sh_degree=3, require_depth=True)
    gt = torch.as_tensor(gt, device=dev)
    bg = torch.zeros(3, device=dev)
    lc = LossConfig(reg_on=True)
    band_kw = {}

    if mode == "views":
        cams = [_camera(0.02 * i, width, height, dev) for i in range(nd)]

        def step():
            shard.render_views_sharded(params, aux, cams, cfg, bg)
    else:
        fields = gm.PARAM_FIELDS
        start = ({k: getattr(params, k).detach().clone() for k in fields},
                 {k: adam.mu[k].clone() for k in fields}, {k: adam.nu[k].clone() for k in fields})

        def step():
            with torch.no_grad():
                for k in fields:
                    getattr(params, k).copy_(start[0][k])
                    adam.mu[k].copy_(start[1][k])
                    adam.nu[k].copy_(start[2][k])
            adam.count = 0
            m = shard.train_step_sharded(params, aux, adam, cam, gt, bg, LRS, cfg, lc,
                                         **band_kw)[3]
            if m["overflowed"]:
                raise RuntimeError(f"a tile list of {m['max_tile_count']} gaussians "
                                   f"exceeds max_per_tile {cfg.max_per_tile}")
            return m

        if mode == "train_balanced" and nd > 1:
            hist = np.asarray(step()["row_pairs"])
            tiles_y = len(hist)
            rpm = min(tiles_y, -(-tiles_y // nd) * 2)
            band_kw["row_bounds"] = shard.balance_band_bounds(hist, nd, rpm)

    t0 = time.perf_counter()
    step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    step()
    dt = benchsync.time_window(step, iters, dev) / iters
    return {"iter_s": dt, "warm_s": warm, "launches": benchsync.launch_counts(),
            "backend": dist.get_backend(), "device": str(dev),
            "row_bounds": [int(b) for b in band_kw.get("row_bounds", ())]}


def _bench(dog, mode, counts):
    from gsjax_torch.parallel.launch import launch

    dev = benchsync.bench_device("GSJAX_SCALING_PLATFORM")
    width = int(os.environ.get("GSJAX_BENCH_WIDTH", 1920))
    height = int(os.environ.get("GSJAX_BENCH_HEIGHT", 1080))
    n = int(os.environ.get("GSJAX_BENCH_N", 100_000))
    iters = int(os.environ.get("GSJAX_BENCH_ITERS", 5))
    timeout = float(os.environ.get("GSJAX_BENCH_TIMEOUT", benchsync.DEFAULT_TIMEOUT_S))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if not counts:
        raise ValueError("no rank count to run (GSJAX_SCALING_DEVICES / _MESHES)")

    rows, launches = [], {}
    for nd in counts:
        res = launch(rank_round, nd, args=(mode, width, height, n, iters, dev.type),
                     device=dev.type, timeout=timeout,
                     threads=None if dev.type == "cuda" else 1)
        dog.cancel()
        per_round = nd if mode == "views" else 1
        dt = max(r["iter_s"] for r in res)
        rays = width * height * per_round / dt
        rows.append({"devices": nd, "iter_s": round(dt, 4), "rays_per_s": round(rays, 1),
                     "frames_per_round": per_round, "dev_pair_capacity": None,
                     "shared_card": dev.type != "cuda" or nd > cards,
                     "backend": res[0]["backend"], "rank_iter_s": [r["iter_s"] for r in res],
                     "row_bounds": res[0]["row_bounds"]})
        for r in res:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        print(f"n={nd}: {dt * 1e3:.1f} ms/round ({per_round} frame(s)), "
              f"{rays / 1e6:.2f} Mrays/s (warmup {max(r['warm_s'] for r in res):.0f}s)",
              file=sys.stderr)

    virtual = any(r["shared_card"] for r in rows)
    r1 = rows[0]["rays_per_s"]
    for r in rows:
        r["efficiency"] = (None if virtual else
                           round(r["rays_per_s"] / (r["devices"] * r1), 4))
    smi = benchsync.smi_line() if dev.type == "cuda" else None
    table = {"platform": dev.type, "cards": cards, "virtual_devices": virtual, "mode": mode,
             "width": width, "height": height, "n_gaussians": n, "nvidia_smi": smi,
             "rows": rows}
    if virtual:
        table["note"] = ("correctness-only: ranks share a card or run on the CPU, so a "
                         "timing ratio measures contention and the efficiency is null")
    out_name = "SCALING_torch.json" if mode == "train" else "SCALING_torch_views.json"
    out_dir = os.environ.get("GSJAX_SCALING_DIR") or ROOT
    with open(os.path.join(out_dir, out_name), "w") as f:
        json.dump(table, f, indent=1)
    benchsync.diagnostics(dev, launches, mode=mode, rows=rows)
    last = rows[-1]
    if virtual:
        line = {"metric": f"{mode}_scaling_correctness_{last['devices']}dev", "value": 1.0,
                "unit": "sharded step ran at every rank count (ranks share a card or run "
                        "on the CPU: efficiency N/A)", "vs_baseline": 1.0}
    else:
        line = {"metric": f"{mode}_scaling_efficiency_{last['devices']}dev",
                "value": last["efficiency"], "unit": "rays_per_s(n)/(n*rays_per_s(1))",
                "vs_baseline": round(last["efficiency"] / TARGET_EFFICIENCY, 4)}
    print(json.dumps(line), flush=True)


def main() -> int:
    mode = os.environ.get("GSJAX_SCALING_MODE", "train")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    counts = rank_counts(cards)
    metric = f"{mode}_scaling_efficiency_{counts[-1] if counts else 0}dev"
    if mode not in MODES:
        print(benchsync.error_line(metric, "rays_per_s(n)/(n*rays_per_s(1))",
                                   f"unknown GSJAX_SCALING_MODE {mode!r}; one of {MODES}"))
        return 1
    return benchsync.run(lambda dog: _bench(dog, mode, counts), metric,
                         "rays_per_s(n)/(n*rays_per_s(1))")


if __name__ == "__main__":
    sys.exit(main())

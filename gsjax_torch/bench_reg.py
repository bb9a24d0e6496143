"""Regularisation-phase train-step benchmark at 1080p (port of gsjax's
`bench_reg.py`).

    python3 bench_reg_torch.py                          # on the card
    GSJAX_NCC_COMPACT=1 python3 bench_reg_torch.py      # block-compacted NCC
    GSJAX_PLATFORM=cpu GSJAX_BENCH_WIDTH=96 GSJAX_BENCH_HEIGHT=64 \\
        GSJAX_BENCH_N=300 GSJAX_BENCH_ITERS=1 python3 bench_reg_torch.py

bench_reg.py's workload through gsjax_torch: its seeded draws and poses
(`bench_reg_inputs`), the model `init_from_pcd(..., sh_degree=3,
sg_degree=0, knn_dist2=1e-4)` (scale 0.01, opacity 0.1), bench.py's
RasterConfig, and the whole `train_step` with `LossConfig(reg_on=True,
mv_on=True)` against the neighbour pose, bench_reg's learning rates and
`gray_r = gray_n = gray` (`reg_workload`): median depth, depth-normal, the
PGSR multi-view terms (B3 / B5 point queries, the NCC on B6), Adam and the
densification statistics.

gsjax settles two static capacities after its first step and recompiles
(`bench_reg.py:85-150`). The port compacts the point queries to their real
count and has none, so GSJAX_MV_COMPACT is accepted and changes nothing,
except that GSJAX_MV_COMPACT=0 also turns GSJAX_NCC_COMPACT off, as gsjax's
`blk_compact` (`:91-92`). GSJAX_NCC_COMPACT=1 runs the block-compacted NCC
(`LossConfig.ncc_compact`: B6 launched as `warp_sample_blocks`). The timed
steps start from gsjax's model state: the port runs as many untimed steps
as gsjax does, counted by gsjax's rule from the first step's `mv_queries`
and `mv_blocks` (`gsjax_untimed_steps`): the warm-up, a re-warm-up where
gsjax would move a capacity, and one settle step. Then GSJAX_BENCH_ITERS
(default 8) steps between two CUDA events. Each step ends in a host read of
its loss metrics (`train/step.py`), so it is host-synchronous.

stderr: gsjax's `warmup ... loss= ncc= geo= mv_queries=` line (and
`mv_blocks=` under compaction), the `re-warmup` line where it runs, the
`timed` line and the diagnostics line (kernel launches, nvidia-smi, the
first step's metrics at full precision, the untimed steps). stdout ends in
gsjax's line {"metric": "reg_train_step_ms_1080p", "value", "unit":
"ms/iter", "vs_baseline": 33.33 / value} (`bench_reg.py:159-164`), or its
error form. The device, the watchdog and the error paths are
`utils/benchsync.py`'s, which also says why gsjax's device probe is not
ported.

Env: GSJAX_BENCH_{WIDTH,HEIGHT,N,ITERS,TIMEOUT}, GSJAX_PLATFORM (`cpu`),
GSJAX_NCC_COMPACT, GSJAX_MV_COMPACT.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from gsjax_torch.train.loop import next_pow2
from gsjax_torch.utils import benchsync

BASELINE_ITER_MS = 1000.0 / 30.0   # reference-class ~30 train iters/s
METRIC = "reg_train_step_ms_1080p"
UNIT = "ms/iter"
LRS = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
           scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
           sg_color=0.00064)
MV_CAP_FLOOR = 1 << 14             # gsjax/train/loop.py:MV_CAP_FLOOR


def bench_reg_inputs(width: int, height: int, n: int, seed: int = 0):
    """bench_reg.py's numpy draws in its order: points [n, 3] and colours
    [n, 3] (`bench_reg.py:58-61`), then, after the model's init (which draws
    from its own stream), the target [H, W, 3] and the gray frame [H, W]
    (`:96-97`); and the two poses (R, T) of `:67-76`, the view and its
    neighbour."""
    rng = np.random.default_rng(seed)
    points = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    points[:, 2] += 5.0
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    gray = rng.uniform(0, 1, (height, width)).astype(np.float32)
    th = 0.05
    r2 = np.eye(3, dtype=np.float32)
    r2[0, 0] = r2[2, 2] = np.cos(th)
    r2[0, 2] = np.sin(th)
    r2[2, 0] = -np.sin(th)
    poses = ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
             (r2, np.asarray([0.15, 0.0, 0.0], np.float32)))
    return points, colors, gt, gray, poses


def reg_workload(width: int, height: int, n: int, device, ncc_compact: bool = False,
                 backend: str = "auto"):
    """bench_reg.py's model, views and step on `device`: (params, aux, adam,
    step), where `step(params, aux, adam)` runs one `train_step` and returns
    its (params, aux, adam, metrics). `backend` is the RasterConfig's
    ("torch": every kernel's plain version, also on the card)."""
    import dataclasses

    from gsjax_torch.bench import bench_config
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera
    from gsjax_torch.train.step import LossConfig, train_step

    points, colors, gt, gray, poses = bench_reg_inputs(width, height, n)
    params, aux = gm.init_from_pcd(points, colors, n, sh_degree=3, sg_degree=0,
                                   knn_dist2=np.full((n,), 1e-4, np.float32),
                                   device=device)
    adam = gm.adam_init(params)
    cam, near = (Camera.create(r, t, 1.0, 0.66, width, height, device=device)
                 for r, t in poses)
    cfg = dataclasses.replace(bench_config(), backend=backend)
    lc = LossConfig(reg_on=True, mv_on=True, ncc_compact=ncc_compact)
    gt = torch.as_tensor(gt, device=device)
    gray = torch.as_tensor(gray, device=device)
    bg = torch.zeros(3, device=device)

    def step(p, a, ad):
        out = train_step(p, a, ad, cam, gt, bg, LRS, cfg, lc, near_cam=near,
                         gray_r=gray, gray_n=gray)
        if out[3]["overflowed"]:
            raise RuntimeError(f"a tile list of {out[3]['max_tile_count']} gaussians "
                               f"exceeds max_per_tile {cfg.max_per_tile}")
        return out

    return params, aux, adam, step


def mv_shrink_target(watermark_max: int, capacity: int, floor: int = MV_CAP_FLOOR):
    """gsjax/train/loop.py:mv_shrink_target: the shrunk bucket, or None."""
    tgt = max(next_pow2(int(watermark_max * 1.3) + 1), floor)
    return tgt if tgt <= capacity // 2 else None


def gsjax_untimed_steps(width: int, height: int, mv_queries: int, mv_blocks: int,
                        compact: bool, blk_compact: bool) -> int:
    """The steps gsjax's bench_reg.py runs before its timed window, from its
    first step's watermarks: the warm-up, a re-warm-up when a capacity moves
    (the query bucket of half the frame grows past 90% full or shrinks by
    `mv_shrink_target`, and so does the block bucket under compaction,
    `:107-150`), and one settle step (`:151`)."""
    moved = False
    if compact:
        cap = next_pow2((width * height) // 2)
        moved = mv_queries > 0.9 * cap or mv_shrink_target(mv_queries, cap) is not None
    if blk_compact:
        nb_total = (-(-height // 16)) * (-(-width // 16))
        blk_cap = next_pow2(nb_total // 2)
        moved = moved or mv_blocks > 0.9 * blk_cap or \
            mv_shrink_target(mv_blocks, blk_cap, floor=256) is not None
    return 3 if moved else 2


def _flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) not in ("0", "")


def _bench(dog):
    dev = benchsync.bench_device("GSJAX_PLATFORM")
    width = int(os.environ.get("GSJAX_BENCH_WIDTH", 1920))
    height = int(os.environ.get("GSJAX_BENCH_HEIGHT", 1080))
    n = int(os.environ.get("GSJAX_BENCH_N", 100_000))
    iters = int(os.environ.get("GSJAX_BENCH_ITERS", 8))
    compact = _flag("GSJAX_MV_COMPACT", "1")
    blk_compact = compact and _flag("GSJAX_NCC_COMPACT", "0")

    params, aux, adam, step = reg_workload(width, height, n, dev, ncc_compact=blk_compact)
    benchsync.reset_launches()
    t0 = time.perf_counter()
    params, aux, adam, m = step(params, aux, adam)
    first = {k: m[k] for k in ("loss", "ncc_loss", "geo_loss", "dn_loss", "mv_queries",
                               "mv_blocks", "mv_max_tile_count", "max_tile_count",
                               "num_live_pairs")}
    print(f"warmup {time.perf_counter() - t0:.1f}s loss={m['loss']:.4f} "
          f"ncc={m['ncc_loss']:.4f} geo={m['geo_loss']:.5f} "
          f"mv_queries={m['mv_queries']}", file=sys.stderr)
    if blk_compact:
        print(f"mv_blocks={m['mv_blocks']}", file=sys.stderr)
    untimed = gsjax_untimed_steps(width, height, m["mv_queries"], m["mv_blocks"],
                                  compact, blk_compact)
    if untimed == 3:
        t0 = time.perf_counter()
        params, aux, adam, m = step(params, aux, adam)
        print(f"re-warmup {time.perf_counter() - t0:.1f}s loss={m['loss']:.4f} "
              f"(gsjax's capacity settle; the port has no capacity)", file=sys.stderr)
    params, aux, adam, m = step(params, aux, adam)         # settle
    dog.cancel()

    state = [params, aux, adam]

    def one():
        state[:] = step(*state)[:3]

    dt = benchsync.time_window(one, iters, dev) / iters
    print(f"timed {iters} iters: {dt * 1e3:.1f} ms/iter", file=sys.stderr)
    benchsync.diagnostics(dev, benchsync.launch_counts(), first_step=first,
                          untimed_steps=untimed, ncc_compact=blk_compact, iters=iters,
                          ms_per_iter=dt * 1e3)
    print(json.dumps({"metric": METRIC, "value": round(dt * 1e3, 2), "unit": UNIT,
                      "vs_baseline": round(BASELINE_ITER_MS / (dt * 1e3), 4)}), flush=True)


def main() -> int:
    return benchsync.run(_bench, METRIC, UNIT)


if __name__ == "__main__":
    sys.exit(main())

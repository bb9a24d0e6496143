"""Headline benchmark: the rasterizer's forward + backward rays/s at 1080p
(port of gsjax's `bench.py`).

    python3 bench_torch.py                      # on the card
    GSJAX_PLATFORM=cpu GSJAX_BENCH_WIDTH=96 GSJAX_BENCH_HEIGHT=64 \\
        GSJAX_BENCH_N=300 GSJAX_BENCH_ITERS=1 python3 bench_torch.py

bench.py's workload through gsjax_torch: its seeded draws (`bench_inputs`),
its camera and its `RasterConfig(max_per_tile=1 << 11, sh_degree=3,
require_depth=True)` (the pair capacities are accepted and bound nothing:
the port sizes its pair buffers from the real counts), and the loss 0.8 L1 +
0.2 (1 - SSIM) + 1e-6 mean(median depth) with its gradients in the five
gaussian inputs (`bench.py:81-87`): B1 forward and B2 backward on the card.
One warm-up iteration, then GSJAX_BENCH_ITERS (default 10) back-to-back
iterations between two CUDA events. Each iteration reads its pair counts to
the host (binning allocates from them), so it is host-synchronous, as a
train step is.

stderr: gsjax's `warmup {s}s loss=` and `timed` lines, then the diagnostics
line (kernel launches, nvidia-smi, the warm-up loss at full precision, the
largest tile list). stdout ends in gsjax's line
{"metric": "raster_fwd_bwd_rays_per_s_1080p", "value", "unit": "rays/s/chip",
"vs_baseline"} against the same 30 Mrays/s (`bench.py:21`), or in its error
form. The device, the watchdog and the error paths are
`utils/benchsync.py`'s, which also says why gsjax's supervisor, device probe
and XLA-cache wipe are not ported.

Env: GSJAX_BENCH_{WIDTH,HEIGHT,N,ITERS,TIMEOUT}, GSJAX_PLATFORM (`cpu`).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from gsjax_torch.utils import benchsync

BASELINE_RAYS_PER_S = 30e6
METRIC = "raster_fwd_bwd_rays_per_s_1080p"
UNIT = "rays/s/chip"


def bench_inputs(width: int, height: int, n: int, seed: int = 0):
    """bench.py's numpy draws in its order (`bench.py:59-73`): means, scales,
    quats, opacity [n, 1], SH [n, 16, 3], then the target image [H, W, 3]."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = np.exp(rng.normal(-3.3, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = (1 / (1 + np.exp(-rng.normal(0.0, 1.0, (n, 1))))).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    return means, scales, quats, opac, shs, gt


def bench_config():
    """bench.py's RasterConfig (`bench.py:70-72`)."""
    from gsjax_torch.ops.raster import RasterConfig

    return RasterConfig(pair_capacity=1 << 21, live_capacity=1 << 20, max_per_tile=1 << 11,
                        sh_degree=3, require_depth=True)


def bench_loss(out: dict, gt: torch.Tensor) -> torch.Tensor:
    """bench.py's loss on a `render` output (`bench.py:82-86`)."""
    from gsjax_torch.train import losses

    return (0.8 * losses.l1_loss(out["render"], gt)
            + 0.2 * (1 - losses.ssim(out["render"], gt))
            + 1e-6 * torch.mean(out["median_depth"]))


def loss_and_grads(leaves, gt, cam, cfg, bg):
    """bench.py's `fwd_bwd`: (loss, gradients in the five leaves, render output)."""
    from gsjax_torch.ops.raster import render

    out = render(*leaves, cam, cfg, bg)
    loss = bench_loss(out, gt)
    return loss, torch.autograd.grad(loss, leaves), out


def _bench(dog):
    from gsjax_torch.ops.raster import Camera

    dev = benchsync.bench_device("GSJAX_PLATFORM")
    width = int(os.environ.get("GSJAX_BENCH_WIDTH", 1920))
    height = int(os.environ.get("GSJAX_BENCH_HEIGHT", 1080))
    n = int(os.environ.get("GSJAX_BENCH_N", 100_000))
    iters = int(os.environ.get("GSJAX_BENCH_ITERS", 10))

    *gauss, gt = bench_inputs(width, height, n)
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        width, height, device=dev)
    cfg = bench_config()
    gt = torch.as_tensor(gt, device=dev)
    bg = torch.zeros(3, device=dev)
    leaves = [torch.as_tensor(a, device=dev).requires_grad_(True) for a in gauss]

    benchsync.reset_launches()
    t0 = time.perf_counter()
    loss, _, out = loss_and_grads(leaves, gt, cam, cfg, bg)
    warm_loss = float(loss.detach())
    print(f"warmup {time.perf_counter() - t0:.1f}s loss={warm_loss:.4f}", file=sys.stderr)
    dog.cancel()

    last = {}

    def step():
        last["loss"] = loss_and_grads(leaves, gt, cam, cfg, bg)[0]

    dt = benchsync.time_window(step, iters, dev)
    print(f"timed {iters} iters in {dt:.3f}s loss={float(last["loss"].detach()):.4f}",
          file=sys.stderr)
    benchsync.diagnostics(dev, benchsync.launch_counts(), loss=warm_loss,
                          max_tile_count=out["max_tile_count"],
                          max_per_tile=cfg.max_per_tile, live_pairs=out["num_live_pairs"],
                          iters=iters, seconds=dt)
    rays_per_s = width * height * iters / dt
    print(json.dumps({"metric": METRIC, "value": round(rays_per_s, 1), "unit": UNIT,
                      "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4)}),
          flush=True)


def main() -> int:
    return benchsync.run(_bench, METRIC, UNIT)


if __name__ == "__main__":
    sys.exit(main())

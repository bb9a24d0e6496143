"""The replicated residue of the sharded step: Adam and the densification
statistics (port of gsjax's `scripts/measure_trepl.py`).

    python -m gsjax_torch.measure_trepl [--device cpu]

Every rank of the sharded step (`parallel/shard.py:train_step_sharded`) runs
these on the whole model after the gradient sum, so they do not shrink with
the ranks: `scaling_model`'s t_repl. At gsjax's size (100k gaussians from
`init_from_pcd`, KNN distance 1e-4, SH degree 3, gradients 1e-6, gsjax's
learning rates, a 1920x1080 frame) one `repl` is `add_densification_stats`,
the `max_radii` update and `adam_update`, as gsjax's jitted `repl`
(:46-55). One untimed call, then 20 calls between CUDA events on the
card (the host clock on the CPU); the port's Adam updates the model in
place, so each call steps the same state again, at the same cost. gsjax's
`devprobe.wait_for_device` waited out a TPU claim and is not ported
(`utils/benchsync.py`). stdout ends in gsjax's line
{"metric": "t_repl_ms", "value", "capacity"}.

The device is the card unless `--device cpu`; with no card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from gsjax_torch.bench_reg import LRS            # gsjax's rates (:40-42)
from gsjax_torch.utils import benchsync

CAPACITY, ITERS = 100_000, 20
WIDTH, HEIGHT = 1920, 1080


def trepl_inputs(n: int, device, seed: int = 0):
    """gsjax's state (measure_trepl.py:32-45): (params, adam, aux, grads,
    g2d, vis, radii)."""
    from gsjax_torch.model import gaussians as gm

    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    params, aux = gm.init_from_pcd(pts, cols, n, sh_degree=3, sg_degree=0,
                                   knn_dist2=np.full((n,), 1e-4, np.float32), device=device)
    adam = gm.adam_init(params)
    grads = {k: torch.ones_like(getattr(params, k)) * 1e-6 for k in gm.PARAM_FIELDS}
    g2d = torch.zeros(n, 2, device=device)
    vis = torch.ones(n, dtype=torch.bool, device=device)
    radii = torch.ones(n, dtype=torch.int32, device=device)
    return params, adam, aux, grads, g2d, vis, radii


def repl(params, adam, aux, grads, g2d, vis, radii, lrs=LRS, width=WIDTH, height=HEIGHT):
    """gsjax's `repl`: the densification statistics, `max_radii` and Adam;
    `params` and `adam` in place. Returns (params, adam, aux)."""
    from gsjax_torch.model import gaussians as gm

    with torch.no_grad():
        aux = gm.add_densification_stats(aux, g2d, vis, width, height)
        aux = dataclasses.replace(aux, max_radii=torch.maximum(
            aux.max_radii, torch.where(vis, radii, torch.zeros_like(radii))))
        gm.adam_update(params, grads, adam, lrs)
    return params, adam, aux


def measure(n: int, iters: int, device) -> float:
    """Mean ms of one `repl` at capacity `n` (module docstring)."""
    state = trepl_inputs(n, device)
    repl(*state)
    benchsync.sync(device)
    return benchsync.time_window(lambda: repl(*state), iters, device) / iters * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "measure_trepl")
    line = {"metric": "t_repl_ms", "value": round(measure(CAPACITY, ITERS, dev), 3),
            "capacity": CAPACITY}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

"""Multi-process exercise of the multi-host layer (port of gsjax's
`scripts/multihost_cpu_demo.py`).

    python -m gsjax_torch.multihost_demo [--out MULTIHOST_torch.json]
        [--port P] [--timeout 300] [--device cpu]

gsjax runs two processes ("hosts") of two virtual devices each and joins
them with `jax.distributed`. On `torch.distributed` a process is one rank,
so the port runs 4 ranks as 2 simulated hosts of 2:
each rank gets `LOCAL_RANK` / `LOCAL_WORLD_SIZE` of its host (what torchrun
sets on a real host, read by `parallel/multihost.py:local_rank_and_size`)
and, on the card, `CUDA_VISIBLE_DEVICES` naming its host's cards (each its
share of the machine's cards, or all of them when there are fewer cards than
hosts). The ranks are started by `parallel/launch.py` (a hard timeout) and
join through `multihost.maybe_init_distributed` on a `tcp://` coordinator,
on a free port unless `--port` is given. Then, as gsjax's:

  1. `collectives.all_sum` of rank + 1 reads 10 on every rank (a sum that
     crosses the hosts);
  2. two `train_step_sharded` steps at the demo's size (64 points, capacity
     128, SH degree 1, 64x64, equal tile-row bands: 2 tile rows over 4
     ranks, so two ranks own none); the ranks' losses are equal bit for bit
     and finite;
  3. only the primary rank (`is_primary`) writes the artifact.

A rank's device and backend follow `multihost.init_group`: `gloo` on the
CPU and where a host's ranks share a card (one H100: the 4 ranks share it),
`nccl` where each has a card of its own. Writes MULTIHOST_torch.json with
gsjax's keys; each rank reports `world`, `hosts` and `local_world` where
gsjax's reports jax's `process_count`, `global_devices` and `local_devices`,
and also its host, local rank, device, backend and kernel launches. Exit 0
when `ok`.

The device is the card unless `--device cpu`; with no card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from gsjax_torch.bench_reg import LRS            # gsjax's demo's rates (:96-98)
from gsjax_torch.utils import benchsync

HOSTS, LOCAL_WORLD = 2, 2
SIZE = 64
STEPS = 2


def demo_inputs(device):
    """gsjax's demo state (multihost_cpu_demo.py:82-99): (params, aux, adam,
    camera, cfg, gt, bg)."""
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.knn import mean_knn_dist2
    from gsjax_torch.ops.raster import Camera, RasterConfig

    rng = np.random.default_rng(0)
    points = rng.normal(0, 1, (64, 3)).astype(np.float32)
    points[:, 2] += 4.0
    colors = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    params, aux = gm.init_from_pcd(points, colors, 128, sh_degree=1, sg_degree=0,
                                   knn_dist2=mean_knn_dist2(points), device=device)
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.9, 0.9,
                        SIZE, SIZE, device=device)
    cfg = RasterConfig(tile=32, chunk=32, tile_batch=2, pair_capacity=1 << 10,
                       max_per_tile=128, sh_degree=1, require_depth=False)
    gt = torch.as_tensor(rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32),
                         device=device)
    return params, aux, gm.adam_init(params), cam, cfg, gt, torch.zeros(3, device=device)


def _rank(rank, coord, hosts, local_world, out_dir, device):
    import torch.distributed as dist

    from gsjax_torch.parallel import multihost
    from gsjax_torch.parallel.collectives import all_sum
    from gsjax_torch.parallel.shard import equal_band_bounds, train_step_sharded
    from gsjax_torch.train.step import LossConfig

    world = hosts * local_world
    args = SimpleNamespace(dist_coordinator=coord, dist_num_processes=world,
                           dist_process_id=rank, dist_auto=False)
    assert multihost.maybe_init_distributed(args, device)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    dev = multihost.local_device(device)
    local_rank, lw = multihost.local_rank_and_size(rank, world)

    psum = float(all_sum(torch.tensor([rank + 1.0], device=dev)))

    params, aux, adam, cam, cfg, gt, bg = demo_inputs(dev)
    tiles_y = cfg.grid(SIZE, SIZE)[1]
    lc = LossConfig(reg_on=False, mv_on=False)
    losses = []
    for _ in range(STEPS):
        params, aux, adam, m = train_step_sharded(
            params, aux, adam, cam, gt, bg, LRS, cfg, lc,
            row_bounds=equal_band_bounds(tiles_y, world))
        losses.append(float(m["loss"]))

    if multihost.is_primary():
        with open(os.path.join(out_dir, "artifact.txt"), "w") as fh:
            fh.write("written by rank 0")
    return {"rank": rank, "world": dist.get_world_size(), "hosts": world // lw,
            "local_world": lw, "host": rank // lw, "local_rank": local_rank,
            "device": str(dev), "backend": dist.get_backend(), "psum": psum,
            "losses": losses, "is_primary": multihost.is_primary(),
            "launches": benchsync.launch_counts()}


def host_env(hosts: int, local_world: int, device: torch.device) -> list[dict]:
    """Each rank's environment: its host's LOCAL_RANK / LOCAL_WORLD_SIZE
    and, on the card, the host's share of the cards."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    env = []
    for r in range(hosts * local_world):
        h = r // local_world
        e = {"LOCAL_RANK": str(r % local_world), "LOCAL_WORLD_SIZE": str(local_world)}
        if cards:
            per = cards // hosts
            mine = range(h * per, (h + 1) * per) if per else range(cards)
            e["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in mine)
        env.append(e)
    return env


def run(hosts: int, local_world: int, device: torch.device, port: int | None = None,
        timeout: float = 300.0) -> dict:
    """Start the ranks, gather their reports and check gsjax's conditions."""
    from gsjax_torch.parallel.launch import free_port, launch

    world = hosts * local_world
    coord = f"127.0.0.1:{port or free_port()}"
    out_dir = tempfile.mkdtemp(prefix="gsjax_torch_mh_")
    t0 = time.time()
    try:
        error, outs = None, []
        try:
            outs = launch(_rank, world, args=(coord, hosts, local_world, out_dir,
                                              device.type),
                          device=device.type, timeout=timeout,
                          threads=1 if device.type == "cpu" else None,
                          rank_env=host_env(hosts, local_world, device), join=False)
        except RuntimeError as e:
            error = str(e)[-4000:]
        artifact = os.path.exists(os.path.join(out_dir, "artifact.txt"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ok = bool(
        error is None and len(outs) == world
        and all(o["world"] == world and o["hosts"] == hosts
                and o["local_world"] == local_world for o in outs)
        and all(abs(o["psum"] - world * (world + 1) / 2) < 1e-6 for o in outs)
        and all(o["losses"] == outs[0]["losses"] for o in outs)
        and all(np.isfinite(v) for o in outs for v in o["losses"])
        and outs[0]["is_primary"] and not any(o["is_primary"] for o in outs[1:])
        and artifact)
    result = {"ok": ok, "wall_s": round(time.time() - t0, 1),
              "primary_artifact_written": artifact, "ranks": outs,
              "backend": outs[0]["backend"] if outs else None, "coordinator": coord}
    if error:
        result["error"] = error
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="MULTIHOST_torch.json")
    ap.add_argument("--port", type=int, default=None,
                    help="the coordinator's port (default: a free one)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds before every rank is killed")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "multihost_demo")
    result = run(HOSTS, LOCAL_WORLD, dev, args.port, args.timeout)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)

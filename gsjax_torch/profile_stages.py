"""Stage-by-stage profile of bench.py's forward + backward step (port of
gsjax's `scripts/profile_stages.py`).

    python -m gsjax_torch.profile_stages [--iters 10] [--n 100000]
        [--width 1920] [--height 1080] [--fast] [--trace DIR]
        [--out PROFILE_torch.json] [--device cpu]

bench.py's scene (`bench.bench_inputs`: 100k gaussians, 1920x1080) through
the port's stages, each timed alone on inputs prepared before its timing
starts (`utils/benchsync.time_stage`: two untimed calls, then `--iters` calls
between CUDA events on the card, on the host clock on the CPU). The labels
are gsjax's, the keys `scaling_model` reads:

  preprocess, binning (expand+sort+lay): `preprocess`, `bin_gaussians`;
  the sort alone: the stable `torch.sort` of the binning's own int64 keys,
      in their enumeration order, at the live pair count (gsjax sorted
      random u32 keys at its 2^21 capacity: its key is null, with the reason);
  prepare_pairs + pack: `render_ref.prepare_pairs` (the [K, 16] payload);
  fwd / bwd kernel (depth) and (no depth): B1 / B2 through
      `render_cuda.blend_fwd` / `blend_bwd` (the twins on the CPU), the
      backward on a cotangent of ones;
  pair-grad regather (VJP): the backward of `prepare_pairs`' gather;
  preprocess VJP: the backward of `preprocess` on cotangents of ones;
  l1+ssim fwd+bwd, FULL fwd+bwd step (bench.py's loss, `bench.loss_and_grads`)
      and FULL fwd only (`render`, no graph).
Each VJP runs against the autograd graph of one forward built before its
timing, so graph construction is not timed as VJP. `--fast` skips B2 without
depth and the two VJPs, as gsjax's.

Then gsjax's `stats` (`stage_stats`, gsjax's formulas of :191-222) on the
port's binning and B1's `n_contrib` plane, with gsjax's chunk G = 128 named
(`chunk_G`) and `pair_capacity` gsjax's 2^21 (the port's pair buffers are
sized by the real count; `fill` is gsjax's ratio). gsjax's kernel blends the
padded rows of the last tile row too (8 of 1088 rows at 1080p); the port's
B1 writes the frame's pixels only, so `n_contrib_*` and the per-tile maxima
are over those. `--trace DIR` writes a `torch.profiler` trace of three full
steps (`DIR/trace.json`). `--out` writes {timings_ms, stats, n, width, height,
full_step_loss, device, nvidia_smi, notes}; `notes` gives the reason of each
null.

The device is the card unless `--device cpu`; with no card it exits
non-zero. The module imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from gsjax_torch.utils import benchsync

CHUNK_G = 128               # gsjax's pair chunk (profile_stages.py:205)
PAIR_CAPACITY = 1 << 21     # gsjax's script's capacity (:86)
GSJAX_SORT_KEY = "lax.sort u32+i32 @ 2^21"


def stage_config(require_depth: bool = True):
    """gsjax's script's RasterConfig (profile_stages.py:86-91): bench.py's,
    with or without the median depth."""
    from gsjax_torch.bench import bench_config

    return dataclasses.replace(bench_config(), require_depth=require_depth)


def stage_inputs(width: int, height: int, n: int, seed: int = 0):
    """gsjax's script's draws in its order (profile_stages.py:74-83, :170):
    bench.py's gaussians and target (`bench.bench_inputs`), then the fixed
    image of the L1 + SSIM stage, the next draw of the same stream."""
    from gsjax_torch.bench import bench_inputs

    *gauss, gt = bench_inputs(width, height, n, seed)
    rng = np.random.default_rng(seed)
    for shape in ((n, 3), (n, 3), (n, 4), (n, 1), (n, 16, 3)):   # replay bench.py's
        rng.normal(0, 1, shape)
    rng.uniform(0, 1, (height, width, 3))
    img = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    return gauss, gt, img


def sort_keys(prep, binning, cfg, width: int, height: int):
    """The int64 keys `bin_gaussians` sorts, in the order it sorts them
    (gaussian-major, each gaussian's tiles row-major), rebuilt from its
    output: the live pairs, their tiles and depths -> (keys, each key's
    gaussian)."""
    tiles_x, tiles_y = cfg.grid(width, height)
    num_tiles = tiles_x * tiles_y
    dev = binning.gauss_idx.device
    counts = binning.tile_count.to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(num_tiles, device=dev), counts)
    g = binning.gauss_idx
    _, enum = torch.sort(g * num_tiles + tile, stable=True)
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = 32 - tile_bits
    dbits = prep.depth[g].clamp_min(0.0).view(torch.int32).to(torch.int64)
    key = (tile << depth_bits) | (dbits >> tile_bits)
    return key[enum].contiguous(), g[enum]


def _pct(x, q):
    return float(np.percentile(x, q))


def stage_stats(prep, binning, n_contrib: torch.Tensor, cfg, width: int,
                height: int) -> dict:
    """gsjax's workload statistics (profile_stages.py:191-222) on the port's
    binning and B1's n_contrib plane [H, W] (see the module docstring)."""
    tiles_x, tiles_y = cfg.grid(width, height)
    t = cfg.tile
    stats = {"num_pairs": int(binning.num_pairs), "pair_capacity": PAIR_CAPACITY,
             "fill": round(float(binning.num_pairs) / PAIR_CAPACITY, 4)}
    tc = binning.tile_count.cpu().numpy()
    stats["tiles"] = int(tiles_x * tiles_y)
    stats["tile_count_mean"] = round(float(tc.mean()), 1)
    stats["tile_count_p50"] = int(np.percentile(tc, 50))
    stats["tile_count_p90"] = int(np.percentile(tc, 90))
    stats["tile_count_max"] = int(tc.max())
    g = CHUNK_G
    stats["chunk_G"] = g
    chunks = np.ceil(tc / g).sum()
    stats["chunk_pad_waste"] = round(float(chunks * g / max(tc.sum(), 1)), 3)
    nc = n_contrib.to(torch.float64)
    stats["n_contrib_mean"] = round(float(nc.mean()), 1)
    stats["n_contrib_p90"] = round(_pct(nc.cpu().numpy(), 90), 1)
    pad = torch.zeros(tiles_y * t, tiles_x * t, dtype=nc.dtype, device=nc.device)
    pad[:height, :width] = nc
    nc_tile_max = pad.reshape(tiles_y, t, tiles_x, t).amax(dim=(1, 3)).reshape(-1)
    nc_tile_max = nc_tile_max.cpu().numpy()
    marched = np.minimum(np.ceil(nc_tile_max / g) * g, np.ceil(tc / g) * g)
    stats["marched_pairs_per_tile_mean"] = round(float(marched.mean()), 1)
    stats["useful_frac_of_marched"] = round(
        float(nc.mean()) / max(float(marched.mean()), 1e-9), 3)
    rad = prep.radius.cpu().numpy()
    vis = rad[rad > 0]
    stats["visible_gaussians"] = int((rad > 0).sum())
    stats["radius_px_p50"] = round(_pct(vis, 50), 1) if len(vis) else 0
    stats["radius_px_p90"] = round(_pct(vis, 90), 1) if len(vis) else 0
    return stats


def _float_fields(prep):
    return [f.name for f in dataclasses.fields(prep) if getattr(prep, f.name).is_floating_point()]


def profile(width: int, height: int, n: int, iters: int, fast: bool, device,
            trace: str = "") -> dict:
    """Time every stage and compute the statistics; returns the JSON
    record (module docstring)."""
    from gsjax_torch import bench
    from gsjax_torch.ops.raster import Camera, render, render_cuda, render_ref
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess
    from gsjax_torch.train import losses

    time_stage = benchsync.time_stage
    gauss, gt, img = stage_inputs(width, height, n)
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        width, height, device=device)
    cfg = stage_config(True)
    cfg_nd = stage_config(False)
    gt = torch.as_tensor(gt, device=device)
    img = torch.as_tensor(img, device=device)
    bg = torch.zeros(3, device=device)
    dev_in = [torch.as_tensor(a, device=device) for a in gauss]
    tail = (width, height, cam.fx, cam.fy, bg)
    results, notes = {}, {}

    prep = time_stage(lambda *a: preprocess(*a, None, None, None, cam, cfg), dev_in,
                      iters, "preprocess", results, device)
    binning = time_stage(lambda p: bin_gaussians(p, cfg, width, height), (prep,), iters,
                         "binning (expand+sort+lay)", results, device)
    keys, _ = sort_keys(prep, binning, cfg, width, height)
    sort_label = f"torch.sort i64 stable @ {keys.shape[0]} (binning's keys)"
    time_stage(lambda k: torch.sort(k, stable=True), (keys,), iters, sort_label, results,
               device)
    results[GSJAX_SORT_KEY] = None
    notes[GSJAX_SORT_KEY] = (f"gsjax sorts random u32 keys with an i32 payload at its "
                             f"static 2^21 capacity; the port sorts its binning's own "
                             f"int64 keys at the live count: '{sort_label}'")
    feats = time_stage(lambda p, b: render_ref.prepare_pairs(p, b), (prep, binning), iters,
                       "prepare_pairs + pack", results, device)
    lists = (feats, binning.tile_start, binning.tile_count)
    planes = time_stage(lambda: render_cuda.blend_fwd(*lists, *tail, cfg), (), iters,
                        "fwd kernel (depth)", results, device)
    planes_nd = time_stage(lambda: render_cuda.blend_fwd(*lists, *tail, cfg_nd), (),
                           iters, "fwd kernel (no depth)", results, device)
    g_out = torch.ones_like(planes)
    time_stage(lambda: render_cuda.blend_bwd(*lists, planes, g_out, *tail, cfg), (), iters,
               "bwd kernel (depth)", results, device)
    late = ("bwd kernel (no depth)", "pair-grad regather (VJP)", "preprocess VJP")
    if fast:
        for k in late:
            results[k] = None
            notes[k] = "skipped (--fast), as gsjax's --fast skips it"
    else:
        time_stage(lambda: render_cuda.blend_bwd(*lists, planes_nd, g_out, *tail, cfg_nd),
                   (), iters, "bwd kernel (no depth)", results, device)
        # the gather's backward, on one graph built before the timing
        p_leaves = {k: getattr(prep, k).detach().requires_grad_(True)
                    for k in _float_fields(prep)}
        prep_g = dataclasses.replace(prep, **p_leaves)
        feats_g = render_ref.prepare_pairs(prep_g, binning)
        d_ft = torch.ones_like(feats_g)
        wrt = list(p_leaves.values())
        time_stage(lambda: torch.autograd.grad(feats_g, wrt, d_ft, retain_graph=True,
                                               allow_unused=True), (), iters,
                   "pair-grad regather (VJP)", results, device)
        leaves = [a.clone().requires_grad_(True) for a in dev_in]
        prep_f = preprocess(*leaves, None, None, None, cam, cfg)
        outs = [getattr(prep_f, k) for k in _float_fields(prep_f)
                if getattr(prep_f, k).requires_grad]
        ones = [torch.ones_like(o) for o in outs]
        time_stage(lambda: torch.autograd.grad(outs, leaves, ones, retain_graph=True,
                                               allow_unused=True), (), iters,
                   "preprocess VJP", results, device)

    img_g = img.clone().requires_grad_(True)

    def l1_ssim():
        loss = 0.8 * losses.l1_loss(img_g, gt) + 0.2 * (1 - losses.ssim(img_g, gt))
        return torch.autograd.grad(loss, img_g)

    time_stage(l1_ssim, (), iters, "l1+ssim fwd+bwd", results, device)

    leaves = [a.clone().requires_grad_(True) for a in dev_in]
    full = time_stage(lambda: bench.loss_and_grads(leaves, gt, cam, cfg, bg), (), iters,
                      "FULL fwd+bwd step", results, device)
    full_loss = float(full[0].detach())

    def fwd_only():
        with torch.no_grad():
            return render(*dev_in, cam, cfg, bg)

    time_stage(fwd_only, (), iters, "FULL fwd only", results, device)

    stats = stage_stats(prep, binning, planes[8], cfg, width, height)
    print(json.dumps(stats, indent=1), flush=True)

    if trace:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        os.makedirs(trace, exist_ok=True)
        with tprofile(activities=acts) as prof:
            for _ in range(3):
                bench.loss_and_grads(leaves, gt, cam, cfg, bg)
            benchsync.sync(device)
        prof.export_chrome_trace(os.path.join(trace, "trace.json"))
        print(f"trace written to {trace}", flush=True)

    notes["n_contrib"] = ("over the frame's pixels; gsjax's kernel also blends the padded "
                          "rows of the last tile row")
    return {"timings_ms": results, "stats": stats, "n": n, "width": width, "height": height,
            "full_step_loss": full_loss, "device": str(device),
            "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
            "nvidia_smi": benchsync.smi_line() if device.type == "cuda" else None,
            "notes": notes}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--trace", default="")
    ap.add_argument("--fast", action="store_true",
                    help="skip the slowest stages (bwd without depth, the VJPs)")
    ap.add_argument("--out", default="PROFILE_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "profile_stages")
    rec = profile(args.width, args.height, args.n, args.iters, args.fast, dev, args.trace)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
    sys.exit(0)

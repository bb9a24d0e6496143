"""Drive gsjax_torch's serving path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  device  the card's name and power limit (nvidia-smi);
  build   compile every hand-written kernel from `gsjax_torch/csrc/` with nvcc;
  parity  `render()` with backend "cuda" (the blend kernel) against backend
          "torch" (its plain-PyTorch twin), and the kernel's other output
          rows against the twin's on the same pair lists, at 640x360 / 20k
          gaussians and at 1920x1080 / 100k;
  slice   the render CLI (`gsjax_torch.render.main`) on a 4-view 1920x1080
          COLMAP scene and a 100k-gaussian PLY made from a seed; the kernel's
          launch count must equal the number of views;
  timing  CUDA-event times of preprocess, binning, the kernel and a whole
          `render()` at 1920x1080 / 100k, with the kernel's bound.
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints no
result. Run from the repository root; the scene is written under
`build/chip_smoke/` and removed at the end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# fp32 operations the blend of a frame needs, per (pair, pixel) interaction,
# counted from csrc/blend_fwd.cu (every arithmetic op, compare, select and
# transcendental counts one). Work is charged once where the function needs
# it once, whatever the kernel recomputes: alpha in the blend only, the
# ray-depth plane and log1p(-alpha) once per applied pair of a pixel whose
# median is searched, then each evaluation of the median model only its
# per-depth terms. The evaluations charged are those of the TPU kernel's
# search (two bracket ends, 7 Newton steps and the final one,
# render_pallas.py:_median_search), not this kernel's 12 Newton steps.
# Transcendentals are held to the fp32 rate like the rest, not to the
# slower special-function rate, so the bound is low on that count.
OPS_ALPHA = 16        # pair_alpha(): every marched pair
OPS_APPLY = 16        # an applied pair: weight, 3 colour + 3 normal FMAs, T update, stop test
OPS_PAIR_MEDIAN = 6   # t_peak (ray-depth plane) and log1p(-alpha)
OPS_DEPTH = 14        # the model's term at one depth
OPS_DERIV = 8         # its d/dt
MEDIAN_BRACKET = 2
MEDIAN_NEWTON = 8

# kernel vs twin tolerances: the render parity bounds gsjax holds its Pallas
# blend to against its XLA path (tests/test_pallas.py:38-44). The twin sums in
# log space over 64-pair chunks and bisects the median (8-way x 5); the kernel
# multiplies T pair by pair and finds the median by safeguarded Newton
# (blend_fwd.cu); both converge to the same root of T(t) = 0.5. The colour,
# alpha and normal bounds hold on >= 99.99% of pixels, as n_contrib's: where
# float rounding flips a discrete test between the two evaluation orders
# (alpha >= 1/255, or the stop T(1 - alpha) < 1e-4) the pixel differs by that
# one pair's weight; the largest such flip read on the card at 1080p / 100k
# was 6.3e-5, so every pixel is held within 1e-3. The median depth is held
# on >= 99.99% of pixels and every pixel within 5e-3 (largest read 1.1e-3).
# dlogT/dt at the root (row 12, what the backward reads) is evaluated at each
# side's own root, so it differs where the roots do: held within 1% / 1e-3
# on >= 99.9% of the pixels in range on both sides (read: 99.98%).
FLIP_FRAC = 0.9999
TOL_FLIP = 1e-3
TOL_COLOR = 3e-5
TOL_NORMAL = 2e-4
MD_ATOL, MD_RTOL, MD_FRAC, MD_MAX = 2e-3, 1e-3, 0.9999, 5e-3
NCONTRIB_FRAC = 0.9999
DD_RTOL, DD_ATOL, DD_FRAC = 1e-2, 1e-3, 0.999


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_gaussians(n, seed=0):
    """bench.py's scene: n gaussians around z=5 (bench.py:59-66)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = np.exp(rng.normal(-3.3, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = (1 / (1 + np.exp(-rng.normal(0.0, 1.0, (n, 1))))).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    return means, scales, quats, opac, shs


def bench_camera(width, height, device):
    from gsjax_torch.ops.raster import Camera

    return Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         1.0, 0.66, width, height, device=device)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps=10, warm=2):
    """Average CUDA-event time of `fn` over `reps` calls, after `warm`."""
    import torch

    for _ in range(warm):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def stages(scene, cam, cfg, dev):
    """preprocess -> binning -> pair payload, as `render()` runs them."""
    import torch

    from gsjax_torch.ops.raster import render_ref
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    args = [torch.as_tensor(a, device=dev) for a in scene]
    prep = preprocess(*args, None, None, None, cam, cfg)
    binning = bin_gaussians(prep, cfg, cam.width, cam.height)
    feats = render_ref.prepare_pairs(prep, binning)
    return args, prep, binning, feats


def compare(ko, to, kp, tp):
    """Kernel vs twin: `render()` dicts ko / to for what a caller sees, blend
    planes kp / tp [16, H, W] for the rows a backward reads -> error summary."""
    import torch

    def err(key):
        d = (ko[key] - to[key]).abs()
        return d.amax(-1) if d.dim() == 3 else d

    def close_frac(key, tol):
        return float((err(key) <= tol).float().mean())

    md_close = torch.isclose(ko["median_depth"], to["median_depth"], atol=MD_ATOL, rtol=MD_RTOL)
    mi_close = torch.isclose(kp[9], tp[9], atol=MD_ATOL, rtol=MD_RTOL)
    both = (kp[11] > 0) & (tp[11] > 0)
    dd_close = torch.isclose(kp[12][both], tp[12][both], rtol=DD_RTOL, atol=DD_ATOL)
    return {
        "color_max_abs_err": float(err("render").max()),
        "color_close_frac": close_frac("render", TOL_COLOR),
        "alpha_max_abs_err": float(err("alpha").max()),
        "alpha_close_frac": close_frac("alpha", TOL_COLOR),
        "normal_max_abs_err": float(err("normal").max()),
        "normal_close_frac": close_frac("normal", TOL_NORMAL),
        "median_depth_close_frac": float(md_close.float().mean()),
        "median_depth_max_abs_err": float(err("median_depth").max()),
        "n_contrib_equal_frac": float((ko["n_contrib"] == to["n_contrib"]).float().mean()),
        "t_final_max_abs_err": float((kp[10] - tp[10]).abs().max()),
        "md_init_close_frac": float(mi_close.float().mean()),
        "in_range_equal_frac": float((kp[11] == tp[11]).float().mean()),
        "in_range_frac": float((kp[11] > 0).float().mean()),
        "dlogT_dt_close_frac": float(dd_close.float().mean()) if both.any() else 1.0,
    }


def phase_build():
    from gsjax_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "built": sorted(logs),
          "ptxas": ptxas})


def phase_parity(width, height, n, dev):
    """`render()` with backend "cuda" against backend "torch" on the card,
    and the kernel's wrapper against the twin on the same pair lists for the
    rows `render()` does not return; returns (errors, twin_ms)."""
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda, render_ref

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    args, _, binning, feats = stages(bench_gaussians(n), cam, cfg, dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    ko, to = (render(*args, cam, dataclasses.replace(cfg, backend=b), bg)
              for b in ("cuda", "torch"))
    blend_args = (feats, binning.tile_start, binning.tile_count, width, height,
                  cam.fx, cam.fy, bg, cfg)
    kp = render_cuda.blend_fwd(*blend_args)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    tp = render_ref.blend_planes(*blend_args)
    b.record()
    torch.cuda.synchronize()
    twin_ms = a.elapsed_time(b)
    err = compare(ko, to, kp, tp)
    emit({"phase": "parity", "width": width, "height": height, "gaussians": n,
          "pairs": binning.num_live, "max_tile_count": binning.max_tile_count,
          "twin_ms": twin_ms, **err})
    check(torch.isfinite(kp).all(), "kernel output not finite")
    for name in ("color", "alpha", "normal"):
        check(err[f"{name}_close_frac"] >= FLIP_FRAC,
              f"{name} within tolerance on {err[f'{name}_close_frac']}")
        check(err[f"{name}_max_abs_err"] <= TOL_FLIP,
              f"{name} max error {err[f'{name}_max_abs_err']}")
    check(err["median_depth_close_frac"] >= MD_FRAC,
          f"median depth close on {err['median_depth_close_frac']}")
    check(err["median_depth_max_abs_err"] <= MD_MAX,
          f"median depth max error {err['median_depth_max_abs_err']}")
    check(err["md_init_close_frac"] >= MD_FRAC, f"md_init close on {err['md_init_close_frac']}")
    check(err["in_range_equal_frac"] >= MD_FRAC, f"in_range equal on {err['in_range_equal_frac']}")
    check(err["n_contrib_equal_frac"] >= NCONTRIB_FRAC,
          f"n_contrib equal on {err['n_contrib_equal_frac']}")
    check(err["dlogT_dt_close_frac"] >= DD_FRAC,
          f"dlogT/dt close on {err['dlogT_dt_close_frac']}")
    return err, twin_ms


def bench_pose(i, n):
    """arc_pose around bench.py's scene centre (0, 0, 5)."""
    from gsjax_torch.data.synth import arc_pose

    r_w2c, tvec = arc_pose(i, n, radius=5.0)
    return r_w2c, tvec - r_w2c @ np.array([0.0, 0.0, 5.0])


def phase_slice(dev, n_views=4, width=1920, height=1080, n=100_000):
    """The render CLI on a seeded scene; returns the kernel's launches."""
    import torch

    from gsjax_torch import render as render_cli
    from gsjax_torch.config import dump_cfg_args
    from gsjax_torch.data.synth import write_rendered_colmap
    from gsjax_torch.model.gaussians import params_from_numpy
    from gsjax_torch.model.io import save_ply
    from gsjax_torch.ops.raster import render_cuda

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    model_dir = os.path.join(WORK, "model")
    g = bench_gaussians(n)
    means, scales, quats, opac, shs = g
    params = dict(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:],
                  opacity=np.log(opac / (1 - opac)), scaling=np.log(scales),
                  rotation=quats, sg_axis=np.zeros((n, 1, 3), np.float32),
                  sg_sharpness=np.zeros((n, 1), np.float32),
                  sg_color=np.zeros((n, 1, 3), np.float32))
    aux = dict(alive=np.ones(n, bool), filter_3d=np.zeros(n, np.float32),
               grad_accum=np.zeros(n), grad_accum_abs=np.zeros(n),
               denom=np.zeros(n), max_radii=np.zeros(n, np.int32))
    t0 = time.perf_counter()
    save_ply(os.path.join(model_dir, "point_cloud", "iteration_30000",
                          "point_cloud.ply"), *params_from_numpy(params, aux, dev))
    write_rendered_colmap(scene_dir, n_images=n_views, width=width, height=height,
                          gaussians=g, pose_fn=bench_pose, max_per_tile=1 << 12,
                          device=dev)
    dump_cfg_args(model_dir, Namespace(
        sh_degree=3, sg_degree=0, source_path=scene_dir, model_path=model_dir,
        images="images", masks="", resolution=1, white_background=False,
        eval=False, kernel_size=0.0))
    setup_s = time.perf_counter() - t0

    stats = []

    def on_view(idx, view, out):
        a = out["alpha"]
        stats.append({
            "view": idx,
            "finite": bool(all(torch.isfinite(out[k]).all() for k in
                               ("render", "alpha", "normal", "median_depth"))),
            "shape": list(out["render"].shape),
            "alpha_mean": float(a.mean()),
            "alpha_gt_half_frac": float((a > 0.5).float().mean()),
            "median_depth_valid_frac": float((out["median_depth"] > 0).float().mean()),
            "pairs": out["num_live_pairs"],
            "max_tile_count": out["max_tile_count"],
        })

    render_cuda.blend_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_cli.main(["-m", model_dir, "--save_depth", "--device", str(dev)],
                    on_view=on_view)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = render_cuda.blend_fwd.launches

    out_dir = os.path.join(model_dir, "train", "ours_30000")
    files = {d: sorted(os.listdir(os.path.join(out_dir, d)))
             for d in ("renders", "gt", "depth")}
    emit({"phase": "slice", "views": n_views, "width": width, "height": height,
          "gaussians": n, "setup_s": setup_s, "cli_s": cli_s,
          "blend_fwd_launches": launches, "files": {k: len(v) for k, v in files.items()},
          "per_view": stats})
    want = [f"{i:05d}.png" for i in range(n_views)]
    check(all(v == want for v in files.values()), f"PNG tree {files}")
    check(len(stats) == n_views, "not every view rendered")
    check(launches == n_views, f"blend_fwd launched {launches} times for {n_views} views")
    for s in stats:
        check(s["finite"], f"view {s['view']} has non-finite output")
        check(s["shape"] == [height, width, 3], f"view {s['view']} shape {s['shape']}")
        check(s["alpha_mean"] > 0.05 and s["alpha_gt_half_frac"] > 0.01,
              f"view {s['view']} alpha coverage {s['alpha_mean']}")
        check(s["median_depth_valid_frac"] > 0.01, f"view {s['view']} has no median depth")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


def applied_pairs(feats, binning, n_contrib, cfg, width, height):
    """[H, W] pairs each pixel applied: those of its tile's list before its
    n_contrib that pass the alpha test, counted with the twin's own test."""
    import torch

    from gsjax_torch.ops.raster import render_ref

    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    n_tiles = tiles_x * tiles_y
    nc = torch.zeros(tiles_y * t, tiles_x * t, dtype=torch.int64, device=feats.device)
    nc[:height, :width] = n_contrib.to(torch.int64)
    nc = nc.reshape(tiles_y, t, tiles_x, t).permute(0, 2, 1, 3).reshape(n_tiles, t * t)
    feats_pad = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    out = torch.zeros_like(nc)
    for i in range(0, n_tiles, cfg.tile_batch):
        ids = torch.arange(i, min(i + cfg.tile_batch, n_tiles), device=feats.device)
        px, py = render_ref._tile_pixels(ids, tiles_x, cfg)
        starts = binning.tile_start[ids].to(torch.int64)
        lim = nc[ids]
        limit = lim.amax(1)
        for base in range(0, int(limit.max()), cfg.chunk):
            f, rel, valid = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
            _, passes, _, _ = render_ref._alpha_terms(f, px, py, cfg, valid)
            out[ids] += (passes & (rel[None, :, None] < lim[:, None, :])).sum(1)
    out = out.reshape(tiles_y, tiles_x, t, t).permute(0, 2, 1, 3)
    return out.reshape(tiles_y * t, tiles_x * t)[:height, :width]


def kernel_bound_ms(planes, feats, binning, cfg, width, height):
    """Least time the card needs for the blend of this frame: the larger of
    bytes moved (pair payload and tile ranges read once, 16 planes written
    once) over HBM bandwidth and fp32 operations (OPS_* above) over the fp32
    peak. Interactions are the ones these inputs need: a pixel marches its
    tile's list up to its last contributor, or the whole (clamped) list
    where T_final >= 1e-2 shows it never reached the stop; it blends its
    applied pairs; where T_final <= min_transmittance it brackets the median
    over them, and where the root is in range it runs the search's
    evaluations over them."""
    import torch

    t = cfg.tile
    tiles_x, tiles_y = cfg.grid(width, height)
    counts = binning.tile_count.clamp_max(cfg.max_per_tile).to(torch.float64)
    per_pix = counts.reshape(tiles_y, tiles_x).repeat_interleave(t, 0) \
        .repeat_interleave(t, 1)[:height, :width]
    n_contrib = planes[8].to(torch.float64)
    t_final = planes[10]
    marched = torch.where(t_final >= 1e-2, per_pix, n_contrib)
    applied = applied_pairs(feats, binning, planes[8], cfg, width, height).to(torch.float64)
    cand = applied * (t_final <= cfg.min_transmittance)
    in_range = applied * (planes[11] > 0)
    ops = float((marched * OPS_ALPHA + applied * OPS_APPLY
                 + cand * (OPS_PAIR_MEDIAN + MEDIAN_BRACKET * OPS_DEPTH)
                 + in_range * MEDIAN_NEWTON * (OPS_DEPTH + OPS_DERIV)).sum())
    nbytes = (binning.num_live * 16 * 4 + counts.numel() * 2 * 4 + 3 * 4
              + 16 * width * height * 4)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "interactions_marched": float(marched.sum()),
            "interactions_applied": float(applied.sum()),
            "interactions_median": float(cand.sum()),
            "interactions_newton": float(in_range.sum())}


def phase_timing(dev, twin_ms, width=1920, height=1080, n=100_000):
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = bench_camera(width, height, dev)
    args, prep, binning, feats = stages(bench_gaussians(n), cam, cfg, dev)
    bg = torch.zeros(3, device=dev)
    pre_ms = event_ms(lambda: preprocess(*args, None, None, None, cam, cfg))
    bin_ms = event_ms(lambda: bin_gaussians(prep, cfg, width, height))
    blend = lambda: render_cuda.blend_fwd(feats, binning.tile_start, binning.tile_count,
                                          width, height, cam.fx, cam.fy, bg, cfg)
    kernel_ms = event_ms(blend)
    cfg_nd = dataclasses.replace(cfg, require_depth=False)
    kernel_nd_ms = event_ms(lambda: render_cuda.blend_fwd(
        feats, binning.tile_start, binning.tile_count, width, height, cam.fx, cam.fy,
        bg, cfg_nd))
    render_ms = event_ms(lambda: render(*args, cam, cfg, bg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render(*args, cam, cfg, bg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound = kernel_bound_ms(blend(), feats, binning, cfg, width, height)
    emit({"phase": "timing", "width": width, "height": height, "gaussians": n,
          "pairs": binning.num_live, "enumerated_pairs": binning.num_pairs,
          "max_tile_count": binning.max_tile_count,
          "preprocess_ms": pre_ms, "binning_ms": bin_ms, "blend_kernel_ms": kernel_ms,
          "blend_kernel_no_depth_ms": kernel_nd_ms,
          "render_ms": render_ms, "twin_ms": twin_ms, "peak_mem_bytes": peak, **bound})
    return kernel_ms, bound


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    from gsjax_torch.ops.raster import render_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    phase_build()
    phase_parity(640, 360, 20_000, dev)
    full_err, twin_ms = phase_parity(1920, 1080, 100_000, dev)
    launches = phase_slice(dev)
    kernel_ms, bound = phase_timing(dev, twin_ms)
    emit({"kernels": [{
        "name": "blend_fwd", "route": "cuda", "source": "gsjax_torch/csrc/blend_fwd.cu",
        "replaces": "gsjax/ops/raster/render_pallas.py:644",
        "launches": launches,
        "max_abs_err": max(full_err["color_max_abs_err"], full_err["alpha_max_abs_err"]),
        "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

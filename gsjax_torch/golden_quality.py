"""Golden-scene quality: train a synthetic scene through the whole schedule and
score it (port of gsjax's `scripts/golden_quality.py`).

    python -m gsjax_torch.golden_quality [--out QUALITY.json] [--iterations 2000]
        [--width 256] [--height 192] [--n_images 24] [--scene sphere|blobs]
        [--tetra] [--no_reg] ... [--device cpu]

The scene is generated, not downloaded: flattened gaussians on a unit sphere
(`data.synth.sphere_gaussians`) or gsjax's harder blobs scene (two occluding
spheres in a textured shell), rendered from a 360-degree camera ring into a
binary COLMAP dataset whose sparse points are jittered by 0.03. The model
trains from those points with the full schedule (densification, opacity
resets, the SH / SG degree steps, PGSR regularisation from the schedule's
half-way point), then is scored:

  - test PSNR over the held-out every-8th views;
  - the TSDF mesh (voxel 0.02, truncation 6.0) and, with `--tetra`, the
    marching-tetrahedra mesh (8 binary-search steps), each against the
    analytic surface: the symmetric chamfer of the mean vertex-to-surface
    distance and the mean distance from 20k surface samples to the nearest
    vertex, after cropping vertices beyond 2.0 (sphere) / 2.5 (blobs).

The JSON written to `--out` has gsjax's keys and gates. Runs on cuda unless
`--device cpu` is given; with no card it raises. `--presize_pairs` sizes
gsjax's XLA capacity buckets: the port has none and accepts the flag so that
gsjax's command lines run unchanged.

Checkpoint and resume: every tenth of the run the trainer's state, the
appearance state, Python's `random` state, the torch generator's state, the
SH / SG degrees and the tile-list cap go to `<model>/golden_ckpt.npz`; a
later run of the same configuration resumes from it and ends where an
uninterrupted run would. gsjax restores neither degree, so a gsjax run
resumed after step 1000 renders at SH 0 until the next multiple of 1000
(ROADMAP queue C); a checkpoint without them (gsjax's) resumes at the
degrees an uninterrupted run has at its iteration. Python's `random` is not
seeded here, as in gsjax: the view order, and so the scores, differ from run
to run.

`--stats_out PATH` writes what the run did beside the scores: the steps by
kind with their host seconds, overflow retries, the neighbour lists clamped
at `max_per_tile`, capacity growths, densify rounds, opacity resets and the
meshing stages.

gsjax's gates were set on its TPU runs, whose NCC sampler drops the pixels
of every 16x16 block whose taps outrun its [48, 64] window: on recipe A
about a third of the NCC's pixels, those near the silhouette
(probe_golden.py). The port samples every tap, as the reference does; on
recipe A it densifies about three times as much as gsjax's record and
misses the sphere's PSNR gate (ROADMAP queue C).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import random
import tempfile
import time

import numpy as np

THRESHOLDS = {"sphere": (34.0, 0.025, 0.0625), "blobs": (23.0, 0.34, 0.22)}
CROP_RADIUS = {"sphere": 2.0, "blobs": 2.5}
CLUSTERS = {"sphere": 1, "blobs": 3}
DEVICE_STEP_REPS = 5


def build_parser() -> argparse.ArgumentParser:
    """gsjax's flags (scripts/golden_quality.py:38-98), `--device` for its
    `--platform`, and `--stats_out`."""
    ap = argparse.ArgumentParser(description="gsjax_torch golden-scene quality")
    ap.add_argument("--out", default="QUALITY.json")
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--n_images", type=int, default=24)
    ap.add_argument("--n_gauss", type=int, default=1500)
    ap.add_argument("--scene", default="sphere", choices=["sphere", "blobs"],
                    help="golden scene: 'sphere' or the harder 'blobs' (two "
                         "occluding spheres, textured background shell, "
                         "anisotropic gaussians)")
    ap.add_argument("--no_reg", action="store_true",
                    help="ablation: zero the geometry losses (depth-normal + "
                         "PGSR NCC / geo); its chamfer against the regularised "
                         "run's tests whether the losses improve geometry")
    ap.add_argument("--reset_interval", type=int, default=0,
                    help="opacity reset interval (0 = no resets)")
    ap.add_argument("--sh_degree", type=int, default=2)
    ap.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    ap.add_argument("--tetra", action="store_true",
                    help="also extract the marching-tetrahedra mesh and gate "
                         "its chamfer")
    ap.add_argument("--sg_degree", type=int, default=0,
                    help="spherical-gaussian lobes, unlocked at iteration 1000")
    ap.add_argument("--appearance", default="no", choices=["no", "gs", "pgsr", "gof"])
    ap.add_argument("--scene_dir", default="", help="reuse / keep the generated scene here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--no_resume", action="store_true",
                    help="ignore an existing golden_ckpt.npz and restart")
    ap.add_argument("--cluster_to_keep", type=int, default=0,
                    help="connected components kept by the mesh post-processing "
                         "(0 = 1 for the sphere, 3 for blobs: the shell and "
                         "the two spheres)")
    ap.add_argument("--mesh_min_opacity", type=float, default=0.0,
                    help="drop gaussians of lower filtered opacity from the "
                         "TSDF depth renders and the tetra points")
    ap.add_argument("--presize_pairs", type=int, default=0,
                    help="no effect: sizes gsjax's XLA pair buckets; the port "
                         "sizes its pair buffers from the real counts")
    ap.add_argument("--schedule_iters", type=int, default=0,
                    help="pin the schedule horizon (lr decay, reg start, "
                         "densify window) to this iteration count while "
                         "training to --iterations (extending a checkpointed "
                         "run)")
    ap.add_argument("--stats_out", default="",
                    help="also write the run's statistics (steps by kind, "
                         "retries, clamps, stage seconds) to this JSON file")
    return ap


def scene_dir(args) -> str:
    """Where the scene is generated (gsjax's default path and key)."""
    return args.scene_dir or os.path.join(
        tempfile.gettempdir(),
        f"gsjax_golden_scene_{args.scene}_{args.width}x{args.height}"
        f"_n{args.n_images}_g{args.n_gauss}")


def model_dir(args) -> str:
    """The run's directory, keyed by its configuration as gsjax's (a short run
    and the real one never share a checkpoint), under the port's own
    prefix so that the two packages never resume from each other, and by
    GSJAX_NCC_COMPACT, so that the two NCC forms never share one either."""
    compact = os.environ.get("GSJAX_NCC_COMPACT", "0") not in ("0", "")
    return os.path.join(
        tempfile.gettempdir(),
        f"gsjax_torch_golden_out_{args.width}x{args.height}"
        f"_n{args.n_images}_g{args.n_gauss}_i{args.iterations}"
        f"_sg{args.sg_degree}_{args.appearance}_{args.scene}"
        f"{'_noreg' if args.no_reg else ''}"
        f"{'_rst' + str(args.reset_interval) if args.reset_interval else ''}"
        f"{'_sh' + str(args.sh_degree) if args.sh_degree != 2 else ''}"
        f"{'_ncccompact' if compact else ''}")


def schedule(args):
    """gsjax's schedule overrides (golden_quality.py:140-155) on the default
    OptimizationParams."""
    from gsjax_torch.config import OptimizationParams

    o = argparse.Namespace(**OptimizationParams._defaults())
    sched = args.schedule_iters or args.iterations
    o.iterations = args.iterations
    o.densify_from_iter = 300
    o.densify_until_iter = int(sched * 0.75)
    o.densification_interval = 100
    o.densify_grad_threshold = args.densify_grad_threshold
    o.opacity_reset_interval = args.reset_interval or 100_000
    o.regularization_from_iter = sched // 2
    o.position_lr_max_steps = sched
    if args.no_reg:
        o.lambda_depth_normal = 0.0
        o.lambda_multi_view_geo = 0.0
        o.lambda_multi_view_ncc = 0.0
    return o


def write_scene(root, args, device):
    """gsjax's golden scene: the sphere on `ring_pose`, or blobs on a wider
    ring aimed at the blobs' centre; sparse points jittered by 0.03."""
    from gsjax_torch.data.synth import (blobs_gaussians, ring_pose, sphere_gaussians,
                                        write_rendered_colmap)

    gen = {"sphere": sphere_gaussians, "blobs": blobs_gaussians}[args.scene]
    ring = ring_pose if args.scene == "sphere" else (
        lambda i, n: ring_pose(i, n, radius=4.2, height_amp=1.1, target=(0.7, 0.1, 0.25)))
    write_rendered_colmap(root, n_images=args.n_images, width=args.width,
                          height=args.height, gaussians=gen(args.n_gauss), pose_fn=ring,
                          points_noise=0.03, max_per_tile=1 << 10, device=device)


# --- scoring against the analytic surface ------------------------------------

def sphere_surface_distance(verts) -> np.ndarray:
    return np.abs(np.linalg.norm(verts, axis=1) - 1.0)


def sphere_surface_samples(n=20000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    samples = rng.normal(0, 1, (n, 3))
    return samples / np.linalg.norm(samples, axis=1, keepdims=True)


def surf_dist(scene: str, verts) -> np.ndarray:
    """Distance of each vertex to the scene's analytic surface."""
    from gsjax_torch.data.synth import blobs_surface_distance

    fn = sphere_surface_distance if scene == "sphere" else blobs_surface_distance
    return fn(np.asarray(verts))


def surface_samples(scene: str) -> np.ndarray:
    from gsjax_torch.data.synth import blobs_surface_samples

    return sphere_surface_samples() if scene == "sphere" else blobs_surface_samples()


def chamfer_of(verts, scene: str, label: str | None = None, samples=None):
    """(chamfer, d2s, s2d, vertices kept) of a mesh against the scene's
    surface, vertices beyond the scene's crop radius dropped first (the DTU
    ObsMask's analogue); inf and 0 vertices for an empty mesh."""
    from scipy.spatial import cKDTree

    verts = np.asarray(verts)
    if len(verts):
        verts = verts[np.linalg.norm(verts, axis=1) <= CROP_RADIUS[scene]]
    if len(verts) == 0:
        return float("inf"), float("inf"), float("inf"), 0
    samples = surface_samples(scene) if samples is None else samples
    d2s = float(np.mean(surf_dist(scene, verts)))
    s2d = float(np.mean(cKDTree(verts).query(samples, k=1)[0]))
    ch = 0.5 * (d2s + s2d)
    if label:
        print(f"{label}: {len(verts)} verts (cropped); chamfer={ch:.4f} "
              f"(d2s={d2s:.4f}, s2d={s2d:.4f})", flush=True)
    return ch, d2s, s2d, len(verts)


# --- checkpoint --------------------------------------------------------------

def save_golden_ckpt(trainer, path):
    """The trainer's state with everything its trajectory depends on in
    `extra`: the appearance state, Python's `random` state, the torch
    generator's state (gsjax's JAX key), the SH / SG degrees and the
    tile-list cap. Written atomically."""
    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.model.io import save_checkpoint

    extra = app_lib.state_to_arrays(trainer.app)
    extra["rng_pystate"] = np.frombuffer(pickle.dumps(random.getstate()), np.uint8)
    extra[f"rng_torch_{trainer.generator.device.type}"] = trainer.generator.get_state().numpy()
    extra["active_sh"] = np.asarray(trainer.active_sh)
    extra["active_sg"] = np.asarray(trainer.active_sg)
    extra["max_per_tile"] = np.asarray(trainer.max_per_tile)
    save_checkpoint(path + ".tmp.npz", trainer.params, trainer.aux, trainer.adam,
                    trainer.iteration, extra)
    os.replace(path + ".tmp.npz", path)


def load_golden_ckpt(trainer, path):
    """Restore `save_golden_ckpt`'s state into `trainer`. A checkpoint that
    lacks the degrees (gsjax's) gets those of an uninterrupted run at its
    iteration; gsjax's JAX key, and a generator state saved on another
    device type, are ignored."""
    import torch

    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.model.io import load_checkpoint

    p, a, ad, it, extra = load_checkpoint(path, device=trainer.device)
    trainer.params, trainer.aux, trainer.adam, trainer.iteration = p, a, ad, it
    trainer.app = app_lib.state_from_arrays(trainer.app, extra)
    if "rng_pystate" in extra:
        random.setstate(pickle.loads(extra["rng_pystate"].tobytes()))
    gen_key = f"rng_torch_{trainer.generator.device.type}"
    if gen_key in extra:     # a generator's state fits its own device type only
        trainer.generator.set_state(torch.from_numpy(extra[gen_key]))
    trainer.active_sh = int(extra["active_sh"]) if "active_sh" in extra else \
        min(it // 1000, trainer.sh_degree)
    trainer.active_sg = int(extra["active_sg"]) if "active_sg" in extra else \
        (trainer.sg_degree if it >= 1000 else 0)
    if "max_per_tile" in extra:
        trainer.max_per_tile = int(extra["max_per_tile"])
    return it


# --- the loop's own clocks ---------------------------------------------------

def step_kind(trainer, metrics) -> str:
    """What a step did: 'mv' (the multi-view losses), 'reg' (regularisation
    without them) or 'plain'; '+densify' / '+reset' when the schedule ran
    either after it."""
    o = trainer.opt
    it = trainer.iteration
    kind = "mv" if metrics["near"] is not None else (
        "reg" if it >= o.regularization_from_iter else "plain")
    if "densify" in metrics:
        kind += "+densify"
    if it < o.densify_until_iter and it % o.opacity_reset_interval == 0:
        kind += "+reset"
    return kind


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_step_ms(trainer, scene, reps=DEVICE_STEP_REPS):
    """The step's own time on the final state (gsjax's `step_ms_device`,
    golden_quality.py:216-254): view 0 against its first neighbour with
    regularisation on, one warm-up and `reps` timed steps. The port's step
    updates the model and Adam in place, so it runs on clones and the
    trainer's state stays as trained. Unlike gsjax's (default lambdas
    whatever the run trained with), the step takes the loop's own loss
    configuration (`Trainer.loss_config`), so a --no_reg run times the step
    it ran."""
    import torch

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.train.loop import next_pow2
    from gsjax_torch.train.step import train_step

    o = trainer.opt
    v0 = scene.train_views[0]
    near = scene.train_views[v0.nearest_ids[0]] if v0.nearest_ids else None
    mv = near is not None and (o.lambda_multi_view_ncc > 0 or o.lambda_multi_view_geo > 0)
    lcfg = dataclasses.replace(trainer.loss_config(True, mv), nan_stats=False)
    kw = {}
    if mv:
        kw = dict(near_cam=near.camera, gray_r=trainer.gray_for(v0), gray_n=trainer.gray_for(near))
    if trainer.app.kind != "no":
        kw.update(app_embedding=trainer.app.table[v0.uid], app_net=trainer.app.net)
    params = gm.GaussianParams(**{k: getattr(trainer.params, k).detach().clone()
                                  for k in gm.PARAM_FIELDS})
    aux = gm.GaussianAux(**{k: getattr(trainer.aux, k).clone() for k in gm.AUX_FIELDS})
    adam = gm.AdamState(mu={k: v.clone() for k, v in trainer.adam.mu.items()},
                        nu={k: v.clone() for k, v in trainer.adam.nu.items()},
                        count=trainer.adam.count)
    gt, bg, lrs = trainer.gt_for(v0), trainer.bg(), trainer.lrs()
    cfg = trainer.raster_cfg(require_depth=True)
    steps, with_queries = [], 0
    for i in range(reps + 1):
        while True:         # the loop's overflow retry, on the clone
            params, aux, adam, m = train_step(params, aux, adam, v0.camera, gt, bg, lrs,
                                              cfg, lcfg, **kw)
            if not m["overflowed"]:
                break
            cfg = dataclasses.replace(cfg, max_per_tile=next_pow2(int(m["max_tile_count"] * 2.5)))
        _sync(trainer.device)
        steps.append(time.perf_counter())
        with_queries += m["mv_queries"] > 0
    del params, aux, adam
    if trainer.device.type == "cuda":
        torch.cuda.empty_cache()
    return (steps[-1] - steps[0]) / reps * 1e3, {"mv": mv, "steps": reps + 1,
                                                 "steps_with_queries": with_queries}


# --- the run -----------------------------------------------------------------

def main(argv=None, on_step=None, on_stage=None):
    """Run the golden CLI on `argv` (default sys.argv[1:]). `on_step(trainer,
    metrics)` is called after every training step; `on_stage(name, trainer)`
    before each stage ('train', 'device_step', 'test', 'tsdf', 'tetra') and
    with 'end' after the last. Returns (result, stats): the JSON written to
    --out and the run's statistics."""
    import torch

    from gsjax_torch import resolve_device
    from gsjax_torch.data.readers import build_nearest_view_graph, load_scene
    from gsjax_torch.mesh.extract import extract_mesh_tetrahedra, extract_mesh_tsdf
    from gsjax_torch.train.loop import Trainer
    from gsjax_torch.train.losses import psnr

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    n_cluster = args.cluster_to_keep or CLUSTERS[args.scene]
    stage = on_stage or (lambda name, trainer: None)
    seconds = {}
    t_start = time.time()
    root = scene_dir(args)
    if not os.path.exists(os.path.join(root, "sparse")):
        print(f"generating golden scene at {root}", flush=True)
        write_scene(root, args, dev)
    scene = load_scene(root, "images", None, eval_split=True, device=dev)
    build_nearest_view_graph(scene.train_views, 30, 0.01, 1.5, 8)

    o = schedule(args)
    out_dir = model_dir(args)
    os.makedirs(out_dir, exist_ok=True)
    print(f"model at {out_dir}", flush=True)
    trainer = Trainer.create(scene, o, out_dir, dev, sh_degree=args.sh_degree,
                             sg_degree=args.sg_degree, appearance=args.appearance)
    ckpt_path = os.path.join(out_dir, "golden_ckpt.npz")
    resumed_at = None
    if not args.no_resume and os.path.exists(ckpt_path):
        resumed_at = load_golden_ckpt(trainer, ckpt_path)
        print(f"resumed from {ckpt_path} at iteration {resumed_at}", flush=True)
    _sync(dev)
    seconds["setup"] = time.time() - t_start

    stage("train", trainer)
    log_every = max(args.iterations // 10, 1)
    loop_s, loop_iters = 0.0, 0
    kinds: dict[str, list] = {}
    stats = {"resumed_at": resumed_at, "attempts": 0, "retried_at": [], "mv_steps": 0,
             "mv_steps_with_queries": 0,
             "mv_max_tile_count": 0, "mv_steps_near_list_clamped": 0,
             "near_list_clamped_at": [], "densify_rounds": 0, "opacity_resets": 0,
             "capacity_growth": [], "max_per_tile_growth": []}
    while trainer.iteration < o.iterations:
        cap, mpt = trainer.params.capacity, trainer.max_per_tile
        t_it = time.perf_counter()
        metrics = trainer.step()
        dt = time.perf_counter() - t_it
        loop_s += dt
        loop_iters += 1
        it = trainer.iteration
        kind = step_kind(trainer, metrics)
        k = kinds.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += dt
        stats["attempts"] += metrics["attempts"]
        if metrics["attempts"] > 1:
            stats["retried_at"].append([it, metrics["attempts"], metrics["max_per_tile"]])
        if metrics["near"] is not None:
            stats["mv_steps"] += 1
            # the point query launches only on a non-empty query set (none
            # right after an opacity reset, before any pixel has a median)
            stats["mv_steps_with_queries"] += metrics["mv_queries"] > 0
            stats["mv_max_tile_count"] = max(stats["mv_max_tile_count"],
                                             int(metrics["mv_max_tile_count"]))
            if metrics["mv_max_tile_count"] > metrics["max_per_tile"]:
                stats["mv_steps_near_list_clamped"] += 1
                stats["near_list_clamped_at"].append(
                    [it, int(metrics["mv_max_tile_count"]), metrics["max_per_tile"]])
        stats["densify_rounds"] += "densify" in metrics
        stats["opacity_resets"] += kind.endswith("+reset")
        if trainer.params.capacity != cap:
            stats["capacity_growth"].append([it, trainer.params.capacity])
        if trainer.max_per_tile != mpt:
            stats["max_per_tile_growth"].append([it, trainer.max_per_tile])
        if on_step is not None:
            on_step(trainer, metrics)
        if it % log_every == 0:
            print(f"it {it}: loss={float(metrics['loss']):.4f} "
                  f"n={int(trainer.aux.alive.sum())} "
                  f"({time.time() - t_start:.0f}s, "
                  f"{loop_iters / max(loop_s, 1e-9):.2f} it/s)", flush=True)
            save_golden_ckpt(trainer, ckpt_path)
    seconds["train_loop"] = loop_s
    stats["steps_by_kind"] = {k: {"steps": n, "seconds": s} for k, (n, s) in sorted(kinds.items())}

    # loop-level iters/s against the step's own time on the final state: the
    # difference is the host's glue per iteration (view choice, densify,
    # capacity bookkeeping, checkpoint scheduling)
    step_ms = None
    if loop_iters > 0:
        stage("device_step", trainer)
        step_ms, stats["device_step"] = device_step_ms(trainer, scene)
        print(f"loop {loop_iters / max(loop_s, 1e-9):.2f} it/s measured; "
              f"device step {step_ms:.0f} ms "
              f"(host glue {loop_s / loop_iters * 1e3 - step_ms:.0f} ms/iter)", flush=True)

    stage("test", trainer)
    t0 = time.time()
    vals = []
    for v in scene.test_views:
        out = trainer.render_view(v, require_depth=True)
        vals.append(float(psnr(torch.clamp(out["render"], 0, 1), trainer.gt_for(v))))
    test_psnr = float(np.mean(vals)) if vals else float("nan")
    print(f"test PSNR over {len(vals)} held-out views: {test_psnr:.2f} dB", flush=True)
    seconds["test"] = time.time() - t0

    stage("tsdf", trainer)
    t0 = time.time()
    samples = surface_samples(args.scene)
    mesh = extract_mesh_tsdf(
        lambda v: trainer.render_view(v, require_depth=True,
                                      min_opacity=args.mesh_min_opacity),
        scene.train_views, voxel_size=0.02, depth_trunc=6.0,
        cluster_to_keep=n_cluster, verbose=False)
    verts, faces = mesh["post"]
    if len(verts) == 0:
        verts, faces = mesh["raw"]
    chamfer, d2s, s2d, nverts = chamfer_of(verts, args.scene, "tsdf mesh", samples)
    seconds["tsdf"] = time.time() - t0
    stats["tsdf"] = {"seconds": mesh["seconds"], "grid": list(mesh["grid"])}

    chamfer_tetra = None
    if args.tetra:
        stage("tetra", trainer)
        t0 = time.time()
        tmesh = extract_mesh_tetrahedra(
            trainer.params, trainer.aux, scene.train_views,
            trainer.raster_cfg(require_depth=True), n_binary_steps=8,
            cluster_to_keep=n_cluster, min_opacity=args.mesh_min_opacity, verbose=False)
        tverts, _ = tmesh["post"]
        if len(tverts) == 0:
            tverts, _ = tmesh["raw"]
        chamfer_tetra = chamfer_of(tverts, args.scene, "tetra mesh", samples)[0]
        seconds["tetra"] = time.time() - t0
        stats["tetra"] = {"seconds": tmesh["seconds"], "counts": tmesh["counts"],
                          "views": len(scene.train_views)}
    stage("end", trainer)

    result = {
        "scene": f"{args.scene}_ring",
        "platform": dev.type,
        "iterations": args.iterations,
        "sg_degree": args.sg_degree,
        "appearance": args.appearance,
        "n_train_views": len(scene.train_views),
        "n_test_views": len(scene.test_views),
        "n_gaussians_final": int(trainer.aux.alive.sum()),
        "test_psnr_db": round(test_psnr, 3),
        "chamfer": round(chamfer, 5),
        "chamfer_d2s": round(d2s, 5),
        "chamfer_s2d": round(s2d, 5),
        "chamfer_tetra": (round(chamfer_tetra, 5)
                          if chamfer_tetra is not None and np.isfinite(chamfer_tetra)
                          else None),
        "mesh_vertices": int(nverts),
        "no_reg": bool(args.no_reg),
        "reset_interval": args.reset_interval,
        "sh_degree": args.sh_degree,
        "cluster_to_keep": n_cluster,
        "mesh_min_opacity": args.mesh_min_opacity,
        "wall_s": round(time.time() - t_start, 1),
        # loop-level throughput (this process; no checkpoint or log IO) and
        # the step's own time on the final state
        "loop_iters_per_s": round(loop_iters / loop_s, 3) if loop_iters else None,
        "loop_mean_ms": round(loop_s / loop_iters * 1e3, 1) if loop_iters else None,
        "step_ms_device": round(step_ms, 1) if step_ms is not None else None,
    }
    # gsjax's gates, set on its own runs (golden_quality.py:351-371): sphere
    # 34.0 dB / TSDF 0.025 / tetra 0.0625; blobs 23.0 / 0.34 / 0.22. A
    # --no_reg run gates PSNR only: its chamfer is the comparison point.
    thr = THRESHOLDS[args.scene]
    result["thresholds"] = {"test_psnr_db_min": thr[0], "chamfer_max": thr[1],
                            "chamfer_tetra_max": thr[2]}
    ch_ok = True if args.no_reg else (
        chamfer <= thr[1] and (chamfer_tetra is None or chamfer_tetra <= thr[2]))
    result["pass"] = bool(test_psnr >= thr[0] and ch_ok)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    stats.update(device=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
                 steps_trained=loop_iters, model_dir=out_dir, scene_dir=root,
                 seconds=seconds, max_per_tile=trainer.max_per_tile,
                 capacity=trainer.params.capacity)
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump(stats, f, indent=1)
    print(json.dumps(result), flush=True)
    return result, stats


if __name__ == "__main__":
    main()

"""The `render` driver: a closed loop, one client, of the port's `api.render`
over `scenes.flythrough`, the benchmark's own orbit of novel views between
the training views (the render CLI's path, `utils/trajectories.py`, faces
away from the scene: PERF.md section 7), each frame ending with its 8-bit
colour image on the host. `checked_frames` frames among the window's first
`checked_within`, drawn from the seed, are kept and rendered again by the
reference once the window has closed.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from gsbench import capture, check, drivers, scenes
from gsbench import trace as trace_lib
from gsbench.counts import work
from gsbench.reference import loop as ref_loop

RESERVE = 1.5     # the traced window's free segment over what its warm-up kept
KERNELS = ("blend_fwd",)
# the faults a serving cell can have (control.fault plants them)
FAULTS = ("altered", "half_tiles")
# the options of the program serving applies; the training options and
# multi-view settings describe how the model was trained and do not apply
APPLIED = {"sh_degree": None, "sg_degree": None, "kernel_size": None,
           "white_background": None, "environment": None, "optimization": None,
           "multi_view_num": None, "multi_view_max_angle": None,
           "multi_view_min_dis": None, "multi_view_max_dis": None,
           "use_decoupled_appearance": None, "disable_filter3d": (False,),
           "random_background": None}


def render_model(scene, cfg, device):
    """The port's model of the generated scene, its 3D filter as training
    leaves it, and the tensors render.py hands `render()`."""
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster.camera import Camera

    params = gm.GaussianParams(**{k: scene.params[k] for k in gm.PARAM_FIELDS})
    cams = [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=device)
            for v in scene.views]
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        filt = gm.compute_3d_filter(params.xyz, scene.alive,
                                    torch.stack([c.world_view for c in cams]),
                                    f32([c.fx for c in cams]), f32([c.width for c in cams]),
                                    f32([c.height for c in cams]), f32([c.fy for c in cams]))
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, filt)
        model = dict(means3d=params.xyz, scales=scales, rotations=params.rotation,
                     opacities=opac, shs=gm.get_features(params),
                     sg_axis=gm.get_sg_axis(params),
                     sg_sharpness=gm.get_sg_sharpness(params), sg_color=params.sg_color,
                     alive=scene.alive)
    return model, cams


def positions(traffic: dict, seed: int) -> tuple[int, dict]:
    """The path position of the window's first frame, and {frame of the
    window: path position} of the checked frames, drawn from the seed."""
    n_path = int(traffic["path_frames"])
    rng = random.Random(seed)
    start = rng.randrange(n_path)
    keep = rng.sample(range(int(traffic["checked_within"])), int(traffic["checked_frames"]))
    return start, {i: (start + i) % n_path for i in keep}


def serving(cfg: dict, traffic: dict, seed: int, dev, scale: float):
    """The generated scene served as render.py serves a model: (scene, the
    flythrough's cameras, `frame(camera) -> (planes, 8-bit colour)`)."""
    from gsjax_torch.ops.raster import RasterConfig
    from gsjax_torch.ops.raster import render as port_render
    from gsjax_torch.ops.raster.camera import Camera

    scene = scenes.make_scene(cfg, seed, dev, scale, targets=False)
    model, _ = render_model(scene, cfg, dev)
    path = [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=dev)
            for v in scenes.flythrough(cfg, int(traffic["path_frames"]), scale)]
    rcfg = RasterConfig(sh_degree=cfg["sh_degree"], sg_degree=cfg["sg_degree"],
                        kernel_size=cfg["kernel_size"], require_depth=True,
                        max_per_tile=int(traffic["max_per_tile"]))
    bg = ref_loop.background(cfg, dev)

    @torch.no_grad()
    def frame(cam):
        out = port_render(camera=cam, cfg=rcfg, bg=bg, **model)
        u8 = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8).contiguous().cpu().numpy()
        return out, u8

    return scene, path, frame


def _planes(out) -> dict:
    return {k: out[k].clone() for k in ("render", "alpha", "normal", "median_depth")}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, scale: float = 1.0) -> drivers.Run:
    drivers.options(cfg, APPLIED)
    drivers.environment(cfg)
    dev = torch.device(device)
    phases = {"start": time.time() - t_start}
    build = drivers.build_kernels(dev, KERNELS)
    phases["built"] = time.time() - t_start
    scene, path, frame = serving(cfg, traffic, seed, dev, scale)
    phases["scene"] = time.time() - t_start
    cap = int(traffic["max_per_tile"])
    start, keep_at = positions(traffic, seed)
    window = int(traffic["checked_within"])

    for i in range(int(traffic["warmup_frames"])):
        out, _ = frame(path[(start + i) % len(path)])
    scene_counts = {"visible_gaussians": int(out["visibility"].sum()),
                    "depth_valid_pixels": int((out["median_depth"] > 0).sum()),
                    "live_pairs": out["num_live_pairs"], "max_tile_count": out["max_tile_count"]}
    drivers.sync(dev)
    setup_s = time.time() - t_start

    kept, lat, tiles = {}, [], []
    frames = failed = reserved = 0
    reduced = counts = None

    def one(i):
        nonlocal failed
        idx = (start + i) % len(path)
        t0 = time.perf_counter()
        try:
            out, u8 = frame(path[idx])
        except Exception as e:  # a failed frame counts against the run
            failed += 1
            print(f"frame {i} failed: {type(e).__name__}: {e}", flush=True)
            return
        lat.append(time.perf_counter() - t0)
        tiles.append(out["max_tile_count"])
        if i in keep_at:
            kept[idx] = _planes(out)

    if not trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or frames < window:
            one(frames)
            frames += 1
        window_s = time.perf_counter() - t0
        values = {"render_ms_p95": statistics.quantiles(lat, n=100)[94] * 1e3 if len(lat) > 1
                  else float("nan"),
                  "render_frames_per_s": frames / window_s, "setup_s": setup_s}
    else:
        n = max(int(traffic["trace_frames"]), window)
        # the capture keeps every traced launch's planes until the trace has
        # closed: the same frames captured once untraced first, and a free
        # segment half as large again as what they kept, grow the caching
        # allocator, so the traced window allocates nothing new
        warm = []
        with capture.launches(warm, only={"blend_fwd"}):
            for i in range(n):
                frame(path[(start + i) % len(path)])
        grown = drivers.kept_bytes(warm)
        del warm
        reserved = drivers.reserve(RESERVE * grown, dev)
        drivers.sync(dev)
        rec = []

        def window_frames():
            nonlocal frames
            for _ in range(n):
                one(frames)
                frames += 1

        with capture.launches(rec, only={"blend_fwd"}):
            reduced = trace_lib.traced(window_frames, dev)
        values = {"setup_s": setup_s}
        launches = drivers.step_counts(rec)
        del rec
        alive = int(scene.alive.sum())
        kernel_ops = sum(x["ops"] for x in launches)
        counts = {"launches": launches, "units": frames,
                  "ops": kernel_ops + frames * work.frame_ops(0.0, alive, cfg["sh_degree"],
                                                              cfg["sg_degree"])}
    peak = drivers.peak(dev)
    notes = {"frames": frames, "max_tile_count": max(tiles or [0]), **build,
             "reserved_bytes": reserved,
             "frames_over_cap": sum(1 for t in tiles if t > cap),
             "latency_ms_median": statistics.median(lat) * 1e3 if lat else None,
             "scene_counts": scene_counts}
    del frame, path, scene
    drivers.free(dev)
    t_ref = time.perf_counter()
    numbers = compare(kept, reference(cfg, traffic, seed, dev, scale))
    phases["reference_s"] = time.perf_counter() - t_ref
    notes["phases"] = phases
    return drivers.Run(setup_s, values, frames, failed, peak, numbers, notes, reduced, counts)


def reference(cfg, traffic, seed, dev, scale, round_to=None) -> dict:
    """The reference's frames at the checked path positions."""
    scene = scenes.make_scene(cfg, seed, dev, scale, targets=False)
    params, aux, _ = ref_loop.model(scene, dev)
    path = ref_loop.path_cameras(cfg, int(traffic["path_frames"]), scale, dev)
    return {idx: ref_loop.render_frame(params, aux, path[idx], cfg,
                                       int(traffic["max_per_tile"]), round_to=round_to)
            for idx in positions(traffic, seed)[1].values()}


def compare(kept: dict, ref: dict, detail: dict | None = None) -> dict:
    """The numbers that compare the kept frames with the reference's; a
    checked frame the program did not keep counts as missing."""
    rows = [check.plane_numbers(kept[idx], planes) for idx, planes in ref.items()
            if idx in kept]
    out = check.worst(rows) if rows else {k: 1.0 for k in check.PLANES}
    out["frames_missing"] = float(sum(1 for idx in ref if idx not in kept))
    return out


def readings(cfg, traffic, seed, dev, scale: float = 1.0) -> dict:
    """The program's frames at the checked path positions alone (no
    window), for calibration."""
    drivers.build_kernels(dev, KERNELS)
    _, path, frame = serving(cfg, traffic, seed, dev, scale)
    return {idx: _planes(frame(path[idx])[0]) for idx in positions(traffic, seed)[1].values()}


def control(cfg, traffic, seed, dev, scale: float = 1.0, round_to: str = "bfloat16") -> dict:
    """The checked frames of the reference computed at `round_to`, in the
    program's place."""
    return reference(cfg, traffic, seed, dev, scale, round_to=round_to)

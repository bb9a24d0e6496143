"""The `train` driver: a closed loop of the port's `Trainer.step()` on the
generated scene, the trainer set at the traffic's start iteration with full
SH/SG, its views drawn by the loop's own `random.choice`, seeded from
`--seed`. Set-up runs the first `checked_steps` steps through that same
trainer; the reference follows them once the window has closed.

Compared: each step's loss and multi-view terms and its view draws, the
first step's B1 planes, and by the worst leaf both the norm of the
parameters' change over the checked steps and the change itself, each over
the elements whose first reference gradient is above the round-off floor
of its row (`check.py`).
"""

from __future__ import annotations

import random
import shutil
import tempfile
import time
import types

import numpy as np
import torch

from gsbench import capture, check, drivers, scenes
from gsbench import trace as trace_lib
from gsbench.counts import work
from gsbench.reference import loop as ref_loop

ADAM_B1 = 0.9     # the port's adam_update default (model/gaussians.py)
RESERVE = 1.5     # the traced window's free segment over what its warm-up kept
KERNELS = ("blend_fwd", "blend_bwd", "sample_fwd", "sample_bwd", "warp_sample")
# the faults a training cell can have (control.fault plants them)
FAULTS = ("unchanged", "half_batch", "altered", "b2_scaled", "grad_sign")
# the options of the program this driver applies, and the values the
# reference follows (None: any); anything else in a configuration is refused
APPLIED = {"sh_degree": None, "sg_degree": None, "kernel_size": None,
           "white_background": None, "optimization": None, "multi_view_num": None,
           "multi_view_max_angle": None, "multi_view_min_dis": None,
           "multi_view_max_dis": None, "use_decoupled_appearance": (0,),
           "disable_filter3d": (False,), "random_background": (False,), "environment": None}
APPEARANCE = {0: "no"}    # use_decoupled_appearance -> the port's appearance kind


def build_trainer(scene, cfg: dict, traffic: dict, device, model_dir: str, seed: int):
    """The port's Trainer on the generated scene with every option the
    configuration states: the views as the reader makes them (host float32
    frames, their luma cached), the neighbour graph as training builds it,
    the leaves as the model's parameters."""
    from gsjax_torch.data.readers import SceneInfo, SceneView, build_nearest_view_graph
    from gsjax_torch.model import appearance as app_lib
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.train.loop import Trainer

    drivers.options(cfg, APPLIED)
    drivers.environment(cfg)
    views = []
    for v in scene.views:
        sv = SceneView(uid=v.uid, image_name=f"view_{v.uid:04d}", R=v.R, T=v.T,
                       fovx=v.fovx, fovy=v.fovy, image=scene.images[v.uid], mask=None,
                       width=v.width, height=v.height, device=device)
        sv._gray = scene.grays[v.uid]
        views.append(sv)
    build_nearest_view_graph(views, cfg["multi_view_max_angle"], cfg["multi_view_min_dis"],
                             cfg["multi_view_max_dis"], cfg["multi_view_num"])
    info = SceneInfo(points=np.zeros((0, 3), np.float32), colors=np.zeros((0, 3), np.float32),
                     train_views=views, test_views=[], radius=scene.radius, ply_path="")
    params = gm.GaussianParams(**{k: scene.params[k] for k in gm.PARAM_FIELDS})
    zeros = torch.zeros(scene.capacity, device=device)
    aux = gm.GaussianAux(alive=scene.alive, filter_3d=zeros, grad_accum=zeros.clone(),
                         grad_accum_abs=zeros.clone(), denom=zeros.clone(),
                         max_radii=torch.zeros(scene.capacity, dtype=torch.int32,
                                               device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    app = app_lib.init_appearance(APPEARANCE[cfg.get("use_decoupled_appearance", 0)],
                                  len(views), torch.Generator().manual_seed(gen.initial_seed()),
                                  device)
    t = Trainer(scene=info, params=params, aux=aux, adam=gm.adam_init(params),
                opt=types.SimpleNamespace(**cfg["optimization"]), model_path=model_dir,
                device=device, kernel_size=cfg["kernel_size"],
                white_background=cfg["white_background"],
                disable_filter3d=bool(cfg.get("disable_filter3d", False)),
                random_background=bool(cfg.get("random_background", False)),
                sh_degree=cfg["sh_degree"], sg_degree=cfg["sg_degree"],
                active_sh=cfg["sh_degree"], active_sg=cfg["sg_degree"],
                max_per_tile=int(traffic["initial_max_per_tile"]),
                iteration=int(traffic["start_iteration"]), generator=gen, app=app)
    t.refresh_filter3d()
    return t


def initial_leaves(cfg: dict, scene, seed: int, device) -> dict:
    """The generator's leaves again, from the seed (drawn first, so the
    same draws)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    leaves, _ = scenes.make_gaussians(cfg, scene.n, scene.capacity, gen, device, scene.views)
    return leaves


def _images(planes) -> dict:
    from gsbench.reference import render_ref

    img = render_ref.planes_to_images(planes)
    return {"render": img["color"], "alpha": img["alpha"], "normal": img["normal"],
            "median_depth": img["median_depth"]}


def _changes(params, p0: dict) -> dict:
    """Each leaf's change since `p0`, on the host (kept there while the
    program's state is freed)."""
    return {k: (getattr(params, k).detach() - p0[k]).cpu() for k in p0}


def program(cfg: dict, traffic: dict, seed: int, dev, scale: float, model_dir: str,
            phases: dict | None = None, t_start: float = 0.0):
    """Set-up of a training cell: the scene, the trainer, and its first
    `checked_steps` steps through `Trainer.step()`, with what the check
    compares (`prog`: each step's loss, multi-view terms and views, the
    first step's B1 planes and gradient norms, the parameters' change).
    Returns (scene, trainer, prog)."""
    phases = {} if phases is None else phases
    scene = scenes.make_scene(cfg, seed, dev, scale)
    phases["scene"] = time.time() - t_start
    trainer = build_trainer(scene, cfg, traffic, dev, model_dir, seed)
    phases["trainer"] = time.time() - t_start
    random.seed(seed)
    prog = {"loss": [], "ncc": [], "geo": [], "view": [], "near": [], "attempts": []}
    for i in range(int(traffic["checked_steps"])):
        rec = []
        with capture.launches(rec, only={"blend_fwd"}):
            m = trainer.step()
        if i == 0:
            prog["planes"] = _images(rec[-1][3])
            prog["grad"] = check.leaf_norms(
                {k: v / (1 - ADAM_B1) for k, v in trainer.adam.mu.items()})
            prog["scene_counts"] = {
                "visible_gaussians": int((trainer.aux.max_radii > 0).sum()),
                "depth_valid_pixels": int((prog["planes"]["median_depth"] > 0).sum()),
                "live_pairs": m["num_live_pairs"], "max_tile_count": m["max_tile_count"],
                "mv_queries": m["mv_queries"]}
        for k, key in (("loss", "loss"), ("ncc", "ncc_loss"), ("geo", "geo_loss"),
                       ("view", "view"), ("near", "near"), ("attempts", "attempts")):
            prog[k].append(m[key])
        del rec
    p0 = initial_leaves(cfg, scene, seed, dev)
    prog["delta"] = _changes(trainer.params, p0)
    del p0
    return scene, trainer, prog


def _step(trainer, metrics_seen: list, n: int) -> int:
    """Step `trainer`; a failed step counts against the run. Returns 1 if
    the step failed."""
    try:
        metrics_seen.append(trainer.step())
        return 0
    except Exception as e:
        print(f"step {n} failed: {type(e).__name__}: {e}", flush=True)
        return 1


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, scale: float = 1.0) -> drivers.Run:
    dev = torch.device(device)
    model_dir = tempfile.mkdtemp(prefix="gsbench_model_")
    try:
        phases = {"start": time.time() - t_start}
        build = drivers.build_kernels(dev, KERNELS)
        phases["built"] = time.time() - t_start
        scene, trainer, prog = program(cfg, traffic, seed, dev, scale, model_dir, phases,
                                       t_start)
        drivers.sync(dev)
        setup_s = time.time() - t_start

        steps = failed = reserved = 0
        metrics_seen = []
        reduced, counts = None, None
        if not trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                steps += 1
                failed += _step(trainer, metrics_seen, steps)
            drivers.sync(dev)
            window_s = time.perf_counter() - t0
            values = {"train_step_ms": window_s / steps * 1e3, "setup_s": setup_s}
        else:
            n = int(traffic["trace_steps"])
            # the capture keeps every traced launch's inputs until the trace
            # has closed: the same steps captured once untraced first, and a
            # free segment half as large again as what they kept, grow the
            # caching allocator, so the traced window allocates nothing new
            warm, warm_seen = [], []
            with capture.launches(warm):
                for _ in range(n):
                    steps += 1
                    failed += _step(trainer, warm_seen, steps)
            grown = drivers.kept_bytes(warm)
            del warm, warm_seen
            reserved = drivers.reserve(RESERVE * grown, dev)
            drivers.sync(dev)
            rec = []

            def window():
                nonlocal steps, failed
                for _ in range(n):
                    steps += 1
                    failed += _step(trainer, metrics_seen, steps)

            with capture.launches(rec):
                reduced = trace_lib.traced(window, dev)
            values = {"setup_s": setup_s}
            launches = drivers.step_counts(rec)
            del rec
            alive = int(scene.alive.sum())
            m_sh = (cfg["sh_degree"] + 1) ** 2
            floats = 3 + 3 * m_sh + 1 + 3 + 4 + 7 * cfg["sg_degree"]
            pixels = scene.views[0].width * scene.views[0].height
            step_ops = sum(x["ops"] for x in launches) + sum(
                work.step_ops(0.0, alive, floats, pixels, cfg["sh_degree"], cfg["sg_degree"],
                              m.get("near") is not None) for m in metrics_seen)
            counts = {"launches": launches, "units": len(metrics_seen), "ops": step_ops,
                      "mv_queries": [m["mv_queries"] for m in metrics_seen]}
        peak = drivers.peak(dev)
        notes = {"steps": steps, "max_per_tile": trainer.max_per_tile,
                 "attempts": max(prog["attempts"]), **build, "reserved_bytes": reserved,
                 "live_pairs": [m["num_live_pairs"] for m in metrics_seen[:5]],
                 "max_tile_count": max([m["max_tile_count"] for m in metrics_seen] or [0]),
                 "mv_queries": [m["mv_queries"] for m in metrics_seen[:5]],
                 "first_losses": prog["loss"], "scene_counts": prog["scene_counts"]}
        del trainer, metrics_seen, scene
        drivers.free(dev)

        t_ref = time.perf_counter()
        numbers = compare(prog, reference(cfg, traffic, seed, dev, scale))
        phases["reference_s"] = time.perf_counter() - t_ref
        notes["phases"] = phases
        return drivers.Run(setup_s, values, steps, failed, peak, numbers, notes, reduced,
                           counts)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


def reference(cfg, traffic, seed, dev, scale, round_to=None) -> dict:
    """The reference's first `checked_steps` steps from the same inputs:
    each step's metrics, the first step's gradient (its norms, and every
    element's |g|, `grad_abs`, which `check.above_floor` reads) and B1
    planes, and the parameters' change, all on the reference's device."""
    scene = scenes.make_scene(cfg, seed, dev, scale)
    p0 = {k: v.clone() for k, v in scene.params.items()}
    ref = {}
    n = int(traffic["checked_steps"])

    def on_step(i, params, adam, m):
        if i == 0:
            grad = {k: v / (1 - ADAM_B1) for k, v in adam.mu.items()}
            ref["grad"] = check.leaf_norms(grad)
            ref["grad_abs"] = {k: g.abs() for k, g in grad.items()}
            ref["planes"] = m.pop("images")
        m.pop("images", None)
        if i == n - 1:
            ref["delta"] = {k: getattr(params, k).detach() - p0[k] for k in p0}

    ref["steps"] = ref_loop.train_steps(scene, cfg, traffic, seed, n, dev, round_to=round_to,
                                        on_step=on_step)
    return ref


def compare(prog: dict, ref: dict, detail: dict | None = None) -> dict:
    """The numbers that compare the program's first steps with the
    reference's; `detail`, when given, gets each leaf's gaps and each step's
    losses on both sides."""
    steps = ref["steps"]
    numbers = {
        "draws_differ": float(any(a != m["view"] or b != m["near"] for a, b, m in
                                  zip(prog["view"], prog["near"], steps))),
        "loss_gap": max(check.rel_gap(a, m["loss"]) for a, m in zip(prog["loss"], steps)),
        "ncc_gap": max(check.rel_gap(a, m["ncc_loss"]) for a, m in zip(prog["ncc"], steps)),
        "geo_gap": max(check.rel_gap(a, m["geo_loss"]) for a, m in zip(prog["geo"], steps)),
    }
    keep = check.above_floor(ref["grad_abs"])
    numbers["change_norm_gap"], numbers["change_dir_gap"] = check.change_gaps(
        prog["delta"], ref["delta"], keep, ref["grad"])
    numbers.update(check.plane_numbers(prog["planes"], ref["planes"]))
    if detail is not None:
        p, r = check.kept(prog["delta"], keep), check.kept(ref["delta"], keep)
        detail.update(grad=check.leaf_gaps(prog["grad"], ref["grad"], ref["grad"]),
                      change=check.leaf_gaps(check.leaf_norms(p), check.leaf_norms(r),
                                             ref["grad"]),
                      direction=check.dir_gaps(p, r, ref["grad"]),
                      rules=_floor_rules(prog["delta"], ref),
                      ref_grad=ref["grad"], ref_change=check.leaf_norms(r),
                      loss=[prog["loss"], [m["loss"] for m in steps]],
                      ncc=[prog["ncc"], [m["ncc_loss"] for m in steps]])
    return numbers


def _floor_rules(prog_delta: dict, ref: dict) -> dict:
    """For calibration: [change_norm_gap, change_dir_gap] and each leaf's
    share of its elements with a nonzero first reference gradient that are
    left out, under no floor (`none`), under floors of the row (`row`,
    `check.above_floor`), and under a floor of the leaf's largest |g|
    (`leaf`), which leaves out half the geometric leaves' elements."""
    first = ref["grad_abs"]
    dev = next(iter(first.values())).device
    pd = {k: v.to(dev) for k, v in prog_delta.items()}
    rules = {"none:0": {k: torch.ones_like(a, dtype=torch.bool) for k, a in first.items()},
             "leaf:1e-06": {k: a >= 1e-6 * a.max() for k, a in first.items()}}
    rules.update({f"row:{f:g}": check.above_floor(first, f) for f in (1e-6, 1e-5, 1e-4)})
    out = {}
    for name, keep in rules.items():
        left = {k: float(((a > 0) & ~keep[k]).sum()) / max(float((a > 0).sum()), 1)
                for k, a in first.items()}
        out[name] = {"gaps": check.change_gaps(pd, ref["delta"], keep, ref["grad"]),
                     "left_out": left}
    return out


def readings(cfg, traffic, seed, dev, scale: float = 1.0) -> dict:
    """The program's checked steps alone (no window), for calibration."""
    model_dir = tempfile.mkdtemp(prefix="gsbench_cal_")
    try:
        drivers.build_kernels(dev, KERNELS)
        _, trainer, prog = program(cfg, traffic, seed, dev, scale, model_dir)
        del trainer
        drivers.free(dev)
        return prog
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


def control(cfg, traffic, seed, dev, scale: float = 1.0, round_to: str = "bfloat16") -> dict:
    """The readings of the reference computed at `round_to`, in the
    program's place."""
    scene = scenes.make_scene(cfg, seed, dev, scale)
    p0 = {k: v.clone() for k, v in scene.params.items()}
    prog = {"loss": [], "ncc": [], "geo": [], "view": [], "near": []}

    def on_step(i, params, adam, m):
        if i == 0:
            prog["grad"] = check.leaf_norms(
                {k: v / (1 - ADAM_B1) for k, v in adam.mu.items()})
            prog["planes"] = m["images"]
        prog["delta"] = _changes(params, p0)
        for k, key in (("loss", "loss"), ("ncc", "ncc_loss"), ("geo", "geo_loss"),
                       ("view", "view"), ("near", "near")):
            prog[k].append(m[key])
        m.pop("images", None)

    ref_loop.train_steps(scene, cfg, traffic, seed, int(traffic["checked_steps"]), dev,
                         round_to=round_to, on_step=on_step)
    return prog

# The loop of gsjax_torch/train/loop.py:Trainer.step (view draw, overflow
# retry, tile cap, learning rates) at commit 95f6082, written out again for
# the reference, and a frame as the render CLI renders it (gsjax_torch/render.py).
"""What the reference runs in the program's place: the first training steps
of a cell from the scene the benchmark made, or the frames of a flythrough.

It is handed the benchmark's inputs (the generator's leaves, cameras and
target frames, the configuration and the seed) and works out again what the
program derived from them: the 3D filter, the neighbour graph, the view
draws, the tile cap, the learning rates.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from gsbench.reference import gaussians as gm
from gsbench.reference import precision
from gsbench.reference import views as views_lib
from gsbench.reference.api import render
from gsbench.reference.camera import Camera
from gsbench.reference.config import RasterConfig
from gsbench.reference.schedules import expon_lr
from gsbench.reference.step import LossConfig, train_step

# tiles per batch of the twins' blend and point query on the card: the port's
# default is 128; a larger batch makes fewer, larger launches. On the CPU the
# port's own batch, so that the CPU twins and the reference sum alike.
TILE_BATCH = 512


def tile_batch(device) -> int:
    return TILE_BATCH if torch.device(device).type == "cuda" else RasterConfig.tile_batch


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def cameras(scene, device) -> list[Camera]:
    return [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=device)
            for v in scene.views]


def model(scene, device):
    """The generator's leaves as the reference's model, its 3D filter over
    the training cameras."""
    params = gm.GaussianParams(**{k: scene.params[k].to(device).clone()
                                  for k in gm.PARAM_FIELDS})
    alive = scene.alive.to(device)
    cams = cameras(scene, device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        filt = gm.compute_3d_filter(params.xyz, alive,
                                    torch.stack([c.world_view for c in cams]),
                                    f32([c.fx for c in cams]), f32([c.width for c in cams]),
                                    f32([c.height for c in cams]), f32([c.fy for c in cams]))
    zeros = torch.zeros(scene.capacity, device=device)
    aux = gm.GaussianAux(alive=alive, filter_3d=filt, grad_accum=zeros.clone(),
                         grad_accum_abs=zeros.clone(), denom=zeros.clone(),
                         max_radii=torch.zeros(scene.capacity, dtype=torch.int32,
                                               device=device))
    return params, aux, cams


def lrs(opt: dict, it: int, radius: float) -> dict:
    return dict(
        xyz=expon_lr(it, opt["position_lr_init"] * radius, opt["position_lr_final"] * radius,
                     lr_delay_mult=opt["position_lr_delay_mult"],
                     max_steps=opt["position_lr_max_steps"]),
        features_dc=opt["feature_dc_lr"], features_rest=opt["feature_rest_lr"],
        opacity=opt["opacity_lr"], scaling=opt["scaling_lr"], rotation=opt["rotation_lr"],
        sg_axis=opt["sg_axis_lr"], sg_sharpness=opt["sg_sharpness_lr"],
        sg_color=opt["sg_color"])


def background(cfg: dict, device) -> torch.Tensor:
    """The background the configuration states (white or black)."""
    return torch.full((3,), 1.0 if cfg.get("white_background") else 0.0, device=device)


def train_steps(scene, cfg: dict, traffic: dict, seed: int, steps: int, device,
                round_to=None, on_step=None) -> list[dict]:
    """The first `steps` steps of a training cell. `on_step(i, params, adam,
    metrics)` is called after each. Returns each step's metrics."""
    params, aux, cams = model(scene, device)
    adam = gm.adam_init(params)
    opt = cfg["optimization"]
    nearest = views_lib.nearest_view_graph(
        np.stack([v.center for v in scene.views]), np.stack([v.R for v in scene.views]),
        cfg["multi_view_max_angle"], cfg["multi_view_min_dis"], cfg["multi_view_max_dis"],
        cfg["multi_view_num"])
    rng = random.Random(seed)
    cap = int(traffic["initial_max_per_tile"])
    it = int(traffic["start_iteration"])
    bg = background(cfg, device)
    out = []
    for i in range(steps):
        it += 1
        v = rng.choice(range(len(cams)))     # random.choice(train_views)'s draw
        reg_on = it >= opt["regularization_from_iter"]
        near = None
        if reg_on and nearest[v] and (opt["lambda_multi_view_ncc"] > 0
                                      or opt["lambda_multi_view_geo"] > 0):
            near = rng.choice(nearest[v])
        lcfg = LossConfig(lambda_dssim=opt["lambda_dssim"],
                          lambda_depth_normal=opt["lambda_depth_normal"],
                          lambda_mv_ncc=opt["lambda_multi_view_ncc"],
                          lambda_mv_geo=opt["lambda_multi_view_geo"], reg_on=reg_on,
                          mv_on=near is not None,
                          pixel_noise_th=opt["multi_view_pixel_noise_th"],
                          patch_size=opt["multi_view_patch_size"])
        args = {}
        if near is not None:
            args = dict(near_cam=cams[near],
                        gray_r=torch.as_tensor(scene.grays[v], device=device),
                        gray_n=torch.as_tensor(scene.grays[near], device=device))
        gt = torch.as_tensor(scene.images[v], device=device)
        for attempt in range(1, 5):
            rcfg = RasterConfig(sh_degree=cfg["sh_degree"], sg_degree=cfg["sg_degree"],
                                kernel_size=cfg["kernel_size"], require_depth=reg_on,
                                max_per_tile=cap, tile_batch=tile_batch(device),
                                round_to=round_to)
            params, aux, adam, m = train_step(params, aux, adam, cams[v], gt, bg,
                                              lrs(opt, it, scene.radius), rcfg, lcfg, **args)
            if not m["overflowed"]:
                break
            cap = next_pow2(int(m["max_tile_count"] * 2.5))
        else:
            raise RuntimeError(f"reference step {i + 1}: tile lists exceed the cap {cap}")
        if int(m["max_tile_count"]) > 0.9 * cap:
            cap = next_pow2(int(m["max_tile_count"] * 2.5))
        m.update(view=v, near=near, attempts=attempt)
        if on_step is not None:
            on_step(i, params, adam, m)
        out.append(m)
    return out


def path_cameras(cfg: dict, n_frames: int, scale: float, device) -> list[Camera]:
    """The flythrough's cameras, from the benchmark's poses."""
    from gsbench import scenes

    return [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=device)
            for v in scenes.flythrough(cfg, n_frames, scale)]


@torch.no_grad()
def render_frame(params, aux, camera: Camera, cfg: dict, max_per_tile: int,
                 round_to=None) -> dict:
    """One flythrough frame as render.py renders it (require_depth, the
    CLI's tile cap, the configuration's background)."""
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    rcfg = RasterConfig(sh_degree=cfg["sh_degree"], sg_degree=cfg["sg_degree"],
                        kernel_size=cfg["kernel_size"], require_depth=True,
                        max_per_tile=max_per_tile, tile_batch=tile_batch(params.xyz.device),
                        round_to=round_to)
    st = lambda x: precision.stage(x, rcfg)
    out = render(st(params.xyz), st(scales), st(params.rotation), st(opac),
                 st(gm.get_features(params)), camera, rcfg,
                 background(cfg, params.xyz.device),
                 sg_axis=st(gm.get_sg_axis(params)),
                 sg_sharpness=st(gm.get_sg_sharpness(params)), sg_color=st(params.sg_color),
                 alive=aux.alive)
    return {k: out[k] for k in ("render", "alpha", "normal", "median_depth")}


def frame_u8(color: torch.Tensor) -> np.ndarray:
    """The 8-bit frame a viewer receives (gsjax_torch/train/loop.py:serve_viewer)."""
    return (torch.clamp(color, 0, 1) * 255).to(torch.uint8).contiguous().cpu().numpy()

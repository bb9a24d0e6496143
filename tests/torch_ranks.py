"""What the ranks of the multi-rank CPU tests run (`gsjax_torch.parallel.launch`
imports this module in each spawned rank, so it imports torch and the port
only: no JAX, which would slow every rank's start-up).

The scene is `tests/util.py`'s, rebuilt from the same seeded numpy draws:
`random_gaussians` and `look_at_camera` are copied here because tests/util.py
imports gsjax.
"""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.model import gaussians as gm
from gsjax_torch.ops.raster import RasterConfig
from gsjax_torch.ops.raster.api import render
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.parallel import shard
from gsjax_torch.train.step import LossConfig, train_step

LRS = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
           scaling=0.005, rotation=0.001, sg_axis=0.0, sg_sharpness=0.0, sg_color=0.0)


def random_gaussians(n: int, seed: int = 0, spread: float = 1.0, center_z: float = 4.0):
    """tests/util.py:random_gaussians."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (n, 3)).astype(np.float32)
    means[:, 2] += center_z
    scales = np.exp(rng.normal(-2.2, 0.4, (n, 3))).astype(np.float32)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opacities = (1 / (1 + np.exp(-rng.normal(0.5, 1.0, (n,))))).astype(np.float32)
    shs = rng.normal(0, 0.4, (n, 16, 3)).astype(np.float32)
    shs[:, 0] += 0.8
    return means, scales, q, opacities, shs


def camera_rt(angle=0.0):
    """tests/util.py:look_at_camera's (R, T)."""
    r = np.eye(3, dtype=np.float32)
    if angle:
        c, s = np.cos(angle), np.sin(angle)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return r, np.zeros(3, np.float32)


def camera(width=96, height=64, angle=0.0, fovx=0.9, fovy=0.7):
    return Camera.create(*camera_rt(angle), fovx, fovy, width, height, device="cpu")


def model_arrays(n=60, capacity=100, seed=2):
    """Seeded gsjax-layout leaves of a model with dead slots past n:
    ({field: array}, {aux field: array}) for `gm.params_from_numpy`."""
    means, scales, q, op, shs = random_gaussians(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    pad = lambda x: np.concatenate(
        [x, np.zeros((capacity - n,) + x.shape[1:], np.float32)]).astype(np.float32)
    params = dict(xyz=pad(means), features_dc=pad(shs[:, :1]), features_rest=pad(shs[:, 1:4]),
                  opacity=pad(np.log(op / (1 - op))[:, None]), scaling=pad(np.log(scales)),
                  rotation=pad(q), sg_axis=pad(rng.normal(0, 1, (n, 1, 3))),
                  sg_sharpness=pad(np.zeros((n, 1))), sg_color=pad(np.zeros((n, 1, 3))))
    params["rotation"][n:, 0] = 1.0
    aux = dict(alive=np.arange(capacity) < n, filter_3d=np.full(capacity, 0.005, np.float32),
               grad_accum=np.zeros(capacity, np.float32),
               grad_accum_abs=np.zeros(capacity, np.float32),
               denom=np.zeros(capacity, np.float32), max_radii=np.zeros(capacity, np.int32))
    return params, aux


def config(require_depth=True, **kw):
    return RasterConfig(tile=32, chunk=128, max_per_tile=256, sh_degree=1,
                        require_depth=require_depth, backend="torch", **kw)


def render_model(params, aux, cam, cfg, bg):
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    with torch.no_grad():
        return render(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                      cam, cfg, bg, sg_axis=gm.get_sg_axis(params),
                      sg_sharpness=gm.get_sg_sharpness(params),
                      sg_color=params.sg_color, alive=aux.alive)


def setup(width=96, height=64, require_depth=True, seed=2):
    """(camera, cfg, bg, params, aux, adam, gt): tests/test_sharding.py's
    `_setup` on the port, the gt the model's own render plus seeded noise."""
    cam = camera(width, height)
    cfg = config(require_depth)
    bg = torch.zeros(3)
    params, aux = gm.params_from_numpy(*model_arrays(seed=seed), "cpu")
    noise = np.random.default_rng(0).normal(0, 0.1, (height, width, 3)).astype(np.float32)
    gt = torch.clamp(render_model(params, aux, cam, cfg, bg)["render"] + torch.as_tensor(noise),
                     0, 1)
    return cam, cfg, bg, params, aux, gm.adam_init(params), gt


def state_arrays(params, aux, adam) -> dict:
    """The model, statistics and Adam moments as numpy, for comparison."""
    p, a = gm.params_to_numpy(params, aux)
    out = {f"params.{k}": v for k, v in p.items()}
    out.update({f"aux.{k}": v for k, v in a.items()})
    out.update({f"mu.{k}": adam.mu[k].detach().numpy() for k in gm.PARAM_FIELDS})
    out.update({f"nu.{k}": adam.nu[k].detach().numpy() for k in gm.PARAM_FIELDS})
    return out


def step_case(case: dict):
    """One step of the case on this process: single (no group) or sharded
    (under the launcher's group) -> (metrics without tensors, state arrays,
    app grads)."""
    kind = case.get("appearance", "no")
    cam, cfg, bg, params, aux, adam, gt = setup(case.get("width", 96), case.get("height", 64),
                                                case.get("require_depth", True))
    lc = LossConfig(reg_on=case.get("reg_on", False), mv_on=case.get("mv_on", False),
                    appearance=kind)
    kw = {}
    if case.get("mv_on"):
        near = camera(cam.width, cam.height, angle=0.12)
        gray = torch.clamp(render_model(params, aux, cam, cfg, bg)["render"], 0, 1).mean(-1)
        kw = dict(near_cam=near, gray_r=gray, gray_n=gray)
    if kind != "no":
        from gsjax_torch.model import appearance as app_lib

        app = app_lib.init_appearance(kind, 4, torch.Generator().manual_seed(0), "cpu")
        kw = dict(app_embedding=app.table[1], app_net=app.net)
    if case.get("sharded"):
        p2, a2, ad2, m = shard.train_step_sharded(
            params, aux, adam, cam, gt, bg, LRS, cfg, lc, row_bounds=case.get("bounds"),
            band_pair=case.get("pair"), **kw)
    else:
        p2, a2, ad2, m = train_step(params, aux, adam, cam, gt, bg, LRS, cfg, lc, **kw)
    grads = {}
    if m.get("app_grad") is not None:
        grads["app_grad"] = m["app_grad"].detach().numpy()
    if m.get("app_net_grad") is not None:
        grads.update({f"net.{k}.{kk}": v.detach().numpy()
                      for k, d in m["app_net_grad"].items() for kk, v in d.items()})
    plain = {k: v for k, v in m.items() if k not in ("app_grad", "app_net_grad")}
    return plain, state_arrays(p2, a2, ad2), grads


def rank_step(rank, case):
    """A rank's sharded step of `case`."""
    return step_case(dict(case, sharded=True))


def rank_steps(rank, cases):
    """A rank's sharded step of each of `cases` ({name: case})."""
    return {name: rank_step(rank, case) for name, case in cases.items()}


def rank_train(rank, argv, base):
    """The training CLI's `main` on a rank, with its model directory
    `base/<rank>` (`{out}` in argv) -> (state arrays, iteration, ranks)."""
    import os

    from gsjax_torch.train import main

    out = os.path.join(base, str(rank))
    trainer = main([a.replace("{out}", out) for a in argv])
    return (state_arrays(trainer.params, trainer.aux, trainer.adam), trainer.iteration,
            trainer.n_ranks)


def rank_render(rank, case):
    """A rank's `render_sharded` and `render_views_sharded` of the case's
    model -> numpy outputs."""
    cam, cfg, bg, params, aux, _, _ = setup(case.get("width", 96), case.get("height", 64))
    one = shard.render_sharded(params, aux, cam, cfg, bg, row_bounds=case.get("bounds"),
                               band_pair=case.get("pair"))
    cams = [camera(cam.width, cam.height, angle=a) for a in case.get("angles", ())]
    views = shard.render_views_sharded(params, aux, cams, cfg, bg) if cams else {}
    return ({k: v.numpy() for k, v in one.items()},
            {k: v.numpy() for k, v in views.items()})


def rank_renders(rank, cases):
    """`rank_render` of each case in `cases`."""
    return [rank_render(rank, case) for case in cases]


def single_render(case):
    cam, cfg, bg, params, aux, _, _ = setup(case.get("width", 96), case.get("height", 64))
    outs = [render_model(params, aux, cam, cfg, bg)]
    outs += [render_model(params, aux, camera(cam.width, cam.height, angle=a), cfg, bg)
             for a in case.get("angles", ())]
    return [{k: v.numpy() for k, v in o.items() if torch.is_tensor(v)} for o in outs]


def rank_sum(rank, k):
    """(rank, the sum over ranks of rank + k through an all-reduce)."""
    import torch.distributed as dist

    t = torch.tensor([rank + k])
    dist.all_reduce(t)
    return rank, int(t)


def rank_fail(rank, bad):
    """Rank `bad` raises; the others wait in an all-reduce it never joins."""
    import torch.distributed as dist

    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))


def rank_sleep(rank, seconds):
    import time

    time.sleep(seconds)


def rank_payloads(rank, cases):
    """The collectives one sharded step of each of `cases` calls, recorded
    at `torch.distributed`: per case [(op, bytes)], an all-gather by its
    output's bytes, an all-reduce by its buffer's."""
    import torch.distributed as dist

    seen, orig = [], (dist.all_gather, dist.all_reduce)

    def gather(parts, x, *a, **k):
        seen.append(("all_gather", x.numel() * x.element_size() * len(parts)))
        return orig[0](parts, x, *a, **k)

    def reduce(t, *a, **k):
        seen.append(("all_reduce", t.numel() * t.element_size()))
        return orig[1](t, *a, **k)

    out = []
    dist.all_gather, dist.all_reduce = gather, reduce
    try:
        for case in cases:
            seen.clear()
            step_case(dict(case, sharded=True))
            out.append(list(seen))
    finally:
        dist.all_gather, dist.all_reduce = orig
    return out

"""The training loop (port of `gsjax/train/loop.py`: `Trainer`, `run_training`).

Mirrors `training()` (train.py:41-270) on one device: camera sampling with
Python's `random` (seeded as train.py:50-54, so the port visits the same
views in the same order as gsjax), the SH/SG degree schedule, the
densification and opacity-reset schedule, the 3D-filter refresh, test
evaluation, PLY snapshots and checkpoints.

gsjax's XLA capacity buckets (pair_capacity, live_capacity, the multi-view
buckets, their recompiles) do not exist here: the port sizes its pair
buffers from the real counts. `max_per_tile` is a semantic clamp, so its
watermark bump and the loss-free overflow retry stay: no step trains on a
truncated list. The gaussian capacity grows as gsjax's does, since
densification writes new gaussians into free slots.

With regularisation on, a view with neighbours draws one of them exactly
where gsjax does (loop.py:388-393) and the step adds the multi-view losses;
the luma frames are cached on the device beside the gt frames.
`GSJAX_NCC_COMPACT=1` (read, as gsjax reads it, only when a neighbour is
drawn; default 0) runs the NCC on the compacted 16x16 blocks of the
geometric mask. gsjax sizes those blocks by a capacity bucket; the port
compacts to the real count and needs none.

`--use_decoupled_appearance 1|2|3` (gs, gof, pgsr) trains a per-view
appearance model: the step maps the render before its L1 term, and after
the step the loop takes a whole-table Adam step of the embeddings (and, for
gof, of the CNN) at gsjax's learning rates (loop.py:537-554). Checkpoints
carry its state under `x_app/...`, as gsjax's, and `--start_checkpoint`
restores it.

Not ported (each raises when asked for): sharding and multi-host, the SIBR
viewer server, the NaN probe, the debug mosaics, TensorBoard and the
profiler trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time

import numpy as np
import torch

from gsjax_torch.data.readers import (SceneInfo, build_nearest_view_graph,
                                      load_scene, write_scene_artifacts)
from gsjax_torch.model import appearance as app_lib
from gsjax_torch.model import gaussians as gm
from gsjax_torch.model.io import load_checkpoint, save_checkpoint, save_ply
from gsjax_torch.ops.knn import mean_knn_dist2
from gsjax_torch.ops.raster import RasterConfig, render
from gsjax_torch.train import losses
from gsjax_torch.train.step import LossConfig, train_step
from gsjax_torch.utils.schedules import expon_lr

APPEARANCE_KINDS = {0: "no", 1: "gs", 2: "gof", 3: "pgsr"}


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


@dataclasses.dataclass
class Trainer:
    scene: SceneInfo
    params: gm.GaussianParams
    aux: gm.GaussianAux
    adam: gm.AdamState
    opt: object                # OptimizationParams namespace
    model_path: str
    device: torch.device
    kernel_size: float = 0.0
    white_background: bool = False
    disable_filter3d: bool = False
    sh_degree: int = 3
    sg_degree: int = 0
    active_sh: int = 0
    active_sg: int = 0
    max_per_tile: int = 1 << 10
    iteration: int = 0
    generator: torch.Generator | None = None
    app: app_lib.AppearanceState = dataclasses.field(
        default_factory=lambda: app_lib.init_appearance("no", 0))
    random_background: bool = False
    # device-resident gt and luma frames, LRU bounded in bytes
    gt_cache_bytes: int = 512 * 1024 * 1024
    _gt_cache: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(scene: SceneInfo, opt, model_path, device, sh_degree=3, sg_degree=0,
               kernel_size=0.0, white_background=False, disable_filter3d=False,
               seed=0, appearance="no"):
        device = torch.device(device)
        knn = mean_knn_dist2(scene.points)
        capacity = next_pow2(int(scene.points.shape[0] * 1.5) + 1)
        params, aux = gm.init_from_pcd(scene.points, scene.colors, capacity,
                                       sh_degree, sg_degree, knn, seed=seed,
                                       device=device)
        # per-camera max-scale clamp 0.05 * dist (scene/__init__.py:125-131)
        scaling = params.scaling.detach().cpu().numpy()
        xyz = params.xyz.detach().cpu().numpy()
        for v in scene.train_views:
            d = np.linalg.norm(xyz - v.camera_center[None, :], axis=1)
            scaling = np.minimum(scaling, np.log(np.maximum(0.05 * d, 1e-12))[:, None])
        with torch.no_grad():
            params.scaling.copy_(torch.as_tensor(scaling, dtype=torch.float32))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        app = app_lib.init_appearance(appearance, len(scene.train_views),
                                      torch.Generator().manual_seed(seed), device)
        t = Trainer(scene=scene, params=params, aux=aux, adam=gm.adam_init(params),
                    opt=opt, model_path=model_path, device=device,
                    kernel_size=kernel_size, white_background=white_background,
                    disable_filter3d=disable_filter3d, sh_degree=sh_degree,
                    sg_degree=sg_degree, generator=gen, app=app)
        t.refresh_filter3d()
        return t

    # --- helpers -------------------------------------------------------------

    def refresh_filter3d(self):
        if self.disable_filter3d:
            filt = torch.zeros(self.params.capacity, device=self.device)
        else:
            views = self.scene.train_views
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            with torch.no_grad():
                filt = gm.compute_3d_filter(
                    self.params.xyz, self.aux.alive,
                    torch.stack([v.camera.world_view for v in views]),
                    f32([v.camera.fx for v in views]), f32([v.width for v in views]),
                    f32([v.height for v in views]), f32([v.camera.fy for v in views]))
        self.aux = dataclasses.replace(self.aux, filter_3d=filt)

    def raster_cfg(self, require_depth: bool) -> RasterConfig:
        return RasterConfig(sh_degree=self.active_sh, sg_degree=self.active_sg,
                            kernel_size=self.kernel_size, require_depth=require_depth,
                            max_per_tile=self.max_per_tile)

    def lrs(self):
        o = self.opt
        sp = self.scene.radius
        return dict(
            xyz=expon_lr(self.iteration, o.position_lr_init * sp,
                         o.position_lr_final * sp,
                         lr_delay_mult=o.position_lr_delay_mult,
                         max_steps=o.position_lr_max_steps),
            features_dc=o.feature_dc_lr, features_rest=o.feature_rest_lr,
            opacity=o.opacity_lr, scaling=o.scaling_lr, rotation=o.rotation_lr,
            sg_axis=o.sg_axis_lr, sg_sharpness=o.sg_sharpness_lr,
            sg_color=o.sg_color)

    def bg(self):
        fill = 1.0 if self.white_background else 0.0
        return torch.full((3,), fill, device=self.device)

    def _cached(self, key, make):
        """The device frame under `key`, made by `make()` on a miss; the
        cache evicts least recently used frames beyond gt_cache_bytes."""
        cached = self._gt_cache.pop(key, None)        # pop + reinsert = LRU
        if cached is None:
            cached = make()
            held = sum(t.numel() * t.element_size() for t in self._gt_cache.values())
            need = cached.numel() * cached.element_size()
            while self._gt_cache and held + need > self.gt_cache_bytes:
                old = self._gt_cache.pop(next(iter(self._gt_cache)))
                held -= old.numel() * old.element_size()
        self._gt_cache[key] = cached
        return cached

    def gt_for(self, view):
        """Masked / bg-composited gt frame on the device, LRU-cached (masked
        scenes compose with the static background, as the reference)."""
        def make():
            img = torch.as_tensor(view.image, device=self.device)
            if view.mask is None:
                return img
            m = torch.as_tensor((view.mask > 0.5).astype(np.float32),
                                device=self.device)[..., None]
            return img * m + self.bg()[None, None, :] * (1 - m)
        return self._cached((view.image_name, "rgb"), make)

    def gray_for(self, view):
        """Luma frame of the unmasked image on the device (the NCC's input)."""
        return self._cached((view.image_name, "gray"),
                            lambda: torch.as_tensor(view.gray, device=self.device))

    def monitor_capacity(self, metrics):
        """Raise max_per_tile near its watermark (gsjax loop.py:329-332) and
        grow the gaussian capacity when alive slots near it (:369-374)."""
        mtc = int(metrics["max_tile_count"])
        if mtc > 0.9 * self.max_per_tile:
            self.max_per_tile = next_pow2(int(mtc * 2.5))
        if int(self.aux.alive.sum()) > 0.9 * self.params.capacity:
            self.params, self.aux, self.adam = gm.grow_capacity(
                self.params, self.aux, self.adam,
                next_pow2(int(self.params.capacity * 2.5)))

    def step_appearance(self, uid: int, metrics):
        """The appearance optimiser after a step (gsjax loop.py:537-554)."""
        o = self.opt
        kind = self.app.kind
        if kind == "no":
            return
        if kind == "gs":
            lr = expon_lr(self.iteration, o.gs_appearance_lr_init, o.gs_appearance_lr_final,
                          lr_delay_steps=o.gs_appearance_lr_delay_steps,
                          lr_delay_mult=o.gs_appearance_lr_delay_mult,
                          max_steps=o.iterations)
        elif kind == "pgsr":
            lr = o.pgsr_appearance_lr
        else:
            lr = o.appearance_embeddings_lr
        self.app = app_lib.update_table(self.app, uid, metrics["app_grad"], lr)
        if kind == "gof":
            self.app = app_lib.update_net(self.app, metrics["app_net_grad"],
                                          o.appearance_network_lr)

    # --- main loop -----------------------------------------------------------

    def step(self):
        self.iteration += 1
        it = self.iteration
        o = self.opt
        if it % 1000 == 0:
            self.active_sh = min(self.active_sh + 1, self.sh_degree)
            self.active_sg = self.sg_degree  # unlockSGdegree(100), train.py:127-130

        view = random.choice(self.scene.train_views)
        reg_on = it >= o.regularization_from_iter
        near = None
        if reg_on and view.nearest_ids and (
                o.lambda_multi_view_ncc > 0 or o.lambda_multi_view_geo > 0):
            near = self.scene.train_views[random.choice(view.nearest_ids)]
        ncc_compact = near is not None and \
            os.environ.get("GSJAX_NCC_COMPACT", "0") not in ("0", "")
        lcfg = LossConfig(lambda_dssim=o.lambda_dssim,
                          lambda_depth_normal=o.lambda_depth_normal,
                          lambda_mv_ncc=o.lambda_multi_view_ncc,
                          lambda_mv_geo=o.lambda_multi_view_geo,
                          reg_on=reg_on, mv_on=near is not None,
                          pixel_noise_th=o.multi_view_pixel_noise_th,
                          patch_size=o.multi_view_patch_size,
                          appearance=self.app.kind, ncc_compact=ncc_compact)
        step_args = {}
        if near is not None:
            step_args = dict(near_cam=near.camera, gray_r=self.gray_for(view),
                             gray_n=self.gray_for(near))
        if self.app.kind != "no":
            step_args.update(app_embedding=self.app.table[view.uid], app_net=self.app.net)
        if self.random_background:
            bg = torch.rand(3, generator=self.generator, device=self.device)
        else:
            bg = self.bg()

        # overflow retry: a view whose largest tile list exceeds the cap is
        # re-run, loss-free, after raising the cap (train_step changes
        # nothing when it reports an overflow)
        for attempt in range(1, 5):
            self.params, self.aux, self.adam, metrics = train_step(
                self.params, self.aux, self.adam, view.camera, self.gt_for(view),
                bg, self.lrs(), self.raster_cfg(require_depth=reg_on), lcfg, **step_args)
            if not metrics["overflowed"]:
                break
            self.monitor_capacity(metrics)
        else:
            raise RuntimeError(f"iteration {it}: tile lists still exceed "
                               f"max_per_tile={self.max_per_tile} after retries")
        metrics["attempts"] = attempt
        metrics["max_per_tile"] = self.max_per_tile    # the cap this step ran with
        metrics["view"] = view.uid
        metrics["near"] = near.uid if near is not None else None
        if not np.isfinite(metrics["loss"]):
            raise FloatingPointError(
                f"non-finite loss at iteration {it} (view {view.image_name})")
        self.step_appearance(view.uid, metrics)

        # densification schedule (train.py:233-258)
        if it < o.densify_until_iter:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                self.params, self.aux, self.adam, dstats = gm.densify_and_prune(
                    self.params, self.aux, self.adam, self.generator,
                    o.densify_grad_threshold, 0.05, self.scene.radius, o.percent_dense)
                metrics["densify"] = dstats
                self.refresh_filter3d()
            if it % o.opacity_reset_interval == 0 or (
                    self.white_background and it == o.densify_from_iter):
                gm.reset_opacity(self.params, self.aux, self.adam)
        elif it % 100 == 0 and not self.disable_filter3d and it < o.iterations - 100:
            self.refresh_filter3d()

        self.monitor_capacity(metrics)
        return metrics

    # --- eval / io -----------------------------------------------------------

    @torch.no_grad()
    def render_view(self, view, require_depth=True):
        scales, opac = gm.scaling_n_opacity_with_3d_filter(self.params, self.aux.filter_3d)
        return render(self.params.xyz, scales, self.params.rotation, opac,
                      gm.get_features(self.params), view.camera,
                      self.raster_cfg(require_depth), self.bg(),
                      sg_axis=gm.get_sg_axis(self.params),
                      sg_sharpness=gm.get_sg_sharpness(self.params),
                      sg_color=self.params.sg_color, alive=self.aux.alive)

    def evaluate(self, views, max_views=None):
        psnrs = []
        for v in views[:max_views]:
            img = torch.clamp(self.render_view(v, require_depth=False)["render"], 0, 1)
            psnrs.append(float(losses.psnr(img, self.gt_for(v))))
        return float(np.mean(psnrs)) if psnrs else float("nan")

    def save_model(self):
        save_ply(os.path.join(self.model_path, "point_cloud",
                              f"iteration_{self.iteration}", "point_cloud.ply"),
                 self.params, self.aux)

    def save_ckpt(self):
        # the appearance state (table, GOF net, both Adam states) rides in
        # `extra` as x_app/..., as gsjax's (loop.py:639-642)
        save_checkpoint(os.path.join(self.model_path, f"chkpnt{self.iteration}.npz"),
                        self.params, self.aux, self.adam, self.iteration,
                        app_lib.state_to_arrays(self.app))


def _refuse_unported(lp, pp, args):
    """Raise for the gsjax options this port leaves out."""
    asks = {
        "--ip (the SIBR viewer server)": getattr(args, "ip", None),
        "--n_devices != 1 (sharding)": int(getattr(args, "n_devices", 1) or 1) != 1,
        "multi-host (--dist_*)": (getattr(args, "dist_coordinator", "")
                                  or int(getattr(args, "dist_num_processes", 1) or 1) != 1
                                  or getattr(args, "dist_auto", False)),
        "--profile_iter (profiler trace)": int(getattr(args, "profile_iter", 0) or 0),
        "--debug (debug mosaics)": bool(getattr(pp, "debug", False)),
    }
    asked = [k for k, v in asks.items() if v]
    if asked:
        raise NotImplementedError("not ported to gsjax_torch yet: " + ", ".join(asked))


def run_training(lp, op, pp, args, device=None, on_step=None):
    """Full CLI training entry (train.py:__main__ + training()) on `device`
    (cuda unless asked for the CPU). `on_step(trainer, metrics)` is called
    after every step."""
    from gsjax_torch import resolve_device

    _refuse_unported(lp, pp, args)
    dev = resolve_device(device)
    scene = load_scene(lp.source_path, lp.images, lp.masks or None, lp.eval,
                       lp.resolution, lp.white_background, device=dev)
    build_nearest_view_graph(scene.train_views, lp.multi_view_max_angle,
                             lp.multi_view_min_dis, lp.multi_view_max_dis,
                             lp.multi_view_num)
    os.makedirs(lp.model_path, exist_ok=True)
    write_scene_artifacts(lp.model_path, scene)
    with open(os.path.join(lp.model_path, "multi_view.json"), "w") as f:
        for v in scene.train_views:
            f.write(json.dumps(
                {"ref_name": v.image_name,
                 "nearest_name": [scene.train_views[i].image_name
                                  for i in v.nearest_ids]}) + "\n")

    trainer = Trainer.create(
        scene, op, lp.model_path, dev, sh_degree=lp.sh_degree, sg_degree=lp.sg_degree,
        kernel_size=lp.kernel_size, white_background=lp.white_background,
        disable_filter3d=lp.disable_filter3D, seed=int(getattr(args, "seed", 0) or 0),
        appearance=APPEARANCE_KINDS[lp.use_decoupled_appearance])
    trainer.random_background = bool(getattr(op, "random_background", False))
    if getattr(args, "start_checkpoint", None):
        p, a, ad, it, extra = load_checkpoint(args.start_checkpoint, device=dev)
        trainer.params, trainer.aux, trainer.adam, trainer.iteration = p, a, ad, it
        trainer.app = app_lib.state_from_arrays(trainer.app, extra)

    test_iters = set(getattr(args, "test_iterations", [7000, 30000])) | {op.iterations}
    save_iters = set(getattr(args, "save_iterations", [7000, 30000])) | {op.iterations}
    ckpt_iters = set(getattr(args, "checkpoint_iterations", [15000]))

    ema = 0.0
    t0 = time.time()
    while trainer.iteration < op.iterations:
        metrics = trainer.step()
        it = trainer.iteration
        if on_step is not None:
            on_step(trainer, metrics)
        ema = 0.4 * metrics["loss"] + 0.6 * ema
        if it % 100 == 0:
            dt = time.time() - t0
            print(f"[{it}] loss={ema:.4f} n={int(trainer.aux.alive.sum())} "
                  f"pairs={metrics['num_pairs']} {100 / dt:.2f} it/s", flush=True)
            t0 = time.time()
        if it in test_iters and scene.test_views:
            psnr = trainer.evaluate(scene.test_views)
            print(f"[{it}] test PSNR {psnr:.3f}", flush=True)
            with open(os.path.join(lp.model_path, f"chkpnt{it}.txt"), "w") as f:
                f.write(f"[ITER {it}] Evaluating test: PSNR {psnr}\n")
        if it in save_iters:
            trainer.save_model()
        if it in ckpt_iters:
            trainer.save_ckpt()
    return trainer

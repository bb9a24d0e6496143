"""The training loop (port of `gsjax/train/loop.py`: `Trainer`, `run_training`).

Mirrors `training()` (train.py:41-270): camera sampling with
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

The loop's extras are gsjax's: `--ip/--port` serves the SIBR remote viewer
before each step (`serve_viewer`, frames from `render_camera`);
GSJAX_NAN_PROBE=1 dumps the pre-step state of the first three steps that
leave an alive gaussian non-finite (`nan_probe_it{it}.npz`, replayed by
`python -m gsjax_torch.nan_hunt`); a non-finite loss dumps
`snapshot_it{it}.npz` before it raises; `--profile_iter` traces five steps
with `torch.profiler` under `<model>/profile/`; `--debug` writes a gt |
render / normal | depth mosaic every 200 regularised steps under
`<model>/debug/`; TensorBoard gets gsjax's scalars, histogram and images
where `torch.utils.tensorboard` imports.

Across devices (gsjax loop.py:222-286, :444-450, :689-821): under a
`torch.distributed` group of more than one rank (`--dist_*`, or the ranks
that `--n_devices N` starts, `parallel.launch`), each step is
`parallel.train_step_sharded` on the band partition of `band_kwargs`
(equal-pair bands from the per-row pair histograms of earlier steps,
`note_row_pairs`; dual bands where they balance better), with the dense
NCC. Every rank draws the same views and randoms and keeps a bit-equal
model; only the primary rank (rank 0) writes the scene artefacts,
`multi_view.json`, TensorBoard, test evaluations, PLYs and checkpoints.
"""

from __future__ import annotations

import contextlib
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
from gsjax_torch.ops.raster.camera import Camera
from gsjax_torch.parallel import multihost, shard
from gsjax_torch.train import losses
from gsjax_torch.train.step import LossConfig, train_step
from gsjax_torch.utils.schedules import expon_lr
from gsjax_torch.utils.trajectories import apply_depth_colormap
from gsjax_torch.viewer.network_gui import NetworkGUI

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
    debug: bool = False   # the gt / render / normal / depth mosaics
    # the NaN probe (GSJAX_NAN_PROBE=1): per-field non-finite counts from
    # the step; the pre-step state of the first three poisoned steps is
    # dumped for `python -m gsjax_torch.nan_hunt`
    nan_probe: bool = dataclasses.field(default_factory=lambda: os.environ.get(
        "GSJAX_NAN_PROBE", "") not in ("", "0"))
    _nan_dumps: int = 0
    # across devices: the ranks of the torch.distributed group (1: one
    # device); equal-PAIR band balancing from per-tile-row pair histograms
    # (GSJAX_BAND_BALANCE=0: equal rows), a band at most rows_factor x the
    # equal-rows height, and dual bands per rank where they balance better
    # (gsjax loop.py:90-103)
    n_ranks: int = 1
    band_balance: bool = dataclasses.field(default_factory=lambda: os.environ.get(
        "GSJAX_BAND_BALANCE", "1") not in ("0", ""))
    band_rows_factor: float = dataclasses.field(default_factory=lambda: float(
        os.environ.get("GSJAX_BAND_ROWS_FACTOR", "2")))
    dual_bands: bool = dataclasses.field(default_factory=lambda: os.environ.get(
        "GSJAX_DUAL_BANDS", "1") not in ("0", ""))
    _row_pairs: dict = dataclasses.field(default_factory=dict)
    primary: bool = True     # this process writes the run's files

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

    # --- across devices ------------------------------------------------------

    @property
    def sharded(self) -> bool:
        return self.n_ranks > 1

    def band_kwargs(self, camera, cfg, uid=None) -> dict:
        """The partition of the sharded step (gsjax loop.py:222-273): equal
        rows before any histogram; then the best of the equal-pair single
        bands, the mirrored dual bands and the freely paired dual bands, from
        the view's own histogram of its last visit, else the scene's EMA."""
        if not (self.sharded and self.band_balance):
            return {}
        n = self.n_ranks
        _, tiles_y = cfg.grid(camera.width, camera.height)
        rows_per = -(-tiles_y // n)
        rpm = min(tiles_y, max(rows_per, int(np.ceil(self.band_rows_factor * rows_per))))
        hist = self._row_pairs.get((uid, tiles_y), self._row_pairs.get(tiles_y))
        if hist is None:
            return dict(row_bounds=shard.equal_band_bounds(tiles_y, n))
        bounds, pair = shard.balance_band_bounds(hist, n, rpm), None
        h = np.asarray(hist, np.float64)
        cum = np.concatenate([[0.0], np.cumsum(h)])
        best = max(cum[bounds[d + 1]] - cum[bounds[d]] for d in range(n))
        if self.dual_bands and tiles_y >= 2 * n:
            b2 = shard.dual_balance_bounds(hist, n, max(rpm // 2, 1))
            s2 = max(cum[b2[d + 1]] - cum[b2[d]] + cum[b2[2 * n - d]] - cum[b2[2 * n - 1 - d]]
                     for d in range(n))
            if s2 < best:
                bounds, pair, best = b2, None, s2
            b3, p3 = shard.paired_balance_bounds(hist, n, rpm)
            s3 = max(cum[b3[p3[d, 0] + 1]] - cum[b3[p3[d, 0]]] +
                     cum[b3[p3[d, 1] + 1]] - cum[b3[p3[d, 1]]] for d in range(n))
            if s3 < best:
                bounds, pair, best = b3, p3, s3
        return dict(row_bounds=bounds, band_pair=pair)

    def note_row_pairs(self, metrics, uid=None):
        """Record a step's per-tile-row pair histogram (gsjax loop.py:275-286):
        exact per view (keyed (uid, tiles_y)) and a scene EMA for views not
        seen yet."""
        if "row_pairs" not in metrics:
            return
        new = np.asarray(metrics["row_pairs"], np.float64)
        if uid is not None:
            self._row_pairs[(uid, len(new))] = new
        old = self._row_pairs.get(len(new))
        self._row_pairs[len(new)] = \
            new if old is None or len(old) != len(new) else 0.7 * old + 0.3 * new

    # --- main loop -----------------------------------------------------------

    def loss_config(self, reg_on: bool, mv_on: bool) -> LossConfig:
        """The step's loss terms and NCC form. GSJAX_NCC_COMPACT is read, as
        gsjax reads it, only for a step with a neighbour; the sharded step
        keeps the dense NCC, as gsjax's (loop.py:418-421)."""
        o = self.opt
        ncc_compact = mv_on and not self.sharded and \
            os.environ.get("GSJAX_NCC_COMPACT", "0") not in ("0", "")
        return LossConfig(lambda_dssim=o.lambda_dssim,
                          lambda_depth_normal=o.lambda_depth_normal,
                          lambda_mv_ncc=o.lambda_multi_view_ncc,
                          lambda_mv_geo=o.lambda_multi_view_geo,
                          reg_on=reg_on, mv_on=mv_on,
                          pixel_noise_th=o.multi_view_pixel_noise_th,
                          patch_size=o.multi_view_patch_size, appearance=self.app.kind,
                          ncc_compact=ncc_compact, nan_stats=self.nan_probe)

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
        lcfg = self.loss_config(reg_on, near is not None)
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

        # the step updates params and Adam in place: the probe keeps a copy
        prev = self.state_copy() if self.nan_probe else None

        # overflow retry: a view whose largest tile list exceeds the cap is
        # re-run, loss-free, after raising the cap (train_step changes
        # nothing when it reports an overflow)
        for attempt in range(1, 5):
            cfg = self.raster_cfg(require_depth=reg_on)
            if self.sharded:
                bands = self.band_kwargs(view.camera, cfg, view.uid)
                self.params, self.aux, self.adam, metrics = shard.train_step_sharded(
                    self.params, self.aux, self.adam, view.camera, self.gt_for(view),
                    bg, self.lrs(), cfg, lcfg, **step_args, **bands)
                metrics["partition"] = {k: np.asarray(v).tolist() for k, v in bands.items()
                                        if v is not None}
            else:
                self.params, self.aux, self.adam, metrics = train_step(
                    self.params, self.aux, self.adam, view.camera, self.gt_for(view),
                    bg, self.lrs(), cfg, lcfg, **step_args)
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
        self.note_row_pairs(metrics, view.uid)
        if self.nan_probe:
            self.probe_nonfinite(metrics, prev, view, near)
        if self.debug and reg_on and it % 200 == 0 and self.primary:
            self.write_debug_mosaic(view)
        # on blow-up, the step's state and views, replayable offline (the
        # reference's snapshot_fw.dump, diff_gaussian_rasterization/__init__.py:101-107)
        if not np.isfinite(metrics["loss"]):
            path = os.path.join(self.model_path, f"snapshot_it{it}.npz")
            flat = {f"params_{i}": getattr(self.params, k).detach().cpu().numpy()
                    for i, k in enumerate(gm.PARAM_FIELDS)}
            flat.update({f"aux_{i}": getattr(self.aux, k).cpu().numpy()
                         for i, k in enumerate(gm.AUX_FIELDS)})
            flat.update(view_uid=np.asarray(view.uid), iteration=np.asarray(it),
                        near_uid=np.asarray(-1 if near is None else near.uid))
            if self.primary:
                np.savez_compressed(path, **flat)
            raise FloatingPointError(
                f"non-finite loss at iteration {it} "
                f"(view {view.image_name}); state dumped to {path}")
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

    # --- diagnostics ---------------------------------------------------------

    def state_copy(self) -> dict:
        """A copy of the model and Adam state on the device, under the NaN
        probe's keys (gsjax loop.py:495-503): `params.<field>`,
        `aux.<field>`, `adam_mu.<field>`, `adam_nu.<field>`, `adam.count`."""
        take = lambda t: t.detach().clone()
        out = {f"params.{k}": take(getattr(self.params, k)) for k in gm.PARAM_FIELDS}
        out.update({f"aux.{k}": take(getattr(self.aux, k)) for k in gm.AUX_FIELDS})
        for name, moments in (("adam_mu", self.adam.mu), ("adam_nu", self.adam.nu)):
            out.update({f"{name}.{k}": take(moments[k]) for k in gm.PARAM_FIELDS})
        out["adam.count"] = np.asarray(self.adam.count, np.int32)
        return out

    def probe_nonfinite(self, metrics, prev, view, near):
        """The NaN probe after a step (gsjax loop.py:487-514): on the first
        three steps that leave an alive gaussian non-finite, dump `prev`, the
        pre-step state, with the views and schedule to replay it."""
        nf = {f"{k}.{f}": v for k, d in metrics["nonfinite"].items() for f, v in d.items()}
        if not any(nf.values()) or self._nan_dumps >= 3:
            return
        self._nan_dumps += 1
        it = self.iteration
        path = os.path.join(self.model_path, f"nan_probe_it{it}.npz")
        if not self.primary:
            return
        flat = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in prev.items()}
        flat.update(view_uid=np.asarray(view.uid),
                    near_uid=np.asarray(-1 if near is None else near.uid),
                    iteration=np.asarray(it), active_sh=np.asarray(self.active_sh),
                    active_sg=np.asarray(self.active_sg))
        np.savez_compressed(path, **flat)
        print(f"NAN_PROBE: iteration {it} produced non-finite values "
              f"{sorted(k for k, v in nf.items() if v)} (counts {nf}); "
              f"pre-step state dumped to {path}", flush=True)

    def debug_mosaic(self, view) -> np.ndarray:
        """[2H, 2W, 3] float32 in [0, 1]: gt | render over normal | depth
        (the reference's PatchMatch debug dumps, loss_utils.py:201-221,
        without the warp-weight pane; gsjax loop.py:604-623)."""
        out = self.render_view(view, require_depth=True)
        host = lambda t: t.cpu().numpy()
        gt = np.clip(host(self.gt_for(view)), 0, 1)
        img = np.clip(host(out["render"]), 0, 1)
        nrm = np.clip((host(out["normal"]) + 1) * 0.5, 0, 1)
        dep = apply_depth_colormap(host(out["median_depth"])).astype(np.float32) / 255.0
        return np.concatenate([np.concatenate([gt, img], axis=1),
                               np.concatenate([nrm, dep], axis=1)], axis=0)

    def write_debug_mosaic(self, view):
        """`debug_mosaic` as `<model>/debug/{it:05d}_{name}.jpg`."""
        from PIL import Image

        dbg = os.path.join(self.model_path, "debug")
        os.makedirs(dbg, exist_ok=True)
        Image.fromarray((self.debug_mosaic(view) * 255).astype(np.uint8)).save(
            os.path.join(dbg, f"{self.iteration:05d}_{view.image_name}.jpg"))

    # --- eval / io -----------------------------------------------------------

    def render_view(self, view, require_depth=True, min_opacity=0.0):
        return self.render_camera(view.camera, require_depth=require_depth,
                                  min_opacity=min_opacity)

    @torch.no_grad()
    def render_camera(self, camera, scaling_modifier=1.0, require_depth=True,
                      min_opacity=0.0):
        """Render any camera (the viewer's path; gsjax loop.py:583-602).
        `scaling_modifier` multiplies the activated, 3D-filtered scales;
        `min_opacity` > 0 drops gaussians of lower filtered opacity."""
        scales, opac = gm.scaling_n_opacity_with_3d_filter(self.params, self.aux.filter_3d)
        if scaling_modifier != 1.0:
            scales = scales * float(np.float32(scaling_modifier))
        alive = self.aux.alive
        if min_opacity > 0.0:
            alive = alive & (opac[:, 0] >= min_opacity)
        return render(self.params.xyz, scales, self.params.rotation, opac,
                      gm.get_features(self.params), camera,
                      self.raster_cfg(require_depth), self.bg(),
                      sg_axis=gm.get_sg_axis(self.params),
                      sg_sharpness=gm.get_sg_sharpness(self.params),
                      sg_color=self.params.sg_color, alive=alive)

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


def serve_viewer(gui: NetworkGUI, trainer: Trainer, source_path: str, final_iter: int):
    """One viewer exchange before a step (reference train.py:93-120, gsjax
    loop.py:646-672): receive a camera, render it at the requested scaling
    modifier, send the uint8 RGB and the source path as the verify string;
    loop while the client keeps the run paused. Any error drops the
    connection, as gsjax's: a failed kernel launch still stops the run,
    since a CUDA error is sticky and the next step raises it."""
    if gui.conn is None:
        gui.try_connect()
    while gui.conn is not None:
        try:
            cam_d, do_training, keep_alive, scaling_mod = gui.receive()
            img = None
            if cam_d is not None:
                cam = Camera.from_matrices(cam_d["width"], cam_d["height"], cam_d["fovx"],
                                           cam_d["fovy"], cam_d["world_view"],
                                           cam_d["full_proj"], device=trainer.device)
                out = trainer.render_camera(cam, scaling_modifier=scaling_mod,
                                            require_depth=False)
                # contiguous on the card: the render is a channels-last view of
                # its planes, and a strided host gather of a 1080p frame costs
                # tens of ms
                img = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
                img = img.contiguous().cpu().numpy()
            gui.send(img, source_path)
            if do_training and (trainer.iteration < final_iter or not keep_alive):
                break
        except Exception:
            gui.disconnect()


def _tensorboard(model_path):
    """gsjax's soft dependency (loop.py:737-743): a SummaryWriter where
    `torch.utils.tensorboard` imports and the writer opens, else None and no
    scalars (any exception of either, as gsjax catches)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(model_path)
    except Exception as e:
        print(f"TensorBoard unavailable ({type(e).__name__}: {e}); training without it")
        return None


def _profiler(device):
    """A torch.profiler recording the host and, on a card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _report(tb, trainer, scene, it, test_iters):
    """TensorBoard's test-time entries (gsjax loop.py:797-818): PSNR, the
    opacity histogram, the first five test views' renders and depths (and
    their gt at the first test iteration)."""
    alive = trainer.aux.alive
    op = gm.get_opacity(trainer.params).detach()[alive].cpu().numpy()
    if op.size:
        tb.add_histogram("scene/opacity_histogram", op, it)
    for v in scene.test_views[:5]:
        out = trainer.render_view(v, require_depth=True)
        tb.add_image(f"{v.image_name}/render",
                     np.clip(out["render"].cpu().numpy(), 0, 1), it, dataformats="HWC")
        tb.add_image(f"{v.image_name}/depth",
                     apply_depth_colormap(out["median_depth"].cpu().numpy()), it,
                     dataformats="HWC")
        if it == min(test_iters):
            tb.add_image(f"{v.image_name}/ground_truth", trainer.gt_for(v).cpu().numpy(),
                         it, dataformats="HWC")


def run_training(lp, op, pp, args, device=None, on_step=None):
    """Full CLI training entry (train.py:__main__ + training()) on `device`
    (cuda unless asked for the CPU). `on_step(trainer, metrics)` is called
    after every step.

    With `--dist_*` in `args` the process joins that group first; under a
    group (joined so, or started by `parallel.launch`) of more than one rank
    the steps are sharded, `args.n_devices` (when not 1) must match the
    group's size, and the rank's device is `cuda:(local rank % cards)`."""
    from gsjax_torch import resolve_device

    dev = resolve_device(device)
    multihost.maybe_init_distributed(args, dev)
    dev = multihost.local_device(dev)
    n_ranks = multihost.ranks()
    n_req = int(getattr(args, "n_devices", 1))
    if n_req != 1 and n_req > 0 and n_req != n_ranks:
        raise ValueError(f"--n_devices {n_req} but {n_ranks} rank(s) are running: start "
                         f"the ranks with parallel.launch or the training CLI")
    # the live-viewer server (SIBR remote protocol, reference train.py:93-120),
    # bound before the scene loads so that a viewer can connect during set-up
    # and see the first step's model
    gui = None
    if getattr(args, "ip", None):
        try:
            gui = NetworkGUI(args.ip, int(getattr(args, "port", 6009)))
        except OSError as e:
            print(f"viewer server unavailable ({e}); training without GUI")
    try:
        return _train(lp, op, pp, args, dev, on_step, gui, n_ranks)
    finally:
        if gui is not None:
            gui.close()


def _train(lp, op, pp, args, dev, on_step, gui, n_ranks):
    # every rank runs the same schedule; only the primary writes files
    primary = multihost.is_primary()
    scene = load_scene(lp.source_path, lp.images, lp.masks or None, lp.eval,
                       lp.resolution, lp.white_background, device=dev)
    build_nearest_view_graph(scene.train_views, lp.multi_view_max_angle,
                             lp.multi_view_min_dis, lp.multi_view_max_dis,
                             lp.multi_view_num)
    if primary:
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
    trainer.debug = bool(getattr(pp, "debug", False))
    trainer.n_ranks, trainer.primary = n_ranks, primary
    if n_ranks > 1 and primary:
        print(f"Sharding tile rows over {n_ranks} ranks")
    if getattr(args, "start_checkpoint", None):
        p, a, ad, it, extra = load_checkpoint(args.start_checkpoint, device=dev)
        trainer.params, trainer.aux, trainer.adam, trainer.iteration = p, a, ad, it
        trainer.app = app_lib.state_from_arrays(trainer.app, extra)

    test_iters = set(getattr(args, "test_iterations", [7000, 30000])) | {op.iterations}
    save_iters = set(getattr(args, "save_iterations", [7000, 30000])) | {op.iterations}
    ckpt_iters = set(getattr(args, "checkpoint_iterations", [15000]))
    # TensorBoard where it imports, and a torch.profiler trace of the five
    # steps from profile_iter (gsjax loop.py:735-771), both closed (the trace
    # written) even when a step raises
    profile_iter = int(getattr(args, "profile_iter", 0) or 0)
    prof = None
    tb = _tensorboard(lp.model_path) if primary else None

    def stop_profile():
        nonlocal prof
        if prof is not None:
            prof.stop()
            trace_dir = os.path.join(lp.model_path, "profile")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"trace_it{profile_iter}.json"))
            prof = None

    ema = 0.0
    t0 = time.time()
    try:
        while trainer.iteration < op.iterations:
            if gui is not None:
                serve_viewer(gui, trainer, lp.source_path, op.iterations)
            if profile_iter and trainer.iteration + 1 == profile_iter and primary:
                prof = _profiler(dev)
                prof.start()
            span = (torch.profiler.record_function(f"train_step {trainer.iteration + 1}")
                    if prof is not None else contextlib.nullcontext())
            with span:
                metrics = trainer.step()
            if prof is not None and trainer.iteration >= profile_iter + 4:
                stop_profile()
            it = trainer.iteration
            if on_step is not None:
                on_step(trainer, metrics)
            ema = 0.4 * metrics["loss"] + 0.6 * ema
            if it % 100 == 0 and primary:
                dt = time.time() - t0
                n_alive = int(trainer.aux.alive.sum())
                print(f"[{it}] loss={ema:.4f} n={n_alive} "
                      f"pairs={metrics['num_pairs']} {100 / dt:.2f} it/s", flush=True)
                if tb is not None:
                    tb.add_scalar("train_loss_patches/total_loss", ema, it)
                    for k, tag in (("l1", "train_loss_patches/l1_loss"),
                                   ("dn_loss", "train_loss_patches/normal_loss"),
                                   ("ncc_loss", "train_loss_patches/ncc_loss"),
                                   ("geo_loss", "train_loss_patches/geo_loss")):
                        tb.add_scalar(tag, float(metrics[k]), it)
                    tb.add_scalar("total_points", n_alive, it)
                    tb.add_scalar("iter_time", dt / 100.0 * 1000.0, it)
                t0 = time.time()
            if it in test_iters and scene.test_views and primary:
                psnr = trainer.evaluate(scene.test_views)
                print(f"[{it}] test PSNR {psnr:.3f}", flush=True)
                with open(os.path.join(lp.model_path, f"chkpnt{it}.txt"), "w") as f:
                    f.write(f"[ITER {it}] Evaluating test: PSNR {psnr}\n")
                if tb is not None:
                    tb.add_scalar("test/psnr", psnr, it)
                    _report(tb, trainer, scene, it, test_iters)
            if it in save_iters and primary:
                trainer.save_model()
            if it in ckpt_iters and primary:
                trainer.save_ckpt()
    finally:
        stop_profile()
        if tb is not None:
            tb.close()
    return trainer

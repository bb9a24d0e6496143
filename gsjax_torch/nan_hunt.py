"""Replay a NaN-probe dump to find the op that first yields a NaN (the port
of `scripts/nan_hunt.py`).

`GSJAX_NAN_PROBE=1` training (`gsjax_torch/train/loop.py`, or gsjax's loop:
the keys are the same) dumps the PRE-step model state the first time an
alive gaussian's gradient or parameter goes non-finite. This tool reloads
that state, rebuilds the same scene and view pair (the scene read with its
eval split, as the dump's view ids count it), and runs that step again on
`--device` (cuda unless `--device cpu`) with the non-finite counts on. By
default it runs under `torch.autograd.detect_anomaly()`, PyTorch's
counterpart of `jax_debug_nans`: the backward then raises at the first op
whose gradient holds a NaN and prints the forward trace of that op.
`--no_debug_nans` only prints the per-field counts and the loss.

Usage:
  python -m gsjax_torch.nan_hunt DUMP.npz --scene_dir SCENE [--no_debug_nans]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
from argparse import Namespace

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot")
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--device", "--platform", dest="device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain-PyTorch path)")
    ap.add_argument("--no_debug_nans", action="store_true",
                    help="just re-run and print per-field non-finite counts "
                         "(faster; use before the anomaly-mode replay)")
    args = ap.parse_args(argv)

    import torch

    from gsjax_torch import resolve_device
    from gsjax_torch.config import OptimizationParams
    from gsjax_torch.data.readers import build_nearest_view_graph, load_scene
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.train.loop import Trainer, next_pow2
    from gsjax_torch.train.step import LossConfig, train_step

    dev = resolve_device(args.device)
    z = np.load(args.snapshot)
    it = int(z["iteration"])
    print(f"snapshot: iteration {it}, view uid {int(z['view_uid'])}, "
          f"near uid {int(z['near_uid'])}")
    params, aux = gm.params_from_numpy({k: z[f"params.{k}"] for k in gm.PARAM_FIELDS},
                                       {k: z[f"aux.{k}"] for k in gm.AUX_FIELDS}, dev)
    moments = lambda pre: {k: torch.as_tensor(np.asarray(z[f"{pre}.{k}"], np.float32),
                                              device=dev) for k in gm.PARAM_FIELDS}
    adam = gm.AdamState(mu=moments("adam_mu"), nu=moments("adam_nu"),
                        count=int(z["adam.count"]))

    scene = load_scene(args.scene_dir, "images", None, eval_split=True, device=dev)
    build_nearest_view_graph(scene.train_views, 30, 0.01, 1.5, 8)
    view = scene.train_views[int(z["view_uid"])]
    near = None if int(z["near_uid"]) < 0 else scene.train_views[int(z["near_uid"])]

    o = Namespace(**OptimizationParams._defaults())
    tr = Trainer(scene=scene, params=params, aux=aux, adam=adam, opt=o,
                 model_path=os.path.dirname(os.path.abspath(args.snapshot)), device=dev)
    tr.iteration = it
    tr.active_sh = int(z["active_sh"])
    tr.active_sg = int(z["active_sg"])
    tr.max_per_tile = 1 << 11
    lcfg = LossConfig(reg_on=True, mv_on=near is not None, nan_stats=True)
    common = {}
    if near is not None:
        common = dict(near_cam=near.camera, gray_r=tr.gray_for(view), gray_n=tr.gray_for(near))
    print(f"replaying step (capacity {params.capacity}, device {dev}, "
          f"debug_nans={not args.no_debug_nans})...", flush=True)
    anomaly = (contextlib.nullcontext() if args.no_debug_nans
               else torch.autograd.detect_anomaly())
    with anomaly:
        while True:   # the step changes nothing when a tile list overflows
            _, _, _, m = train_step(params, aux, adam, view.camera,
                                    torch.as_tensor(view.image, device=dev),
                                    torch.zeros(3, device=dev), tr.lrs(),
                                    tr.raster_cfg(require_depth=True), lcfg, **common)
            if not m["overflowed"]:
                break
            tr.max_per_tile = next_pow2(m["max_tile_count"])
    nf = {f"{k}.{f}": v for k, d in m["nonfinite"].items() for f, v in d.items()}
    print("replay non-finite counts:", {k: v for k, v in nf.items() if v})
    print("loss:", m["loss"])
    return nf


if __name__ == "__main__":
    main()

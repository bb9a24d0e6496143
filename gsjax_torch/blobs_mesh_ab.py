"""The blobs scene's TSDF mesh against the pre-meshing opacity cull and the
TSDF's min-weight (port of gsjax's `scripts/blobs_mesh_ab.py`).

    python -m gsjax_torch.blobs_mesh_ab --model_dir <golden run> --scene_dir <scene>
        [--out blobs_mesh_ab.json] [--opacities 0.0,0.1,0.3]
        [--min_weights 1,2,3] [--clusters 3,6] [--device cpu]

From a trained golden checkpoint (`<model_dir>/golden_ckpt.npz`, as
`python -m gsjax_torch.golden_quality --scene blobs` leaves it), renders the
training views' median depth once per opacity cull on the device, fuses
them (voxel 0.02, truncation 6.0), then meshes and cluster-filters per
(min_weight, cluster_to_keep) and scores each mesh against the blobs'
surfaces, so one run measures the whole grid. Writes gsjax's rows
(`min_opacity`, `min_weight`, `clusters`, `chamfer`, `d2s`, `s2d`,
`nverts`) to `--out` (default `blobs_mesh_ab.json` in the temporary
directory). Runs on cuda unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np


def chamfer_row(verts) -> dict:
    """gsjax's row of a mesh: the blobs chamfer rounded to 4 places."""
    from gsjax_torch.golden_quality import chamfer_of

    ch, d2s, s2d, n = chamfer_of(verts, "blobs")
    if n == 0:
        return dict(chamfer=None, d2s=None, s2d=None, nverts=0)
    return dict(chamfer=round(ch, 4), d2s=round(d2s, 4), s2d=round(s2d, 4), nverts=int(n))


def main(argv=None):
    import torch

    from gsjax_torch import resolve_device
    from gsjax_torch.config import OptimizationParams
    from gsjax_torch.data.readers import build_nearest_view_graph, load_scene
    from gsjax_torch.mesh.cluster import post_process_mesh
    from gsjax_torch.mesh.extract import fuse_tsdf, tsdf_to_mesh
    from gsjax_torch.model.io import load_checkpoint
    from gsjax_torch.train.loop import Trainer

    ap = argparse.ArgumentParser(description="gsjax_torch blobs mesh A/B")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "blobs_mesh_ab.json"))
    ap.add_argument("--opacities", default="0.0,0.1,0.3")
    ap.add_argument("--min_weights", default="1,2,3")
    ap.add_argument("--clusters", default="3,6")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scene = load_scene(args.scene_dir, "images", None, eval_split=True, device=dev)
    build_nearest_view_graph(scene.train_views, 30, 0.01, 1.5, 8)
    p, a, ad, it, _ = load_checkpoint(os.path.join(args.model_dir, "golden_ckpt.npz"),
                                      device=dev)
    # the degrees the checkpoint's features hold, and gsjax's tile-list cap
    tr = Trainer(scene=scene, params=p, aux=a, adam=ad,
                 opt=argparse.Namespace(**OptimizationParams._defaults()),
                 model_path=args.model_dir, device=dev, iteration=it,
                 max_per_tile=1 << 11,
                 active_sh=math.isqrt(p.features_rest.shape[1] + 1) - 1,
                 active_sg=p.sg_color.shape[1] if p.sg_color.dim() == 3 else 0)
    print(f"loaded ckpt at iter {it}, {int(a.alive.sum())} gaussians", flush=True)

    rows = []
    for mo in [float(x) for x in args.opacities.split(",")]:
        depths, colors = [], []
        for v in scene.train_views:
            out = tr.render_view(v, require_depth=True, min_opacity=mo)
            depths.append(out["median_depth"])
            colors.append(torch.clamp(out["render"], 0, 1))
        print(f"rendered {len(depths)} depth maps at min_opacity={mo}", flush=True)
        tsdf, weight, _c, origin, vs = fuse_tsdf(depths, colors, scene.train_views,
                                                 0.02, 6.0, verbose=False)
        for mw in [float(x) for x in args.min_weights.split(",")]:
            verts, faces = tsdf_to_mesh(tsdf, weight, origin, vs, min_weight=mw)
            for nc in [int(x) for x in args.clusters.split(",")]:
                pv, _ = post_process_mesh(verts, faces, nc)
                row = dict(min_opacity=mo, min_weight=mw, clusters=nc, **chamfer_row(pv))
                rows.append(row)
                print(row, flush=True)
        del tsdf, weight, _c

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()

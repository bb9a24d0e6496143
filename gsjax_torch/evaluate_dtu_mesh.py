"""DTU mesh evaluation CLI: align the trained cameras to the official DTU
calibration, transform recon_post.ply, run the chamfer protocol (port of the
repository's `evaluate_dtu_mesh.py`).

Mirrors the reference evaluate_dtu_mesh.py:140-185 (alignment) +
dtu_eval/eval.py (metric), all in-process. Writes
<model>/recon_aligned.ply and <model>/vis/results.json. The scene is read
with its views on cuda unless `--device cpu` is given; the protocol itself
runs on the host (numpy, scipy).

    python -m gsjax_torch.evaluate_dtu_mesh -s <scan> -m <model>
        --DTU <Offical_DTU_Dataset> [--scan_id N] [--device cpu]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the results
    dict (mean_d2s, mean_s2d, overall) with the alignment's `scale`."""
    from gsjax_torch import resolve_device
    from gsjax_torch.config import ModelParams, PipelineParams, get_combined_args
    from gsjax_torch.data.ply import read_ply, write_ply
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.eval.dtu import (align_to_dtu, evaluate_mesh_chamfer,
                                      load_dtu_calibration_centers)

    parser = ArgumentParser(description="DTU mesh evaluation")
    ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=30_000, type=int)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--scan_id", type=str, default=None)
    parser.add_argument("--DTU", type=str, default="dtu_eval/Offical_DTU_Dataset")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the CPU)")
    args = get_combined_args(parser, argv)
    dev = resolve_device(getattr(args, "device", None))

    scene = load_scene(args.source_path, args.images, args.masks or None,
                       bool(getattr(args, "eval", False)), args.resolution,
                       args.white_background, device=dev)
    centers = np.stack([v.camera_center for v in scene.train_views])
    dtu_centers = load_dtu_calibration_centers(args.DTU)
    scale, r, t = align_to_dtu(centers, dtu_centers)

    mesh_file = os.path.join(args.model_path, "recon_post.ply")
    v = read_ply(mesh_file)
    verts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    faces = v["__faces__"]
    verts = (verts * scale) @ r.T + t
    write_ply(os.path.join(args.model_path, "recon_aligned.ply"),
              dict(x=verts[:, 0].astype(np.float32),
                   y=verts[:, 1].astype(np.float32),
                   z=verts[:, 2].astype(np.float32)),
              faces=np.asarray(faces, np.int32))

    # get_combined_args drops a flag left at None, so read --scan_id with a
    # default: without it the scan id comes from the scene's name, scan<N>
    # (gsjax's CLI raises AttributeError there, ROADMAP queue C)
    scan_id = getattr(args, "scan_id", None)
    scan = int(scan_id) if scan_id else \
        int(os.path.basename(args.source_path.rstrip("/"))[4:])
    res = evaluate_mesh_chamfer(verts, np.asarray(faces), scan, args.DTU)
    out_dir = os.path.join(args.model_path, "vis")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(res)
    return {**res, "scale": float(scale)}


if __name__ == "__main__":
    main()

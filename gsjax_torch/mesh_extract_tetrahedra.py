"""Marching-tetrahedra mesh extraction CLI (TnT route).

Port of the repository's `mesh_extract_tetrahedra.py` (the reference
`mesh_extract_tetrahedra.py`): reads the model's
`point_cloud/iteration_N/point_cloud.ply` and the scene's training views,
and writes `recon_init.ply`, `recon.ply` and `recon_post.ply` into the model
directory, on one device: cuda unless `--device cpu` is given.

    python -m gsjax_torch.mesh_extract_tetrahedra -s <scene> -m <model> [--device cpu]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def write_mesh(path, verts, faces):
    """A triangle mesh as a binary PLY (float32 x, y, z and int faces)."""
    from gsjax_torch.data.ply import write_ply

    write_ply(path, dict(x=verts[:, 0].astype(np.float32), y=verts[:, 1].astype(np.float32),
                         z=verts[:, 2].astype(np.float32)), faces=np.asarray(faces))


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the meshes dict
    of `extract_mesh_tetrahedra`."""
    from gsjax_torch import resolve_device
    from gsjax_torch.config import ModelParams, PipelineParams, get_combined_args
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.mesh.extract import extract_mesh_tetrahedra
    from gsjax_torch.model.io import load_ply
    from gsjax_torch.ops.raster import RasterConfig
    from gsjax_torch.utils.system import search_max_iteration

    parser = ArgumentParser(description="marching tetrahedra mesh extraction")
    ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--num_cluster", default=1, type=int)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--move_cpu", action="store_true",
                        help="kept for flag parity with gsjax; unused")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the "
                             "plain-PyTorch path)")
    args = get_combined_args(parser, argv)
    dev = resolve_device(getattr(args, "device", None))

    iteration = args.iteration
    if iteration == -1:
        iteration = search_max_iteration(os.path.join(args.model_path, "point_cloud"))
    params, aux = load_ply(os.path.join(args.model_path, "point_cloud",
                                        f"iteration_{iteration}", "point_cloud.ply"),
                           device=dev)
    scene = load_scene(args.source_path, args.images, args.masks or None,
                       bool(getattr(args, "eval", False)), args.resolution,
                       args.white_background, device=dev)

    cfg = RasterConfig(sh_degree=args.sh_degree,
                       sg_degree=getattr(args, "sg_degree", 0) or 0,
                       kernel_size=args.kernel_size, require_depth=True,
                       pair_capacity=1 << 22, max_per_tile=1 << 12)
    meshes = extract_mesh_tetrahedra(params, aux, scene.train_views, cfg,
                                     cluster_to_keep=args.num_cluster)
    for name, key in (("recon_init", "init"), ("recon", "raw"), ("recon_post", "post")):
        write_mesh(os.path.join(args.model_path, f"{name}.ply"), *meshes[key])
    print("done!")
    return meshes


if __name__ == "__main__":
    main()

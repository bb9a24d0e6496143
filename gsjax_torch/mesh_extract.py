"""TSDF mesh extraction CLI (DTU route).

Port of the repository's `mesh_extract.py` (the reference `mesh_extract.py`):
renders the median depth of every training view on a white background,
fuses it into a TSDF grid and writes `recon.ply` and `recon_post.ply` into
the model directory, on one device: cuda unless `--device cpu` is given.

    python -m gsjax_torch.mesh_extract -s <scene> -m <model> [--voxel_size 0.002] [--device cpu]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the meshes dict
    of `extract_mesh_tsdf`."""
    from gsjax_torch import resolve_device
    from gsjax_torch.config import ModelParams, PipelineParams, get_combined_args
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.mesh.cluster import cull_mesh
    from gsjax_torch.mesh.extract import extract_mesh_tsdf
    from gsjax_torch.mesh_extract_tetrahedra import write_mesh
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.model.io import load_ply
    from gsjax_torch.ops.raster import RasterConfig, render
    from gsjax_torch.utils.system import search_max_iteration

    parser = ArgumentParser(description="TSDF mesh extraction")
    ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--num_cluster", default=1, type=int)
    parser.add_argument("--voxel_size", default=0.002, type=float)
    parser.add_argument("--cull", action="store_true",
                        help="drop faces unobserved by any training camera "
                             "(frustum + rendered-depth occlusion; the "
                             "eval_tnt/cull_mesh.py protocol)")
    parser.add_argument("--quiet", action="store_true")
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

    bg = torch.ones(3, device=dev)  # the reference renders on white for TSDF (mesh_extract.py:46)
    cfg = RasterConfig(sh_degree=args.sh_degree,
                       sg_degree=getattr(args, "sg_degree", 0) or 0,
                       kernel_size=args.kernel_size, require_depth=True,
                       pair_capacity=1 << 22, max_per_tile=1 << 12)
    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
        feats = gm.get_features(params)
        sg_axis, sg_sharp = gm.get_sg_axis(params), gm.get_sg_sharpness(params)

    @torch.no_grad()
    def render_fn(view):
        return render(params.xyz, scales, params.rotation, opac, feats, view.camera,
                      cfg, bg, sg_axis=sg_axis, sg_sharpness=sg_sharp,
                      sg_color=params.sg_color, alive=aux.alive)

    meshes = extract_mesh_tsdf(render_fn, scene.train_views, voxel_size=args.voxel_size,
                               cluster_to_keep=args.num_cluster)
    if args.cull:
        meshes["post"] = cull_mesh(*meshes["post"], scene.train_views,
                                   depths=meshes["depths"])
    for name, key in (("recon", "raw"), ("recon_post", "post")):
        write_mesh(os.path.join(args.model_path, f"{name}.ply"), *meshes[key])
    print("done!")
    return meshes


if __name__ == "__main__":
    main()

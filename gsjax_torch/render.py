"""NVS rendering CLI: render train/test splits, and optionally an ellipse
flythrough, to PNG trees.

Port of the repository's `render.py` (the reference `render.py:24-65` output
layout, <model>/{train,test,traj}/ours_<iter>/{renders,gt,depth}/#####.png):
cuda unless `--device cpu` is given.

    python -m gsjax_torch.render -m <model> [-s <scene>] [--traj_frames N
        [--video]] [--save_depth] [--n_devices N] [--device cpu]

`--n_devices N` (root render.py:82-111) renders view-parallel: N ranks
started here (`parallel.launch`; min(N, cards) on the card, N on the CPU;
N <= 0 every card) take the views round-robin (`render_views_sharded`), and
rank 0 writes every PNG.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from gsjax_torch.utils.trajectories import apply_depth_colormap, create_videos, generate_path


def save_png(path, arr):
    from PIL import Image

    Image.fromarray((np.clip(np.asarray(arr), 0, 1) * 255).astype(np.uint8)).save(path)


class _TrajView:
    """A flythrough frame as `render_set` reads it: a camera and a black
    ground-truth image."""

    def __init__(self, camera):
        self.camera = camera
        self.image = np.zeros((camera.height, camera.width, 3), np.float32)


def render_set(model_path, name, iteration, views, render_fn,
               save_depth=False, on_view=None, batch=1, write=True):
    """Render `views` to <model>/<name>/ours_<iteration>/. `on_view(idx,
    view, out)` is called with each view's output dict. With `batch` > 1,
    `render_fn` takes a list of up to `batch` views and returns their
    outputs; `write`: False renders without writing (the ranks other than
    the writer of a view-parallel run)."""
    base = os.path.join(model_path, name, f"ours_{iteration}")
    paths = [os.path.join(base, d) for d in ("renders", "gt", "depth")]
    if write:
        for path in paths[:3 if save_depth else 2]:
            os.makedirs(path, exist_ok=True)
    for i0 in range(0, len(views), batch):
        chunk = views[i0:i0 + batch]
        outs = render_fn(chunk) if batch > 1 else [render_fn(chunk[0])]
        for idx, view, out in zip(range(i0, i0 + len(chunk)), chunk, outs):
            if write:
                _write_view(paths, idx, view, out, save_depth)
            if on_view is not None:
                on_view(idx, view, out)
            if write:
                print(f"\r{name} {idx + 1}/{len(views)}", end="", flush=True)
    if write:
        print()


def _write_view(paths, idx, view, out, save_depth):
    renders_path, gts_path, depth_path = paths
    save_png(os.path.join(renders_path, f"{idx:05d}.png"), out["render"].cpu().numpy())
    save_png(os.path.join(gts_path, f"{idx:05d}.png"), view.image)
    if save_depth:
        from PIL import Image

        Image.fromarray(apply_depth_colormap(out["median_depth"].cpu().numpy())).save(
            os.path.join(depth_path, f"{idx:05d}.png"))


def _rank_main(rank, argv):
    """One rank of `--n_devices N` (its group is up): the CLI on `argv`."""
    main(argv)


def main(argv=None, on_view=None):
    """Run the CLI on `argv` (default sys.argv[1:]); `on_view` as in
    `render_set`."""
    import torch.distributed as dist

    from gsjax_torch import resolve_device
    from gsjax_torch.config import ModelParams, PipelineParams, get_combined_args
    from gsjax_torch.data.readers import load_scene
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.model.io import load_ply
    from gsjax_torch.ops.raster import RasterConfig, render
    from gsjax_torch.parallel import launch, multihost, shard
    from gsjax_torch.utils.system import search_max_iteration

    parser = ArgumentParser(description="gsjax_torch rendering")
    ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--traj_frames", default=0, type=int,
                        help="also render an N-frame ellipse flythrough "
                             "(render_utils.py generate_path equivalent)")
    parser.add_argument("--save_depth", action="store_true",
                        help="write colormapped median-depth PNGs too")
    parser.add_argument("--video", action="store_true",
                        help="stitch the flythrough frames into .mp4s "
                             "(render_utils.py create_videos equivalent; "
                             "needs OpenCV, cv2)")
    parser.add_argument("--n_devices", default=1, type=int,
                        help="render views data-parallel over N ranks started here "
                             "(<= 0: every card; 1: one device)")
    parser.add_argument("--pair_capacity", default=1 << 22, type=int,
                        help="kept for flag parity with gsjax; the port sizes "
                             "its pair buffers from the real pair count")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' for the "
                             "plain-PyTorch path)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_combined_args(parser, argv)
    n = multihost.resolve_ranks(args.n_devices, getattr(args, "device", None))
    if n > 1 and not dist.is_initialized():
        launch.launch(_rank_main, n, args=(argv,),
                      device=getattr(args, "device", None) or "cuda", timeout=None,
                      threads=None)
        return
    dev = multihost.local_device(resolve_device(getattr(args, "device", None)))
    batch = multihost.ranks()
    write = multihost.is_primary()
    if args.video and args.traj_frames > 0:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "--video writes the flythrough with OpenCV (cv2), which does "
                f"not import here: {e}") from e

    iteration = args.iteration
    if iteration == -1:
        iteration = search_max_iteration(os.path.join(args.model_path, "point_cloud"))
    params, aux = load_ply(os.path.join(args.model_path, "point_cloud",
                                        f"iteration_{iteration}", "point_cloud.ply"),
                           device=dev)
    scene = load_scene(args.source_path, args.images, args.masks or None,
                       bool(getattr(args, "eval", False)), args.resolution,
                       args.white_background, device=dev)

    bg = torch.ones(3, device=dev) if args.white_background else torch.zeros(3, device=dev)
    cfg = RasterConfig(sh_degree=args.sh_degree,
                       sg_degree=getattr(args, "sg_degree", 0) or 0,
                       kernel_size=args.kernel_size, require_depth=True,
                       pair_capacity=args.pair_capacity, max_per_tile=1 << 12)

    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
        feats = gm.get_features(params)
        sg_axis, sg_sharp = gm.get_sg_axis(params), gm.get_sg_sharpness(params)

    @torch.no_grad()
    def render_fn(view):
        return render(params.xyz, scales, params.rotation, opac, feats,
                      view.camera, cfg, bg, sg_axis=sg_axis,
                      sg_sharpness=sg_sharp, sg_color=params.sg_color,
                      alive=aux.alive)

    if batch > 1:
        if write:
            print(f"view-parallel rendering over {batch} ranks", flush=True)

        def render_fn(views):             # noqa: F811 (the view-parallel form)
            outs = shard.render_views_sharded(params, aux, [v.camera for v in views], cfg, bg)
            return [{k: v[i] for k, v in outs.items()} for i in range(len(views))]

    kw = dict(save_depth=args.save_depth, on_view=on_view, batch=batch, write=write)
    if not args.skip_train:
        render_set(args.model_path, "train", iteration, scene.train_views, render_fn, **kw)
    if not args.skip_test and scene.test_views:
        render_set(args.model_path, "test", iteration, scene.test_views, render_fn, **kw)
    if args.traj_frames > 0:
        cams = generate_path([v.camera for v in scene.train_views],
                             n_frames=args.traj_frames)
        render_set(args.model_path, "traj", iteration,
                   [_TrajView(c) for c in cams], render_fn, **kw)
        if args.video and write:
            out = create_videos(
                args.model_path,
                os.path.join(args.model_path, "traj", f"ours_{iteration}"),
                f"traj_{iteration}", num_frames=args.traj_frames)
            print("videos:", ", ".join(out))


if __name__ == "__main__":
    main()

"""`sample_depth` split into its stages (port of gsjax's
`scripts/profile_sample.py`).

    python -m gsjax_torch.profile_sample [--iters 5] [--width 1920]
        [--height 1080] [--n 100000] [--out SAMPLE_PROFILE_torch.json]
        [--device cpu]

gsjax's workload (`query_workload`): 100k gaussians from `init_from_pcd`
(KNN distance 1e-4, SH degree 1), the identity camera and its neighbour
turned 0.05 rad and shifted 0.15, and as the query cloud the reference
view's depth 4 +- 0.1 back-projected at every pixel (2.07 M points at
1080p: a dense load, against bench_reg's 48,401 depth-valid queries). The
port's `ops/sample.py:sample_depth` splits into gsjax's stages, each timed
alone (`utils/benchsync.time_stage`):

  prep fwd, prep fwd+bwd: `prepare_view`, the neighbour's preprocess,
      binning and pair payload (forward; forward and the gradient of
      sum(payload^2) in the means and scales, as gsjax's);
  layout fwd: `prepare_points`, the projection, the stable tile sort and the
      block table;
  kernel fwd: B3 (`sample_cuda.sample_fwd`) on the prepared query;
  kernel fwd+bwd: B3 and B5 (`sample_cuda.SampleDepth`), the gradient of
      sum(m_t) in the payload and the points;
  full fwd, full fwd+bwd: `sample_depth`, and the gradient of the summed
      depth in the points, means and scales.

gsjax's round statistics become the port's: `mean pts per tile` (the points
inside the view over the tiles, as gsjax's), `point blocks` (blocks of at
most 256 points of one tile, `point_blocks`: the port's unit of work, in
gsjax's `r_total (live rounds)` too) and `block fill`. gsjax's `r_cap (grid
size)` is its static TPU round grid: null, with the reason under `notes`.
On the CPU the kernels' plain versions run. The device is the card unless
`--device cpu`; with no card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gsjax_torch.utils import benchsync


def query_workload(width: int, height: int, n: int, device, sh_degree: int = 1):
    """gsjax's profile_sample / profile_reg model and cameras
    (profile_sample.py:59-81): (params, aux, scales, opacities, cam, near,
    cfg, rng), `rng` after the points' and colours' draws."""
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera, RasterConfig

    rng = np.random.default_rng(0)
    points = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    points[:, 2] += 5.0
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    params, aux = gm.init_from_pcd(points, colors, n, sh_degree=sh_degree, sg_degree=0,
                                   knn_dist2=np.full((n,), 1e-4, np.float32), device=device)
    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    th = 0.05
    r2 = np.eye(3, dtype=np.float32)
    r2[0, 0] = r2[2, 2] = np.cos(th)
    r2[0, 2] = np.sin(th)
    r2[2, 0] = -np.sin(th)
    near = Camera.create(r2, np.asarray([0.15, 0.0, 0.0], np.float32), 1.0, 0.66,
                         width, height, device=device)
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        width, height, device=device)
    cfg = RasterConfig(pair_capacity=1 << 21, live_capacity=1 << 20, max_per_tile=1 << 11,
                       sh_degree=sh_degree, require_depth=True)
    return params, aux, scales, opac, cam, near, cfg, rng


def backproject(depth: np.ndarray, cam) -> np.ndarray:
    """[H, W] z-depth of `cam` -> [H*W, 3] float32 points (profile_sample.py:84-88)."""
    height, width = depth.shape
    xs = (np.arange(width) - cam.cx) / cam.fx
    ys = (np.arange(height) - cam.cy) / cam.fy
    return np.stack([depth * xs[None, :], depth * ys[:, None], depth],
                    -1).reshape(-1, 3).astype(np.float32)


def profile(width: int, height: int, n: int, iters: int, device) -> dict:
    from gsjax_torch.ops import sample, sample_cuda, sample_ref
    from gsjax_torch.ops.raster.api import select

    time_stage = benchsync.time_stage
    params, aux, scales, opac, cam, near, cfg, rng = query_workload(width, height, n, device)
    depth = (4.0 + rng.normal(0, 0.1, (height, width))).astype(np.float32)
    pts = torch.as_tensor(backproject(depth, cam), device=device)
    xyz, rot, alive = params.xyz.detach(), params.rotation.detach(), aux.alive
    results, notes = {}, {}

    time_stage(lambda *a: sample.prepare_view(*a, near, cfg, alive),
               (xyz, scales, rot, opac), iters, "prep fwd", results, device)
    xyz_g, scales_g = xyz.clone().requires_grad_(True), scales.clone().requires_grad_(True)

    def prep_fwd_bwd():
        f = sample.prepare_view(xyz_g, scales_g, rot, opac, near, cfg, alive).feats
        return torch.autograd.grad((f * f).sum(), [xyz_g, scales_g])

    time_stage(prep_fwd_bwd, (), iters, "prep fwd+bwd", results, device)

    view = sample.prepare_view(xyz, scales, rot, opac, near, cfg, alive)
    qr = time_stage(lambda p: sample.prepare_points(view, p, near, cfg), (pts,), iters,
                    "layout fwd", results, device)
    tiles_x, tiles_y = cfg.grid(width, height)
    inside = int(qr.sorted_q.shape[0])
    blocks = int(qr.blocks.shape[0])
    results["r_total (live rounds)"] = blocks
    results["r_cap (grid size)"] = None
    notes["r_total (live rounds)"] = ("the port's point blocks (at most 256 points of one "
                                      "tile, ops/sample.py:point_blocks), its unit of work")
    notes["r_cap (grid size)"] = ("gsjax's static grid of 1024-point rounds, a TPU layout; "
                                  "the port launches one block per point block, no grid")
    results["mean pts per tile"] = round(inside / (tiles_x * tiles_y), 1)
    results["point blocks"] = blocks
    results["points inside"] = inside
    results["block fill"] = round(inside / max(blocks, 1) / 256, 4)
    print(f"blocks: {blocks} for {inside} points inside; pts/tile mean "
          f"{results['mean pts per tile']}", flush=True)

    fwd, bwd = select(cfg, device, (sample_cuda.sample_fwd, sample_cuda.sample_bwd),
                      (sample_ref.sample_fwd_rows, sample_ref.sample_bwd_rows))
    lists = (qr.binning.tile_start, qr.binning.tile_count)
    time_stage(lambda: fwd(qr.feats, *lists, qr.pts, qr.blocks, cfg), (), iters,
               "kernel fwd", results, device)
    feats_g = qr.feats.detach().clone().requires_grad_(True)
    pts_g = qr.pts.detach().clone().requires_grad_(True)

    def kernel_fwd_bwd():
        res = sample_cuda.SampleDepth.apply(feats_g, pts_g, *lists, qr.blocks, cfg, fwd, bwd)
        return torch.autograd.grad(res[0].sum(), [feats_g, pts_g])

    time_stage(kernel_fwd_bwd, (), iters, "kernel fwd+bwd", results, device)

    def full_fwd():
        with torch.no_grad():
            return sample.sample_depth(pts, xyz, scales, rot, opac, near, cfg,
                                       alive)["sampled_depth"]

    time_stage(full_fwd, (), iters, "full fwd", results, device)
    pts_l = pts.clone().requires_grad_(True)

    def full_fwd_bwd():
        d = sample.sample_depth(pts_l, xyz_g, scales_g, rot, opac, near, cfg,
                                alive)["sampled_depth"]
        return torch.autograd.grad(d.sum(), [pts_l, xyz_g, scales_g])

    time_stage(full_fwd_bwd, (), iters, "full fwd+bwd", results, device)
    results["notes"] = notes
    results["device"] = str(device)
    results["nvidia_smi"] = benchsync.smi_line() if device.type == "cuda" else None
    results["queries"] = width * height
    print(json.dumps(results, indent=1), flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", default="SAMPLE_PROFILE_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "profile_sample")
    rec = profile(args.width, args.height, args.n, args.iters, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()

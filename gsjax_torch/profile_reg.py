"""The regularisation phase's pieces, timed alone (port of gsjax's
`scripts/profile_reg.py`).

    python -m gsjax_torch.profile_reg [--iters 5] [--width 1920]
        [--height 1080] [--n 100000] [--out REG_PROFILE_torch.json]
        [--device cpu]

gsjax's workload: `profile_sample.query_workload`'s model and cameras, then
the reference view's depth 4 +- 0.1, normals tilted by N(0, 0.05) from -z
and two uniform gray frames, drawn in gsjax's order (profile_reg.py:77-84).
Each piece is timed alone (`utils/benchsync.time_stage`) under gsjax's key:

  sample_depth fwd @<Q/1000>k pts, sample_depth fwd+bwd: `ops/sample.py:
      sample_depth` on the back-projected depth (every pixel), and the
      gradient of the summed depth in the points and means (B3, B5);
  ncc fwd (49 taps), ncc fwd+bwd: `ops/ncc.py:warp_patch_ncc` (B6 inside)
      and the gradient of the summed NCC in the depth and normals;
  gather2d 2M, gather1d 2M, gather1d 2Mx4 (batched corners): gsjax's three
      gather forms as the torch indexing they are, `img[v, u]`,
      `img.view(-1)[v * W + u]` and `img.view(-1)[idx]` with idx [Q, 4], at
      one index per pixel (gsjax's labels name 1080p's 2 M);
  patchmatch_terms fwd: `train/multiview.py:patchmatch_terms`, what the
      train step embeds.

On the CPU the kernels' plain versions run. The device is the card unless
`--device cpu`; with no card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gsjax_torch.profile_sample import backproject, query_workload
from gsjax_torch.utils import benchsync


def profile(width: int, height: int, n: int, iters: int, device) -> dict:
    from gsjax_torch.ops.ncc import warp_patch_ncc
    from gsjax_torch.ops.sample import sample_depth
    from gsjax_torch.train.multiview import patchmatch_terms

    time_stage = benchsync.time_stage
    hw = width * height
    params, aux, scales, opac, cam, near, cfg, rng = query_workload(width, height, n, device)
    depth_np = (4.0 + rng.normal(0, 0.1, (height, width))).astype(np.float32)
    nrm = np.concatenate([rng.normal(0, 0.05, (height, width, 2)),
                          -np.ones((height, width, 1))], -1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    gray_r = torch.as_tensor(rng.uniform(0, 1, (height, width)).astype(np.float32),
                             device=device)
    gray_n = torch.as_tensor(rng.uniform(0, 1, (height, width)).astype(np.float32),
                             device=device)
    depth = torch.as_tensor(depth_np, device=device)
    nrm = torch.as_tensor(nrm, device=device)
    xyz, rot, alive = params.xyz.detach(), params.rotation.detach(), aux.alive
    results = {}

    pts = torch.as_tensor(backproject(depth_np, cam), device=device)

    def sd_fwd():
        with torch.no_grad():
            return sample_depth(pts, xyz, scales, rot, opac, near, cfg, alive)["sampled_depth"]

    time_stage(sd_fwd, (), iters, f"sample_depth fwd @{hw // 1000}k pts", results, device)
    pts_g, xyz_g = pts.clone().requires_grad_(True), xyz.clone().requires_grad_(True)

    def sd_bwd():
        d = sample_depth(pts_g, xyz_g, scales, rot, opac, near, cfg, alive)["sampled_depth"]
        return torch.autograd.grad(d.sum(), [pts_g, xyz_g])

    time_stage(sd_bwd, (), iters, "sample_depth fwd+bwd", results, device)

    rel = near.world_view @ torch.linalg.inv(cam.world_view)
    rel_r, rel_t = rel[:3, :3].contiguous(), rel[:3, 3].contiguous()
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)

    def ncc_fwd():
        with torch.no_grad():
            return warp_patch_ncc(depth, nrm, gray_r, gray_n, rel_r, rel_t, intr, intr)[0]

    time_stage(ncc_fwd, (), iters, "ncc fwd (49 taps)", results, device)
    depth_g, nrm_g = depth.clone().requires_grad_(True), nrm.clone().requires_grad_(True)

    def ncc_bwd():
        c = warp_patch_ncc(depth_g, nrm_g, gray_r, gray_n, rel_r, rel_t, intr, intr)[0]
        return torch.autograd.grad(c.sum(), [depth_g, nrm_g])

    time_stage(ncc_bwd, (), iters, "ncc fwd+bwd", results, device)

    vi = torch.as_tensor(rng.integers(0, height, hw, dtype=np.int32), device=device).long()
    ui = torch.as_tensor(rng.integers(0, width, hw, dtype=np.int32), device=device).long()
    time_stage(lambda g, v, u: g[v, u], (gray_n, vi, ui), iters, "gather2d 2M", results,
               device)
    time_stage(lambda g, v, u: g.view(-1)[v * width + u], (gray_n, vi, ui), iters,
               "gather1d 2M", results, device)
    lin = torch.as_tensor(rng.integers(0, hw, (hw, 4), dtype=np.int32), device=device).long()
    time_stage(lambda g, i: g.view(-1)[i], (gray_n, lin), iters,
               "gather1d 2Mx4 (batched corners)", results, device)

    def pm():
        with torch.no_grad():
            return patchmatch_terms(depth, nrm, xyz, scales, rot, opac, alive, cam, near,
                                    gray_r, gray_n, cfg)

    time_stage(pm, (), iters, "patchmatch_terms fwd", results, device)
    results["device"] = str(device)
    results["nvidia_smi"] = benchsync.smi_line() if device.type == "cuda" else None
    results["queries"] = hw
    print(json.dumps(results, indent=1), flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", default="REG_PROFILE_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "profile_reg")
    rec = profile(args.width, args.height, args.n, args.iters, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()

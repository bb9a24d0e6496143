"""Where recipe A's densification comes from, on the card.

    python3 probe_golden.py [--steps 1500] [--out probe_golden.json] [-- GOLDEN FLAGS]

Trains gsjax's golden recipe A (`python -m gsjax_torch.golden_quality`'s
flags of `scripts/quality_r04.py`, or those given after `--`) up to
`--steps`, then, on that model, for every training view against its first
neighbour:

  - the densification statistic of each loss term: |d term / d mean2d| in
    NDC units (`model/gaussians.py:add_densification_stats`) over the
    view's visible gaussians, its mean and the share at or above the
    densify threshold (1e-4), for the photometric, depth-normal, NCC and
    geometric terms with the step's weights, and for their sum;
  - the NCC's pixels (`train/multiview.py:patchmatch_terms`' mask) with
    every tap sampled (the port, the reference) and those that gsjax's TPU
    sampler window would keep (`tpu_window_ok_dense`), and the median
    distance of the pixels the window alone drops, and of those it keeps,
    to the nearest pixel without depth.

gsjax's TPU sampler (gsjax/ops/warp_sample.py:41-55, :67-111) samples each
16x16 block's taps from a [48, 64] window of the neighbour image placed at
the block's smallest tap, and its NCC drops every pixel with a tap outside
it. A block that holds a pixel without depth (whose homography throws its
taps far away) places its window there and loses its valid pixels too. The
port samples every tap, as the reference does; this script only measures
what the window would drop.

Prints one JSON line per view and a summary line, and writes them to
`--out`. Runs on the card only (kernels B1-B6); exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RECIPE_A = ["--scene", "sphere", "--iterations", "3000", "--reset_interval", "900",
            "--n_gauss", "2000", "--tetra", "--width", "320", "--height", "240",
            "--sh_degree", "3", "--sg_degree", "2", "--densify_grad_threshold", "1e-4",
            "--n_images", "28"]


# gsjax's TPU sampler window: rows, DMA columns, sampled columns; pixel block side
TPU_RV, TPU_RU, TPU_RU_E = 48, 256, 64
BLK = 16


class _Stop(Exception):
    pass


def tpu_window_ok(un, vn, h_img: int, w_img: int):
    """[B, P] bool: the pixels of blocks of tap positions un, vn [B, K, P]
    whose every tap lies in gsjax's TPU window (warp_sample.py:67-111) of a
    neighbour image padded to [h_img, w_img]: columns from the block's
    smallest tap less one, rows from there aligned down to 16. A non-finite
    tap counts as -inf."""
    import torch

    clean = lambda t: torch.nan_to_num(t.detach(), nan=-3e38, posinf=3e38, neginf=-3e38)
    ub, vb = clean(un), clean(vn)
    # floor of the block's smallest tap as an int32, less one, clipped
    start = lambda t, hi: torch.clamp(
        torch.floor(t.amin(dim=(1, 2))).clamp(-2.0 ** 31, 2.0 ** 31 - 1) - 1, 0, hi)
    umin = start(ub, w_img - TPU_RU)[:, None, None]
    vmin = (torch.div(start(vb, h_img - TPU_RV), 16, rounding_mode="floor") * 16)[:, None, None]
    u_hi = min(TPU_RU_E, w_img) - 1.001
    ur, vr = ub - umin, vb - vmin
    return ((ur >= 0) & (ur <= u_hi) & (vr >= 0) & (vr <= TPU_RV - 1.001)).all(dim=1)


def tpu_window_ok_dense(un_k, vn_k):
    """[Hs, W] bool: `tpu_window_ok` of the dense taps [K, Hs, W], blocked as
    gsjax's dense sampler blocks them (edge-replicated to whole blocks, the
    image padded past the last block by a window, warp_sample.py:194-203)."""
    import torch.nn.functional as F

    k, hs, w = un_k.shape
    hb, wb = -(-hs // BLK), -(-w // BLK)

    def blocks(x):
        x = F.pad(x[None], (0, wb * BLK - w, 0, hb * BLK - hs), mode="replicate")[0]
        return x.reshape(k, hb, BLK, wb, BLK).permute(1, 3, 0, 2, 4).reshape(hb * wb, k, BLK * BLK)

    ok = tpu_window_ok(blocks(un_k), blocks(vn_k), max(-(-hs // 16) * 16, hb * BLK + TPU_RV),
                       max(-(-w // 128) * 128, wb * BLK + TPU_RU))
    ok = ok.reshape(hb, wb, BLK, BLK).permute(0, 2, 1, 3).reshape(hb * BLK, wb * BLK)
    return ok[:hs, :w]


def train_to(argv, steps):
    """The golden CLI on `argv`, stopped after step `steps`; its Trainer."""
    from gsjax_torch import golden_quality

    held = {}

    def on_step(trainer, metrics):
        if trainer.iteration >= steps:
            held["trainer"] = trainer
            raise _Stop

    try:
        golden_quality.main(argv, on_step=on_step)
    except _Stop:
        return held["trainer"]
    raise RuntimeError(f"the run ended before step {steps}")


def view_terms(tr, view, near, threshold):
    """The per-term densification statistics and the NCC's pixels of one view."""
    import torch
    from scipy.ndimage import distance_transform_edt

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops import ncc as ncc_ops
    from gsjax_torch.ops.raster import render
    from gsjax_torch.train import losses, multiview

    o, p, aux = tr.opt, tr.params, tr.aux
    cfg = tr.raster_cfg(require_depth=True)
    tap = torch.zeros(p.capacity, 2, device=tr.device, requires_grad=True)
    scales, opac = gm.scaling_n_opacity_with_3d_filter(p, aux.filter_3d)
    out = render(p.xyz, scales, p.rotation, opac, gm.get_features(p), view.camera, cfg,
                 tr.bg(), sg_axis=gm.get_sg_axis(p), sg_sharpness=gm.get_sg_sharpness(p),
                 sg_color=p.sg_color, alive=aux.alive, mean2d_offset=tap)
    if out["max_tile_count"] > cfg.max_per_tile:
        cfg = dataclasses.replace(cfg, max_per_tile=int(out["max_tile_count"]) * 2)
        return view_terms(dataclasses.replace(tr, max_per_tile=cfg.max_per_tile), view,
                          near, threshold)
    img, gt = out["render"], tr.gt_for(view)
    cam = view.camera
    dnorm, valid = losses.depth_to_normal(out["median_depth"], cam.fx, cam.fy, cam.cx, cam.cy)
    ncc, geo, _, _, _ = multiview.patchmatch_losses(
        out["median_depth"], out["normal"], p.xyz, scales, p.rotation, opac, aux.alive, cam,
        near.camera, tr.gray_for(view), tr.gray_for(near), cfg, o.multi_view_pixel_noise_th,
        o.multi_view_patch_size)
    terms = {"rgb": (1 - o.lambda_dssim) * losses.l1_loss(img, gt)
             + o.lambda_dssim * (1 - losses.ssim(img, gt)),
             "depth_normal": o.lambda_depth_normal * losses.depth_normal_loss(
                 out["normal"], dnorm, valid),
             "ncc": o.lambda_multi_view_ncc * ncc, "geo": o.lambda_multi_view_geo * geo}
    vis = out["visibility"] & aux.alive
    ndc = torch.tensor([0.5 * cam.width, 0.5 * cam.height], device=tr.device)
    res, total = {"view": view.uid, "near": near.uid}, 0
    for name, t in terms.items():
        g, = torch.autograd.grad(t, tap, retain_graph=True, allow_unused=True)
        g = torch.zeros_like(tap) if g is None else g
        total = total + g
        s = torch.linalg.norm(g * ndc, dim=1)[vis]
        res[name] = {"value": float(t.detach()), "mean": float(s.mean()),
                     "share_ge_threshold": float((s >= threshold).float().mean())}
    s = torch.linalg.norm(total * ndc, dim=1)[vis]
    res["total"] = {"mean": float(s.mean()), "share_ge_threshold": float((s >= threshold).float().mean())}

    # the NCC's pixels with every tap, and those gsjax's TPU window keeps
    with torch.no_grad():
        _, _, d_mask, _, _, _ = multiview._geo_terms(
            multiview.backproject(out["median_depth"], cam), out["median_depth"], p.xyz,
            scales, p.rotation, opac, aux.alive, cam, near.camera, cfg,
            o.multi_view_pixel_noise_th)
        nrm2 = (out["normal"] ** 2).sum(-1, keepdim=True)
        nrm = torch.where(nrm2 > 1e-20, out["normal"] * torch.rsqrt(nrm2.clamp_min(1e-20)), 0.0)
        rel = near.camera.world_view @ multiview._invert_rigid(cam.world_view)
        args = (out["median_depth"], nrm, tr.gray_for(view), tr.gray_for(near), rel[:3, :3],
                rel[:3, 3], (cam.fx, cam.fy, cam.cx, cam.cy),
                (near.camera.fx, near.camera.fy, near.camera.cx, near.camera.cy))
        cc, cc_valid = ncc_ops.warp_patch_ncc(*args, radius=o.multi_view_patch_size)
        kept = {False: ((1 - cc).clamp(0, 2) < 0.9) & cc_valid & d_mask}
        kept[True] = kept[False] & tpu_window_ok_dense(*ncc_ops.neighbour_taps(
            *args[:2], *args[4:], radius=o.multi_view_patch_size))
        dist = distance_transform_edt(out["median_depth"].cpu().numpy() > 0)
        dropped = (kept[False] & ~kept[True]).cpu().numpy()
        both = kept[True].cpu().numpy()
        res["ncc_pixels"] = {"every_tap": int(kept[False].sum()), "tpu_window": int(kept[True].sum()),
                             "dropped_median_px_to_no_depth": float(np.median(dist[dropped]))
                             if dropped.any() else None,
                             "kept_median_px_to_no_depth": float(np.median(dist[both]))
                             if both.any() else None}
    return res


def main(argv=None):
    import torch

    if not torch.cuda.is_available():
        print("probe_golden: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    golden = RECIPE_A
    if "--" in argv:
        golden, argv = argv[argv.index("--") + 1:], argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--out", default="probe_golden.json")
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="probe_golden_", dir=os.path.join(ROOT, "build"))
    tempfile.tempdir = tmp      # the golden run's scene and model
    try:
        return probe(golden + ["--out", os.path.join(tmp, "q.json"), "--no_resume"], args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe(golden, args):
    import torch

    tr = train_to(golden, args.steps)
    rows = []
    for view in tr.scene.train_views:
        if view.nearest_ids:
            rows.append(view_terms(tr, view, tr.scene.train_views[view.nearest_ids[0]],
                                   tr.opt.densify_grad_threshold))
            print(json.dumps(rows[-1]), flush=True)
    summary = {"steps": tr.iteration, "alive": int(tr.aux.alive.sum()), "views": len(rows),
               "device": torch.cuda.get_device_name(0)}
    for name in ("rgb", "depth_normal", "ncc", "geo", "total"):
        summary[name] = {k: float(np.mean([r[name][k] for r in rows]))
                         for k in ("mean", "share_ge_threshold")}
    for k in ("every_tap", "tpu_window"):
        summary[f"ncc_pixels_{k}"] = int(sum(r["ncc_pixels"][k] for r in rows))
    print(json.dumps(summary), flush=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "views": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

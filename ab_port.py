"""Time gsjax_torch's kernels and steps on one card from a given checkout, so
that two commits can be compared on the same card, one after the other:

    python3 ab_port.py [ROOT] [--label NAME]

ROOT (default: this file's directory) is the checkout whose `gsjax_torch`
and `chip_smoke.py` are imported; its kernels build into ROOT/build. Prints
one JSON line of CUDA-event milliseconds at chip_smoke's workloads
(1920x1080, bench.py's 100k gaussians): B1 with and without the median
depth, B2, B3 on the multi-view query and on the tetra points of a
100k-gaussian sphere, B4 on those points, B5, B6, a whole `render()`, a
train step with regularisation and one with the multi-view losses, beside
the card's name and power limit. To compare commits, unpack the other one
under build/ and run the two in turns (A, B, B, A) on the same machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 30        # launches per kernel timing (chip_smoke's event_ms takes 10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("ab_port: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops import sample_cuda
    from gsjax_torch.ops import warp_sample as ws
    from gsjax_torch.ops.raster import RasterConfig, render, render_cuda
    from gsjax_torch.ops.sample import prepare_query
    from gsjax_torch.train.step import LossConfig, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    w, h, n = 1920, 1080, 100_000
    out = {"label": args.label, "root": root, "nvidia_smi": cs.smi_line()}

    # B1, B2 and render() on bench.py's frame
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cfg_nd = RasterConfig(sh_degree=3, require_depth=False, max_per_tile=1 << 12)
    cam = cs.bench_camera(w, h, dev)
    g = cs.bench_gaussians(n)
    gt = torch.as_tensor(cs.bench_gt(n, w, h), device=dev)
    scene, _, binning, feats = cs.stages(g, cam, cfg, dev)
    bg = torch.zeros(3, device=dev)
    lists = (feats, binning.tile_start, binning.tile_count)
    tail = (w, h, cam.fx, cam.fy, bg)
    out["b1_ms"] = cs.event_ms(lambda: render_cuda.blend_fwd(*lists, *tail, cfg), reps=REPS)
    out["b1_no_depth_ms"] = cs.event_ms(lambda: render_cuda.blend_fwd(*lists, *tail, cfg_nd),
                                        reps=REPS)
    planes = render_cuda.blend_fwd(*lists, *tail, cfg)
    grad = cs.bench_cotangent(planes, gt, True)
    out["b2_ms"] = cs.event_ms(lambda: render_cuda.blend_bwd(*lists, planes, grad, *tail, cfg),
                               reps=REPS)
    out["render_ms"] = cs.event_ms(lambda: render(*scene, cam, cfg, bg))
    del planes, grad, feats, binning

    # train steps (each ends in a host read of the loss)
    params, aux = cs.bench_params(g, dev)
    adam = gm.adam_init(params)
    lrs = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
               scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
               sg_color=0.00064)
    out["train_step_reg_on_ms"] = cs.event_ms(lambda: train_step(
        params, aux, adam, cam, gt, bg, lrs, cfg, LossConfig(reg_on=True)), reps=5)

    # B3, B5, B6 and the multi-view step on the neighbour query
    sc = cs.mv_scene(w, h, n, dev)
    cfg = sc["cfg"]
    qr = prepare_query(sc["points"], *sc["args"], sc["cams"][1], cfg)
    q_lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, qr.blocks)
    out["b3_ms"] = cs.event_ms(lambda: sample_cuda.sample_fwd(*q_lists, cfg), reps=REPS)
    rows = sample_cuda.sample_fwd(*q_lists, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cot = torch.randn(qr.pts.shape[0], generator=gen, device=dev)
    out["b5_ms"] = cs.event_ms(lambda: sample_cuda.sample_bwd(*q_lists, rows, cot, cfg),
                               reps=REPS)
    un, vn = cs.scene_taps(sc)
    gray_n = sc["gray"][1]
    out["b6_ms"] = cs.event_ms(lambda: ws.warp_sample(gray_n, un, vn), reps=REPS)
    del un, vn, rows
    ref, near = sc["cams"]
    mv = dict(near_cam=near, gray_r=sc["gray"][0], gray_n=gray_n)
    out["train_step_mv_ms"] = cs.event_ms(lambda: train_step(
        params, aux, adam, ref, gt, bg, lrs, cfg, LossConfig(reg_on=True, mv_on=True), **mv),
        reps=5)
    del sc, qr, q_lists, params, aux, adam

    # B3 and B4 on the tetra points of a sphere
    qr, t_eval, cfg = cs.sphere_query(w, h, n, dev)
    p_lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts)
    out["b4_ms"] = cs.event_ms(lambda: sample_cuda.integrate_fwd(*p_lists, t_eval,
                                                                 qr.blocks, cfg), reps=REPS)
    out["b3_tetra_ms"] = cs.event_ms(lambda: sample_cuda.sample_fwd(*p_lists, qr.blocks, cfg),
                                     reps=REPS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

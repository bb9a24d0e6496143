"""Time gsjax_torch's kernels and steps on one card from a given checkout, so
that two commits can be compared on the same card, one after the other:

    python3 ab_port.py [ROOT] [--label NAME]

ROOT (default: this file's directory) is the checkout whose `gsjax_torch`
and `chip_smoke.py` are imported; its kernels build into ROOT/build. Prints
one JSON line of CUDA-event milliseconds at chip_smoke's workloads
(1920x1080, bench.py's 100k gaussians): B1 with and without the median
depth, B2 with and without it, B3 on the multi-view query and on the tetra
points of a 100k-gaussian sphere, B4 on those points (in the order of the
checkout's integrate path), B5, B6, the dense NCC's forward + backward, a
whole `render()`, preprocess forward + backward (as chip_smoke's
`timing_train`), a train step with regularisation and one with the
multi-view losses (each also with the allocator's peak over one call),
beside the card's name and power limit; where the
checkout has the block-compacted NCC, also B6 on its compacted taps, its
forward + backward and the multi-view step with it; where the checkout's kernels have profile counters, also
B2's and B5's readings of them (`render_cuda.bwd_stats`) and B4's
(`sample_cuda.integrate_stats`); and the host-clock time of one
`integrate_view` call at the meshing scene's size (`integrate_view_ms`: the
point prep, B4 and the scatter), with B4's time there, both also with the
points in tile order where the checkout's integrate sorts them by pixel
(`integrate_view_tile_order_ms`). To compare commits, unpack the other one
under build/ and run the two in turns (A, B, B, A) on the same machine.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

REPS = 30        # launches per kernel timing (chip_smoke's event_ms takes 10)


def peak_bytes(fn):
    """The allocator's peak over one call of `fn`, in bytes."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def integrate_views(cs, dev, w, h, n=20_000, rounds=4, reps=10):
    """One `integrate_view` call (the point prep, B4 and the scatter, ending
    in a synchronise) on the tetra points of chip_smoke's meshing scene, an
    n-gaussian sphere in ring view 0 of 8: its host-clock ms in the
    checkout's own order and, where the checkout's integrate sorts points by
    pixel, with its point prep made to sort by tile alone, the two timed in
    alternating rounds, each beside its point prep alone (`prepare_points`);
    and B4's CUDA-event ms on each order's points."""
    import time

    import torch

    from gsjax_torch.core.transforms import focal2fov
    from gsjax_torch.data.synth import ring_pose, sphere_gaussians
    from gsjax_torch.mesh.extract import get_tetra_points
    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops import sample as smp
    from gsjax_torch.ops import sample_cuda
    from gsjax_torch.ops.raster import Camera, RasterConfig

    params, aux = cs.bench_params(sphere_gaussians(n, seed=0), dev)
    pts, _ = get_tetra_points(params, aux)
    r_w2c, tvec = ring_pose(0, 8)
    cam = Camera.create(r_w2c.T, tvec, focal2fov(0.9 * w, w), focal2fov(0.9 * w, h), w, h,
                        device=dev)
    cfg = RasterConfig(require_depth=True, max_per_tile=1 << 12)
    own = smp.prepare_points
    pixel = "pixel_order" in inspect.signature(own).parameters
    # each order: the point prep integrate_view is to call, and its arguments
    orders = {"": (own, {"pixel_order": True} if pixel else {})}
    if pixel:
        orders["_tile_order"] = (lambda view, points, camera, cfg_, pixel_order=False: own(
            view, points, camera, cfg_), {})
    host = {k: [] for k in orders}
    host_prep = {k: [] for k in orders}
    out = {}
    with torch.no_grad():
        scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
        view = smp.prepare_view(params.xyz, scales, params.rotation, opac, cam, cfg, aux.alive)
        try:
            for r in range(rounds + 1):
                for key, (prep, kw) in orders.items():
                    smp.prepare_points = prep
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        smp.integrate_view(view, pts, cam, cfg)
                    torch.cuda.synchronize()
                    if r:                              # round 0 warms up
                        host[key].append((time.perf_counter() - t0) / reps * 1e3)
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        prep(view, pts, cam, cfg, **kw)
                    torch.cuda.synchronize()
                    if r:
                        host_prep[key].append((time.perf_counter() - t0) / reps * 1e3)
        finally:
            smp.prepare_points = own
        for key, (prep, kw) in orders.items():
            qr = prep(view, pts, cam, cfg, **kw)
            t_eval = qr.t_ray[qr.sorted_q].contiguous()
            out[f"integrate_view{key}_ms"] = sum(host[key]) / len(host[key])
            out[f"integrate_view{key}_rounds_ms"] = host[key]
            out[f"point_prep{key}_ms"] = sum(host_prep[key]) / len(host_prep[key])
            out[f"b4_mesh_scene{key}_ms"] = cs.event_ms(lambda: sample_cuda.integrate_fwd(
                qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, t_eval,
                qr.blocks, cfg), reps=REPS)
        out["mesh_scene_points"] = int(qr.pts.shape[0])
    return out


def ncc_timings(cs, sc):
    """The dense NCC's forward + backward on the multi-view cell (the sum of
    1 - ncc^2 over valid pixels, as chip_smoke's `timing_mv`) and, where the
    checkout has the block-compacted NCC, B6 on the compacted blocks' taps
    and the block NCC's forward + backward on the reference view's
    geometric mask."""
    import torch

    from gsjax_torch.ops import ncc as ncc_ops
    from gsjax_torch.ops import warp_sample as ws
    from gsjax_torch.train.multiview import _invert_rigid

    ref, near = sc["cams"]
    nrm = sc["normal"] / sc["normal"].norm(dim=-1, keepdim=True).clamp_min(1e-12)
    rel = near.world_view @ _invert_rigid(ref.world_view)
    args = (sc["depth"].clone().requires_grad_(True), nrm.clone().requires_grad_(True),
            sc["gray"][0], sc["gray"][1], rel[:3, :3], rel[:3, 3],
            (ref.fx, ref.fy, ref.cx, ref.cy), (near.fx, near.fy, near.cx, near.cy))

    def dense():
        cc, valid = ncc_ops.warp_patch_ncc(*args)
        return torch.autograd.grad(torch.where(valid, 1 - cc, 0.0).sum(), args[:2])

    out = {"ncc_fwd_bwd_ms": cs.event_ms(dense, reps=5)}
    if not hasattr(ncc_ops, "warp_patch_ncc_blocks"):
        return out
    un, vn = ncc_ops.block_neighbour_taps(args[0].detach(), args[1].detach(), sc["d_mask"],
                                          *args[4:])
    out["b6b_ms"] = cs.event_ms(lambda: ws.warp_sample_blocks(args[3], un, vn), reps=REPS)
    del un, vn

    def blocks():
        s, *_ = ncc_ops.warp_patch_ncc_blocks(*args, sc["d_mask"], sc["weights"])
        return torch.autograd.grad(s, args[:2])

    out["ncc_blocks_fwd_bwd_ms"] = cs.event_ms(blocks, reps=5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--mesh", action="store_true",
                    help="run the checkout's chip_smoke `mesh` phase (both meshing CLIs) "
                         "in place of the kernel timings")
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
    from gsjax_torch.ops.raster.preprocess import preprocess
    from gsjax_torch.ops.raster.render_ref import prepare_pairs
    from gsjax_torch.ops.sample import prepare_query
    from gsjax_torch.train.step import LossConfig, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    w, h, n = 1920, 1080, 100_000
    out = {"label": args.label, "root": root, "nvidia_smi": cs.smi_line()}
    if args.mesh:
        print(json.dumps(out), flush=True)
        cs.phase_mesh(dev)
        return 0
    # first, while the process's allocator holds nothing else
    out.update(integrate_views(cs, dev, w, h))

    # B1, B2 and render() on bench.py's frame
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cfg_nd = RasterConfig(sh_degree=3, require_depth=False, max_per_tile=1 << 12)
    cam = cs.bench_camera(w, h, dev)
    if hasattr(cs, "bench_inputs"):
        *g, gt = cs.bench_inputs(w, h, n)
    else:                    # a checkout before the draws moved to gsjax_torch.bench
        g, gt = cs.bench_gaussians(n), cs.bench_gt(n, w, h)
    gt = torch.as_tensor(gt, device=dev)
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
    profiled = hasattr(render_cuda, "bwd_counters")
    if profiled:
        ctr = render_cuda.bwd_counters(dev)
        render_cuda.blend_bwd(*lists, planes, grad, *tail, cfg, counters=ctr)
        out["b2_profile"] = render_cuda.bwd_stats(ctr)
    planes_nd = render_cuda.blend_fwd(*lists, *tail, cfg_nd)
    grad_nd = cs.bench_cotangent(planes_nd, gt, False)
    out["b2_no_depth_ms"] = cs.event_ms(lambda: render_cuda.blend_bwd(
        *lists, planes_nd, grad_nd, *tail, cfg_nd), reps=REPS)
    del planes_nd, grad_nd
    out["render_ms"] = cs.event_ms(lambda: render(*scene, cam, cfg, bg))

    # preprocess under autograd, as chip_smoke's timing_train phase times it
    prep_in = [a.clone().requires_grad_(True) for a in scene]
    d_feats = render_cuda.blend_bwd(*lists, planes, grad, *tail, cfg)

    def prep_bwd():
        p = preprocess(*prep_in, None, None, None, cam, cfg)
        return torch.autograd.grad(prepare_pairs(p, binning), prep_in, d_feats,
                                   allow_unused=True)

    out["preprocess_fwd_bwd_ms"] = cs.event_ms(prep_bwd, reps=REPS)
    del planes, grad, feats, binning, prep_in, d_feats

    # train steps (each ends in a host read of the loss)
    params, aux = cs.bench_params(g, dev)
    adam = gm.adam_init(params)
    lrs = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
               scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
               sg_color=0.00064)
    def step_reg():
        return train_step(params, aux, adam, cam, gt, bg, lrs, cfg, LossConfig(reg_on=True))

    out["train_step_reg_on_ms"] = cs.event_ms(step_reg, reps=5)
    out["train_step_reg_on_peak_bytes"] = peak_bytes(step_reg)

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
    if profiled:
        ctr = render_cuda.bwd_counters(dev)
        sample_cuda.sample_bwd(*q_lists, rows, cot, cfg, counters=ctr)
        out["b5_profile"] = render_cuda.bwd_stats(ctr)
    un, vn = cs.scene_taps(sc)
    gray_n = sc["gray"][1]
    out["b6_ms"] = cs.event_ms(lambda: ws.warp_sample(gray_n, un, vn), reps=REPS)
    del un, vn, rows
    ref, near = sc["cams"]
    out.update(ncc_timings(cs, sc))
    mv = dict(near_cam=near, gray_r=sc["gray"][0], gray_n=gray_n)
    def step_mv():
        return train_step(params, aux, adam, ref, gt, bg, lrs, cfg,
                          LossConfig(reg_on=True, mv_on=True), **mv)

    out["train_step_mv_ms"] = cs.event_ms(step_mv, reps=5)
    out["train_step_mv_peak_bytes"] = peak_bytes(step_mv)
    if "ncc_compact" in inspect.signature(LossConfig).parameters:
        out["train_step_mv_compact_ms"] = cs.event_ms(lambda: train_step(
            params, aux, adam, ref, gt, bg, lrs, cfg,
            LossConfig(reg_on=True, mv_on=True, ncc_compact=True), **mv), reps=5)
    del sc, qr, q_lists, params, aux, adam

    # B3 and B4 on the tetra points of a sphere, each in its own path's order
    # (a checkout whose integrate sorts by pixel says so in sphere_query)
    qr, t_eval, cfg = cs.sphere_query(w, h, n, dev)
    p_lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts)
    out["b3_tetra_ms"] = cs.event_ms(lambda: sample_cuda.sample_fwd(*p_lists, qr.blocks, cfg),
                                     reps=REPS)
    if "pixel_order" in inspect.signature(cs.sphere_query).parameters:
        qr, t_eval, cfg = cs.sphere_query(w, h, n, dev, pixel_order=True)
        p_lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts)
    out["b4_ms"] = cs.event_ms(lambda: sample_cuda.integrate_fwd(*p_lists, t_eval,
                                                                 qr.blocks, cfg), reps=REPS)
    if hasattr(sample_cuda, "integrate_counters"):
        ctr = sample_cuda.integrate_counters(dev)
        sample_cuda.integrate_fwd(*p_lists, t_eval, qr.blocks, cfg, counters=ctr)
        out["b4_profile"] = sample_cuda.integrate_stats(ctr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

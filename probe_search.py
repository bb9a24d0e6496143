"""Sweep the median slots of kernels B1 and B3 on one card:

    python3 probe_search.py [--slots 0,8,14,20,24,32,48]
    python3 probe_search.py --cpu-tiles 48

For each slot count it prints one JSON line per workload (chip_smoke.py's,
at 1920x1080 / 100k gaussians): B1 on bench.py's frame, B3 on the
multi-view query and B3 on the tetra points of a 100k-gaussian sphere. Each
line holds the kernel's CUDA-event time, its search counters
(`render_cuda.search_stats`: threads on the slot path and on the re-walk,
Newton evaluations, varying pairs per thread with both histograms, folded
share, re-walk sweeps) and, for B1 and the multi-view B3, its agreement
with the twin under chip_smoke.py's limits (MD_*, DD_*). B1 without the
median depth and B4 on the tetra points are timed once. The first and last
lines are the card's name and power limit.

With --cpu-tiles N it runs on the CPU instead, through the twin: on N tiles
of bench.py's 1080p frame drawn with seed 0 it counts, per pixel whose
median is searched, the applied pairs and the varying pairs at the 6- and
14.5-sigma cuts (what the kernels' first sweep keeps), the share of pixels
that per-thread slots of 8-64 would leave to the re-walk, and per 16x16
block the mean over its threads (what a pool shared by the block holds).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import chip_smoke as cs


def planes_err(kp, tp):
    import torch

    both = (kp[11] > 0) & (tp[11] > 0)
    md = torch.isclose(kp[7], tp[7], atol=cs.MD_ATOL, rtol=cs.MD_RTOL)
    dd = torch.isclose(kp[12][both], tp[12][both], rtol=cs.DD_RTOL, atol=cs.DD_ATOL)
    return {"md_close_frac": float(md.float().mean()),
            "md_max_abs_err": float((kp[7] - tp[7]).abs().max()),
            "in_range_equal_frac": float((kp[11] == tp[11]).float().mean()),
            "dlogT_dt_close_frac": float(dd.float().mean()),
            "finite": bool(torch.isfinite(kp).all())}


def rows_err(rk, rt):
    import torch

    both = (rk[1] > 0) & (rt[1] > 0)
    md = torch.isclose(rk[0], rt[0], atol=cs.MD_ATOL, rtol=cs.MD_RTOL)
    dd = torch.isclose(rk[5][both], rt[5][both], rtol=cs.DD_RTOL, atol=cs.DD_ATOL)
    return {"md_close_frac": float(md.float().mean()),
            "md_max_abs_err": float((rk[0] - rt[0])[both].abs().max()),
            "in_range_equal_frac": float((rk[1] == rt[1]).float().mean()),
            "dlogT_dt_close_frac": float(dd.float().mean()),
            "finite": bool(torch.isfinite(rk).all())}


def cpu_estimate(n_tiles):
    """The varying-set sizes of the first sweep on the CPU (module note)."""
    import numpy as np
    import torch

    from gsjax_torch.ops.raster import RasterConfig, render_ref

    w, h = 1920, 1080
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = cs.bench_camera(w, h, "cpu")
    _, _, binning, feats = cs.stages(cs.bench_inputs(1920, 1080, 100_000)[:5], cam, cfg, "cpu")
    tiles_x, tiles_y = cfg.grid(w, h)
    ids = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        tiles_x * tiles_y, n_tiles, replace=False)))
    feats_pad = torch.cat([feats, feats.new_zeros(1, 16)])
    counts = binning.tile_count.to(torch.int64).clamp_max(cfg.max_per_tile)
    starts = binning.tile_start.to(torch.int64)[ids]
    out = render_ref.blend_tiles_batch(feats_pad, ids, starts, counts[ids], tiles_x, cfg,
                                       torch.zeros(3), w, h, cam.fx, cam.fy)
    nc, md = out[:, 8].to(torch.int64), out[:, 9]
    px, py = render_ref._tile_pixels(ids, tiles_x, cfg)
    searched = (out[:, 11] > 0) & (px < w) & (py < h)
    lo = (md - cfg.sample_range).clamp_min(0)
    hi = (md + cfg.sample_range).clamp_min(0)
    applied_n = torch.zeros_like(nc)
    varying = {6.0: torch.zeros_like(nc), 14.5: torch.zeros_like(nc)}
    limit = nc.amax(1)
    for base in range(0, int(limit.max()), cfg.chunk):
        f, rel, valid = render_ref._gather_chunk(feats_pad, starts, limit, base, cfg.chunk)
        _, passes, dx, dy = render_ref._alpha_terms(f, px, py, cfg, valid)
        applied = passes & (rel[None, :, None] < nc[:, None, :])
        t_peak = f[..., 9:10] * dx + f[..., 10:11] * dy + f[..., 11:12]
        rsig = f[..., 12:13]
        applied_n += applied.sum(1)
        for cut, v in varying.items():
            behind = torch.where(rsig > 0, (lo[:, None] - t_peak) * rsig >= cut,
                                 lo[:, None] > t_peak)
            ahead = torch.where(rsig > 0, (hi[:, None] - t_peak) * rsig <= -cut,
                                hi[:, None] <= t_peak)
            v += (applied & ~behind & ~ahead).sum(1)
    a = applied_n[searched].double()
    cs.emit({"probe": "cpu_estimate", "tiles": n_tiles, "pixels_searched": int(searched.sum()),
             "applied_mean": float(a.mean()), "applied_max": int(a.max())})
    for cut, v in varying.items():
        x = v[searched].numpy()
        # per 16x16 thread block (a tile is 2 x 2 of them): the varying pairs a
        # slot pool shared by the block would hold, per thread
        blk = torch.where(searched, v, 0).reshape(-1, 2, 16, 2, 16).permute(0, 1, 3, 2, 4)
        per_thread = blk.reshape(-1, 256).sum(1).double() / 256
        cs.emit({"probe": "cpu_estimate", "cut": cut, "varying_mean": float(x.mean()),
                 "varying_p50": float(np.percentile(x, 50)),
                 "varying_p99": float(np.percentile(x, 99)), "varying_max": int(x.max()),
                 "folded_share": 1 - float(x.sum() / a.sum()),
                 "rewalk_share": {s: float((x > s).mean()) for s in (8, 16, 24, 32, 48, 64)},
                 "block_mean_per_thread_max": float(per_thread.max()),
                 "blocks_over": {s: float((per_thread > s).double().mean())
                                 for s in (16, 24, 32)}})
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", default="0,8,14,20,24,32,48")
    ap.add_argument("--cpu-tiles", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpu_tiles:
        return cpu_estimate(args.cpu_tiles)
    slot_counts = [int(x) for x in args.slots.split(",")]
    import torch

    if not torch.cuda.is_available():
        print("probe_search: no CUDA device", file=sys.stderr)
        return 1
    from gsjax_torch.ops import sample_cuda, sample_ref
    from gsjax_torch.ops.raster import RasterConfig, render_cuda, render_ref
    from gsjax_torch.ops.sample import prepare_query

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cs.phase_build()
    ctr = render_cuda.search_counters(dev)

    def sweep(name, launch, twin=None, compare=None, **where):
        for s in slot_counts:
            res = launch(s, ctr)
            st = render_cuda.search_stats(ctr)
            ms = cs.event_ms(lambda: launch(s, None))
            err = compare(res, twin) if twin is not None else {}
            cs.emit({"probe": name, **where, "slots": s, "ms": ms, **err, **st})

    # B1 on bench.py's frame
    cfg = RasterConfig(sh_degree=3, require_depth=True, max_per_tile=1 << 12)
    cam = cs.bench_camera(1920, 1080, dev)
    _, _, binning, feats = cs.stages(cs.bench_inputs(1920, 1080, 100_000)[:5], cam, cfg, dev)
    args = (feats, binning.tile_start, binning.tile_count, 1920, 1080, cam.fx, cam.fy,
            torch.zeros(3, device=dev))
    nd = dataclasses.replace(cfg, require_depth=False)
    cs.emit({"probe": "blend_fwd_no_depth",
             "ms": cs.event_ms(lambda: render_cuda.blend_fwd(*args, nd))})
    sweep("blend_fwd", lambda s, c: render_cuda.blend_fwd(*args, cfg, slots=s, counters=c),
          render_ref.blend_planes(*args, cfg), planes_err)
    del feats, binning, args

    # B3 on the multi-view query
    sc = cs.mv_scene(1920, 1080, 100_000, dev)
    qr = prepare_query(sc["points"], *sc["args"], sc["cams"][1], sc["cfg"])
    lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, qr.blocks)
    sweep("sample_fwd_mv", lambda s, c: sample_cuda.sample_fwd(*lists, sc["cfg"], slots=s,
                                                               counters=c),
          sample_ref.sample_fwd_rows(*lists, sc["cfg"]), rows_err,
          points=int(qr.pts.shape[0]))
    del sc, qr, lists

    # B3 and B4 on the tetra points
    qr, t_eval, cfg = cs.sphere_query(1920, 1080, 100_000, dev)
    lists = (qr.feats, qr.binning.tile_start, qr.binning.tile_count, qr.pts, qr.blocks)
    cs.emit({"probe": "integrate_fwd_tetra", "ms": cs.event_ms(
        lambda: sample_cuda.integrate_fwd(*lists[:4], t_eval, qr.blocks, cfg))})
    sweep("sample_fwd_tetra", lambda s, c: sample_cuda.sample_fwd(*lists, cfg, slots=s,
                                                                  counters=c),
          points=int(qr.pts.shape[0]))
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Analytic strong-scaling model of the row-sharded train step (port of
gsjax's `scripts/scaling_model.py`).

    python -m gsjax_torch.scaling_model [--profile PROFILE_torch.json]
        [--ici_gbps 450] [--t_repl_ms X | --t_repl_file F] [--measured F]
        [--measure_link N] [--out SCALING_MODEL_torch.json] [--device cpu]

gsjax's model, term for term, over n in {1, 2, 4, 8, 16} ranks:

  t(n) = t_prep / n + t_repl + t_band * share_max(n) + collectives(n)

  - t_prep = preprocess + preprocess VJP, t_band = FULL fwd+bwd step -
    t_prep - t_repl, from the port's own stage profile (`profile_stages`,
    `--profile`, default PROFILE_torch.json: never gsjax's TPU profile);
  - t_repl: Adam and the densification statistics, which every rank runs on
    the whole model (`measure_trepl`): measured in this run on `--device`
    unless `--t_repl_ms` or a file of measure_trepl's line (`--t_repl_file`)
    gives it; the JSON says which;
  - share_max(n): the largest rank's share of the live pairs, the best of
    the port's `balance_band_bounds`, `dual_balance_bounds` and
    `paired_balance_bounds` on bench.py's per-tile-row pair histogram
    (`bench_scene_row_hist`: the port's `preprocess` and `bin_gaussians`), as
    gsjax picks (:118-149); equal rows are printed beside it;
  - collectives(n): the bytes that `parallel/shard.py:train_step_sharded`
    (no regularisation, as bench.py's loss) moves through
    `parallel/collectives.py` at n ranks (`port_payloads`): the band planes
    (8 f32 planes of the tallest rank's rows, all-gathered, and the
    cotangent's all-reduce that is the gather's backward), the gaussian-
    sharded preprocess (its float fields gathered and all-reduced back, its
    integer fields gathered), the pair counts, the loss sums with the row
    histogram, and the summed gradients (every parameter leaf and the mean2d
    tap). An all-gather of B bytes in all costs B (n-1)/n over the link, an
    all-reduce twice that (a ring), as in gsjax's model; latency is not
    modelled (gsjax's was not either).

The link: the flag keeps gsjax's name, `--ici_gbps`, with the card's figure
as its default: 450 GB/s a direction, the H100 SXM's NVLink in NVIDIA's
datasheet, written into the JSON as "datasheet, unmeasured". `--measure_link
N` measures it instead: N ranks, one a card over nccl, all-gather the band
planes' payload of N ranks (`measure_link_gbps`), and the model uses that
bandwidth, with its source. `--measured F` puts the steps of a real
multi-card `bench_scaling_torch.py` table (SCALING_torch.json) beside the
predictions under `falsify`.

Writes {model, inputs, falsify, rows} (gsjax's keys; each row gsjax's keys
plus the partition chosen and its payloads). The device is the card unless
`--device cpu`; with no card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gsjax_torch.utils import benchsync

DEVICES = (1, 2, 4, 8, 16)
NVLINK_GBPS = 450.0          # H100 SXM NVLink, 900 GB/s both directions (datasheet)
DATASHEET = "datasheet, unmeasured"
SCENE = "bench.py scene (1080p, 100k gaussians)"
FALSIFY = ("run bench_scaling_torch.py with one rank a card (nccl); compare the measured "
           "iter_s ratios to pred_step_ms, and each rank's share to metrics['row_pairs'] "
           "slices")


def bench_scene_row_hist(width=1920, height=1080, n=100_000, device="cpu"):
    """Per-tile-row live-pair histogram of bench.py's scene through the
    port's preprocess and binning -> (hist [tiles_y], tiles_x, tiles_y, cfg),
    as gsjax's (:44-71)."""
    from gsjax_torch.bench import bench_config, bench_inputs
    from gsjax_torch.ops.raster import Camera
    from gsjax_torch.ops.raster.binning import bin_gaussians
    from gsjax_torch.ops.raster.preprocess import preprocess

    *g, _ = bench_inputs(width, height, n)
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        width, height, device=device)
    cfg = bench_config()            # gsjax's model's (scaling_model.py:63-64)
    with torch.no_grad():
        prep = preprocess(*(torch.as_tensor(a, device=device) for a in g), None, None, None,
                          cam, cfg)
        binning = bin_gaussians(prep, cfg, width, height)
    tiles_x, tiles_y = cfg.grid(width, height)
    tc = binning.tile_count.cpu().numpy().reshape(tiles_y, tiles_x)
    return tc.sum(axis=1), tiles_x, tiles_y, cfg


def step_columns(cfg) -> dict:
    """Per-gaussian columns that the sharded step moves: the preprocess
    outputs' float and integer columns, and the gradient's (every parameter
    leaf of a model at `cfg`'s SH / SG degrees, plus the 2 of the mean2d
    tap). Read from one gaussian's preprocess and model, on the CPU."""
    import dataclasses

    from gsjax_torch.model import gaussians as gm
    from gsjax_torch.ops.raster import Camera
    from gsjax_torch.ops.raster.preprocess import preprocess

    params, aux = gm.init_from_pcd(np.asarray([[0.0, 0.0, 4.0]], np.float32),
                                   np.full((1, 3), 0.5, np.float32), 1, cfg.sh_degree,
                                   cfg.sg_degree, np.full((1,), 1e-4, np.float32),
                                   device="cpu")
    cam = Camera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0, 0.66,
                        64, 64, device="cpu")
    scales, opac = gm.scaling_n_opacity_with_3d_filter(params, aux.filter_3d)
    with torch.no_grad():
        prep = preprocess(params.xyz, scales, params.rotation, opac, gm.get_features(params),
                          gm.get_sg_axis(params), gm.get_sg_sharpness(params),
                          params.sg_color, cam, cfg, aux.alive)
    cols = {True: 0, False: 0}
    for f in dataclasses.fields(prep):
        t = getattr(prep, f.name)
        cols[t.is_floating_point()] += t.reshape(1, -1).shape[1]
    grad = sum(getattr(params, k).reshape(1, -1).shape[1] for k in gm.PARAM_FIELDS) + 2
    return {"prep_float": cols[True], "prep_int": cols[False], "grad": grad}


def port_payloads(n_dev: int, bounds, pair, capacity: int, width: int, height: int, cfg,
                  cols: dict) -> list[tuple[str, str, int]]:
    """[(what, collective, bytes)] of one `train_step_sharded` at `n_dev`
    ranks on the partition (`bounds`, `pair`), without regularisation: the
    bytes of each all-gather's output and each all-reduce's buffer (module
    docstring)."""
    from gsjax_torch.parallel.shard import IMAGE_PLANES, band_rows, check_partition

    _, tiles_y = cfg.grid(width, height)
    b, p = check_partition(bounds, pair, tiles_y, n_dev)
    rpm = max(len(band_rows(b, p, r)) for r in range(n_dev))
    frame = n_dev * IMAGE_PLANES * rpm * cfg.tile * width * 4
    ns = -(-capacity // n_dev)
    prep_f = n_dev * ns * cols["prep_float"] * 4
    return [("band planes", "all_gather", frame),
            ("band planes' cotangent", "all_reduce", frame),
            ("preprocess floats", "all_gather", prep_f),
            ("preprocess floats' cotangent", "all_reduce", prep_f),
            ("preprocess integers", "all_gather", n_dev * ns * cols["prep_int"] * 4),
            ("pair counts", "all_gather", n_dev * 3 * 8),
            ("loss sums and row histogram", "all_reduce", (6 + tiles_y) * 8),
            ("gradients", "all_reduce", capacity * cols["grad"] * 4)]


def collective_ms(payloads, n_dev: int, gbps: float) -> float:
    """gsjax's link time of the payloads at n_dev ranks: an all-gather of B
    bytes B (n-1)/n, an all-reduce 2 B (n-1)/n, over gbps GB/s."""
    bw = gbps * 1e9
    t = 0.0
    for _, op, b in payloads:
        t += (2 if op == "all_reduce" else 1) * b * (n_dev - 1) / n_dev / bw
    return t * 1e3


def model_rows(hist, tiles_y: int, t_prep: float, t_repl: float, t_full: float,
               payloads, gbps: float, devices=DEVICES) -> list[dict]:
    """gsjax's rows (scaling_model.py:101-161). `payloads(n, bounds, pair)`
    gives the collectives of n ranks on the chosen partition."""
    from gsjax_torch.parallel.shard import (balance_band_bounds, dual_balance_bounds,
                                            paired_balance_bounds)

    hist = np.asarray(hist)
    total = float(hist.sum())
    t_band = t_full - t_prep - t_repl
    rows = []
    for n_dev in devices:
        part, loads = "single", {}
        if n_dev == 1:
            share_max = share_rows = 1.0
            t_coll = 0.0
        else:
            rpm = min(tiles_y, -(-tiles_y // n_dev) * 2)
            b = balance_band_bounds(hist, n_dev, rpm)
            chosen = (b, None)
            shares = np.array([hist[b[d]:b[d + 1]].sum() for d in range(n_dev)], np.float64)
            if tiles_y >= 2 * n_dev:
                b2 = dual_balance_bounds(hist, n_dev, max(rpm // 2, 1))
                shares2 = np.array(
                    [hist[b2[d]:b2[d + 1]].sum()
                     + hist[b2[2 * n_dev - 1 - d]:b2[2 * n_dev - d]].sum()
                     for d in range(n_dev)], np.float64)
                if shares2.max() < shares.max():
                    shares, chosen, part = shares2, (b2, None), "dual"
                b3, p3 = paired_balance_bounds(hist, n_dev, rpm)
                shares3 = np.array(
                    [hist[b3[p3[d, 0]]:b3[p3[d, 0] + 1]].sum()
                     + hist[b3[p3[d, 1]]:b3[p3[d, 1] + 1]].sum()
                     for d in range(n_dev)], np.float64)
                if shares3.max() < shares.max():
                    shares, chosen, part = shares3, (b3, p3), "paired"
            share_max = float(shares.max()) / total
            be = np.minimum(np.arange(n_dev + 1) * (-(-tiles_y // n_dev)), tiles_y)
            share_rows = float(max(hist[be[d]:be[d + 1]].sum() for d in range(n_dev))) / total
            pl = payloads(n_dev, *chosen)
            loads = {name: b for name, _, b in pl}
            t_coll = collective_ms(pl, n_dev, gbps)
        t_n = t_prep / n_dev + t_repl + t_band * share_max + t_coll
        eff = (t_prep + t_repl + t_band) / (n_dev * t_n)
        rows.append({"devices": n_dev, "pred_step_ms": round(t_n, 2),
                     "share_max_balanced": round(share_max, 4),
                     "share_max_equal_rows": round(share_rows, 4),
                     "collective_ms": round(t_coll, 3), "pred_efficiency": round(eff, 4),
                     "partition": part, "payload_bytes": loads})
        print({k: v for k, v in rows[-1].items() if k != "payload_bytes"}, flush=True)
    return rows


def _link_rank(rank, nbytes, iters, device_type):
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    n = dist.get_world_size()
    x = torch.ones(nbytes // (4 * n), device=dev)
    parts = [torch.empty_like(x) for _ in range(n)]
    for _ in range(3):
        dist.all_gather(parts, x)
    benchsync.sync(dev)
    dt = benchsync.time_window(lambda: dist.all_gather(parts, x), iters, dev) / iters
    return {"seconds": dt, "backend": dist.get_backend(), "device": str(dev)}


def measure_link_gbps(n: int, nbytes: int, iters: int = 20, timeout: float = 300.0,
                      device: str = "cuda") -> dict:
    """All-gather bandwidth of n ranks, one a card (`parallel/launch.py`; on
    the CPU, gloo ranks): `nbytes` gathered in all, `iters` back-to-back
    gathers between CUDA events; bandwidth in the model's terms, nbytes
    (n-1)/n over the slowest rank's time."""
    from gsjax_torch.parallel.launch import launch

    res = launch(_link_rank, n, args=(nbytes, iters, device), device=device, timeout=timeout,
                 threads=None if device == "cuda" else 1)
    dt = max(r["seconds"] for r in res)
    gbps = nbytes * (n - 1) / n / dt / 1e9
    return {"metric": "link_gbps", "value": gbps, "ranks": n, "bytes": nbytes,
            "seconds": dt, "backend": res[0]["backend"], "iters": iters}


def read_t_repl(path: str) -> float:
    """The value of the last `t_repl_ms` line in a file of measure_trepl's output."""
    value = None
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if ln.startswith("{"):
                d = json.loads(ln)
                if d.get("metric") == "t_repl_ms":
                    value = float(d["value"])
    if value is None:
        raise ValueError(f"{path} holds no t_repl_ms line")
    return value


def falsify(rows, measured_path: str | None):
    """gsjax's `falsify` note and, given a multi-card bench_scaling table,
    its measured steps beside the predictions (speed-ups against n = 1)."""
    out = {"how": FALSIFY, "measured": None}
    if not measured_path:
        return out
    with open(measured_path) as f:
        table = json.load(f)
    pred = {r["devices"]: r["pred_step_ms"] for r in rows}
    meas = {r["devices"]: r["iter_s"] for r in table["rows"]}
    out["measured"] = [
        {"devices": d, "measured_iter_s": meas[d], "pred_step_ms": pred.get(d),
         "measured_speedup": meas[1] / meas[d] if 1 in meas else None,
         "pred_speedup": pred[1] / pred[d] if d in pred else None,
         "efficiency": r.get("efficiency"), "backend": r.get("backend")}
        for d, r in ((r["devices"], r) for r in table["rows"])]
    out["measured_file"] = measured_path
    out["measured_workload"] = (f"bench_scaling_torch.py mode {table.get('mode')}: the "
                                f"regularised sharded step of init_from_pcd's model, not "
                                f"bench.py's loss; compare speed-ups, not milliseconds")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="PROFILE_torch.json",
                    help="the port's stage profile (profile_stages' JSON)")
    ap.add_argument("--ici_gbps", type=float, default=None,
                    help=f"link bandwidth per rank, GB/s (gsjax's flag name; default "
                         f"{NVLINK_GBPS:g}, the H100 SXM's NVLink a direction, datasheet)")
    ap.add_argument("--measure_link", type=int, default=0,
                    help="measure the link with N ranks, one a card over nccl, and use it")
    ap.add_argument("--capacity", type=int, default=100_000)
    ap.add_argument("--t_repl_ms", type=float, default=None,
                    help="the replicated residue; default: measure_trepl in this run")
    ap.add_argument("--t_repl_file", default=None,
                    help="a file holding measure_trepl's t_repl_ms line")
    ap.add_argument("--measured", default=None,
                    help="a multi-card bench_scaling_torch.py table to put beside the rows")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", default="SCALING_MODEL_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    dev = benchsync.cli_device(args.device, "scaling_model")

    hist, tiles_x, tiles_y, cfg = bench_scene_row_hist(args.width, args.height, args.n, dev)
    with open(args.profile) as f:
        prof = json.load(f)["timings_ms"]
    t_prep = prof["preprocess"] + (prof.get("preprocess VJP") or 0.0)
    if args.t_repl_ms is not None:
        t_repl, repl_src = args.t_repl_ms, "given on the command line"
    elif args.t_repl_file:
        t_repl, repl_src = read_t_repl(args.t_repl_file), f"file {args.t_repl_file}"
    else:
        from gsjax_torch import measure_trepl

        t_repl = round(measure_trepl.measure(args.capacity, 20, dev), 3)
        repl_src = (f"measured in this run (measure_trepl, capacity {args.capacity}, "
                    f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    t_full = prof["FULL fwd+bwd step"]

    cols = step_columns(cfg)

    def payloads(n_dev, bounds, pair):
        return port_payloads(n_dev, bounds, pair, args.capacity, args.width, args.height,
                             cfg, cols)

    link = None
    gbps, src = NVLINK_GBPS, DATASHEET
    if args.measure_link:
        from gsjax_torch.parallel.shard import equal_band_bounds

        nbytes = payloads(args.measure_link, equal_band_bounds(tiles_y, args.measure_link),
                          None)[0][2]
        link = measure_link_gbps(args.measure_link, nbytes)
        print(json.dumps(link), flush=True)
        gbps = link["value"]
        src = (f"measured: all_gather of {nbytes} bytes on {link['ranks']} ranks over "
               f"{link['backend']} (scaling_model --measure_link)")
    if args.ici_gbps is not None:
        gbps, src = args.ici_gbps, "given on the command line"

    rows = model_rows(hist, tiles_y, t_prep, t_repl, t_full, payloads, gbps)
    out = {
        "model": "t(n) = t_prep/n + t_repl + t_band*share_max(n) + collectives(n)",
        "inputs": {
            "profile": args.profile, "t_prep_ms": t_prep, "t_repl_ms": t_repl,
            "t_repl_source": repl_src, "t_band_ms": round(t_full - t_prep - t_repl, 2),
            "ici_gbps": gbps, "link_gbps_source": src, "link_measurement": link,
            "frame_gather_bytes": {str(r["devices"]): r["payload_bytes"]["band planes"]
                                   for r in rows if r["payload_bytes"]},
            "grad_psum_bytes": args.capacity * cols["grad"] * 4,
            "step_columns": cols,
            "scene": SCENE if (args.width, args.height, args.n) == (1920, 1080, 100_000)
            else f"bench.py's draws at {args.width}x{args.height}, {args.n} gaussians",
            "preprocess_vjp_in_profile": prof.get("preprocess VJP") is not None,
            "device": str(dev),
            "nvidia_smi": benchsync.smi_line() if dev.type == "cuda" else None,
        },
        "falsify": falsify(rows, args.measured),
        "rows": rows,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()

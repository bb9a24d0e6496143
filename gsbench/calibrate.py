"""Readings the limits in `limits/<cell>.json` are set from, on the card, at
the cell's own size, in one process (the kernels built once):

    python3 gsbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control 3 --faults 3 --out chiprun_out/cal.jsonl

One JSON line per reading: the program's numbers on every seed, the
control's (the bfloat16 reference in the program's place) on the first
`--control` seeds and each planted fault's (`--only` names some) on the
first `--faults` seeds. The reference runs once a seed; every reading of
that seed is compared with it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--only", default="", help="comma-separated faults (default: all)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gsbench import control, drivers, harness

    e = harness.cell(harness.benchmark(), args.workload)
    cfg, traffic = e["config"], e["traffic"]
    mod = harness.driver(traffic["kind"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    scale = 1.0 if dev.type == "cuda" else float(os.environ.get("GSBENCH_SCALE", "0.08"))
    faults = [f for f in mod.FAULTS if f != "unchanged"      # reads 1: no run needed
              and (not args.only or f in args.only.split(","))]

    def emit(what, seed, readings, ref, t0):
        detail = {}
        numbers = mod.compare(readings, ref, detail)
        line = {"cell": args.workload, "seed": seed, "what": what, "numbers": numbers,
                "s": time.perf_counter() - t0, "detail": detail}
        with open(args.out, "a") as f:
            f.write(json.dumps(line, default=str) + "\n")
        print(json.dumps({k: line[k] for k in ("what", "seed", "numbers", "s")}), flush=True)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ref = mod.reference(cfg, traffic, seed, dev, scale)
        drivers.free(dev)
        print(json.dumps({"reference": seed, "s": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
        emit("program", seed, mod.readings(cfg, traffic, seed, dev, scale), ref, t0)
        drivers.free(dev)
        if i < args.control:
            t0 = time.perf_counter()
            emit("control", seed, mod.control(cfg, traffic, seed, dev, scale,
                                               round_to=control.CONTROL), ref, t0)
            drivers.free(dev)
        if i < args.faults:
            for name in faults:
                t0 = time.perf_counter()
                with control.fault(name):
                    readings = mod.readings(cfg, traffic, seed, dev, scale)
                emit(name, seed, readings, ref, t0)
                drivers.free(dev)
        del ref
        drivers.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark on this machine's card and print its result.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without CUDA or with fewer cards than the
cell asks for, when the run is not whole, or when JAX or the JAX package was
loaded, in this process or in any rank the run spawned. The last stdout
line is the result's JSON object; the numbers compared, each beside its
limit, are the last lines on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """The epoch time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the program at a fixed path in the
    # checkout (the port builds its kernels into build/gsjax_torch itself)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    sys.path.insert(0, ROOT)
    try:
        import torch

        from gsbench import harness
    except ImportError as e:
        print(f"gsbench: cannot import what a run needs: {e}", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"gsbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out, err, in_ranks = harness.run_cell(args.workload, args.seed, args.seconds,
                                          bool(args.trace), "cuda", t_start)
    found = harness.forbidden_modules()
    if found or in_ranks:
        print(f"gsbench: the run loaded {found} in this process and {in_ranks} in its "
              f"ranks; no result", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(err) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

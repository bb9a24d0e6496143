"""TnT F1 evaluation CLI (port of the repository's `eval_tnt/run.py`, with
its flags). Mirrors the reference eval_tnt/run.py:59-200 flag surface,
delegating to `gsjax_torch.eval.tnt`; the protocol runs on the host (numpy,
scipy). Writes results.json, then the precision/recall figure, into
`--out-dir` (default: the PLY's directory). Where matplotlib does not import,
the figure is not drawn, the CLI says so, and results.json is all it writes.

    python -m gsjax_torch.eval_tnt --dataset-dir <scene> --traj-path <log>
        --ply-path <mesh.ply> [--out-dir <dir>]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the results."""
    from gsjax_torch.data.ply import read_ply
    from gsjax_torch.eval.tnt import run_tnt_evaluation

    parser = ArgumentParser(description="Tanks-and-Temples F1 evaluation")
    parser.add_argument("--dataset-dir", required=True)
    parser.add_argument("--traj-path", required=True)
    parser.add_argument("--ply-path", required=True)
    parser.add_argument("--out-dir", default=None)
    args = parser.parse_args(argv)

    scene = os.path.basename(os.path.normpath(args.dataset_dir))
    v = read_ply(args.ply_path)
    verts = np.stack([v["x"], v["y"], v["z"]], 1)
    faces = v.get("__faces__", np.zeros((0, 3), np.int64))
    try:
        import matplotlib  # noqa: F401  (the precision/recall figure)
        plot = True
    except ImportError:
        plot = False
    out_dir = args.out_dir or os.path.dirname(args.ply_path)
    res = run_tnt_evaluation(verts, faces, args.dataset_dir, scene,
                             args.traj_path, out_dir, plot=plot)
    if not plot:
        print(f"matplotlib does not import: wrote {out_dir}/results.json, "
              "not the precision/recall figure")
    print(f"precision {res['precision']:.4f} recall {res['recall']:.4f} "
          f"f1 {res['f1']:.4f} @ tau {res['tau']}")
    return res


if __name__ == "__main__":
    main()

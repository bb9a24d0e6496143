"""Quality gate on the golden scenes: three golden runs and the
regularisation ablation (port of gsjax's `scripts/quality_r04.py`).

    python -m gsjax_torch.quality_r04 [--out QUALITY_torch.json]
        [--width 320 --height 240] [--repeat_main N] [--device cpu]

  A. the sphere through the whole schedule: 3000 steps, opacity resets every
     900, SH degree 3 and 2 SG lobes, densify gradient threshold 1e-4, PGSR
     regularisation from step 1500, the TSDF and tetra meshes gated on
     chamfer;
  B. A with `--no_reg`: B's chamfer minus A's (`reg_chamfer_improvement`)
     must be positive, the geometry losses must improve the geometry;
  C. the blobs scene (occluding spheres, a textured background shell,
     anisotropic gaussians) on the same schedule, 2400 steps.

Each sub-run is `python -m gsjax_torch.golden_quality` with gsjax's argument
lists and this run's `--device`; it checkpoints and resumes, so an
interrupted sweep continues. Their JSON files land beside `--out` as
`<stem>_main.json`, `<stem>_noreg.json` and `<stem>_blobs.json`, with each
run's statistics (`--stats_out`) as `<name>_stats.json`; the merge has
gsjax's keys plus the card's name and power limit (`device`), the
statistics and, with `--repeat_main N`, N more runs of A from scratch (the
view order is not seeded, so they give the spread of one recipe).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name where it is not a card."""
    if not device.startswith("cuda"):
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run(args_list, out, device):
    """One golden sub-run -> its JSON (None where it wrote none)."""
    stats = out[:-len(".json")] + "_stats.json"
    cmd = [sys.executable, "-m", "gsjax_torch.golden_quality", "--out", out,
           "--stats_out", stats, "--device", device] + args_list
    print("RUN:", " ".join(cmd), flush=True)
    rc = subprocess.call(cmd, cwd=REPO)
    if rc != 0:
        print(f"WARNING: sub-run exited rc={rc}", flush=True)
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    return None


def read_stats(out):
    path = out[:-len(".json")] + "_stats.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description="gsjax_torch golden quality gate")
    ap.add_argument("--out", default="QUALITY_torch.json")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--iters_main", type=int, default=3000)
    ap.add_argument("--iters_blobs", type=int, default=2400)
    ap.add_argument("--repeat_main", type=int, default=0,
                    help="run A this many more times from scratch (--no_resume) "
                         "after C, for the spread of one recipe")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sub-runs (cuda unless 'cpu')")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    stem = out[:-len(".json")] if out.endswith(".json") else out
    name = lambda tag: f"{stem}_{tag}.json"

    wh = ["--width", str(args.width), "--height", str(args.height)]
    sched = ["--sh_degree", "3", "--sg_degree", "2",
             "--densify_grad_threshold", "1e-4", "--n_images", "28"]

    main_cfg = ["--scene", "sphere", "--iterations", str(args.iters_main),
                "--reset_interval", str(args.iters_main // 3 - 100),
                "--n_gauss", "2000", "--tetra"] + wh + sched
    a = run(main_cfg, name("main"), args.device)
    b = run(main_cfg + ["--no_reg"], name("noreg"), args.device)
    c = run(["--scene", "blobs", "--iterations", str(args.iters_blobs),
             "--reset_interval", str(args.iters_blobs // 3 - 100),
             "--n_gauss", "2600", "--tetra"] + wh + sched,
            name("blobs"), args.device)
    repeats = [run(main_cfg + ["--no_resume"], name(f"main_repeat{i}"), args.device)
               for i in range(args.repeat_main)]

    delta = None
    if a and b and a.get("chamfer") and b.get("chamfer"):
        delta = round(b["chamfer"] - a["chamfer"], 5)
    merged = {
        "main_sphere_full_schedule": a,
        "ablation_no_reg": b,
        "blobs_hard_scene": c,
        # regularisation must improve geometry: the no-reg chamfer must be
        # strictly worse than the regularised run's
        "reg_chamfer_improvement": delta,
        "pass": bool(a and a.get("pass") and c and c.get("pass")
                     and delta is not None and delta > 0),
        "device": device_line(args.device),
        "main_sphere_repeats": repeats,
        "stats": {tag: read_stats(name(tag)) for tag in
                  ["main", "noreg", "blobs"] + [f"main_repeat{i}"
                                                for i in range(args.repeat_main)]},
    }
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps({k: v for k, v in merged.items() if k != "stats"}, indent=1), flush=True)
    return merged


if __name__ == "__main__":
    main()

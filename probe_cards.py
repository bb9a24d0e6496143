"""The runs that need more than one card: the `nccl` path and the scaling
model against measured steps, on four cards of one host.

    python3 probe_cards.py [OUT_DIR]        # on a host with four cards

One rank a card over nccl (`parallel/multihost.py:choose_backend`), in order:
  scaling    `GSJAX_SCALING_DEVICES=4 python3 bench_scaling_torch.py` (mode
             train: 1, 2 and 4 ranks, each with a card of its own, so the
             efficiency is measured) -> OUT_DIR/SCALING_torch.json;
  multihost  `multihost_demo` as 2 simulated hosts of 2 cards each;
  train      chip_smoke's `train` phase on card 0 (40 steps at 1080p from
             100k points; its step-40 checkpoint), then its `multi_gpu`
             comparison with 4 ranks of the train CLI (`--dist_*`, a card
             each) against the single process from that checkpoint, held to
             its bounds (dryrun_multichip's after the first step, three times
             the single runs' spread after the later ones); then `python -m
             gsjax_torch.train ... --n_devices 4` (the CLI starts its 4 ranks
             itself) for one step from the same checkpoint, its xyz and
             statistics held to dryrun's first-step bounds against the
             `--dist_*` rank 0's at the same step;
  model      `profile_stages` on card 0, then `scaling_model --measure_link 4
             --measured OUT_DIR/SCALING_torch.json`: the link's all-gather
             bandwidth measured on the 4 cards and the model's predictions
             beside the measured steps -> OUT_DIR/SCALING_MODEL_torch_4card.json.
Each part prints one JSON line (chip_smoke's phases print their own); the
last line is {"ok": true, ...}. A failed check exits 1, fewer than 4 cards
exit 2. It runs from the repository root; OUT_DIR, relative to it, defaults
to `build/probe_cards`. Scenes go under `build/chip_smoke*` and are removed.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CARDS = 4


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gsjax_torch import multihost_demo, profile_stages, scaling_model

    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"probe_cards: needs {CARDS} cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join("build", "probe_cards")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    print(smi, flush=True)
    cs.emit({"phase": "cards", "count": torch.cuda.device_count(),
             "names": [torch.cuda.get_device_name(i) for i in range(CARDS)]})
    cs.phase_build()

    # scaling: the benchmark entry as a user runs it, 1, 2 and 4 ranks
    table_path = os.path.join(out_dir, "SCALING_torch.json")
    run = cs.run_entry("bench_scaling_torch.py", GSJAX_SCALING_DEVICES=str(CARDS),
                       GSJAX_SCALING_DIR=os.path.abspath(out_dir))
    with open(table_path) as f:
        table = json.load(f)
    rows = table["rows"]
    cs.check([r["devices"] for r in rows] == [1, 2, 4]
             and all(r["backend"] == "nccl" and not r["shared_card"] for r in rows)
             and run["line"]["metric"] == f"train_scaling_efficiency_{CARDS}dev",
             f"bench_scaling on {CARDS} cards: {run['line']} {rows}")
    cs.emit({"phase": "scaling", "line": run["line"], "rows": rows, "wall_s": run["wall_s"],
             "launches": run["diag"]["launches"]})

    # multihost: 2 simulated hosts of 2 cards
    res = multihost_demo.run(2, 2, dev, timeout=cs.MULTIHOST_TIMEOUT)
    with open(os.path.join(out_dir, "MULTIHOST_torch.json"), "w") as f:
        json.dump(res, f, indent=1)
    cs.check(res["ok"] and res["backend"] == "nccl"
             and sorted({r["device"] for r in res["ranks"]}) == ["cuda:0", "cuda:1"],
             f"multihost demo on the cards: {json.dumps(res)[:3000]}")
    cs.emit({"phase": "multihost", "backend": res["backend"], "wall_s": res["wall_s"],
             "losses": res["ranks"][0]["losses"], "psum": [r["psum"] for r in res["ranks"]],
             "visible": [multihost_demo.host_env(2, 2, dev)[r]["CUDA_VISIBLE_DEVICES"]
                         for r in range(4)]})

    # train: 4 ranks of the CLI against one process
    keep = os.path.join(ROOT, "build", "chip_smoke_cards")
    shutil.rmtree(keep, ignore_errors=True)
    cs.phase_train(dev, keep=keep)
    started = cs.start_multi_gpu(dev, keep, n=CARDS)
    try:
        cs.phase_multi_gpu(dev, keep, started, n=CARDS, remove=False)
    finally:
        cs.stop(started[0])
    first = cs.MGPU_SNAPSHOTS[0]
    ref = np.load(os.path.join(keep, "rank0.json.npz"))
    argv = cs.mgpu_base(keep)
    for flag in ("--iterations", "--densify_until_iter", "--save_iterations",
                 "--checkpoint_iterations", "--test_iterations"):
        argv[argv.index(flag) + 1] = str(first)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gsjax_torch.train", *argv, "-m",
                        os.path.join(keep, "model_nd"), "--n_devices", str(CARDS)],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    cs.check(r.returncode == 0, f"--n_devices {CARDS} exited {r.returncode}:\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    z = np.load(os.path.join(keep, "model_nd", f"chkpnt{first}.npz"))
    alive = ref[f"{first}.alive"]
    dxyz = np.abs(z["p_xyz"] - ref[f"{first}.xyz"])[alive]
    ga = ref[f"{first}.grad_accum"]
    nd = {"seconds": time.perf_counter() - t0, "ranks_line": [ln for ln in r.stdout.splitlines()
                                                              if "backend" in ln],
          "dxyz_q90": float(np.quantile(dxyz, 0.9)), "dxyz_max": float(dxyz.max()),
          "grad_accum_max_rel": float(np.abs(z["a_grad_accum"] - ga).max()
                                      / (np.abs(ga).max() + 1e-12)),
          "denom_equal": bool(np.array_equal(z["a_denom"], ref[f"{first}.denom"]))}
    cs.emit({"phase": "n_devices", **nd})
    cs.check(len(nd["ranks_line"]) == CARDS and all("nccl" in ln for ln in nd["ranks_line"]),
             f"--n_devices ranks: {nd['ranks_line']}")
    cs.check(nd["dxyz_q90"] < cs.MGPU_DXYZ_Q90 and nd["dxyz_max"] < cs.MGPU_DXYZ_MAX
             and nd["grad_accum_max_rel"] < cs.MGPU_STATS_RTOL and nd["denom_equal"],
             f"--n_devices {CARDS} against the --dist_* ranks after one step: {nd}")
    shutil.rmtree(keep, ignore_errors=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)

    # model: the card's profile, the measured link, the measured steps
    prof_path = os.path.join(out_dir, "PROFILE_torch_4card.json")
    with open(os.path.join(out_dir, "profile_stages.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        profile_stages.main(["--out", prof_path])
        model = scaling_model.main(
            ["--profile", prof_path, "--measure_link", str(CARDS), "--measured", table_path,
             "--out", os.path.join(out_dir, "SCALING_MODEL_torch_4card.json")])
    link = model["inputs"]["link_measurement"]
    cs.check(link["backend"] == "nccl" and link["value"] > 0, f"link probe: {link}")
    cs.emit({"phase": "model", "link": link, "rows": [
        {k: row[k] for k in ("devices", "pred_step_ms", "pred_efficiency", "collective_ms")}
        for row in model["rows"]], "falsify": model["falsify"]["measured"]})
    print(smi, flush=True)
    cs.emit({"ok": True, "cards": CARDS, "out_dir": out_dir})
    return 0


if __name__ == "__main__":
    sys.exit(main())

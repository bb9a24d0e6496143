"""The port's multi-host demo (`python -m gsjax_torch.multihost_demo`,
gsjax's `scripts/multihost_cpu_demo.py`) on the CPU.

- As a user runs it, a subprocess with a 120 s timeout: 4 gloo ranks on 2
  simulated hosts join through `maybe_init_distributed`; `ok` is true, the
  all-sum reads 10 on every rank, the ranks report 4 / 2 / 2 for world /
  hosts / local world, only rank 0 is primary and wrote the artifact, and the
  4 ranks' losses are equal bit for bit and within tests/test_sharding.py's
  loss tolerances (rtol 2e-4, atol 2e-5) of the port's single-process
  `train_step` on the same inputs and bands' frame, step by step
  (tests/test_torch_sharded_step.py holds that step to gsjax's
  `make_mesh(4)` step).
- Each simulated host's ranks see their own share of the cards
  (`host_env`), with a card count monkeypatched.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsjax_torch import multihost_demo
from gsjax_torch.parallel.shard import equal_band_bounds
from gsjax_torch.train.step import LossConfig, train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_demo_four_ranks_two_hosts(tmp_path):
    out = tmp_path / "MULTIHOST_torch.json"
    r = subprocess.run([sys.executable, "-m", "gsjax_torch.multihost_demo", "--device", "cpu",
                        "--out", str(out), "--timeout", "110"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["ok"] and res["primary_artifact_written"] and res["backend"] == "gloo"
    ranks = res["ranks"]
    assert [o["rank"] for o in ranks] == [0, 1, 2, 3]
    assert [(o["host"], o["local_rank"]) for o in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["psum"] == 10.0 and (o["world"], o["hosts"], o["local_world"]) == (4, 2, 2)
               for o in ranks)
    assert [o["is_primary"] for o in ranks] == [True, False, False, False]
    losses = [o["losses"] for o in ranks]
    assert all(ls == losses[0] for ls in losses) and len(losses[0]) == multihost_demo.STEPS

    params, aux, adam, cam, cfg, gt, bg = multihost_demo.demo_inputs("cpu")
    single = []
    for _ in range(multihost_demo.STEPS):
        params, aux, adam, m = train_step(params, aux, adam, cam, gt, bg, multihost_demo.LRS,
                                          cfg, LossConfig(reg_on=False, mv_on=False))
        single.append(m["loss"])
    np.testing.assert_allclose(losses[0], single, rtol=2e-4, atol=2e-5)
    assert equal_band_bounds(cfg.grid(64, 64)[1], 4).tolist() == [0, 1, 2, 2, 2]


@pytest.mark.parametrize("cards,want", [
    (1, ["0", "0", "0", "0"]),
    (4, ["0,1", "0,1", "2,3", "2,3"]),
    (8, ["0,1,2,3"] * 2 + ["4,5,6,7"] * 2)])
def test_host_env_splits_cards(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    env = multihost_demo.host_env(2, 2, torch.device("cuda"))
    assert [e["CUDA_VISIBLE_DEVICES"] for e in env] == want
    assert [(e["LOCAL_RANK"], e["LOCAL_WORLD_SIZE"]) for e in env] == [
        ("0", "2"), ("1", "2"), ("0", "2"), ("1", "2")]
    assert "CUDA_VISIBLE_DEVICES" not in multihost_demo.host_env(2, 2, torch.device("cpu"))[0]

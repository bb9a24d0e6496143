"""A tiny CPU run of each cell (the harness's look for a card skipped)
prints a well-formed result; the run loads neither JAX nor the JAX package;
the control and the planted faults come out not correct."""

import json
import os
import subprocess
import sys
import time

import pytest

from gsbench import harness
from gsbench.tests.conftest import ROOT, SCALE

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _run(name, seed=2**31 + 9, trace=False):
    out, err, in_ranks = harness.run_cell(name, seed, 0.5, trace, "cpu", time.time(), SCALE)
    assert in_ranks == []          # one process: no rank of its own
    return out, err


@pytest.mark.parametrize("name", CELLS)
def test_cell_result_line(name):
    out, err = _run(name)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert out["attempted"] > 0 and out["failed"] == 0
    mine = {m["name"] for m in harness.end_to_end(harness.benchmark(), name)}
    assert set(out["metrics"]) == mine
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert err[-1].startswith("check failed_units")
    json.dumps(out)


def test_traced_result_line():
    out, _ = _run("m360.render", trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    # on the CPU no kernel runs: the device readers find nothing to read
    assert "idle_share.render" not in out["metrics"]


def test_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); from gsbench import harness; "
            "harness.run_cell('tnt.train_mv', 3, 0.2, False, 'cpu', time.time(), %r); "
            "print(harness.forbidden_modules())") % (ROOT, SCALE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, OMP_NUM_THREADS="1")).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; sys.argv = "
            "['run.py', '--workload', 'm360.render', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']; sys.path.insert(0, %r); import runpy; "
            "runpy.run_path(%r, run_name='__main__')") % (ROOT, os.path.join(ROOT, "gsbench",
                                                                             "run.py"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("in_ranks", [[], ["jax"]])
def test_rank_modules_refuse_the_result(in_ranks, monkeypatch, capsys):
    """`run.py` prints its result only where no rank loaded JAX or the JAX
    package (the look for a card and the run replaced)."""
    import torch

    from gsbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (
        {"correct": True, "checks": {}}, ["check failed_units: 0 (limit 0)"], in_ranks))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, "unused")
    rc = run.main(["--workload", "m360.render", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    if in_ranks:
        assert rc != 0 and out.out == "" and "['jax'] in its ranks" in out.err
    else:
        assert rc == 0 and json.loads(out.out.splitlines()[-1])["correct"] is True


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsjax_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gsjax.ops", sys)
    assert harness.forbidden_modules() == ["gsjax"]

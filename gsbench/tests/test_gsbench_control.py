"""The control (the bfloat16 reference in the program's place) and each fault
a cell can have, planted under a whole run (the look for a card skipped),
come out not correct at a tiny size on the CPU; a planted fault reaches the
ranks a run spawns. The cases come from `BENCHMARK.json`'s cells and each
cell's own `FAULTS`."""

import os
import time

import pytest
import torch

from gsbench import control, harness
from gsbench.tests.conftest import SCALE


def _kinds() -> dict:
    """Each cell's kind of traffic, in `BENCHMARK.json`'s order."""
    bench = harness.benchmark()
    return {w["name"]: harness.cell(bench, w["name"])["traffic"]["kind"]
            for w in bench["workloads"]}


def _fault_cases() -> list:
    """The first cell of each kind with each fault of its kind's `FAULTS`."""
    first = {}
    for name, kind in _kinds().items():
        first.setdefault(kind, name)
    return [(name, f) for kind, name in first.items() for f in harness.driver(kind).FAULTS]


@pytest.mark.parametrize("name", list(_kinds()))
def test_control_is_not_correct(name):
    from gsbench import check

    e = harness.cell(harness.benchmark(), name)
    mod = harness.driver(e["traffic"]["kind"])
    seed, cpu = 2**31 + 77, torch.device("cpu")
    readings = mod.control(e["config"], e["traffic"], seed, cpu, SCALE,
                           round_to=control.CONTROL)
    numbers = mod.compare(readings, mod.reference(e["config"], e["traffic"], seed, cpu, SCALE))
    ok, lines = check.judge(numbers, e["limits"])
    assert not ok, lines


@pytest.mark.parametrize("name,fault", _fault_cases())
def test_fault_is_not_correct(name, fault):
    with control.fault(fault):
        out, err, _ = harness.run_cell(name, 2**31 + 78, 0.2, False, "cpu", time.time(), SCALE)
    assert out["correct"] is False, out["checks"]


def _xyz_step(rank):
    """In a spawned rank, after `control.replant()`: the sign of Adam's first
    step on an xyz element whose gradient is +1 (-1 when sound)."""
    from gsjax_torch.model import gaussians as gm

    with control.replant():
        params = gm.GaussianParams(**{k: torch.zeros(1, 3) for k in gm.PARAM_FIELDS})
        grads = {k: torch.ones(1, 3) for k in gm.PARAM_FIELDS}
        gm.adam_update(params, grads, gm.adam_init(params), {k: 1.0 for k in gm.PARAM_FIELDS})
        return float(torch.sign(params.xyz.detach()[0, 0]))


def test_fault_reaches_every_rank(tmp_path):
    from gsjax_torch.parallel.launch import launch

    def ranks(tag):
        return launch(_xyz_step, 2, device="cpu", timeout=120,
                      init_method=f"file://{tmp_path}/{tag}")

    assert ranks("before") == [-1.0, -1.0]
    with control.fault("grad_sign"):
        assert ranks("planted") == [1.0, 1.0]
    assert ranks("after") == [-1.0, -1.0]
    assert control.FAULT_ENV not in os.environ

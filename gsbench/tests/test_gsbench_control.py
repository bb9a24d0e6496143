"""The control (the bfloat16 reference in the program's place) and each fault
a cell can have, planted under a whole run (the look for a card skipped),
come out not correct at a tiny size on the CPU."""

import time

import pytest
import torch

from gsbench import control, harness
from gsbench.tests.conftest import SCALE


def _limits(name):
    return harness.cell(harness.benchmark(), name)["limits"]


@pytest.mark.parametrize("name", ["tnt.train_mv", "m360.train_mv", "m360.render"])
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


@pytest.mark.parametrize("name,fault", [(w, f) for w, k in (("tnt.train_mv", "train"),
                                                            ("m360.render", "render"))
                                        for f in harness.driver(k).FAULTS])
def test_fault_is_not_correct(name, fault):
    with control.fault(fault):
        out, err = harness.run_cell(name, 2**31 + 78, 0.2, False, "cpu", time.time(), SCALE)
    assert out["correct"] is False, out["checks"]

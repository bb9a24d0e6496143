"""Tests of the benchmark itself (run by hand: `python -m pytest gsbench/tests -q`).
A test that needs the card carries the `card` marker and decides inside a
fixture whether there is one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SCALE = 0.08     # 128x72 frames, ~850-1,500 gaussians: seconds a step on the CPU


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA card")
    # the CPU's multithreaded reductions sum in an order that varies with the
    # threads; on one thread the program's twins and the reference agree bit
    # for bit, so a sound tiny run reads 0 and a planted fault stands out
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")

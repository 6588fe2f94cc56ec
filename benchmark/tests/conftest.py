"""Tests of the benchmark: the reference against the program on the CPU,
the metric readers, the harness's rehearsal and the check's faults.

    python -m pytest -q benchmark/tests            # the CPU tests
    python -m pytest -q -m cuda benchmark/tests    # on a card: the control

Tests that need a card carry the ``cuda`` marker and skip where torch
sees none; the card is looked for inside the ``cuda`` fixture only.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where torch sees none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_set_up(monkeypatch):
    """The program's initial conditions fail the test if they are built."""
    from pysco_tpu_torch import ic_device

    def refuse(*args, **kwargs):
        raise AssertionError("the program's set-up ran")

    monkeypatch.setattr(ic_device, "generate_lpt", refuse)

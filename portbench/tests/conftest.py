"""Shared fixtures of the benchmark's tests: a small configuration tree
(the published radar at 64 pulses, the Doppler CFAR window shrunk to fit)
that the CPU runs in seconds, and a fixture that skips without a card."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_radar(name: str) -> dict:
    """The configuration file ``name``'s radar at 64 pulses, CFAR's
    Doppler window 3 reference and 4 guard cells."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        radar = json.load(f)["radar"]
    radar["sig"]["prt_num"] = 64
    radar["cfar"].update(ref_cells_v=3, guard_cells_v=4)
    return radar


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def small():
    return small_radar

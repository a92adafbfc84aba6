"""On the card, at each cell's own size: a sound run's first steps within
the cell's limits, and the control and every fault outside them.  Run on
a machine with a CUDA device:

    python -m pytest bench_port/tests/test_port_bench_card.py -m cuda
"""

import pytest
import torch

from bench_port import cell as C
from bench_port import faults
from bench_port.calibrate import side_readings
from bench_port.cell import load_benchmark, load_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEED = 2**31 + 97


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fails(cell, values):
    return any(c["value"] > c["limit"] for c in C.judge(cell, values).values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_within_the_limits(name, card):
    cell = load_cell(name)
    assert not _fails(cell, side_readings(cell, "program", SEED, card))


@pytest.mark.cuda
@pytest.mark.parametrize("side", ("control", *faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_outside_the_limits(name, side, card):
    cell = load_cell(name)
    assert _fails(cell, side_readings(cell, side, SEED, card))

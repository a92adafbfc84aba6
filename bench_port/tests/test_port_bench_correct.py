"""``correct`` comes out false for the control and for every fault a cell
on one card can have, at a size the CPU runs, under each cell's limits.

The faults are planted in runs of the cell's model form in IEEE fp32 (the
``highest`` tier, the plain versions on the CPU), where a sound run reads
within every cell's limits and comes out true; the control runs at the
cell's own tier.  ``test_port_bench_card.py`` reads both at each cell's
own size and tier on the card."""

import time

import pytest

from bench_port import cell as C
from bench_port import faults
from bench_port.calibrate import side_readings
from bench_port.cell import load_benchmark, load_cell
from conftest import tiny_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEED = 2**31 + 29


def _tiny_of(name, precision="highest"):
    real = load_cell(name)
    return tiny_cell(real.config["arch"], precision or real.precision,
                     limits=real.spec["limits"],
                     control=real.spec["control"])


def _run(cell, cpu):
    result = C.run(cell, SEED, 0.05, False, cpu, time.perf_counter())
    return result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_faults_come_out_not_correct(name, fault, cpu):
    cell = _tiny_of(name)
    with faults.planted(fault):
        correct, checks = _run(cell, cpu)
    assert not correct, checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_comes_out_correct(name, cpu):
    """Also after faults were planted and removed."""
    cell = _tiny_of(name)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    correct, checks = _run(cell, cpu)
    assert correct, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name, cpu):
    """The cell's control: the reference with its operands rounded to the
    next lower precision in the program's place."""
    cell = _tiny_of(name, precision=None)
    values = side_readings(cell, "control", SEED, cpu)
    checks = C.judge(cell, values)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

"""The Oobleck cell's ``correct`` at a size the CPU runs: its model form
(``arch = oobleck`` against ``reference/oobleck_vae.py``) at tiny widths,
judged under the cell's own limits and control.

``conftest.py`` ``tiny_cell`` builds the MLP form, which
``test_port_bench_correct.py`` runs for every cell; this file holds the
same three claims for the Oobleck form: a sound run comes out true, each
fault that can reach the model comes out false, and so does the control.
``bias_twice`` plants a second bias on the decoder's last layer, which the
published model has without a bias, so it has nothing to reach here."""

import time

import pytest

from bench_port import cell as C
from bench_port import faults
from bench_port.calibrate import side_readings
from bench_port.cell import load_cell

NAME = "oobleck-bf16-b48x65536"
SEED = 2**31 + 29
FAULTS = [f for f in faults.FAULTS if f != "bias_twice"]


def tiny_oobleck(precision: str = "highest") -> C.Cell:
    """The cell's form at channels 4 · [1, 1, 2], strides [2, 4] and
    kernel 7 over 128 stereo frames, a batch of 6, 5 steps an epoch."""
    real = load_cell(NAME)
    config = dict(real.config, name="tiny", segment_length=256,
                  hop_length=256, latent_dim=4, batch_size=6)
    config["program"] = {
        "vae": {"conv_channels": "4,4,8", "conv_strides": "2,4",
                "conv_kernel": 7, "io_channels": 2},
        "tpu": dict(real.config["program"]["tpu"])}
    traffic = {"corpus": {"samples": 256 * 30, "files": 4},
               "program": {"tpu": {"precision": precision}}}
    return C.Cell(name="tiny", chips=1, config=config, traffic=traffic,
                  spec=real.spec)


def _run(cell, cpu):
    result = C.run(cell, SEED, 0.05, False, cpu, time.perf_counter())
    return result["correct"], result["checks"]


def test_tiny_form_is_the_cells_model():
    real, tiny = load_cell(NAME), tiny_oobleck()
    assert (tiny.config["arch"], tiny.config["reference"]) == (
        real.config["arch"], real.config["reference"]) == (
        "oobleck", "oobleck_vae")
    assert tiny.spec["limits"] == real.spec["limits"]


def test_sound_run_comes_out_correct(cpu):
    """Also after faults were planted and removed."""
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    correct, checks = _run(tiny_oobleck(), cpu)
    assert correct, checks


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_come_out_not_correct(fault, cpu):
    with faults.planted(fault):
        correct, checks = _run(tiny_oobleck(), cpu)
    assert not correct, checks


def test_control_comes_out_not_correct(cpu):
    """The reference with every tensor the program's bf16 step holds in
    bf16 rounded to fp8 instead, and the gradients reaching them."""
    cell = tiny_oobleck(load_cell(NAME).precision)
    values = side_readings(cell, "control", SEED, cpu)
    checks = C.judge(cell, values)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

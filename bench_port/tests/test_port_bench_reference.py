"""The plain reference against the program on the same inputs, at a size
the CPU runs: the seed rules copied into the benchmark are the program's,
and the reference's first steps are the program's plain path's."""

import pytest

from bench_port import cell as C
from bench_port import seeds
from conftest import tiny_cell

SEEDS = [0, 7, 2**31 - 1, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_rules_are_the_programs(seed):
    from rawaudiovae_kelsey_tpu_torch.parallel.resident import perm_seed
    from rawaudiovae_kelsey_tpu_torch.parallel.step import noise_seed
    for k in (0, 1, 22, 1000):
        assert seeds.perm_seed(seed, k) == perm_seed(seed, k)
        assert seeds.noise_seed(seed, k) == noise_seed(seed, k, None)


@pytest.mark.parametrize("arch", ["dense", "deep"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_reference_follows_the_plain_path(arch, backend, cpu):
    """IEEE fp32 on both sides: the losses of set-up's first steps and of
    the window's (after an epoch) within fp32 rounding, the gradients'
    norms too, the parameters' change within Adam's rounding (a gradient
    near 0 turns rounding into up to lr of change)."""
    cell = tiny_cell(arch, "highest", backend)
    prog = C.set_up(cell, 2**31 + 11, cpu)
    window = C.run_window(prog, 0.0, cpu)
    got = C.reference_readings(cell, 2**31 + 11,
                               C.readout(prog, window, cell), cpu)
    assert got["loss_gap"] <= 1e-6
    assert got["window_loss_gap"] <= 1e-6
    assert got["grad_gap"] <= 1e-6
    assert got["change_gap"] <= 1e-3


def test_reference_is_the_same_from_the_same_seed(cpu):
    cell = tiny_cell()
    ref = C.reference_module(cell)
    a = ref.init_params(cell.config, 5, cpu)
    b = ref.init_params(cell.config, 5, cpu)
    c = ref.init_params(cell.config, 6, cpu)
    la, lb, lc = (ref.leaves(t, cell.config) for t in (a, b, c))
    assert all((la[k] == lb[k]).all() for k in la)
    assert not all((la[k] == lc[k]).all() for k in la)

"""Shared fixtures of the benchmark's tests: the checkout on the import
path, and cells small enough for the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(arch: str = "dense", precision: str = "highest",
              backend: str = "pallas", limits: dict = None,
              control: dict = None):
    """A cell of the real configurations' form at widths the CPU runs in a
    second: 64-sample frames at hop 16, a batch of 64, 397 frames."""
    from bench_port import cell as C
    hidden = [32] if arch == "dense" else [48, 32, 16]
    config = {
        "name": "tiny", "reference": "mlp_vae", "arch": arch,
        "sampling_rate": 44100, "segment_length": 64, "hop_length": 16,
        "hidden_dims": hidden, "latent_dim": 8, "kl_beta": 1e-4,
        "learning_rate": 1e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
        "batch_size": 64, "loss_reduction": "mean",
        "program": {"tpu": {"backend": backend, "microbatch_size": 0,
                            "resident_budget_gb": 4.0, "rng": "threefry",
                            "resident_shuffle": "global"}}}
    traffic = {"corpus": {"samples": 6400, "files": 4},
               "program": {"tpu": {"precision": precision}}}
    return C.Cell(name="tiny", chips=1, config=config, traffic=traffic,
                  spec={"limits": limits or {},
                        "control": control or {"rounding": "fp8"}})


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")

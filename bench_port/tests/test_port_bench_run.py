"""run.py's refusals: no card, and no program beside the benchmark."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port.cell import HERE, ROOT

ARGS = ["--workload", "dense-bf16-b131072", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "bench_port/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_exits_nonzero_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and bench_port/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("traces", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)

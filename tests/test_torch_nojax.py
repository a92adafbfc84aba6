"""The port (rawaudiovae_kelsey_tpu_torch) stands alone: none of its
modules imports JAX or the JAX package, so it runs on a machine that has
neither."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = "rawaudiovae_kelsey_tpu_torch"
SOURCES = sorted((REPO / PKG).rglob("*.py"))

SLICE = [
    "config.schema", "config.ini", "config.workspace", "io.wavio",
    "io.native",
    "io.resample", "data.framing", "data.corpus", "data.datasets",
    "data.validate", "data.loader", "models.vae", "models.registry",
    "models.variants", "tree",
    "ops.mlp", "ops.quant", "ops.rng", "ops.loss", "ops._build",
    "ops.linear", "ops.toeplitz", "ops.conv", "ops.linear_bwd", "ops.adam",
    "probes.common", "probes.deep_bwd", "probes.deep_step",
    "probes.adam_fusion", "probes.sass_count",
    "parallel.step", "parallel.mesh", "parallel.spmd",
    "parallel.resident", "train.state",
    "train.optim", "train.checkpoint", "train.loop", "train.interrupt",
    "train.epoch", "train.stream", "train.cli", "eval.fixtures", "eval.cli",
    "observe.tb",
    "observe.timing", "observe.logging", "compat.from_jax",
    "infer.synthesis", "infer.api", "infer.server", "infer.http",
    "infer.audio_utils", "infer.som", "infer.som_train", "infer.onnx_model",
    "infer.export", "infer.runs", "observe.viz", "compat.torch_import",
    "__main__",
]
# the port's example scripts, beside the JAX package's
EXAMPLES = sorted((REPO / "examples").glob("*_torch.py"))


def _modules():
    found = [m.name for m in pkgutil.walk_packages([str(REPO / PKG)],
                                                   PKG + ".")]
    return [PKG] + sorted(found)


def test_every_slice_module_exists():
    mods = _modules()
    for name in SLICE:
        assert f"{PKG}.{name}" in mods


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rawaudiovae_kelsey_tpu', 'bench', "
        "'benchmarks'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO / PKG)))
def test_no_source_imports_jax(path):
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|rawaudiovae_kelsey_tpu|bench|"
        r"benchmarks)(\.|\s|$)",
        re.M)
    assert not pattern.findall(path.read_text())


def test_the_three_examples_of_the_port_exist():
    assert [p.name for p in EXAMPLES] == ["export_torch.py",
                                          "live_session_torch.py",
                                          "tutorial_torch.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_no_example_of_the_port_imports_jax(path):
    assert not re.findall(
        r"^\s*(import|from)\s+(jax|jaxlib|rawaudiovae_kelsey_tpu|bench|"
        r"benchmarks)(\.|\s|$)", path.read_text(), re.M)


def test_chip_smoke_imports_no_jax_either():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.findall(
        r"^\s*(import|from)\s+(jax|jaxlib|rawaudiovae_kelsey_tpu|bench|"
        r"benchmarks)(\.|\s|$)", text, re.M)

"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the references load nothing of the program."""

import ast
import subprocess
import sys

import pytest

from bench_port.cell import FORBIDDEN, HERE, ROOT

PROGRAM = "rawaudiovae_kelsey_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    imported = _top_level_imports(path)
    assert PROGRAM not in imported
    assert imported <= {"__future__", "typing", "torch", "bench_port"}


def test_what_a_run_loads_holds_no_jax():
    """Import what run.py reaches, the program's modules of the window
    with it, and read ``sys.modules`` as run.py does after the window."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_port import cell, corpus, faults, flops, trace\n"
        "from bench_port.reference import mlp_vae\n"
        "import bench_port.run\n"
        "from rawaudiovae_kelsey_tpu_torch.models import registry\n"
        "from rawaudiovae_kelsey_tpu_torch.parallel import resident\n"
        "for name in ('step_mfu', 'launches_per_step', 'kernels_roofline',"
        " 'device_idle_pct'): cell.load_reader(name)\n"
        "print(','.join(cell.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""

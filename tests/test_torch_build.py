"""The kernel build of the port (rawaudiovae_kelsey_tpu_torch/ops/_build.py):
every csrc/*.cu compiled by its own nvcc, linked into one library, cached
by a hash of sources and flags, and a failure that raises.  nvcc exists
only where the GPU is, so a stand-in
compiler records what the build asks of it; the real build runs in
chip_smoke.py."""

import json
import os
import stat
import sys
from pathlib import Path

import pytest

from rawaudiovae_kelsey_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import json, sys
from pathlib import Path
args = sys.argv[1:]
with open({log!r}, "a") as fh:
    fh.write(json.dumps(args) + "\\n")
if {fail!r}:
    print("error: fake compile failure", file=sys.stderr)
    sys.exit(2)
Path(args[args.index("-o") + 1]).write_bytes(b"\\x7fELF")
print("ptxas info    : Used 32 registers", file=sys.stderr)
"""


def _fake_nvcc(tmp_path, monkeypatch, fail=False):
    log = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     fail=fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def test_build_compiles_every_source_once_and_caches(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch)
    lib = _build.build()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert "registers" in lib.with_suffix(".log").read_text()
    calls = [json.loads(c) for c in log.read_text().splitlines()]
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    # one compile per source (started together), then one link
    compiles, link = calls[:-1], calls[-1]
    assert sorted(Path(c[-1]).name for c in compiles) == sources
    for c in compiles:
        for flag in ("arch=compute_90a,code=sm_90a", "-O3", "-c"):
            assert flag in c
    assert "-shared" in link
    assert len([a for a in link if a.endswith(".o")]) == len(sources)
    for src in ("mlp.cu", "quant.cu", "bwd.cu", "rng.cu", "loss.cu"):
        assert src in sources
    assert _build.build() == lib                # cached: no second compile
    assert len(log.read_text().splitlines()) == len(calls)
    assert not list(lib.parent.glob("*.tmp*"))
    assert not list(lib.parent.glob("*.o"))


def test_every_bound_entry_point_is_exported_by_a_source():
    """Each C entry point the loader binds is defined, ``extern "C"``, in
    one of the sources, with as many parameters as its ctypes signature
    (the stream last); and every ``rvk_`` function a source exports is
    bound."""
    import re

    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    exported = {}
    for m in re.finditer(r"^int (rvk_\w+)\(([^)]*)\)\s*\{", text, re.M):
        exported[m.group(1)] = [a.strip() for a in m.group(2).split(",")]
    assert set(exported) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        params = exported[name]
        assert len(params) == len(argtypes), name
        assert params[-1] == "void* stream", name
        for param, ctype in zip(params, argtypes):
            pointer = "*" in param
            assert pointer == (ctype is _build._P), (name, param)
            if param.startswith("long long"):
                assert ctype is _build._L, (name, param)
    for name in ("rvk_enc_bwd_full", "rvk_dec_bwd_full", "rvk_loss_sums"):
        assert name in exported
    assert "const char* rvk_error_string(int code)" in text


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    first = _build.build()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    (csrc / "gemm.cuh").write_text((csrc / "gemm.cuh").read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.build() != first              # an edited header rebuilds


def test_build_failure_raises(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.build()
    assert not list((tmp_path / "build").glob("*"))


def test_missing_toolkit_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if _build.shutil.which("nvcc"):
        pytest.skip("an nvcc is on PATH")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()

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
    for src in ("mlp.cu", "quant.cu", "bwd.cu", "rng.cu", "loss.cu",
                "linear.cu", "toeplitz.cu", "linear_bwd.cu", "adam.cu"):
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
            assert param.startswith("float ") == (ctype is _build._F), \
                (name, param)
    for name in ("rvk_enc_bwd_full", "rvk_dec_bwd_full", "rvk_loss_sums",
                 "rvk_linear_fwd", "rvk_linear_ksplit_fwd",
                 "rvk_toeplitz_fwd", "rvk_dw_fused", "rvk_dx_fused",
                 "rvk_leaf_update", "rvk_adam_tree"):
        assert name in exported
    assert "const char* rvk_error_string(int code)" in text
    # the entry points with a tensor-core form name the kernel to run last
    # before the stream, its tile width before that, and their sources
    # build on the shared mainloop
    for name in ("rvk_linear_fwd", "rvk_linear_ksplit_fwd", "rvk_matmul_nt",
                 "rvk_toeplitz_fwd"):
        assert exported[name][-2] == "int kernel", name
        assert exported[name][-3] == "int tile_n", name
        assert _build._SIGNATURES[name][-2] is _build._I, name
    # the encoder: the hidden product's tile width, then the heads'
    assert exported["rvk_encoder_fwd"][-4:-1] == [
        "int tile_hidden", "int tile_heads", "int kernel"]
    # the weight gradients on the tensor cores: the tile width and the
    # batch's slices before the kernel, the slices' workspace after the
    # outputs
    assert exported["rvk_grad_accum"][-4:-1] == [
        "int tile_dw", "int split", "int kernel"]
    assert exported["rvk_enc_bwd_dw1"][-5:-1] == [
        "int tile_dh", "int tile_dw", "int split", "int kernel"]
    for name in ("rvk_grad_accum", "rvk_enc_bwd_dw1", "rvk_dec_bwd_fused"):
        assert "float* workspace" in exported[name], name
    for src in ("linear.cu", "bwd.cu", "toeplitz.cu", "mlp.cu"):
        assert '#include "wgmma.cuh"' in (_build.CSRC / src).read_text()
    assert (_build.CSRC / "wgmma.cuh").is_file()


def test_every_wrapper_names_a_bound_entry_point():
    """Each kernel wrapper of ``ops`` launches entry points the loader
    binds, and the three probe kernels are among the wrappers."""
    import inspect
    import re

    from rawaudiovae_kelsey_tpu_torch import ops

    names = {w.__name__ for w in ops.KERNEL_WRAPPERS}
    assert {"dw_fused", "dx_fused", "adam_tree", "leaf_update"} <= names
    assert set(ops.PROBE_KERNELS) <= set(ops.KERNEL_WRAPPERS)
    for w in ops.KERNEL_WRAPPERS:
        launched = re.findall(r'launch\(\s*"(rvk_\w+)"',
                              inspect.getsource(w))
        assert launched, w.__name__
        assert set(launched) <= set(_build._SIGNATURES), w.__name__
        assert w.launches == 0 or isinstance(w.launches, int)
    assert _build._SIGNATURES["rvk_leaf_update"] == (
        [_build._P] * 6 + [_build._L] + [_build._F] * 6 + [_build._P])
    # p, g, m, v, n, start, vec (host arrays) | leaves | bc1_ptr, bc2_ptr
    # | bc1, bc2, c1, b1, c2, b2, eps, neg_lr
    assert _build._SIGNATURES["rvk_adam_tree"] == (
        [_build._P] * 7 + [_build._I] + [_build._P] * 2
        + [_build._F] * 8 + [_build._P])
    # x, w, b, y, ws | batch, k, n, slices, kslice, act, dtype, tile_n,
    # kernel
    assert _build._SIGNATURES["rvk_linear_ksplit_fwd"] == (
        [_build._P] * 5 + [_build._I] * 9 + [_build._P])
    # a, w, out | batch, n, m, dtype, tile_n, kernel
    assert _build._SIGNATURES["rvk_matmul_nt"] == (
        [_build._P] * 3 + [_build._I] * 6 + [_build._P])
    # x, w, b, y | batch, k, n, act, dtype, tile_n, kernel
    assert _build._SIGNATURES["rvk_linear_fwd"] == (
        [_build._P] * 4 + [_build._I] * 7 + [_build._P])
    # x, w1, b1, w21, b21, w22, b22, mu, logvar, h, workspace | batch, seg,
    # units, latent, dtype, split_hidden, split_heads, tile_hidden,
    # tile_heads, kernel
    assert _build._SIGNATURES["rvk_encoder_fwd"] == (
        [_build._P] * 11 + [_build._I] * 10 + [_build._P])
    # z, w3, b3, w4, b4, y, h3, workspace | batch, latent, units, seg,
    # dtype, split_hidden, split_out, tile_hidden, tile_out, kernel
    assert _build._SIGNATURES["rvk_decoder_fwd"] == (
        [_build._P] * 8 + [_build._I] * 10 + [_build._P])
    # x, w, bias, y, workspace | B, nb, G, kb, N, t_out, shift, act,
    # passes, dtype, k0, k_len, t_half, b_half, tile_n, kernel
    assert _build._SIGNATURES["rvk_toeplitz_fwd"] == (
        [_build._P] * 5 + [_build._I] * 16 + [_build._P])
    for w in ops.KERNEL_WRAPPERS:
        if w.__name__ in ("linear_fwd", "linear_ksplit_fwd", "matmul_nt",
                          "toeplitz_fwd", "encoder_fwd", "decoder_fwd",
                          "dec_bwd_fused", "grad_accum", "enc_bwd_dw1"):
            assert w.tensor_core_launches == 0 \
                or isinstance(w.tensor_core_launches, int)
            assert "kernel" in inspect.signature(w).parameters


@pytest.mark.parametrize("header", ["gemm.cuh", "wgmma.cuh", "sgemm.cuh"])
def test_build_key_follows_the_sources(tmp_path, monkeypatch, header):
    _fake_nvcc(tmp_path, monkeypatch)
    first = _build.build()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    (csrc / header).write_text((csrc / header).read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.build() != first              # an edited header rebuilds


def test_the_fp32_forward_entry_points_build_on_sgemm_cuh():
    """rvk_encoder_fwd and rvk_decoder_fwd launch sgemm.cuh's launch_fwd for
    kernel code 2: h with the ReLU, then both heads in one two-output
    launch; h3 with the ReLU, then y with tanh; so do their row-parallel
    forms (the encoder's with no head biases, the decoder's y with no bias
    and no tanh).  The two-output grid and the epilogue of a split product
    are sgemm.cuh's and slices.cuh's."""
    text = (_build.CSRC / "mlp.cu").read_text()
    assert '#include "sgemm.cuh"' in text
    assert text.count("kernel == rvk::tc::kSgemm") == 4
    partial = text.split("int sgemm_decoder_partial(")[1].split("}\n")[0]
    assert partial.count("rvk::sgemm::launch_fwd<1, rvk::kActRelu>") == 1
    assert partial.count("rvk::sgemm::launch_fwd<1, rvk::kActNone>") == 1
    assert "sgemm_encoder(x, w1, b1, w21, nullptr, w22, nullptr" in text
    encoder = text.split("int sgemm_encoder(")[1].split(
        "int sgemm_decoder(")[0]
    decoder = text.split("int sgemm_decoder(")[1].split("}  // namespace")[0]
    assert encoder.count("rvk::sgemm::launch_fwd<1, rvk::kActRelu>") == 1
    assert encoder.count("rvk::sgemm::launch_fwd<2, rvk::kActNone>") == 1
    assert decoder.count("rvk::sgemm::launch_fwd<1, rvk::kActRelu>") == 1
    assert decoder.count("rvk::sgemm::launch_fwd<1, rvk::kActTanh>") == 1
    assert "sgemm_heads_kernel" in (_build.CSRC / "sgemm.cuh").read_text()
    assert "__global__ void slices_epilogue(" in (
        _build.CSRC / "slices.cuh").read_text()

def test_the_fp32_entry_points_build_on_sgemm_cuh():
    """rvk_linear_fwd, rvk_linear_ksplit_fwd, rvk_matmul_nt,
    rvk_matmul_nt_mask, rvk_matmul_nt2_mask, rvk_grad_accum,
    rvk_grad_accum2, rvk_enc_bwd_dw1 and rvk_dec_bwd_fused launch the fp32
    mainloop of csrc/sgemm.cuh for kernel code 2 (the rvk::tc::Kernel
    enum), the two linear entry points and their row-parallel form
    (rvk_linear_partial) with the same call, the gated ones
    its gated form, rvk_grad_accum its weight-gradient form, the last three
    those launches one after another (grad_accum2: the weight gradient
    twice; enc_bwd_dw1: the joined gated form, then the weight gradient;
    dec_bwd_fused: the gated form, the plain one, the weight gradient), the
    full chains in one fp32 pass (rvk_enc_bwd_full, rvk_dec_bwd_full) those
    of enc_bwd_dw1 and grad_accum2, and of dec_bwd_fused and one more
    weight gradient, and its tile table is the wrappers' SGEMM_TILES."""
    import re

    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    # source → (entry points with an fp32 branch, the launches' calls)
    for src, branches, calls in (
            ("linear.cu", 3, {"rvk::sgemm::launch_act<false>": 3}),
            ("bwd.cu", 9, {"rvk::sgemm::launch<true, rvk::kActNone>": 2,
                           "rvk::sgemm::launch_gated<false>(": 2,
                           "rvk::sgemm::launch_gated<true>(": 2,
                           "rvk::sgemm::launch_wgrad(src<float>": 6})):
        text = (_build.CSRC / src).read_text()
        assert '#include "sgemm.cuh"' in text
        assert text.count("kernel == rvk::tc::kSgemm") == branches, src
        for call, times in calls.items():
            assert text.count(call) == times, (src, call)
    grad = (_build.CSRC / "bwd.cu").read_text().split(
        "int rvk_grad_accum(")[1].split("int rvk_grad_accum2(")[0]
    assert "rvk::sgemm::launch_wgrad(src<float>" in grad
    ksplit = (_build.CSRC / "linear.cu").read_text().split(
        "int rvk_linear_ksplit_fwd(")[1]
    assert "kernel == rvk::tc::kSgemm" in ksplit
    assert "kSgemm = 2" in (_build.CSRC / "wgmma.cuh").read_text()
    tiles = re.search(r"kTiles\[3\]\[2\] = \{(.*?)\};",
                      (_build.CSRC / "sgemm.cuh").read_text()).group(1)
    assert tuple(tuple(int(v) for v in pair) for pair in
                 re.findall(r"\{(\d+), (\d+)\}", tiles)) == \
        tensor_cores.SGEMM_TILES


def test_a_failed_build_is_not_run_again(monkeypatch):
    """library() remembers a failed build for the sources' hash: a second
    call raises the same error without building; a changed hash (an edited
    source) builds again."""
    calls = []

    def failing_build():
        calls.append(_build.source_digest())
        raise RuntimeError("kernel build failed (nvcc exit 2)")

    monkeypatch.setattr(_build, "build", failing_build)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_failed", {})
    with pytest.raises(RuntimeError, match="nvcc exit 2") as first:
        _build.library()
    with pytest.raises(RuntimeError, match="nvcc exit 2") as second:
        _build.library()
    assert second.value is first.value
    assert len(calls) == 1
    monkeypatch.setattr(_build, "source_digest", lambda: "another")
    with pytest.raises(RuntimeError, match="nvcc exit 2"):
        _build.library()
    assert calls == [calls[0], "another"]
    with pytest.raises(RuntimeError, match="nvcc exit 2"):
        _build.launch("rvk_encoder_fwd", None)
    assert len(calls) == 2


def test_a_failed_compile_runs_the_compiler_once(tmp_path, monkeypatch):
    """With a compiler that fails: the first library() call runs one nvcc a
    source, later calls none; an edited source compiles again."""
    log = _fake_nvcc(tmp_path, monkeypatch, fail=True)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_failed", {})
    n_sources = len(list(_build.CSRC.glob("*.cu")))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="fake compile failure"):
            _build.library()
    assert len(log.read_text().splitlines()) == n_sources
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    (csrc / "mlp.cu").write_text((csrc / "mlp.cu").read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.library()
    assert len(log.read_text().splitlines()) == 2 * n_sources


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


def test_launch_passes_pointers_and_the_current_stream(monkeypatch):
    """``launch`` hands the entry point each tensor's data pointer, every
    other argument as it is, and the raw current stream of the device last;
    a ``cuda`` device without an index is the current one; a non-zero
    return code raises with the library's message."""
    import types

    import torch

    calls = []
    monkeypatch.setitem(_build._entry, "rvk_stand_in",
                        lambda *a: calls.append(a) or 0)
    monkeypatch.setitem(_build._entry, "rvk_failing", lambda *a: 700)
    monkeypatch.setattr(_build.torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        rvk_error_string=lambda rc: b"an illegal memory access"))
    t = torch.zeros(4)
    _build.launch("rvk_stand_in", torch.device("cuda"), t, 7, 1.5, None)
    _build.launch("rvk_stand_in", torch.device("cuda", 2), t)
    assert calls == [(t.data_ptr(), 7, 1.5, None, 1002),
                     (t.data_ptr(), 1002)]
    with pytest.raises(RuntimeError, match="rvk_failing: CUDA error 700 "
                       r"\(an illegal memory access\)"):
        _build.launch("rvk_failing", torch.device("cuda", 2), t)

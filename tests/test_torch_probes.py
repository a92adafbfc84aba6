"""The port's probes (rawaudiovae_kelsey_tpu_torch/probes/) on the CPU at a
tiny size: each ``main(["--device", "cpu", ...])`` runs, passes its own
parity and ends with one JSON line; the shared ``build_cfg`` gives
the fields of the JAX repository's ``bench._build_cfg``; a probe refuses
``--device cuda`` where there is no card.  Times taken here are the CPU's
and are checked only for being numbers: the probes measure on the card.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.config.ini import PORT_ONLY
from rawaudiovae_kelsey_tpu_torch.ops import adam as adam_ops
from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.probes import (
    adam_fusion,
    common,
    deep_bwd,
    deep_step,
    fusion_ab,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench  # noqa: E402  (the JAX repository's harness; imports no JAX)


@pytest.fixture
def tiny(monkeypatch):
    """The three families at a few dozen units."""
    monkeypatch.setattr(common, "SEG", 64)
    monkeypatch.setattr(common, "UNITS", 48)
    monkeypatch.setattr(common, "LATENT", 8)
    monkeypatch.setattr(common, "DEEP_SEG", 64)
    monkeypatch.setattr(common, "DEEP_HIDDEN", (48, 32))
    monkeypatch.setattr(common, "CONV_CHANNELS", (4, 8))
    monkeypatch.setattr(common, "CONV_K", 5)
    monkeypatch.setattr(common, "DEEP_SHAPES", ((48, 40), (24, 16)))


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines


@pytest.mark.parametrize("arch", common.ARCHS)
@pytest.mark.parametrize("precision,backend,micro",
                         [("bfloat16", "xla", 0), ("high", "pallas", 512)])
def test_build_cfg_gives_the_fields_of_bench_build_cfg(arch, precision,
                                                       backend, micro):
    want = bench._build_cfg(arch, 4096, precision, backend, micro)
    got = dataclasses.asdict(
        common.build_cfg(arch, 4096, precision, backend, micro))
    # the port's own keys (the Oobleck VAE's) are at their defaults
    for (section, key), default in PORT_ONLY.items():
        assert got[section.lower()].pop(key) == default, (section, key)
    assert got == dataclasses.asdict(want)
    assert common.flops_per_frame(arch) == bench.flops_per_frame(arch)


def test_constants_are_the_harness_ones():
    for name in ("SEG", "UNITS", "LATENT", "KL_BETA", "LR", "DEEP_SEG",
                 "DEEP_HIDDEN", "CONV_CHANNELS", "CONV_K", "CONV_S"):
        assert getattr(common, name) == getattr(bench, name), name
    dims = [common.DEEP_SEG, *common.DEEP_HIDDEN]
    assert common.DEEP_SHAPES == tuple(zip(dims[:-1], dims[1:]))
    with pytest.raises(ValueError):
        common.build_cfg("resnet", 8, "bfloat16", "xla")


@pytest.mark.parametrize("dtype,act", [("bfloat16", "relu"),
                                       ("float32", "tanh"),
                                       ("bfloat16", "none")])
def test_deep_bwd_runs_and_passes_its_parity(capsys, dtype, act):
    out = deep_bwd.main(["--device", "cpu", "--batch", "64", "--k", "48",
                         "--n", "40", "--dtype", dtype, "--act", act,
                         "--pairs", "2", "--launches", "1"])
    last, lines = _last_json(capsys)
    assert last == json.loads(json.dumps(out)) and last["device"] == "cpu"
    (shape,) = last["shapes"]
    assert (shape["batch"], shape["k"], shape["n"]) == (64, 48, 40)
    assert set(shape["parity"]) == {"dx", "dw", "db"}
    assert all(e <= deep_bwd.PARITY_REL[dtype]
               for e in shape["parity"].values())
    assert set(shape["ms"]) == {"plain", "fused", "dw_fused", "dx_fused"}
    for s in shape["ms"].values():
        assert s["n"] == 2 and 0 < s["p10"] <= s["median"] <= s["p90"]
    # on the CPU the wrappers run their plain versions: no launch counted
    assert shape["launches_per_fused_bwd"] == {"dw_fused": 0, "dx_fused": 0}
    assert any(line.startswith("parity dx") for line in lines)


def test_deep_bwd_all_runs_the_deep_shapes(capsys, tiny):
    deep_bwd.main(["--device", "cpu", "--batch", "32", "--all", "--pairs",
                   "1", "--launches", "1"])
    last, _ = _last_json(capsys)
    assert [(s["k"], s["n"]) for s in last["shapes"]] == [(48, 40), (24, 16)]


def test_deep_bwd_fails_on_a_parity_miss(monkeypatch, capsys):
    monkeypatch.setattr(
        linear_bwd, "dx_fused_ref",
        lambda y, dy, w, act="relu": torch.zeros((y.shape[0], w.shape[0]),
                                                 dtype=y.dtype))
    with pytest.raises(RuntimeError, match="parity dx"):
        deep_bwd.main(["--device", "cpu", "--batch", "16", "--k", "8",
                       "--n", "8", "--pairs", "1", "--launches", "1"])


@pytest.mark.parametrize("arch", common.ARCHS)
def test_deep_step_decomposes_a_step(capsys, tiny, arch):
    deep_step.main(["--device", "cpu", "--arch", arch, "--batch", "16",
                    "--pairs", "2", "--steps", "1"])
    last, lines = _last_json(capsys)
    assert last["probe"] == "deep_step" and last["device"] == "cpu"
    assert set(last["ms"]) == {"full", "grads", "adam"}
    assert last["adam_bytes"] == 28 * last["params"]
    assert last["adam_bound_ms"] == pytest.approx(
        28 * last["params"] / 3.35e12 * 1e3)
    assert any("7-stream fp32 bound" in line for line in lines)


def test_deep_step_bounds_at_full_width():
    """The analytic rows of the two models at their real widths: 7 fp32
    streams over the parameters at the H100's 3.35 TB/s."""
    deep = 55_987_712
    assert 28 * deep / common.H100_HBM_BYTES_S * 1e3 == pytest.approx(
        0.468, abs=5e-4)
    assert 28 * 5_772_800 / common.H100_HBM_BYTES_S * 1e3 == pytest.approx(
        0.048, abs=5e-4)


@pytest.mark.parametrize("arch,backend", [("dense", "pallas"),
                                          ("deep", "xla"),
                                          ("deep", "pallas"),
                                          ("conv1d", "xla")])
def test_adam_fusion_runs_and_the_states_are_equal(capsys, tiny, arch,
                                                   backend):
    out = adam_fusion.main(["--device", "cpu", "--arch", arch, "--backend",
                            backend, "--batch", "16", "--pairs", "2",
                            "--steps", "2"])
    last, lines = _last_json(capsys)
    assert last == json.loads(json.dumps(out))
    assert last["states_equal"] is True and last["backend"] == backend
    # one step to count launches, two of warm-up, then 2 pairs x 2 steps
    assert last["steps_each"] == 1 + 2 + 4
    assert last["leaves"] == {"dense": 10, "deep": 14, "conv1d": 14}[arch]
    assert last["adam_tree_launches_per_step"] == {"plain": 0, "fused": 0}
    assert set(last["frames_per_s"]) == {"plain", "fused"}
    assert any("equal bit for bit" in line for line in lines)


def test_adam_fusion_exits_when_the_states_differ(monkeypatch, capsys, tiny):
    tree_update = adam_ops.adam_tree

    def off_by_an_ulp(ps, gs, ms, vs, bc1, bc2, **hyper):
        tree_update(ps, gs, ms, vs, bc1, bc2, **hyper)
        ps[0].mul_(1 + 2.0 ** -23)

    off_by_an_ulp.launches = 0
    monkeypatch.setattr(adam_ops, "adam_tree", off_by_an_ulp)
    with pytest.raises(SystemExit, match="differ"):
        adam_fusion.main(["--device", "cpu", "--arch", "dense", "--batch",
                          "8", "--pairs", "1", "--steps", "1"])
    assert "DIFFER" in capsys.readouterr().out


@pytest.mark.parametrize("probe", [deep_bwd, deep_step, adam_fusion])
def test_a_probe_refuses_cuda_without_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main(["--device", "cuda"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main([])                     # cuda is the default


def test_alternate_reverses_the_order_every_round():
    order = []
    common.alternate({"a": lambda: order.append("a"),
                      "b": lambda: order.append("b")},
                     pairs=3, launches=1, device=torch.device("cpu"),
                     warmup=0)
    assert order == ["a", "b", "b", "a", "a", "b"]
    s = common.summary([float(v) for v in range(1, 11)])
    assert (s["median"], s["n"]) == (5.5, 10) and s["p10"] < 2 < 9 < s["p90"]


@pytest.mark.parametrize("precision", ["bfloat16", "high"])
def test_fusion_ab_runs_and_prints_its_line(tiny, capsys, monkeypatch,
                                            precision):
    """Both modes' steps from one state, each through its own backward (the
    calls of the chains and of the split kernels, counted here: on the CPU
    the wrappers run their plain versions and count no launch), a rate for
    each, the JSON line last; the switch put back."""
    calls = {}
    for name in ("enc_bwd_full", "dec_bwd_full", "enc_bwd_dw1",
                 "dec_bwd_fused"):
        real = getattr(mlp, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mlp, name, spy)
    out = fusion_ab.main(["--device", "cpu", "--batch", "64", "--precision",
                          precision, "--pairs", "2", "--steps", "1"])
    last, lines = _last_json(capsys)
    assert last == json.loads(json.dumps(out)) and last["device"] == "cpu"
    assert (last["probe"], last["precision"], last["modes"]) == (
        "fusion_ab", precision, ["split", "full"])
    # a step each, alternate's two warm-up calls, two pairs of one step
    assert calls == {name: 1 + 2 + 2 for name in calls} and len(calls) == 4
    assert last["launches_per_step"] == {"split": {}, "full": {}}
    for mode in ("split", "full"):
        f = last["frames_per_s"][mode]
        assert f["p10"] <= f["median"] <= f["p90"]
        assert any(line.strip().startswith(f"{precision} {mode}")
                   for line in lines)
    assert mlp.BWD_FUSION == "auto"

"""The port's export (rawaudiovae_kelsey_tpu_torch/infer/onnx_model.py,
infer/export.py) and its ``export`` command against the JAX package's, on
the CPU.

``export_onnx`` writes the JAX writer's bytes for the same weights, in all
four flavors (the reference-parity graph, a symbolic batch, z = mu, a seeded
RandomNormalLike).  The port's decoder reads both writers' files as JAX's
reader does, and malformed bytes raise its one ``OnnxDecodeError`` (the
fuzz of tests/test_onnx.py, with hypothesis).  ``export_npz`` gives the JAX
file's keys and arrays for the three families, and ``export_program`` /
``load_program`` round-trip the plain forward: the deterministic graph to
the eager forward bit for bit here, the stochastic one under the same
``torch.manual_seed``.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.infer import export as jexport
from rawaudiovae_kelsey_tpu.infer import onnx_model as jonnx
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config, save_config
from rawaudiovae_kelsey_tpu_torch.infer import export, onnx_model
from rawaudiovae_kelsey_tpu_torch.infer.onnx_model import (
    OnnxDecodeError,
    OnnxModel,
    export_onnx,
)
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.train import save_params

SEG, HOP, UNITS, LATENT = 64, 16, 128, 8
ARCHS = {
    "dense": {},
    "deep": dict(hidden_dims="96,48"),
    "conv1d": dict(conv_channels="4,8", conv_kernel=5, conv_stride=4),
}
FLAVORS = {
    "reference": dict(),
    "batch_N": dict(batch="N", deterministic=True),
    "deterministic": dict(deterministic=True),
    "seed": dict(seed=7),
    "batch_3": dict(batch=3),
}


def _cfg(cls, arch="dense", backend="pallas"):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.vae.arch = arch
    for k, v in ARCHS[arch].items():
        setattr(cfg.vae, k, v)
    cfg.tpu.backend = backend
    cfg.tpu.precision = "highest"
    return cfg


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    arch = request.param
    jmodel = jbuild_model(_cfg(JConfig, arch))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(5)))
    return jmodel, jparams, build_model(_cfg(Config, arch), "cpu"), \
        params_from_jax(jparams)


@pytest.fixture(scope="module")
def dense():
    jmodel = jbuild_model(_cfg(JConfig))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(2)))
    return jmodel, jparams, build_model(_cfg(Config), "cpu"), \
        params_from_jax(jparams)


@pytest.fixture(scope="module")
def onnx_bytes(dense, tmp_path_factory):
    _, _, model, params = dense
    path = export_onnx(model, params,
                       tmp_path_factory.mktemp("onnx") / "ref.onnx")
    return path.read_bytes()


# ------------------------------------------------------------------ ONNX --

@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_export_onnx_writes_the_jax_bytes(dense, tmp_path, flavor):
    jmodel, jparams, model, params = dense
    got = export_onnx(model, params, tmp_path / "port.onnx",
                      **FLAVORS[flavor]).read_bytes()
    want = jonnx.export_onnx(jmodel, jparams, tmp_path / "jax.onnx",
                             **FLAVORS[flavor]).read_bytes()
    assert got == want


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_both_readers_parse_both_files_alike(dense, tmp_path, flavor):
    jmodel, jparams, model, params = dense
    x = np.random.default_rng(1).uniform(-1, 1, SEG).astype(np.float32)
    if "batch" in FLAVORS[flavor]:
        x = np.tile(x, (3, 1))
    for data in (export_onnx(model, params, tmp_path / "p.onnx",
                             **FLAVORS[flavor]).read_bytes(),
                 jonnx.export_onnx(jmodel, jparams, tmp_path / "j.onnx",
                                   **FLAVORS[flavor]).read_bytes()):
        port, ref = OnnxModel(data), jonnx.OnnxModel(data)
        assert (port.ir_version, port.opset, port.inputs, port.outputs) == \
            (ref.ir_version, ref.opset, ref.inputs, ref.outputs)
        assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
                for n in port.nodes] == \
            [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
             for n in ref.nodes]
        assert sorted(port.initializers) == sorted(ref.initializers)
        for k, v in port.initializers.items():
            np.testing.assert_array_equal(v, ref.initializers[k])
        got = port.run({"input": x}, rng=np.random.default_rng(4))
        want = ref.run({"input": x}, rng=np.random.default_rng(4))
        for k in port.outputs:
            np.testing.assert_array_equal(got[k], want[k])


def test_deterministic_graph_matches_the_forward(dense, tmp_path):
    _, _, model, params = dense
    m = OnnxModel.load(export_onnx(model, params, tmp_path / "det.onnx",
                                   batch="batch", deterministic=True))
    assert all(n.op_type != "RandomNormalLike" for n in m.nodes)
    x = np.random.default_rng(0).uniform(-1, 1, (7, SEG)).astype(np.float32)
    out = m.run({"input": x})
    recon, mu, logvar = export.make_forward_fn(model, True)(
        params, torch.from_numpy(x))
    for name, want in (("recon", recon), ("mu", mu), ("logvar", logvar)):
        np.testing.assert_allclose(out[name], want.numpy(), atol=2e-5)


def test_stochastic_graph_replays_its_eps(dense, tmp_path):
    _, _, model, params = dense
    m = OnnxModel.load(export_onnx(model, params, tmp_path / "sto.onnx"))
    x = np.random.default_rng(1).uniform(-1, 1, (SEG,)).astype(np.float32)
    out = m.run({"input": x}, rng=np.random.default_rng(42))
    assert out["recon"].shape == (1, SEG)
    mu, logvar = model.encode(params, torch.from_numpy(x).reshape(1, SEG))
    eps = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (1, LATENT)).astype(np.float32))
    recon = model.decode(params, mu + eps * torch.exp(0.5 * logvar))
    np.testing.assert_allclose(out["mu"], mu.numpy(), atol=2e-5)
    np.testing.assert_allclose(out["recon"], recon.numpy(), atol=2e-5)
    # the seed attribute is honored when the caller injects no rng
    m7 = OnnxModel.load(export_onnx(model, params, tmp_path / "s7.onnx",
                                    seed=7))
    m8 = OnnxModel.load(export_onnx(model, params, tmp_path / "s8.onnx",
                                    seed=8))
    o7 = m7.run({"input": x})["recon"]
    assert not np.array_equal(o7, m8.run({"input": x})["recon"])
    np.testing.assert_array_equal(o7, m7.run({"input": x})["recon"])


def test_onnx_rejects_the_variants(tmp_path):
    for arch in ("deep", "conv1d"):
        model = build_model(_cfg(Config, arch), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="dense"):
            export_onnx(model, params, tmp_path / "x.onnx")


def test_gemm_explicit_zero_alpha_beta():
    def gemm_model(attrs):
        node = onnx_model._Node(b"")
        node.op_type = "Gemm"
        node.inputs, node.outputs = ["x", "w", "c"], ["y"]
        node.attrs = dict(attrs)
        m = OnnxModel.__new__(OnnxModel)
        m.nodes = [node]
        m.initializers = {"w": np.eye(3, dtype=np.float32),
                          "c": np.full((1, 3), 7.0, np.float32)}
        m.inputs, m.outputs = ["x"], ["y"]
        return m

    x = np.arange(3, dtype=np.float32).reshape(1, 3)
    for attrs, want in (({}, x + 7.0), ({"beta": 0.0}, x),
                        ({"alpha": 0.0}, np.full((1, 3), 7.0)),
                        ({"alpha": 0.0, "beta": 0.0}, np.zeros((1, 3)))):
        np.testing.assert_allclose(gemm_model(attrs).run({"x": x})["y"],
                                   want)


# ------------------------------------------- the decoder's fuzz (hypothesis)

def _parses_or_raises(blob):
    """Malformed bytes raise OnnxDecodeError; bytes that parse give a model
    whose run() fails only with the documented errors."""
    try:
        m = OnnxModel(blob)
    except OnnxDecodeError:
        return
    try:
        m.run({"input": np.zeros(SEG, np.float32)})
    except (OnnxDecodeError, KeyError, NotImplementedError, ValueError,
            IndexError):
        pass


FUZZ = settings(max_examples=150, deadline=None,
                suppress_health_check=[HealthCheck.function_scoped_fixture])


@FUZZ
@given(cut=st.integers(min_value=0, max_value=1 << 20))
def test_truncations(onnx_bytes, cut):
    _parses_or_raises(onnx_bytes[:cut % len(onnx_bytes)])


@FUZZ
@given(flips=st.lists(st.tuples(st.integers(min_value=0),
                                st.integers(min_value=0, max_value=7)),
                      min_size=1, max_size=4))
def test_bit_flips(onnx_bytes, flips):
    data = bytearray(onnx_bytes)
    for i, bit in flips:
        data[i % len(data)] ^= 1 << bit
    _parses_or_raises(bytes(data))


@FUZZ
@given(blob=st.one_of(st.binary(max_size=4096),
                      st.sampled_from([b"", b"\x00", b"\xff" * 64,
                                       b"\x80" * 1024])))
def test_garbage_and_empty(blob):
    _parses_or_raises(blob)


def test_decode_error_is_a_value_error():
    assert issubclass(OnnxDecodeError, ValueError)
    with pytest.raises(OnnxDecodeError):
        OnnxModel(b"\x80" * 8)
    with pytest.raises(OnnxDecodeError, match="overruns"):
        OnnxModel(b"\x3a\x7f")        # field 7, 127 bytes of a 2-byte stream


# ------------------------------------------------------------ npz, program

def test_export_npz_gives_the_jax_file(pair, tmp_path):
    jmodel, jparams, model, params = pair
    got = export.export_npz(model, params, tmp_path / "p.npz")
    want = jexport.export_npz(jmodel, jparams, tmp_path / "j.npz")
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        if model.name == "dense":
            assert g["fc1.weight"].shape == (UNITS, SEG)   # torch layout
        else:
            assert "enc.0.w" in g.files


def test_forward_fn_matches_jax(pair):
    jmodel, jparams, model, params = pair
    x = np.random.default_rng(3).uniform(-1, 1, (5, SEG)).astype(np.float32)
    got = export.make_forward_fn(model, True)(params, torch.from_numpy(x))
    want = jexport.make_forward_fn(jmodel, True)(jparams, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # flat audio is reshaped to (-1, segment), as VAE.forward does
    flat = export.make_forward_fn(model, True)(
        params, torch.from_numpy(x.reshape(-1)))
    torch.testing.assert_close(flat[0], got[0], atol=0, rtol=0)


@pytest.mark.parametrize("deterministic", [True, False])
def test_program_round_trip(pair, tmp_path, deterministic):
    _, _, model, params = pair
    path = export.export_program(model, params, tmp_path / "vae.pt2",
                                 batch=3, deterministic=deterministic)
    fn = export.load_program(path)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (3, SEG)).astype(np.float32))
    fwd = export.make_forward_fn(model, deterministic)
    torch.manual_seed(9)
    got = fn(x)
    torch.manual_seed(9)
    want = fwd(params, x) if deterministic else fwd(params, None, x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    # mu and logvar do not depend on the noise; recon does
    if not deterministic:
        again = fn(x)
        torch.testing.assert_close(again[1], got[1], atol=0, rtol=0)
        assert not torch.equal(again[0], got[0])


def _same_fn(f, g):
    if f is g:
        return True
    return (getattr(f, "func", None) is getattr(g, "func", 0)
            and f.args == g.args and f.keywords == g.keywords)


@pytest.mark.parametrize("backend", ["pallas", "xla", "best"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_exported_ops_are_the_xla_backend_ops(arch, backend):
    """What ``export_program`` traces (``ModelDef.plain_encode`` /
    ``plain_decode``) is, for every family and backend, the encode / decode
    the registry builds for ``backend = xla``."""
    model = build_model(_cfg(Config, arch, backend), "cpu")
    xla = build_model(_cfg(Config, arch, "xla"), "cpu")
    assert _same_fn(model.plain_encode, xla.encode)
    assert _same_fn(model.plain_decode, xla.decode)


# --------------------------------------------------------------- command --

def _cli(monkeypatch, *argv):
    from rawaudiovae_kelsey_tpu_torch import __main__ as cli

    monkeypatch.setattr("sys.argv", ["rawaudiovae_kelsey_tpu_torch", *argv])
    cli.main()


def _run_dir(tmp_path, arch, params):
    run = tmp_path / f"run-{arch}"
    save_config(_cfg(Config, arch), run / "config.ini")
    save_params(run / "model" / "best_model.npz", params)
    return run


def test_export_command_on_the_cpu(dense, tmp_path, monkeypatch, capsys):
    jmodel, jparams, model, params = dense
    run = _run_dir(tmp_path, "dense", params)
    out = tmp_path / "out"
    _cli(monkeypatch, "export", "--run", str(run), "--out", str(out),
         "--batch", "2", "--device", "cpu")
    said = capsys.readouterr().out
    names = ("rawaudiovae.onnx", "rawaudiovae_det.onnx", "rawaudiovae.pt2",
             "rawaudiovae_det.pt2", "rawaudiovae_weights.npz")
    for name in names:
        assert f"exported {out / name}" in said
    assert (out / "rawaudiovae.onnx").read_bytes() == jonnx.export_onnx(
        jmodel, jparams, tmp_path / "j.onnx").read_bytes()
    fn = export.load_program(out / "rawaudiovae_det.pt2")
    x = torch.zeros((2, SEG))
    torch.testing.assert_close(
        fn(x)[0], export.make_forward_fn(model, True)(params, x)[0])
    # --onnx alone
    _cli(monkeypatch, "export", "--run", str(run), "--out",
         str(tmp_path / "onnx"), "--onnx", "--device", "cpu")
    assert sorted(p.name for p in (tmp_path / "onnx").iterdir()) == \
        ["rawaudiovae.onnx", "rawaudiovae_det.onnx"]


def test_export_command_of_a_variant(tmp_path, monkeypatch, capsys):
    model = build_model(_cfg(Config, "conv1d"), "cpu")
    run = _run_dir(tmp_path, "conv1d",
                   model.init(torch.Generator().manual_seed(0)))
    with pytest.raises(SystemExit, match="dense reference family"):
        _cli(monkeypatch, "export", "--run", str(run), "--out",
             str(tmp_path / "o"), "--onnx", "--device", "cpu")
    _cli(monkeypatch, "export", "--run", str(run), "--out",
         str(tmp_path / "all"), "--device", "cpu")
    assert sorted(p.name for p in (tmp_path / "all").iterdir()) == \
        ["rawaudiovae.pt2", "rawaudiovae_det.pt2", "rawaudiovae_weights.npz"]
    assert capsys.readouterr().out.count("exported") == 3


def test_export_command_refuses_without_a_gpu(dense, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _run_dir(tmp_path, "dense", dense[3])
    with pytest.raises(SystemExit, match="export: --device cuda but no CUDA "
                                         "device"):
        _cli(monkeypatch, "export", "--run", str(run), "--out",
             str(tmp_path / "o"))
    assert not (tmp_path / "o").exists()

"""The Oobleck VAE of the port (``models/variants.py``, ``arch = oobleck``):
its numbers against the benchmark's plain reference
(``bench_port/reference/oobleck_vae.py``, written from the equations) at a
tiny size on the CPU, its published widths on the ``meta`` device,
SnakeBeta's plain versions (``ops/snake.py``) against autograd of the
formula, stereo ingest, and the configuration files.  A port-only family:
the JAX package has no counterpart to hold it against."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import cell as C
from bench_port import faults
from bench_port.reference import oobleck_vae as ref
from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.models import variants
from rawaudiovae_kelsey_tpu_torch.models.registry import build_model
from rawaudiovae_kelsey_tpu_torch.ops import snake
from rawaudiovae_kelsey_tpu_torch.parallel.step import make_loss_fn
from rawaudiovae_kelsey_tpu_torch.tree import flatten, leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
PUBLISHED = {"conv_channels": "128,128,256,512,1024,2048", "conv_kernel": 7,
             "conv_strides": "2,4,4,8,8", "io_channels": 2}
SEED = 2**31 + 29

# channels 4 · [1, 1, 2], strides [2, 4]: T = 64 stereo frames, latent 4
TINY = {"segment_length": 128, "hop_length": 128, "latent_dim": 4,
        "kl_beta": 1e-4, "batch_size": 3, "learning_rate": 1e-4, "b1": 0.9,
        "b2": 0.999, "eps": 1e-8,
        "program": {"vae": {"conv_channels": "4,4,8", "conv_strides": "2,4",
                            "conv_kernel": 7, "io_channels": 2}}}


def _cfg(conf=TINY, precision="float32", backend="pallas"):
    cfg = Config()
    cfg.vae.arch = "oobleck"
    for key, value in conf["program"]["vae"].items():
        setattr(cfg.vae, key, value)
    cfg.vae.latent_dim = conf["latent_dim"]
    cfg.vae.kl_beta = conf["kl_beta"]
    cfg.audio.segment_length = conf["segment_length"]
    cfg.audio.hop_length = conf["hop_length"]
    cfg.tpu.backend, cfg.tpu.precision = backend, precision
    cfg.validate()
    return cfg


def _by_path(tree):
    return dict(flatten(tree))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_family_matches_the_reference_loss_and_every_gradient(backend):
    """fp32 on both sides, the same ops in another order (the closed-form
    SnakeBeta backward and ``torch._weight_norm`` against autograd of the
    formulas): mu, logvar and the reconstruction within 1e-5 of their
    largest entry, the loss within 1e-6, each leaf's gradient within 2e-5
    of its largest entry (measured 3e-6)."""
    model = build_model(_cfg(backend=backend), "cpu")
    assert model.latent_dim == 4 * 64 // 8
    params = ref.init_params(TINY, SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    x = 0.5 * torch.randn(3, 128, generator=g)
    eps = torch.randn(3, model.latent_dim, generator=g)

    with torch.no_grad():
        mu, logvar = model.encode(params, x)
        recon = model.decode(params, mu + eps * torch.exp(0.5 * logvar))
        want = ref.forward(params, x, eps, TINY)
    for got, w in zip((recon, mu, logvar), want):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= 1e-5 * float(w.abs().max())

    mine = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, _ = make_loss_fn(model, _cfg(backend=backend))(mine, eps, x)
    grads = dict(zip(_by_path(mine), torch.autograd.grad(loss,
                                                         leaves(mine))))
    theirs = tree_map(lambda t: t.clone().requires_grad_(), params)
    want = ref.loss(theirs, x, eps, TINY)
    by_path = ref.leaves(theirs, TINY)
    want_grads = torch.autograd.grad(want, list(by_path.values()))
    assert abs(float(loss.detach()) / float(want.detach()) - 1.0) <= 1e-6
    assert len(grads) == len(want_grads) == 155
    for path, w in zip(by_path, want_grads):
        got = grads[".".join(map(str, path))]
        assert float((got - w).abs().max()) <= 2e-5 * float(w.abs().max()), \
            path


def test_forward_shapes_and_interleaving(monkeypatch):
    """Encode reads interleaved frames as channels, decode writes them
    back interleaved: a reconstruction of frames whose right channel is
    silent differs from one of the swapped frames."""
    cfg = _cfg()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 128, generator=torch.Generator().manual_seed(2))
    mu, logvar = model.encode(params, x)
    assert mu.shape == logvar.shape == (2, 32)
    assert mu.dtype == logvar.dtype == torch.float32
    # the shapes, dtypes and layouts row 14's loss kernels take
    from rawaudiovae_kelsey_tpu_torch.ops import loss
    monkeypatch.setattr(loss, "on_card", lambda t: True)
    assert loss.takes_fused_loss(model.decode(params, mu), x, mu, logvar)
    assert model.decode(params, mu).shape == (2, 128)
    left = x.clone().view(2, 64, 2)
    left[..., 1] = 0
    right = left.flip(-1)
    a, _ = model.encode(params, left.reshape(2, 128))
    b, _ = model.encode(params, right.reshape(2, 128))
    assert not torch.allclose(a, b)
    # logvar = 2 log(softplus(scale) + 1e-4) is bounded below
    assert float(logvar.min()) >= 2 * np.log(1e-4)


def test_three_adam_steps_through_the_resident_engine_match_the_reference():
    """The benchmark's own comparison at a tiny size on the CPU (IEEE fp32,
    the plain versions): the engine the cell runs (``build_model``,
    ``resident_model``, ``build_resident_epoch``) against the reference
    over set-up's epoch and the window's first steps.  Losses within 1e-6,
    the first gradient's leaf norms within 1e-5, the change after three
    Adam steps within 1e-4 (Adam divides by the root of each entry's square,
    so a relative gap of a tiny gradient entry reaches its update whole;
    measured 3.1e-6); a fault reads far outside them."""
    cell = _tiny_cell()
    result = C.run(cell, SEED, 0.01, False, torch.device("cpu"),
                   time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["window"]["steps"] == 5
    with faults.planted("unchanged"):
        broken = C.run(cell, SEED, 0.01, False, torch.device("cpu"),
                       time.perf_counter())
    assert not broken["correct"]
    assert broken["checks"]["grad_gap"]["value"] == 1.0


def _tiny_cell():
    config = dict(TINY, name="tiny", reference="oobleck_vae", arch="oobleck",
                  sampling_rate=44100, segment_length=256, hop_length=256,
                  hidden_dims=[], batch_size=6, loss_reduction="mean")
    config["program"] = dict(TINY["program"], tpu={
        "backend": "pallas", "microbatch_size": 0, "resident_budget_gb": 4.0,
        "rng": "threefry", "resident_shuffle": "global"})
    return C.Cell(name="tiny", chips=1, config=config,
                  traffic={"corpus": {"samples": 256 * 30, "files": 4},
                           "program": {"tpu": {"precision": "highest"}}},
                  spec={"control": {"rounding": "fp8"},
                        "limits": {"loss_gap": 1e-6, "window_loss_gap": 1e-6,
                                   "grad_gap": 1e-5, "change_gap": 1e-4,
                                   "change_median": 1e-5}})


def test_published_widths_on_the_meta_device():
    """156,112,514 parameters in 365 leaves (the paper's 156M), a latent of
    64 channels × 32 steps for 65,536 stereo frames, and each stage's
    shape."""
    conf = dict(TINY, segment_length=131072, hop_length=131072,
                latent_dim=64, program={"vae": PUBLISHED})
    model = build_model(_cfg(conf, backend="xla"), "meta")
    params = model.init(None)
    assert len(leaves(params)) == 365
    assert sum(t.numel() for t in leaves(params)) == 156_112_514
    assert model.latent_dim == 64 * 32
    spec = variants.OobleckSpec((128, 128, 256, 512, 1024, 2048),
                                (2, 4, 4, 8, 8), 7, 2, 64)
    enc = params["encoder"]
    h = torch.empty(1, 2, 65536, device="meta")
    h = variants._conv(enc["conv_in"], h, padding=3)
    shapes = [tuple(h.shape[1:])]
    for block, s in zip(enc["blocks"], spec.strides):
        for unit, d in zip(block["res"], variants.OOBLECK_DILATIONS):
            h = variants._res_apply(unit, h, d, variants.snake_plain)
        h = variants._conv(block["down"], h, stride=s, padding=-(-s // 2))
        shapes.append(tuple(h.shape[1:]))
    assert shapes == [(128, 65536), (128, 32768), (256, 8192), (512, 2048),
                      (1024, 256), (2048, 32)]
    mu, logvar = model.encode(params, torch.empty(2, 131072, device="meta"))
    assert mu.shape == logvar.shape == (2, 2048)
    assert model.decode(params, mu).shape == (2, 131072)
    dec = params["decoder"]
    assert [tuple(b["up"]["g"].shape) for b in dec["blocks"]] == \
        [(2048, 1, 1), (1024, 1, 1), (512, 1, 1), (256, 1, 1), (128, 1, 1)]
    assert "b" not in dec["conv_out"]


def test_snake_plain_versions_against_autograd_of_the_formula():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 11, generator=g, dtype=torch.float64)
    alpha = 0.3 * torch.randn(5, generator=g, dtype=torch.float64)
    beta = 0.3 * torch.randn(5, generator=g, dtype=torch.float64)
    dy = torch.randn(2, 5, 11, generator=g, dtype=torch.float64)
    args = [t.clone().requires_grad_() for t in (x, alpha, beta)]
    want = variants.snake_plain(*args)
    assert torch.allclose(snake.snake_ref(x, alpha, beta), want.detach(),
                          rtol=1e-14, atol=1e-14)
    want_grads = torch.autograd.grad(want, args, dy)
    for got, w in zip(snake.snake_bwd_ref(x, alpha, beta, dy), want_grads):
        assert torch.allclose(got, w, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(snake.snake, args)
    # the wrappers run the plain versions on CPU tensors, launching nothing
    launched = snake.snake_fwd.launches, snake.snake_bwd.launches
    y = snake.snake(*[t.float() for t in args])
    assert y.dtype == torch.float32
    assert (snake.snake_fwd.launches, snake.snake_bwd.launches) == launched


def test_stereo_ingest_keeps_the_channels_interleaved(tmp_path):
    audio = tmp_path / "audio"
    audio.mkdir()
    stereo = np.stack([np.linspace(-0.5, 0.5, 300),
                       np.linspace(0.25, -0.25, 300)], axis=1)
    write_wav(audio / "a.wav", stereo.astype(np.float32), 44100)
    write_wav(audio / "b.wav", np.full(10, 0.125, np.float32), 44100)
    corpus, n = build_corpus(audio, 44100, channels=2)
    assert n == 620
    np.testing.assert_allclose(corpus[:600], stereo.reshape(-1), atol=1e-7)
    # a mono file goes to both channels
    np.testing.assert_array_equal(corpus[600:], np.full(20, 0.125))
    mono, m = build_corpus(audio, 44100)
    assert m == 310


def test_benchmark_config_is_the_published_autoencoder():
    conf = json.loads((REPO / "bench_port" / "configs"
                       / "stable_audio_vae.json").read_text())
    assert conf["program"]["vae"] == PUBLISHED
    assert (conf["arch"], conf["reference"], conf["latent_dim"]) == \
        ("oobleck", "oobleck_vae", 64)
    assert conf["segment_length"] == conf["hop_length"] == 2 * 65536
    assert conf["reduced"] == []
    cfg = C.port_config(C.load_cell("oobleck-bf16-b48x65536"), SEED)
    assert build_model(cfg, "cpu").latent_dim == 2048
    assert (cfg.vae.conv_strides, cfg.vae.io_channels) == ("2,4,4,8,8", 2)


def test_port_ini_loads_and_round_trips(tmp_path):
    ini = REPO / "configs" / "port" / "stable_audio_vae.ini"
    cfg = load_config(ini)
    assert cfg.vae.arch == "oobleck"
    for key, value in PUBLISHED.items():
        assert getattr(cfg.vae, key) == value
    assert build_model(cfg, "cpu").latent_dim == 2048
    save_config(cfg, tmp_path / "config.ini")
    text = (tmp_path / "config.ini").read_text()
    # a port-only key is written where it differs from its default only
    assert "io_channels = 2" in text and "conv_strides" not in text
    again = load_config(tmp_path / "config.ini")
    assert again.vae == cfg.vae

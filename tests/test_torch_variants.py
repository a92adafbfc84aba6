"""The port's model variants (rawaudiovae_kelsey_tpu_torch/models/variants.py
and their routing in models/registry.py) against the JAX package's: the
deep/wide MLP VAE and the conv1d VAE, function by function on carried-over
weights, one coupled train step with the JAX step's noise injected, and a
short training run end to end whose checkpoint resumes in the other
package.

Tolerances:
* forward, fp32: atol 1e-5 (both sides form the same fp32 products; only
  the order of the sums differs).
* one ``highest`` train step: loss rel 1e-5, params atol 1e-5 after Adam
  (tests/test_torch_train_step.py's bound for the dense model).
* the end-to-end loss history over ~9 coupled steps: rel 1e-4
  (tests/test_torch_train_e2e.py's bound).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.models import variants as jvariants
from rawaudiovae_kelsey_tpu.parallel import build_train_step as jbuild_step
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch import tree
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import (
    Conv1dVAE,
    DeepVAE,
    build_model,
    variants,
)
from rawaudiovae_kelsey_tpu_torch.ops import linear
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.train import TrainState

from test_torch_train_e2e import (  # noqa: F401  (fixtures and helpers)
    batch_losses,
    jax_eps,
    jax_train,
    port_train,
    scratch_dataset,
    small_cfg,
)

SEG, LATENT, SEED, LR = 256, 16, 0, 1e-3
FAMILIES = {
    "deep": dict(hidden_dims="128,64"),
    "conv1d": dict(conv_channels="8,16", conv_kernel=5, conv_stride=4),
}


def _cfg(cls, arch, backend="xla", precision="highest", seg=SEG, **kw):
    cfg = cls()
    cfg.audio.segment_length = seg
    cfg.audio.hop_length = 64
    cfg.vae.latent_dim = LATENT
    cfg.vae.arch = arch
    for k, v in {**FAMILIES[arch], **kw}.items():
        setattr(cfg.vae, k, v)
    cfg.training.learning_rate = LR
    cfg.tpu.backend = backend
    cfg.tpu.precision = precision
    return cfg


def _x(rows, seed=0, seg=SEG):
    return np.random.default_rng(seed).uniform(
        -1, 1, (rows, seg)).astype(np.float32)


def _close(t, a, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=atol,
                               rtol=0)


# ------------------------------------------------------------- the functions

def test_deep_functions_match_jax():
    jp = jvariants.init_deep(jax.random.PRNGKey(1), SEG, (128, 64), LATENT)
    tp = params_from_jax(jax.device_get(jp))
    x = _x(12)
    jmu, jlv = jvariants.encode_deep(jp, jnp.asarray(x))
    mu, lv = variants.encode_deep(tp, torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)
    _close(variants.decode_deep(tp, mu), jvariants.decode_deep(jp, jmu))


def test_conv1d_functions_match_jax():
    jp = jvariants.init_conv1d(jax.random.PRNGKey(2), SEG, (8, 16), 9, 4,
                               LATENT)
    tp = params_from_jax(jax.device_get(jp))
    width = variants.conv_latent_width(SEG, 2, 4)
    assert width == jvariants.conv_latent_width(SEG, 2, 4) == 16
    x = _x(6, 1)
    jmu, jlv = jvariants.encode_conv1d(jp, jnp.asarray(x), 4)
    mu, lv = variants.encode_conv1d(tp, torch.from_numpy(x), 4)
    _close(mu, jmu)
    _close(lv, jlv)
    _close(variants.decode_conv1d(tp, mu, 4, width, 16),
           jvariants.decode_conv1d(jp, jmu, 4, width, 16))


@pytest.mark.parametrize("K,S", [(9, 4), (5, 2), (3, 4), (7, 4), (1, 2),
                                 (1, 4), (2, 4), (4, 4), (5, 4)])
@pytest.mark.parametrize("L", [12, 13])
def test_same_padding_is_jax_same_padding(K, S, L):
    """Forward and transpose convolution, kernels wider and narrower than
    the stride, lengths the stride does and does not divide."""
    rng = np.random.default_rng(K * 100 + S * 10 + L)
    x = rng.standard_normal((2, L, 3)).astype(np.float32)
    w = (rng.standard_normal((K, 3, 5)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(5) * 0.1).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    y = variants.conv_same(tp, torch.from_numpy(x), S)
    assert y.shape == (2, -(-L // S), 5)
    _close(y, jvariants._conv(jp, jnp.asarray(x), S))
    yt = variants.conv_transpose_same(tp, torch.from_numpy(x), S)
    assert yt.shape == (2, L * S, 5)
    _close(yt, jvariants._conv_transpose(jp, jnp.asarray(x), S))


def test_bf16_convolutions_give_bf16():
    tp = variants.init_conv1d(torch.Generator().manual_seed(0), 64, (4, 8),
                              5, 4, 8)
    tp = tree.tree_map(lambda t: t.to(torch.bfloat16), tp)
    mu, lv = variants.encode_conv1d(tp, torch.zeros(3, 64).bfloat16(), 4)
    y = variants.decode_conv1d(tp, mu, 4, 4, 8)
    assert {mu.dtype, lv.dtype, y.dtype} == {torch.bfloat16}


# ------------------------------------------------------------- the registry

@pytest.mark.parametrize("arch", ["deep", "conv1d"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "best"])
def test_registry_routes_the_variants_as_jax_does(arch, backend):
    """deep + pallas → the fused linear kernels; conv1d → the plain
    convolutions under every backend; best → the plain ops for both."""
    model = build_model(_cfg(Config, arch, backend), "cpu")
    assert (model.name, model.segment_length, model.latent_dim) == \
        (arch, SEG, LATENT)
    assert model.backend == ("xla" if backend == "best" else backend)
    enc = getattr(model.encode, "func", model.encode)
    dec = getattr(model.decode, "func", model.decode)
    if arch == "deep" and backend == "pallas":
        assert (enc, dec) == (linear.deep_encode_pallas,
                              linear.deep_decode_pallas)
    elif arch == "deep":
        assert (enc, dec) == (variants.encode_deep, variants.decode_deep)
    else:
        assert (enc, dec) == (variants.encode_conv1d, variants.decode_conv1d)
        assert model.decode.keywords == dict(stride=4, width=16, channels=16)
    # the same routing decision as the JAX registry
    jmodel = jbuild_model(_cfg(JConfig, arch, backend))
    jenc = getattr(jmodel.encode, "func", jmodel.encode)
    assert jenc.__name__ == enc.__name__
    # and a best → xla even for a CUDA device
    from rawaudiovae_kelsey_tpu_torch.models.registry import resolve_backend
    assert resolve_backend(_cfg(Config, arch, "best"),
                           torch.device("cuda")) == "xla"


@pytest.mark.parametrize("arch,leaf,shape", [
    ("deep", lambda p: p["enc"][3]["w"], (1024, 512)),
    ("conv1d", lambda p: p["dec"][0]["w"], (9, 256, 128))])
def test_registry_defaults_are_the_shipped_widths(arch, leaf, shape):
    """An empty ``hidden_dims`` means 4096,2048,1024,512; the default
    ``conv_channels`` are 32,64,128,256 (kernel 9, stride 4)."""
    cfg = Config()
    cfg.vae.arch = arch
    cfg.audio.segment_length = 1024
    cfg.vae.latent_dim = 8
    model = build_model(cfg, "cpu")
    assert tuple(leaf(model.init(torch.Generator().manual_seed(0))).shape) \
        == shape


def test_conv1d_bad_segment_raises():
    cfg = _cfg(Config, "conv1d", seg=200)         # 200 % 4**2 != 0
    with pytest.raises(ValueError, match="not divisible"):
        build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        jbuild_model(_cfg(JConfig, "conv1d", seg=200)).init(
            jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["deep", "conv1d"])
def test_forward_shapes_and_bounds(arch):
    model = build_model(_cfg(Config, arch, seg=1024), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(8, seg=1024))
    mu, logvar = model.encode(params, x)
    recon = model.decode(params, mu + torch.randn_like(mu)
                         * torch.exp(0.5 * logvar))
    assert recon.shape == (8, 1024)
    assert mu.shape == (8, LATENT) and logvar.shape == (8, LATENT)
    assert float(recon.abs().max()) <= 1.0
    # the same init for the same generator seed, another for another
    again = model.init(torch.Generator().manual_seed(0))
    other = model.init(torch.Generator().manual_seed(1))
    for a, b, c in zip(*(tree.leaves(p) for p in (params, again, other))):
        assert torch.equal(a, b) and not torch.equal(a, c)
    # the JAX init's tree, leaf for leaf in shape
    jp = jbuild_model(_cfg(JConfig, arch, seg=1024)).init(
        jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree.leaves(params)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]


@pytest.mark.parametrize("cls,args", [
    (DeepVAE, (64, (48, 32), 8)), (Conv1dVAE, (64, (4, 8), 5, 4, 8))])
def test_module_face_shares_storage_with_its_tree(cls, args):
    module = cls(*args, generator=torch.Generator().manual_seed(0))
    params = module.params()
    n = sum(p.numel() for p in module.parameters())
    assert n == sum(t.numel() for t in tree.leaves(params))
    recon, mu, logvar = module(torch.zeros(2, 64), deterministic=True)
    assert recon.shape == (2, 64) and mu.shape == (2, 8)
    with torch.no_grad():
        params["enc"][0]["b"].add_(1.0)
    assert torch.equal(module.enc[0].b, params["enc"][0]["b"])
    init = variants.init_deep if cls is DeepVAE else variants.init_conv1d
    fresh = init(torch.Generator().manual_seed(0), *args)
    assert not any(t.requires_grad for t in tree.leaves(fresh))


# ----------------------------------------------------------------- the step

def _pair(arch, backend, precision):
    jcfg = _cfg(JConfig, arch, backend, precision)
    jmodel = jbuild_model(jcfg)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(p, opt.init(p), seed=SEED)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)
    cfg = _cfg(Config, arch, backend, precision)
    model = build_model(cfg, "cpu")
    state = TrainState.create(params_from_jax(jax.device_get(p)), SEED)
    return jstep, jstate, build_train_step(model, cfg, noise=jax_eps), state


@pytest.mark.parametrize("arch", ["deep", "conv1d"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_coupled_steps_match_jax(arch, backend):
    """Two ``highest`` steps, the second from the state the first left."""
    jstep, jstate, step, state = _pair(arch, backend, "highest")
    for k in range(2):
        x = _x(32, 10 + k)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        for t, a in zip(tree.leaves(state.params),
                        jax.tree_util.tree_leaves(jstate.params)):
            _close(t, a)
    assert state.step == int(jstate.step) == 2


@pytest.mark.parametrize("arch", ["deep", "conv1d"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_variant_bf16_trains(arch, backend):
    """Five bf16 steps: a finite loss near the JAX step's, fp32 masters."""
    jstep, jstate, step, state = _pair(arch, backend, "bfloat16")
    x = _x(32)
    for _ in range(5):
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert {t.dtype for t in tree.leaves(state.params)} == {torch.float32}
    assert {t.dtype for t in tree.leaves(state.mu)} == {torch.float32}


# ------------------------------------------------------------ end to end

def _deep_cfg(cfg, tmp_path, **kw):
    cfg = small_cfg(cfg, tmp_path, **kw)
    cfg.vae.arch = "deep"
    cfg.vae.hidden_dims = "96,48"
    cfg.extra.description = "deep_e2e"
    return cfg


@pytest.fixture
def deep_parity(monkeypatch):
    """The port's trainer starts from the JAX trainer's initial weights and
    takes the JAX step's noise (tests/test_torch_train_e2e.py
    ``jax_parity``, for the deep model)."""
    from rawaudiovae_kelsey_tpu_torch.models import registry
    from rawaudiovae_kelsey_tpu_torch.parallel import step
    from rawaudiovae_kelsey_tpu_torch.train import loop

    def build(cfg, device):
        model = registry.build_model(cfg, device)
        params = jax.device_get(jbuild_model(
            _deep_cfg(JConfig(), ".")).init(jax.random.PRNGKey(cfg.tpu.seed)))
        return dataclasses.replace(
            model, init=lambda _g: params_from_jax(params, device))

    monkeypatch.setattr(loop, "build_model", build)
    monkeypatch.setattr(loop, "build_train_step", functools.partial(
        step.build_train_step, noise=jax_eps))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_deep_run_resumes_across_packages(scratch_dataset, deep_parity,
                                          first):
    """Two epochs of the deep model in one package, ``resume`` in the other
    for a third: the resumed epoch logs the losses of a straight
    three-epoch JAX run.  The port's run also leaves the workspace
    contract: checkpoints, best/last models, histograms under dotted tree
    names."""
    straight = jax_train(_deep_cfg(JConfig(), scratch_dataset, epochs=3,
                                   interval=0))
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 6}
    runs = {"jax": (JConfig, jax_train), "port": (Config, port_train)}
    cls, run = runs[first]
    run(_deep_cfg(cls(), scratch_dataset, epochs=2, interval=2))
    cls, run = runs["port" if first == "jax" else "jax"]
    cfg = _deep_cfg(cls(), scratch_dataset, epochs=3, interval=1)
    cfg.training.resume = True
    resumed = run(cfg)
    assert resumed.start_step == 6
    got = batch_losses(resumed.workspace.log_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    ws = resumed.workspace
    assert (ws.model_dir / "last_model.npz").exists()
    assert "ckpt_00003.npz" in [
        p.name for p in ws.checkpoint_dir.glob("ckpt_*.npz")]
    with np.load(ws.checkpoint_dir / "ckpt_00003.npz") as npz:
        assert len(npz.files) == 3 * 14 + 3


def test_histograms_use_dotted_tree_names(scratch_dataset):
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    ctx = port_train(_deep_cfg(Config(), scratch_dataset, epochs=1,
                               interval=1))
    tags = set()
    for f in sorted(ctx.workspace.log_dir.glob("events.out.tfevents.*")):
        for e in loader.LegacyEventFileLoader(str(f)).Load():
            tags.update(v.tag for v in e.summary.value)
    want = {n for n, _ in tree.flatten(ctx.state.params)}
    assert "enc.0.w" in want and "mu_head.b" in want
    assert want <= tags
    assert not any(t.endswith(".weight") for t in tags)


@pytest.mark.parametrize("arch", ["deep", "conv1d"])
def test_server_serves_a_variant_and_ignores_quantize(arch):
    """``quantize`` is the dense model's int8 decoder; for another family
    the server decodes in full precision, as the JAX server does."""
    from rawaudiovae_kelsey_tpu_torch.infer.server import InferenceServer

    model = build_model(_cfg(Config, arch), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    plain = InferenceServer(model, params, deterministic=True)
    quant = InferenceServer(model, params, deterministic=True, quantize=True)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, LATENT)).astype(np.float32))
    assert torch.equal(plain._decode(z), quant._decode(z))
    assert torch.equal(plain._decode(z), model.decode(params, z))
    x = torch.from_numpy(_x(4))
    assert plain._reconstruct(0, x).shape == (4, SEG)

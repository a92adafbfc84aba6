"""The port's dense model, registry, weight transfer and checkpoints against
the JAX package (rawaudiovae_kelsey_tpu).

Weights go across with ``params_from_jax``; inputs are made from a numpy
seed.  fp32 tolerance ``atol=1e-6, rtol=1e-5``: the tests/test_model_parity
bound (the same products, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.train.checkpoint import (
    load_params as jload_params,
    save_params as jsave_params,
)
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax, params_to_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import (
    DenseVAE,
    build_model,
    init_dense,
    reparameterize,
)
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.train.checkpoint import (
    flatten,
    load_params,
    save_params,
)

SEG, UNITS, LATENT = 256, 512, 64
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(3), SEG, UNITS, LATENT))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams)


def _x(batch=50, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, SEG)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=RTOL)


def test_dense_vae_module_matches_jax(jparams, tparams):
    model = DenseVAE.from_params(tparams)
    x = _x()
    jmu, jlv = jvae.encode(jparams, jnp.asarray(x))
    mu, lv = model.encode(torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)
    _close(model.decode(mu), jvae.decode(jparams, jmu))
    jrec, _, _ = jvae.forward(jparams, None, jnp.asarray(x), SEG,
                              deterministic=True)
    rec, _, _ = model(torch.from_numpy(x), deterministic=True)
    _close(rec, jrec)


def test_functional_encode_decode_match_jax(jparams, tparams):
    x = _x(seed=1)
    jmu, jlv = jvae.encode(jparams, jnp.asarray(x))
    mu, lv = vae.encode(tparams, torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)
    _close(vae.decode(tparams, mu), jvae.decode(jparams, jmu))


def test_module_params_share_storage_with_the_module(tparams):
    model = DenseVAE.from_params(tparams)
    p = model.params()
    assert list(p) == ["fc1", "fc21", "fc22", "fc3", "fc4"]
    assert p["fc1"]["w"].data_ptr() == model.fc1.w.data_ptr()
    assert p["fc1"]["w"].shape == (SEG, UNITS)      # (in, out)
    assert sorted(k for k, _ in model.named_parameters()) == \
        [name for name, _ in flatten(tparams)]


def test_reparameterize_with_injected_eps_matches_jax_formula():
    rng = np.random.default_rng(4)
    mu, lv, eps = (rng.standard_normal((9, LATENT)).astype(np.float32)
                   for _ in range(3))
    want = jnp.asarray(mu) + jnp.asarray(eps) * jnp.exp(0.5 * jnp.asarray(lv))
    got = reparameterize(torch.from_numpy(mu), torch.from_numpy(lv),
                         eps=torch.from_numpy(eps))
    _close(got, want)
    np.testing.assert_array_equal(
        reparameterize(torch.from_numpy(mu), torch.from_numpy(lv),
                       deterministic=True).numpy(), mu)


def test_reparameterize_generator_is_reproducible():
    mu, lv = torch.zeros(2000, 4), torch.zeros(2000, 4)
    a = reparameterize(mu, lv, torch.Generator().manual_seed(5))
    b = reparameterize(mu, lv, torch.Generator().manual_seed(5))
    c = reparameterize(mu, lv, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05


def test_init_follows_nn_linear_and_the_generator():
    p = init_dense(torch.Generator().manual_seed(0), SEG, UNITS, LATENT)
    q = init_dense(torch.Generator().manual_seed(0), SEG, UNITS, LATENT)
    for (name, t), (_, u) in zip(flatten(p), flatten(q)):
        assert torch.equal(t, u) and t.dtype == torch.float32
    for layer, fan_in in (("fc1", SEG), ("fc21", UNITS), ("fc3", LATENT)):
        bound = 1 / np.sqrt(fan_in)
        for t in p[layer].values():
            assert float(t.abs().max()) <= bound
            assert float(t.abs().max()) > 0.9 * bound   # uniform, not normal
    # the same shapes as the JAX package's init
    j = jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT)
    assert [tuple(t.shape) for _, t in flatten(p)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(j)]


def test_params_round_trip_exactly(jparams):
    back = params_to_jax(params_from_jax(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flatten_order_is_jax_tree_order(tparams, jparams):
    names = [name for name, _ in flatten(tparams)]
    assert names == ["fc1.b", "fc1.w", "fc21.b", "fc21.w", "fc22.b",
                     "fc22.w", "fc3.b", "fc3.w", "fc4.b", "fc4.w"]
    for (_, t), a in zip(flatten(tparams), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(t.numpy(), a)


def test_jax_checkpoint_loads_in_the_port(tmp_path, jparams):
    path = jsave_params(tmp_path / "best_model.npz", jparams)
    template = init_dense(None, SEG, UNITS, LATENT)
    loaded = load_params(path, template)
    for (_, t), a in zip(flatten(loaded), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(t.numpy(), a)


def test_port_checkpoint_loads_in_jax(tmp_path, tparams):
    path = save_params(tmp_path / "model" / "best_model.npz", tparams)
    assert not list(path.parent.glob("*.tmp*"))
    template = jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT)
    loaded = jload_params(path, template)
    for (_, t), a in zip(flatten(tparams), jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_load_params_rejects_the_wrong_architecture(tmp_path, tparams):
    path = save_params(tmp_path / "m.npz", tparams)
    with pytest.raises(ValueError, match="shape"):
        load_params(path, init_dense(None, SEG, UNITS * 2, LATENT))
    with pytest.raises(ValueError, match="leaves"):
        load_params(path, {"fc1": init_dense(None, SEG, UNITS, LATENT)["fc1"]})


def _cfg(backend, arch="dense"):
    cfg = Config()
    cfg.audio.segment_length = SEG
    cfg.vae.n_units, cfg.vae.latent_dim = UNITS, LATENT
    cfg.vae.arch = arch
    cfg.tpu.backend = backend
    return cfg


@pytest.mark.parametrize("backend,resolved,encode", [
    ("pallas", "pallas", mlp.encode),
    ("xla", "xla", vae.encode),
    ("best", "xla", vae.encode),     # no CUDA device given → plain ops
])
def test_registry_backends_on_cpu(backend, resolved, encode):
    model = build_model(_cfg(backend), "cpu")
    # under `pallas` the registry binds the backward mode (the switch's,
    # ops/mlp.py fusion) to the kernels' entry points (functools.partial)
    assert (model.name, model.backend,
            getattr(model.encode, "func", model.encode)) == \
        ("dense", resolved, encode)
    assert (getattr(model.encode, "keywords", None) ==
            ({"mode": "primitive"} if resolved == "pallas"
             else None))
    assert (model.segment_length, model.latent_dim) == (SEG, LATENT)
    p = model.init(torch.Generator().manual_seed(1))
    assert p["fc4"]["w"].shape == (UNITS, SEG)


@pytest.mark.parametrize("precision",
                         ["bfloat16", "float32", "high", "highest"])
def test_registry_best_resolves_to_xla_on_a_cuda_device(precision):
    """``best`` is the measured winner per family and tier, as in the JAX
    registry: on a CUDA device the plain ops won every dense cell measured
    (and the unmeasured ones, dense ``float32`` among them, take them as in
    JAX), so it picks ``xla``; the kernels are ``pallas`` by name."""
    from rawaudiovae_kelsey_tpu_torch.models.registry import resolve_backend

    cfg = _cfg("best")
    cfg.tpu.precision = precision
    cfg.validate()
    assert resolve_backend(cfg, torch.device("cuda")) == "xla"
    for backend in ("xla", "pallas"):
        cfg.tpu.backend = backend
        assert resolve_backend(cfg, torch.device("cuda")) == backend


@pytest.mark.parametrize("arch", ["deep", "conv1d"])
def test_registry_builds_every_variant_and_rejects_unknown_arch(arch):
    """No family is left unported: ``deep`` and ``conv1d`` build (their
    routing is held in tests/test_torch_variants.py), and only an arch the
    JAX package does not know either raises."""
    assert build_model(_cfg("xla", arch), "cpu").name == arch
    with pytest.raises(ValueError, match="unknown arch"):
        build_model(_cfg("xla", arch + "-unknown"), "cpu")


def test_registry_models_match_jax_pallas_model(jparams, tparams):
    jcfg = JConfig()
    jcfg.audio.segment_length = SEG
    jcfg.vae.n_units, jcfg.vae.latent_dim = UNITS, LATENT
    jcfg.tpu.backend = "pallas"
    jmodel = jbuild_model(jcfg)
    model = build_model(_cfg("pallas"), "cpu")
    x = _x(70, seed=6)
    jmu, jlv = jmodel.encode(jparams, jnp.asarray(x))
    mu, lv = model.encode(tparams, torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)
    _close(model.decode(tparams, mu), jmodel.decode(jparams, jmu))

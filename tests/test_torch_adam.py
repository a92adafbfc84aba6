"""The port's one-pass Adam (rawaudiovae_kelsey_tpu_torch/ops/adam.py).

Bit for bit against ``train/optim.py`` ``Adam.update``: that is the
kernel's contract, and on the CPU the wrapper runs the plain version, which
must already hold it (same operations, same order, same scalars).

Against the TPU kernel ``_leaf_update`` and ``fused_adam_apply`` of
benchmarks/adam_fusion_ab.py with an optax state, on the same seeded
gradients: atol 1e-6 on parameters of magnitude ~1, the tolerance
tests/test_torch_tree.py states for Adam across the packages (the same fp32
operations; XLA may contract a multiply-add).  The probe's ``pallas_call``
passes no ``interpret=``, so the test hands the loaded module a ``pl`` whose
``pallas_call`` adds it; nothing in benchmarks/ changes.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as real_pl

from rawaudiovae_kelsey_tpu.models import variants as jvariants
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu_torch import tree
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.ops import adam as adam_ops
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam

REPO = Path(__file__).resolve().parents[1]
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-2)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "adam_fusion_ab", REPO / "benchmarks" / "adam_fusion_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() is guarded

    def pallas_call(*args, **kwargs):
        return real_pl.pallas_call(*args, interpret=True, **kwargs)

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call,
                                   BlockSpec=real_pl.BlockSpec)
    return mod


def _jparams(family):
    key = jax.random.PRNGKey(3)
    if family == "dense":
        return jvae.init_dense(key, 64, 48, 8)
    if family == "deep":
        return jvariants.init_deep(key, 64, (48, 32), 8)
    return jvariants.init_conv1d(key, 64, (4, 8), 5, 4, 8)


def _grads(rng, leaves, step):
    # magnitudes that move from step to step, so that v's root and the
    # quotient see several exponents
    return [rng.standard_normal(a.shape).astype(np.float32)
            * 10.0 ** (step % 3 - 1) for a in leaves]


def _states_equal(a, b):
    for field in ("params", "mu", "nu"):
        for (name, ta), (_, tb) in zip(tree.flatten(getattr(a, field)),
                                       tree.flatten(getattr(b, field))):
            assert torch.equal(ta, tb), f"{field}.{name}"
    assert (a.count, a.step) == (b.count, b.step)


@pytest.mark.parametrize("family", ["dense", "deep", "conv1d"])
def test_fused_adam_apply_equals_adam_update_bit_for_bit(family):
    params = params_from_jax(jax.device_get(_jparams(family)))
    ranks = {t.dim() for t in tree.leaves(params)}
    assert ranks == ({1, 2, 3} if family == "conv1d" else {1, 2})
    plain = TrainState.create(params, seed=0)
    fused = plain.clone()
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(0)
    for step in range(6):
        g = [torch.from_numpy(a) for a in
             _grads(rng, [t.numpy() for t in tree.leaves(params)], step)]
        adam.update(plain, tree.unflatten(plain.params, g))
        adam_ops.FusedAdam(adam).update(
            fused, tree.unflatten(fused.params, [t.clone() for t in g]))
    assert fused.count == 6
    _states_equal(plain, fused)


@pytest.mark.parametrize("shape", [(1,), (255,), (7, 33, 5), (64, 48)])
def test_leaf_update_ref_equals_adam_update_on_one_leaf(shape):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    state = TrainState.create({"w": p.clone()}, seed=0)
    q, m, v = p.clone(), torch.zeros(shape), torch.zeros(shape)
    adam = Adam(learning_rate=HYPER["lr"])
    for step in range(1, 5):
        g = torch.from_numpy(_grads(rng, [p.numpy()], step)[0])
        adam.update(state, {"w": g})
        bc = [torch.full((), c) for c in
              adam_ops.bias_corrections(0.9, 0.999, step)]
        adam_ops.leaf_update(q, g, m, v, *bc, **HYPER)
    assert torch.equal(q, state.params["w"])
    assert torch.equal(m, state.mu["w"]) and torch.equal(v, state.nu["w"])


def test_hyper_is_what_eager_multiplies_by():
    """A Python scalar meets an fp32 tensor as the scalar rounded to fp32:
    ``1 - b1`` in double first."""
    c1, b1, c2, b2, eps, neg_lr = adam_ops.hyper(0.9, 0.999, 1e-8, 1e-4)
    one = torch.ones((), dtype=torch.float32)
    assert float((1 - 0.9) * one) == c1 and float(0.9 * one) == b1
    assert float((1 - 0.999) * one) == c2 and float(0.999 * one) == b2
    assert float(-1e-4 * one) == neg_lr and float(one * 1e-8) == eps
    assert c1 != float(np.float32(1) - np.float32(0.9))   # not fp32 - fp32


# leaf shapes: inside the TPU kernel's tile budget (one block), above it with
# rows it can tile (1024 = 2 blocks of 512), above it with rows it cannot
# (1001 is no multiple of 8: the JAX function's plain fallback), and 1-D / 3-D
@pytest.mark.parametrize("shape", [(48, 32), (1024, 512), (1001, 512),
                                   (513,), (5, 4, 8)])
def test_leaf_update_matches_the_tpu_kernel(probe, shape):
    rows, cols = probe._leaf_2d(np.empty(shape)).shape
    bm = probe._row_block(rows, cols)
    if shape == (1024, 512):
        assert rows * cols > probe._TILE_BUDGET_ELEMS and bm == 512
    if shape == (1001, 512):
        assert bm is None
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(shape).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape)
    p = torch.from_numpy(p0.copy())
    m, v = torch.zeros(shape), torch.zeros(shape)
    for step in range(1, 4):
        g = _grads(rng, [p0], step)[0]
        bc = adam_ops.bias_corrections(0.9, 0.999, step)
        jp, jm, jv = probe._leaf_update(
            jp, jnp.asarray(g), jm, jv,
            *[jnp.full((1, 1), c, jnp.float32) for c in bc], **HYPER)
        adam_ops.leaf_update(p, torch.from_numpy(g), m, v,
                             *[torch.full((), c) for c in bc], **HYPER)
    for got, want in ((p, jp), (m, jm), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("family", ["deep", "conv1d"])
def test_fused_adam_apply_matches_the_jax_one_on_an_optax_state(probe,
                                                                family):
    jp = _jparams(family)
    jopt = optax.adam(1e-2).init(jp)
    state = TrainState.create(params_from_jax(jax.device_get(jp)), seed=0)
    adam = Adam(learning_rate=1e-2)
    rng = np.random.default_rng(3)
    leaves = jax.tree_util.tree_leaves(jp)
    for step in range(4):
        g = _grads(rng, leaves, step)
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp), [jnp.asarray(a) for a in g])
        jp, jopt = probe.fused_adam_apply(jg, jopt, jp, lr=1e-2)
        adam_ops.fused_adam_apply(adam, state, tree.unflatten(
            state.params, [torch.from_numpy(a) for a in g]))
    assert state.count == int(jopt[0].count) == 4
    for got, want in ((state.params, jp), (state.mu, jopt[0].mu),
                      (state.nu, jopt[0].nu)):
        for t, a in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=1e-5)


def test_a_strided_gradient_is_taken():
    p = torch.randn((6, 4), generator=torch.Generator().manual_seed(0))
    a, b = (TrainState.create({"w": p.clone()}, 0) for _ in range(2))
    g = torch.randn((4, 6), generator=torch.Generator().manual_seed(1)).t()
    assert not g.is_contiguous()
    adam = Adam(learning_rate=1e-2)
    adam.update(a, {"w": g})
    adam_ops.fused_adam_apply(adam, b, {"w": g})
    _states_equal(a, b)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """Only a CPU leaf takes the plain version; the checks a CUDA leaf
    passes before its launch are exercised on a device the kernel does not
    run on, where the first of them already raises."""
    t = torch.zeros((4, 3), device="meta")
    s = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        adam_ops.leaf_update(t, t, t, t, s, s, **HYPER)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        adam_ops.leaf_update([1.0], t, t, t, s, s, **HYPER)
    dev = torch.device("meta")
    for bad, err in ((t.double(), TypeError), (t[:2], ValueError),
                     (t.t(), ValueError), (torch.zeros((4, 3)), ValueError),
                     (3.0, TypeError)):
        with pytest.raises(err):
            adam_ops._leaf(bad, "g", dev, (4, 3))
    adam_ops._leaf(t, "g", dev, (4, 3))
    with pytest.raises(ValueError, match="shape"):
        adam_ops._leaf(torch.zeros((1,), device="meta"), "bc1", dev, ())


def test_cpu_calls_count_no_launch():
    before = adam_ops.leaf_update.launches
    p = torch.ones(5)
    adam_ops.leaf_update(p, torch.ones(5), torch.zeros(5), torch.zeros(5),
                         torch.full((), 0.1), torch.full((), 0.001), **HYPER)
    assert adam_ops.leaf_update.launches == before
    assert bool((p < 1).all())

"""The port's train step (rawaudiovae_kelsey_tpu_torch/parallel/step.py)
against the JAX package's ``build_train_step`` on the same weights, the
same batches and the same noise.

The JAX step draws ``eps`` from threefry: ``fold_in(fold_in(PRNGKey(seed),
step), i)`` for microbatch ``i``, ``fold_in(PRNGKey(seed), step)`` alone
when the step does not microbatch (parallel/step.py:180, 192, 218, 231).
The test computes those numbers with JAX and injects them into the port.
On the CPU the JAX ``pallas`` backend runs its kernels in interpret mode
and the port's wrappers run their plain versions.

Tolerances:
* ``highest`` (IEEE fp32 on both sides): loss rel 1e-5, params atol 1e-5
  after each step — tests/test_pallas.py:142-146's bound between the JAX
  package's own backends.  Both sides form the same fp32 products; only
  the order of the sums differs.
* ``bfloat16``: bf16 keeps 8 significant bits, so every rounding moves a
  value by up to 2^-9 relative, and XLA and PyTorch round the elementwise
  bf16 passes at different places (XLA may keep fp32 between fused ops).
  The loss, a mean over thousands of such values, is held at rel 1e-3
  (measured ≤ 3.4e-5).  After a first Adam step from zero moments
  every update is ``lr·g/(|g|+eps)`` ≈ ``±lr``, so a gradient that is
  bf16 noise can flip an update's sign: params are held at atol 2·lr,
  and the gradient itself through Adam's first moment (``mu = 0.1·g``
  after one step) at a relative L2 error of 3e-2 (measured ≤ 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.parallel import build_train_step as jbuild_step
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch.compat import (
    params_from_jax,
    train_state_from_jax,
)
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.train import TrainState

SEG, UNITS, LATENT, BATCH, SEED, LR = 128, 192, 32, 48, 5, 1e-3
FP32 = dict(loss_rel=1e-5, atol=1e-5, mu_rel=None)
BF16 = dict(loss_rel=1e-3, atol=2 * LR, mu_rel=3e-2)


def _configure(cfg, backend, precision, reduction, micro):
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = 64
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.learning_rate = LR
    cfg.training.loss_reduction = reduction
    cfg.tpu.backend = backend
    cfg.tpu.precision = precision
    cfg.tpu.microbatch_size = micro
    return cfg


def jax_eps(step, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, dtype=jnp.float32)))


def _pair(backend, precision, reduction="mean", micro=0):
    jcfg = _configure(JConfig(), backend, precision, reduction, micro)
    jmodel = jbuild_model(jcfg)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(p, opt.init(p), seed=SEED)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)
    cfg = _configure(Config(), backend, precision, reduction, micro)
    model = build_model(cfg, "cpu")
    state = TrainState.create(params_from_jax(jax.device_get(p)), SEED)
    return jstep, jstate, build_train_step(model, cfg, noise=jax_eps), state


def _batch(seed, rows=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (rows, SEG)).astype(np.float32)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tleaves(params):
    return [params[n][k].numpy() for n in sorted(params)
            for k in sorted(params[n])]


def _compare(jstate, jm, state, m, tol):
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=tol["loss_rel"])
    for name in ("mse", "kld"):
        assert float(m[name]) == pytest.approx(float(jm[name]),
                                               rel=tol["loss_rel"],
                                               abs=1e-7)
    for a, b in zip(_tleaves(state.params), _leaves(jstate.params)):
        np.testing.assert_allclose(a, b, atol=tol["atol"], rtol=0)
    if tol["mu_rel"] is not None:
        mu_t = np.concatenate([a.ravel() for a in _tleaves(state.mu)])
        mu_j = np.concatenate([a.ravel() for a in
                               _leaves(jstate.opt_state[0].mu)])
        err = np.linalg.norm(mu_t - mu_j) / np.linalg.norm(mu_j)
        assert err <= tol["mu_rel"], err
    assert state.step == int(jstate.step)
    assert state.count == int(jstate.opt_state[0].count)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_one_step_matches_jax(backend, precision, reduction):
    jstep, jstate, step, state = _pair(backend, precision, reduction)
    x = _batch(0)
    jstate, jm = jstep(jstate, jnp.asarray(x))
    state, m = step(state, torch.from_numpy(x))
    _compare(jstate, jm, state, m, FP32 if precision == "highest" else BF16)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("micro", [16, 20], ids=["even", "ragged"])
def test_microbatched_step_matches_jax(backend, precision, reduction, micro):
    """48 rows in microbatches of 16 (three full ones) or of 20 (two full
    ones and a ragged tail of 8, weighted 8/48)."""
    jstep, jstate, step, state = _pair(backend, precision, reduction, micro)
    x = _batch(1)
    jstate, jm = jstep(jstate, jnp.asarray(x))
    state, m = step(state, torch.from_numpy(x))
    _compare(jstate, jm, state, m, FP32 if precision == "highest" else BF16)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_coupled_steps_match_jax(backend):
    """Four steps, each from the state the previous one left, with a
    ragged last batch (as the epoch loader yields it) and microbatches."""
    jstep, jstate, step, state = _pair(backend, "highest", micro=20)
    for k, rows in enumerate((BATCH, BATCH, BATCH, 30)):
        x = _batch(10 + k, rows)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
        _compare(jstate, jm, state, m, FP32)


def test_state_from_jax_continues_the_jax_trajectory():
    """A JAX state after one step, carried over with train_state_from_jax,
    takes the next step as the JAX state does (Adam count and moments
    included)."""
    jstep, jstate, step, state = _pair("xla", "highest")
    jstate, _ = jstep(jstate, jnp.asarray(_batch(2)))
    state = train_state_from_jax(
        _leaves(jax.device_get(jstate)), state)
    assert (state.count, state.step, state.seed) == (1, 1, SEED)
    x = _batch(3)
    jstate, jm = jstep(jstate, jnp.asarray(x))
    state, m = step(state, torch.from_numpy(x))
    _compare(jstate, jm, state, m, FP32)


def test_seeded_noise_replays_from_the_step():
    """Without injected noise, a step's eps is a function of (seed, step,
    microbatch): the same state gives the same update twice, and another
    step number gives another."""
    cfg = _configure(Config(), "xla", "highest", "mean", 20)
    model = build_model(cfg, "cpu")
    step = build_train_step(model, cfg)
    base = TrainState.create(model.init(torch.Generator().manual_seed(0)), 3)
    x = torch.from_numpy(_batch(4))
    a, ma = step(base.clone(), x)
    b, mb = step(base.clone(), x)
    assert torch.equal(ma["loss"], mb["loss"])
    for p, q in zip(_tleaves(a.params), _tleaves(b.params)):
        np.testing.assert_array_equal(p, q)
    other = base.clone()
    other.step = 7
    _, mc = step(other, x)
    assert not torch.equal(ma["loss"], mc["loss"])


@pytest.mark.parametrize("rng", ["threefry", "tpu_prng"])
def test_unported_step_options_raise(rng):
    """``remat`` is the one step option still to port; ``rng = tpu_prng``
    (the in-kernel sampler) builds."""
    cfg = _configure(Config(), "xla", "highest", "mean", 0)
    cfg.tpu.rng = rng
    build_train_step(build_model(cfg, "cpu"), cfg)
    cfg.tpu.remat = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(build_model(cfg, "cpu"), cfg)

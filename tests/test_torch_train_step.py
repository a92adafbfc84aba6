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
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves

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
    """No step option is left unported: ``remat`` and ``rng = tpu_prng``
    (the in-kernel sampler) build, alone and together, and the step takes
    a batch."""
    cfg = _configure(Config(), "xla", "highest", "mean", 0)
    cfg.tpu.rng = rng
    build_train_step(build_model(cfg, "cpu"), cfg)
    cfg.tpu.remat = True
    model = build_model(cfg, "cpu")
    step = build_train_step(model, cfg)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              SEED)
    state, m = step(state, torch.from_numpy(_batch(1)))
    assert state.step == 1 and np.isfinite(float(m["loss"]))


# ------------------------------------------------------------------ remat

def _variant(cfg, arch):
    if arch == "deep":
        cfg.vae.arch = "deep"
        cfg.vae.hidden_dims = "96,48"
    elif arch == "conv1d":
        cfg.vae.arch = "conv1d"
        cfg.vae.conv_channels = "4,8"
        cfg.vae.conv_kernel = 5
        cfg.vae.conv_stride = 4
    return cfg


def _remat_pair(arch, backend, precision, micro, rng="threefry"):
    """The plain step and the remat step of one config, and one state."""
    steps = []
    for remat in (False, True):
        cfg = _variant(_configure(Config(), backend, precision, "mean",
                                  micro), arch)
        cfg.tpu.rng = rng
        cfg.tpu.remat = remat
        model = build_model(cfg, "cpu")
        steps.append(build_train_step(model, cfg, noise=jax_eps))
    state = TrainState.create(model.init(torch.Generator().manual_seed(1)),
                              SEED)
    return steps, state


REMAT_CASES = [
    ("dense", "xla", "highest", 0), ("dense", "pallas", "highest", 0),
    ("dense", "xla", "bfloat16", 0), ("dense", "pallas", "bfloat16", 20),
    ("dense", "pallas", "high", 16), ("deep", "xla", "highest", 0),
    ("deep", "pallas", "bfloat16", 16), ("conv1d", "xla", "highest", 0),
    ("conv1d", "xla", "bfloat16", 20),
]


@pytest.mark.parametrize("arch,backend,precision,micro", REMAT_CASES)
def test_remat_step_equals_the_plain_step_bit_for_bit(arch, backend,
                                                      precision, micro):
    """The recomputed forward is the same function of the same inputs (the
    noise is an input), so three coupled remat steps give the plain
    steps' losses, params and Adam moments bit for bit — every family, on
    the kernels' wrappers and on the plain ops, microbatched too."""
    (plain, remat), state = _remat_pair(arch, backend, precision, micro)
    a, b = state.clone(), state.clone()
    for k in range(3):
        x = torch.from_numpy(_batch(20 + k))
        a, ma = plain(a, x)
        b, mb = remat(b, x)
        for name in ("loss", "mse", "kld"):
            assert torch.equal(ma[name], mb[name]), (k, name)
    for p, q in zip(tree_leaves((a.params, a.mu, a.nu)),
                    tree_leaves((b.params, b.mu, b.nu))):
        assert torch.equal(p, q)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_remat_step_under_the_sampler_equals_the_plain_step(backend):
    """Under ``rng = tpu_prng`` the sampler draws from the step's seed
    words, which are the loss's input: recomputing gives the same draw."""
    (plain, remat), state = _remat_pair("dense", backend, "highest", 16,
                                        rng="tpu_prng")
    x = torch.from_numpy(_batch(30))
    a, ma = plain(state.clone(), x)
    b, mb = remat(state.clone(), x)
    assert torch.equal(ma["loss"], mb["loss"])
    for p, q in zip(_tleaves(a.params), _tleaves(b.params)):
        np.testing.assert_array_equal(p, q)


def test_remat_recomputes_the_forward_only():
    """Under remat the loss's forward runs twice a microbatch (once in the
    step, once in the backward) and the backward once."""
    from rawaudiovae_kelsey_tpu_torch.models import vae

    calls = {"encode": 0, "decode": 0}
    counted = {}
    for remat in (False, True):
        cfg = _configure(Config(), "xla", "highest", "mean", 16)
        cfg.tpu.remat = remat
        model = build_model(cfg, "cpu")

        def encode(p, x, _f=model.encode):
            calls["encode"] += 1
            return _f(p, x)

        def decode(p, z, _f=model.decode):
            calls["decode"] += 1
            return _f(p, z)

        import dataclasses

        model = dataclasses.replace(model, encode=encode, decode=decode)
        step = build_train_step(model, cfg, noise=jax_eps)
        state = TrainState.create(vae.init_dense(
            torch.Generator().manual_seed(0), SEG, UNITS, LATENT), SEED)
        calls.update(encode=0, decode=0)
        step(state, torch.from_numpy(_batch(3)))
        counted[remat] = dict(calls)
    assert counted[False] == {"encode": 3, "decode": 3}   # 48 rows / 16
    assert counted[True] == {"encode": 6, "decode": 6}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
def test_remat_step_matches_the_jax_remat_step(backend, precision):
    """``remat = true`` on both sides: the JAX step under
    ``jax.checkpoint`` and the port's under ``torch.utils.checkpoint``
    agree at the file's tolerances, microbatched."""
    jcfg = _configure(JConfig(), backend, precision, "mean", 16)
    jcfg.tpu.remat = True
    jmodel = jbuild_model(jcfg)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(p, opt.init(p), seed=SEED)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)
    cfg = _configure(Config(), backend, precision, "mean", 16)
    cfg.tpu.remat = True
    step = build_train_step(build_model(cfg, "cpu"), cfg, noise=jax_eps)
    state = TrainState.create(params_from_jax(jax.device_get(p)), SEED)
    tol = FP32 if precision == "highest" else BF16
    x = _batch(40)
    jstate, jm = jstep(jstate, jnp.asarray(x))
    state, m = step(state, torch.from_numpy(x))
    _compare(jstate, jm, state, m, tol)


# ------------------------------------------------- the loss off the card

LOSS_CASES = [(arch, backend, precision, reduction)
              for arch in ("dense", "deep")
              for backend in ("xla", "pallas")
              for precision in ("highest", "bfloat16")
              for reduction in ("mean", "sum")
              if arch == "dense" or reduction == "mean"]


@pytest.mark.parametrize("arch,backend,precision,reduction", LOSS_CASES)
def test_step_loss_off_the_card_is_the_plain_loss_bit_for_bit(
        arch, backend, precision, reduction):
    """On the CPU, under either backend, the step's loss is
    ``models/vae.py``'s plain ops on the reconstruction brought to fp32,
    written out here as the step ran them before its loss went to row
    14's kernels on the card: the loss, the metrics and the gradients
    equal bit for bit, and neither loss kernel launches."""
    from rawaudiovae_kelsey_tpu_torch.models import vae
    from rawaudiovae_kelsey_tpu_torch.models.registry import under_tier
    from rawaudiovae_kelsey_tpu_torch.ops import loss as fused
    from rawaudiovae_kelsey_tpu_torch.parallel.step import make_loss_fn
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    cfg = _variant(_configure(Config(), backend, precision, reduction, 0),
                   arch)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    x = torch.from_numpy(_batch(6))
    eps = jax_eps(0, None, (BATCH, LATENT))
    before = (fused.loss_sums.launches, fused.loss_grads.launches)

    def fresh():
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        return p, tree_leaves(p)

    p, leaves = fresh()
    got, (mse, kld) = make_loss_fn(model, cfg)(p, eps, x)
    got_grads = torch.autograd.grad(got, leaves)

    q, qleaves = fresh()
    tiered = under_tier(model, cfg)
    work = torch.bfloat16 if precision == "bfloat16" else torch.float32
    cq = tree_map(lambda t: t.to(work), q)
    rows = x.reshape(-1, SEG)
    mu, logvar = tiered.encode(cq, rows.to(work))
    mu, logvar = mu.float(), logvar.float()
    z = vae.reparameterize(mu, logvar, eps=eps).to(work)
    recon = tiered.decode(cq, z).float()
    want = vae.loss_components(recon, rows, mu, logvar, cfg.vae.kl_beta,
                               SEG, reduction)
    want_grads = torch.autograd.grad(want[0], qleaves)

    for a, b in zip((got, mse, kld), want):
        assert torch.equal(a, b)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)
    # the whole step reports the same metrics
    state = TrainState.create(tree_map(lambda t: t.clone(), params), SEED)
    _, m = build_train_step(model, cfg, noise=jax_eps)(state, x)
    for name, w in zip(("loss", "mse", "kld"), want):
        assert torch.equal(m[name], w.detach())
    assert (fused.loss_sums.launches, fused.loss_grads.launches) == before

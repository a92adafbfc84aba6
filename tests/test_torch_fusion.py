"""The backward-fusion switch in the port (rawaudiovae_kelsey_tpu_torch/ops
/mlp.py ``BWD_FUSION`` and ``fusion``, the counterparts of the JAX
package's ``pallas_mlp.py:993-1011``) and every form of the dense backward
kernels it reaches: the 3-pass forms of ``matmul_nt_mask``, ``grad_accum``,
``grad_accum2``, ``enc_bwd_dw1`` and ``dec_bwd_fused`` (rows 5 and 7-10)
and the one-pass fp32 full chains (rows 11-12), against the JAX package's
Pallas kernels; ``encoder_bwd`` / ``decoder_bwd``; the train step of every
mode and tier.

On the CPU the JAX side runs its kernels in interpret mode under
``jax.default_matmul_precision(tier)``, as tests/test_torch_high_forward.py
does, and the port's wrappers run their plain versions (CPU tensors).  The
switch is read by JAX when it traces, so every change of it is followed by
``jax.clear_caches()`` (the ``switch`` fixture), and it is put back after
each test.  Inputs come from numpy seeds; segment 128, units 64, latent 16;
batches 64 and a ragged 37.

Tolerances:
* three passes (``high``): ``atol = rtol = 2e-5``, the 3-pass bound of
  tests/test_torch_full_backward.py: the same split (bit for bit) and the
  same bf16 x bf16 products (exact in fp32), summed in another order;
* one fp32 pass (``float32`` / ``highest``): ``rtol = 1e-6`` and ``atol =
  1e-6 · max|want|``, the fp32 bound of
  tests/test_torch_full_backward.py:228 scaled to each output: the same
  fp32 products summed in another order, whose error follows the size of
  the terms (a bias gradient sums 64 rows of O(1) values into elements as
  small as 0.1: 1.4e-6 measured apart), not the size of the result;
* the train step: the bounds of tests/test_torch_train_step.py, ``FP32``
  (loss rel 1e-5, params atol 1e-5) for ``high`` and ``highest`` and
  ``BF16`` (loss rel 1e-3, params atol 2·lr, the gradient through Adam's
  first moment at rel 3e-2: bf16 rounds where XLA and PyTorch differ) for
  ``bfloat16``.  In fp32 the gradient itself, through Adam's first moment
  (``mu = 0.1 · g`` after one step), is held within 2e-5 of each leaf's
  largest value (the 3-pass bound; measured ≤ 3.1e-6), and a param whose
  gradient lies in Adam's eps zone (below ``ADAM_EPS_ZONE`` = 1e-7, where
  ``lr · g / (|g| + 1e-8)`` turns the rounding of a tiny ``g`` into a move
  of up to lr: measured 8.3e-5 at ``g`` = 1.5e-9 against 5.1e-10) at lr,
  as tests/test_torch_mesh.py holds it; the zone stays under 1 % of a
  leaf.
* The two fault tests: inputs on which a pass count shows.  The encoder's
  input rows come in pairs whose values nearly cancel, x and -x·(1 + 2^-7),
  one pair a column, under cotangents equal within a pair and open gates:
  every element of dW1 is two terms whose 3-pass products each drop their
  own lo·lo (~2^-18 of a term), ~2^-11 of the result, while two terms add
  alike in any order.  One pass against three moves dW1 far outside the
  bound; the same pass count on both sides meets it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.models import build_model as jbuild_model
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu.parallel import build_train_step as jbuild_step
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.train import TrainState

SEG, UNITS, LATENT = 128, 64, 16
BATCHES = [64, 37]
TOL3 = 2e-5
TOL1 = 1e-6
SEED, LR = 5, 1e-3
FP32 = dict(loss_rel=1e-5, atol=1e-5, mu_rel=None)
BF16 = dict(loss_rel=1e-3, atol=2 * LR, mu_rel=3e-2)
GRAD_REL = 2e-5
ADAM_EPS_ZONE = 1e-7
MODES = ("primitive", "split", "full")
TIERS = ("bfloat16", "high", "highest")
LAYERS = ("fc1", "fc21", "fc22", "fc3", "fc4")


@pytest.fixture
def jax_switch():
    """Set the JAX package's switch (it then traces anew); put it back and
    clear JAX's traces after the test."""
    saved = jmlp.BWD_FUSION

    def set_(mode):
        jmlp.BWD_FUSION = mode
        jax.clear_caches()

    yield set_
    jmlp.BWD_FUSION = saved
    jax.clear_caches()


@pytest.fixture
def switch(jax_switch):
    """Set both packages' switch; put the port's back after the test."""
    saved = mlp.BWD_FUSION

    def set_(mode):
        mlp.BWD_FUSION = mode
        jax_switch(mode)

    yield set_
    mlp.BWD_FUSION = saved


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(3), SEG, UNITS, LATENT))


def _rows(seed, *shapes, relu=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, s in enumerate(shapes):
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.maximum(a, 0) if k in relu else a)
    return out


def _both(arrays):
    """The same fp32 values for both packages."""
    ts = [torch.from_numpy(np.array(a, np.float32)) for a in arrays]
    return [jnp.asarray(t.numpy()) for t in ts], ts


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    """Within the bound of ``tol``'s pass count (header): at one pass the
    absolute part scales with the output's largest value."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = TOL1 * float(np.abs(want).max()) if tol == TOL1 else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol)


def _w(jparams, name):
    return np.array(jparams[name]["w"])


def _form_inputs(jparams, name, batch):
    """Each form's operands, as its JAX kernel takes them."""
    x, h, dmu, dlv, da, h3, z = _rows(
        batch, (batch, SEG), (batch, UNITS), (batch, LATENT),
        (batch, LATENT), (batch, SEG), (batch, UNITS), (batch, LATENT),
        relu=(1, 5))
    w21, w22, w3, w4 = (_w(jparams, n) for n in ("fc21", "fc22", "fc3",
                                                  "fc4"))
    return {"matmul_nt_mask": [da, w4, h3],
            "grad_accum": [h3, da],
            "grad_accum2": [h, dmu, dlv],
            "enc_bwd_dw1": [x, h, dmu, dlv, w21, w22],
            "dec_bwd_fused": [da, h3, z, w4, w3],
            "enc_bwd_full": [x, h, dmu, dlv, w21, w22],
            "dec_bwd_full": [da, h3, z, w4, w3]}[name]


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------- each form against its kernel

@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", ["matmul_nt_mask", "grad_accum",
                                  "grad_accum2", "enc_bwd_dw1",
                                  "dec_bwd_fused"])
def test_three_pass_forms_match_jax_kernels(jparams, name, batch):
    """Rows 5 and 7-10 at three passes (the ``high`` tier with the switch
    forced to "primitive" or "split"): dh and dh3 fp32, both operands of a
    weight gradient split, the bias gradients of the unsplit values."""
    js, ts = _both(_form_inputs(jparams, name, batch))
    with jax.default_matmul_precision("high"):
        want = _outs(getattr(jmlp, name)(*js))
    got = _outs(getattr(mlp, name)(*ts, passes=3))
    assert len(got) == len(want)
    assert all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, want):
        _close(g, w, TOL3)
    # the plain version is what the wrapper ran
    for g, w in zip(got, _outs(getattr(mlp, name + "_ref")(*ts, 3))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("tier", ["highest", "float32"])
@pytest.mark.parametrize("name", ["enc_bwd_full", "dec_bwd_full"])
def test_full_chains_in_one_fp32_pass_match_jax_kernels(jparams, name, tier,
                                                        batch):
    """Rows 11-12 under ``highest`` / ``float32`` with "full" forced: one
    IEEE fp32 pass (``_ambient_passes`` gives 1), dh and dh3 unrounded."""
    js, ts = _both(_form_inputs(jparams, name, batch))
    with jax.default_matmul_precision(tier):
        want = getattr(jmlp, name)(*js)
    got = getattr(mlp, name)(*ts, passes=1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, TOL1)


@pytest.mark.parametrize("passes,tier,tol", [(3, "high", TOL3),
                                             (1, "highest", TOL1)],
                         ids=["high", "highest"])
@pytest.mark.parametrize("batch", BATCHES)
def test_encoder_and_decoder_bwd_match_jax(jparams, batch, passes, tier,
                                           tol):
    x, dmu, dlv, z, dy = _rows(10 + batch, (batch, SEG), (batch, LATENT),
                               (batch, LATENT), (batch, LATENT),
                               (batch, SEG))
    enc = [np.asarray(jparams[n][k]) for n in LAYERS[:3] for k in ("w", "b")]
    dec = [np.asarray(jparams[n][k]) for n in LAYERS[3:] for k in ("w", "b")]
    (jx, jz), (tx, tz) = _both([x, z])
    with jax.default_matmul_precision(tier):
        _, _, jh = jmlp.encoder_fwd(*_both(enc)[0], jx)
        jy, jh3 = jmlp.decoder_fwd(*_both(dec)[0], jz)
    # both sides from the same activations: JAX's
    th, ty, th3 = _both([_np(jh), _np(jy), _np(jh3)])[1]
    jw1, jw21, jw22, jw3, jw4 = (jnp.asarray(_w(jparams, n)) for n in LAYERS)
    tw1, tw21, tw22, tw3, tw4 = (torch.from_numpy(_w(jparams, n))
                                 for n in LAYERS)
    (jdmu, jdlv, jdy), (tdmu, tdlv, tdy) = _both([dmu, dlv, dy])
    with jax.default_matmul_precision(tier):
        want_e = jmlp.encoder_bwd(jw1, jw21, jw22, jx, jh, jdmu, jdlv)
        want_d = jmlp.decoder_bwd(jw3, jw4, jz, jh3, jy, jdy)
    got_e = mlp.encoder_bwd(tw1, tw21, tw22, tx, th, tdmu, tdlv, passes)
    got_d = mlp.decoder_bwd(tw3, tw4, tz, th3, ty, tdy, passes)
    assert len(got_e) == 7 and len(got_d) == 5
    for g, w in zip(got_e + got_d, want_e + want_d):
        _close(g, w, tol)


# ------------------------------------------------------------- the switch

@pytest.mark.parametrize("value", ["auto", *MODES])
def test_fusion_is_the_jax_rule(switch, value):
    """``fusion`` against ``_fusion`` for each value of the switch, both
    dtypes and every tier: the port's pass count is 3 exactly where
    ``_ambient_passes`` is."""
    switch(value)
    for tier in ("bfloat16", "float32", "high", "highest"):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            with jax.default_matmul_precision(tier):
                want = jmlp._fusion(jdt)
                passes = jmlp._ambient_passes(jdt)
            assert passes == (3 if tdt == torch.float32 and tier == "high"
                              else 1)
            assert mlp.fusion(tdt, passes) == want, (value, tier, tdt)


def test_a_step_keeps_the_mode_its_model_was_built_with(switch):
    """The switch is read when the model is built (``models/registry.py``
    ``backward_fusion``), as JAX reads it when a step is traced: changing
    it afterwards leaves a built model's mode alone."""
    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "high"
    switch("split")
    model = build_model(cfg, "cpu")
    switch("primitive")
    assert model.encode.keywords == {"mode": "split"}
    assert build_model(cfg, "cpu").encode.keywords == {"mode": "primitive"}
    switch("auto")
    assert build_model(cfg, "cpu").decode.keywords == {"mode": "full"}


# ---------------------------------------- the train step, each mode × tier

def _configure(cfg, precision):
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = 64
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.learning_rate = LR
    cfg.tpu.backend = "pallas"
    cfg.tpu.precision = precision
    return cfg


def jax_eps(step, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, dtype=jnp.float32)))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tleaves(params):
    return [params[n][k].numpy() for n in sorted(params)
            for k in sorted(params[n])]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mode", MODES)
def test_train_step_of_each_mode_and_tier_matches_jax(switch, mode, tier):
    """The ``backend = pallas`` step with the switch forced, against JAX's
    step with its switch forced the same way and its eps injected: the
    port's model runs the mode on every tier, at the tier's pass count."""
    switch(mode)
    tol = BF16 if tier == "bfloat16" else FP32
    jcfg = _configure(JConfig(), tier)
    jmodel = jbuild_model(jcfg)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(p, opt.init(p), seed=SEED)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)
    cfg = _configure(Config(), tier)
    model = build_model(cfg, "cpu")
    assert model.encode.keywords == {"mode": mode}
    step = build_train_step(model, cfg, noise=jax_eps)
    state = TrainState.create(params_from_jax(jax.device_get(p)), SEED)
    x = np.random.default_rng(30).uniform(-1, 1, (64, SEG)).astype(
        np.float32)
    jstate, jm = jstep(jstate, jnp.asarray(x))
    state, m = step(state, torch.from_numpy(x))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=tol["loss_rel"])
    mus = list(zip(_tleaves(state.mu), _leaves(jstate.opt_state[0].mu)))
    for (a, b), (mu_t, mu_j) in zip(zip(_tleaves(state.params),
                                        _leaves(jstate.params)), mus):
        if tier == "bfloat16":
            np.testing.assert_allclose(a, b, atol=tol["atol"], rtol=0)
            continue
        np.testing.assert_allclose(mu_t, mu_j, rtol=0,
                                   atol=GRAD_REL * np.abs(mu_j).max())
        zone = np.abs(mu_j / 0.1) < ADAM_EPS_ZONE
        assert zone.mean() < 1e-2
        assert np.all(np.abs(a - b) <= np.where(zone, LR, tol["atol"]))
    if tol["mu_rel"] is not None:
        mu_t, mu_j = (np.concatenate([a.ravel() for a in side])
                      for side in zip(*mus))
        assert np.linalg.norm(mu_t - mu_j) / np.linalg.norm(mu_j) <= \
            tol["mu_rel"]


# ------------------------------------------------ the two faults repaired

def _cancelling_case(batch=64):
    """Params and inputs on which a pass count shows in dW1 (header): the
    rows of x in pairs, x and -x·(1 + 2^-7), pair k non-zero in the
    columns s ≡ k (mod batch/2) alone; the cotangents of mu and logvar
    equal within a pair; b1 = 1 keeps every gate open."""
    rng = np.random.default_rng(21)
    pairs = batch // 2
    x = np.zeros((batch, SEG), np.float32)
    for k in range(pairs):
        cols = np.arange(k, SEG, pairs)
        v = rng.uniform(1, 2, cols.size).astype(np.float32) * \
            rng.choice([-1, 1], cols.size).astype(np.float32)
        x[2 * k, cols] = v
        x[2 * k + 1, cols] = -v * np.float32(1 + 2.0 ** -7)
    cmu, clv = (np.repeat(rng.standard_normal((pairs, LATENT)).astype(
        np.float32) * 4, 2, axis=0) for _ in range(2))
    params = jax.device_get(jvae.init_dense(jax.random.PRNGKey(4), SEG,
                                            UNITS, LATENT))
    params["fc1"]["b"] = np.ones(UNITS, np.float32)
    params["fc21"]["w"] = rng.standard_normal((UNITS, LATENT)).astype(
        np.float32)
    params["fc22"]["w"] = rng.standard_normal((UNITS, LATENT)).astype(
        np.float32)
    z, cy = _rows(22, (batch, LATENT), (batch, SEG))
    return params, x, z, cmu, clv, cy


def _grads_both(mode, tier, passes):
    """The gradients of ``Σ mu·cmu + Σ logvar·clv + Σ y·cy`` through JAX's
    ``pallas_encode`` / ``pallas_decode`` under ``tier`` and through the
    port's ``Encode`` / ``Decode`` in ``mode`` at ``passes`` passes."""
    params, x, z, cmu, clv, cy = _cancelling_case()

    def jloss(p, x, z):
        mu, logvar = jmlp.pallas_encode(p, x)
        y = jmlp.pallas_decode(p, z)
        return jnp.sum(mu * cmu) + jnp.sum(logvar * clv) + jnp.sum(y * cy)

    with jax.default_matmul_precision(tier):
        jg, jdx, jdz = jax.grad(jloss, argnums=(0, 1, 2))(
            params, jnp.asarray(x), jnp.asarray(z))
    tp = params_from_jax(params)
    for layer in tp.values():
        for t in layer.values():
            t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tz = torch.from_numpy(z).requires_grad_()
    mu, logvar = mlp.Encode.apply(mode, passes, tx, tp["fc1"]["w"],
                                  tp["fc1"]["b"], tp["fc21"]["w"],
                                  tp["fc21"]["b"], tp["fc22"]["w"],
                                  tp["fc22"]["b"])
    y = mlp.Decode.apply(mode, passes, tz, tp["fc3"]["w"], tp["fc3"]["b"],
                         tp["fc4"]["w"], tp["fc4"]["b"])
    ((mu * torch.from_numpy(cmu)).sum() + (logvar * torch.from_numpy(
        clv)).sum() + (y * torch.from_numpy(cy)).sum()).backward()
    got = {f"{n}.{k}": tp[n][k].grad for n in LAYERS for k in ("w", "b")}
    want = {f"{n}.{k}": jg[n][k] for n in LAYERS for k in ("w", "b")}
    got.update(dx=tx.grad, dz=tz.grad)
    want.update(dx=jdx, dz=jdz)
    return got, want


@pytest.mark.parametrize("mode", ["split", "primitive"])
def test_split_and_primitive_take_three_passes_under_high(jax_switch, mode):
    """The fault: under ``high`` the port's "split" and "primitive"
    backward ran their products in one IEEE pass (``dx`` too) where JAX's
    kernels take three.  JAX's step under ``high`` with the switch forced
    against the port's backward at ``passes = 3``."""
    jax_switch(mode)
    got, want = _grads_both(mode, "high", 3)
    for name, g in got.items():
        _close(g, want[name], TOL3)


def test_the_fault_cases_tell_one_pass_from_three():
    """The checks above have teeth: on the same inputs the one-pass dW1
    (``enc_bwd_dw1``'s, which "primitive" computes alike) is outside the
    3-pass bound of the 3-pass dW1, which the test above holds to JAX's."""
    params, x, z, cmu, clv, cy = _cancelling_case()
    tp = params_from_jax(params)
    tx = torch.from_numpy(x)
    w21, w22 = tp["fc21"]["w"], tp["fc22"]["w"]
    _, _, h = mlp.encoder_fwd_ref(*(tp[n][k] for n in LAYERS[:3]
                                    for k in ("w", "b")), tx, 3)
    dmu, dlv = torch.from_numpy(cmu), torch.from_numpy(clv)
    three = mlp.enc_bwd_dw1_ref(tx, h, dmu, dlv, w21, w22, 3)[0]
    one = mlp.enc_bwd_dw1_ref(tx, h, dmu, dlv, w21, w22, 1)[0]
    bad = np.abs(_np(one) - _np(three)) > TOL3 + TOL3 * np.abs(_np(three))
    assert bad.mean() > 0.5


def test_full_takes_one_pass_under_highest(jax_switch):
    """The fault: the port's "full" chains took three passes for every
    fp32 operand, where JAX's ``enc_bwd_full`` / ``dec_bwd_full`` take one
    under ``highest`` (``_ambient_passes`` gives 1) with the switch forced
    to "full".  Held at the one-pass fp32 bound."""
    jax_switch("full")
    got, want = _grads_both("full", "highest", 1)
    for name, g in got.items():
        _close(g, want[name], TOL1)

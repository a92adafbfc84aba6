"""The ``high`` tier's forward and input gradient in the port
(rawaudiovae_kelsey_tpu_torch/ops/mlp.py at ``passes = 3``: rows 1, 2, 6
and 4 of the kernel table, and the row-parallel forms of rows 1 and 2)
against the JAX package's Pallas kernels, and where the tier reaches them
(``models/registry.py`` ``under_tier``).

Under ``jax.default_matmul_precision("high")`` the JAX dense kernels take
every fp32 product in three bf16 passes (``pallas_mlp.py:167``
``_ambient_passes``).  On the CPU the JAX side runs its kernels in
interpret mode under that scope, as tests/test_torch_full_backward.py
does, and the port's wrappers run their plain versions (CPU tensors).
Inputs come from numpy seeds; segment 128, units 64, latent 16; batches 64
and a ragged 37.

Tolerances:
* random operands: ``atol = rtol = 2e-5``, the 3-pass bound of the
  kernel-level cases of tests/test_torch_full_backward.py: the same split
  (bit for bit, :func:`mlp.split_hi_lo`) and the same bf16 x bf16 products
  (exact in fp32), summed in another order;
* ``chip_smoke.py`` ``exact_forward_case`` (every sum one term): h, mu,
  logvar, h3, dh and dx bit for bit; y within ``TANH_ULPS`` = 8 ulps, the
  two tanh implementations' own difference (XLA's CPU tanh is a rational
  approximation; measured at most 4 ulps from ``torch.tanh`` here), where
  one fp32 pass moves a pre-activation by ~2^-16 of it, hundreds of ulps
  of an unsaturated y;
* the train step: loss rel 1e-5 and params atol 1e-5 after each step, the
  ``highest`` bound of tests/test_torch_train_step.py.
"""

import importlib.util
from pathlib import Path

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
from rawaudiovae_kelsey_tpu_torch.infer import InferenceServer
from rawaudiovae_kelsey_tpu_torch.infer import api
from rawaudiovae_kelsey_tpu_torch.infer.export import make_forward_fn
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.models.registry import (
    tier_passes,
    under_tier,
)
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import (
    build_eval_step,
    build_train_step,
)
from rawaudiovae_kelsey_tpu_torch.train import TrainState

SEG, UNITS, LATENT = 128, 64, 16
BATCHES = [64, 37]
ATOL = RTOL = 2e-5
TANH_ULPS = 8
ENC = ("fc1", "fc21", "fc22")
DEC = ("fc3", "fc4")


def _smoke():
    """``chip_smoke.py`` of the repository root, as a module: it builds the
    operands on which the card holds the 3-pass forms bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(3), SEG, UNITS, LATENT))


def _weights(jparams, layers):
    return [np.asarray(jparams[n][k]) for n in layers for k in ("w", "b")]


def _both(arrays):
    """The same fp32 values for both packages."""
    ts = [torch.from_numpy(np.array(a, np.float32)) for a in arrays]
    return [jnp.asarray(t.numpy()) for t in ts], ts


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _rows(seed, *shapes, relu=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, s in enumerate(shapes):
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.maximum(a, 0) if k in relu else a)
    return out


def _ulps(got, want):
    a = _np(got).astype(np.float32).view(np.int32).astype(np.int64)
    b = _np(want).astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ------------------------------------------------------ random operands

@pytest.mark.parametrize("batch", BATCHES)
def test_encoder_fwd_three_pass_matches_jax_kernel(jparams, batch):
    js, ts = _both(_weights(jparams, ENC) + _rows(1, (batch, SEG)))
    with jax.default_matmul_precision("high"):
        want = jmlp.encoder_fwd(*js)
    got = mlp.encoder_fwd(*ts, passes=3)
    for g, w in zip(got, want):           # mu, logvar, h
        _close(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_decoder_fwd_three_pass_matches_jax_kernel(jparams, batch):
    js, ts = _both(_weights(jparams, DEC) + _rows(2, (batch, LATENT)))
    with jax.default_matmul_precision("high"):
        want = jmlp.decoder_fwd(*js)
    got = mlp.decoder_fwd(*ts, passes=3)
    for g, w in zip(got, want):           # y, h3
        _close(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_input_grad_three_pass_matches_jax_kernels(jparams, batch):
    """Row 6 (dh, two products joined and gated) then row 4 (dx = dh·W1ᵀ),
    each against its JAX kernel on the same inputs."""
    dmu, dlv, h = _rows(3, (batch, LATENT), (batch, LATENT),
                        (batch, UNITS), relu=(2,))
    w1, w21, w22 = (np.asarray(jparams[n]["w"]) for n in ENC)
    js, ts = _both([dmu, w21, dlv, w22, h])
    with jax.default_matmul_precision("high"):
        want_dh = jmlp.matmul_nt2_mask(*js)
    dh = mlp.matmul_nt2_mask(*ts, passes=3)
    assert dh.dtype == torch.float32
    _close(dh, want_dh)
    jdh, tdh = _both([_np(want_dh)])
    jw1, tw1 = _both([w1])
    with jax.default_matmul_precision("high"):
        want_dx = jmlp.matmul_nt(jdh[0], jw1[0])
    _close(mlp.matmul_nt(tdh[0], tw1[0], passes=3), want_dx)
    # the encoder's input gradient as encode_grads takes it
    _close(mlp.encode_input_grad(ts[4], ts[0], ts[2], tw1[0], ts[1], ts[3],
                                 passes=3), want_dx)


@pytest.mark.parametrize("batch", BATCHES)
def test_row_parallel_forms_three_pass_add_up_to_the_jax_kernels(jparams,
                                                                 batch):
    """The model-2 ``high`` forward: each rank's 3-pass partial form on its
    shards (fc1 / fc3 by columns, the heads / fc4 by rows), the two ranks'
    fp32 sums added, then the bias, the activation and one rounding, as
    ``parallel/tensor_parallel.py`` ``ShardedEncode`` / ``ShardedDecode``
    add them over the model group — against the JAX kernels on the whole
    weights."""
    w1, b1, w21, b21, w22, b22 = (torch.from_numpy(np.array(a)) for a in
                                  _weights(jparams, ENC))
    w3, b3, w4, b4 = (torch.from_numpy(np.array(a))
                      for a in _weights(jparams, DEC))
    (x,) = (torch.from_numpy(a) for a in _rows(4, (batch, SEG)))
    (z,) = (torch.from_numpy(a) for a in _rows(5, (batch, LATENT)))
    half = UNITS // 2
    parts = [mlp.encoder_fwd_partial(
        w1[:, s].contiguous(), b1[s].contiguous(), w21[s].contiguous(),
        w22[s].contiguous(), x, passes=3)
        for s in (slice(0, half), slice(half, UNITS))]
    mu = (parts[0][0] + parts[1][0]) + b21
    logvar = (parts[0][1] + parts[1][1]) + b22
    dparts = [mlp.decoder_fwd_partial(
        w3[:, s].contiguous(), b3[s].contiguous(), w4[s].contiguous(), z,
        passes=3) for s in (slice(0, half), slice(half, UNITS))]
    y = torch.tanh((dparts[0][0] + dparts[1][0]) + b4)
    with jax.default_matmul_precision("high"):
        jmu, jlv, jh = jmlp.encoder_fwd(*_both(
            _weights(jparams, ENC) + [x.numpy()])[0])
        jy, jh3 = jmlp.decoder_fwd(*_both(
            _weights(jparams, DEC) + [z.numpy()])[0])
    _close(mu, jmu)
    _close(logvar, jlv)
    _close(y, jy)
    _close(torch.cat([parts[0][2], parts[1][2]], 1), jh)
    _close(torch.cat([dparts[0][1], dparts[1][1]], 1), jh3)
    # one rank's partial sums plus the bias are the full form's outputs
    mu1, lv1, h1 = mlp.encoder_fwd(w1, b1, w21, b21, w22, b22, x, passes=3)
    pm, pl, ph = mlp.encoder_fwd_partial(w1, b1, w21, w22, x, passes=3)
    assert torch.equal(pm + b21, mu1) and torch.equal(pl + b22, lv1)
    assert torch.equal(ph, h1)
    y1, h31 = mlp.decoder_fwd(w3, b3, w4, b4, z, passes=3)
    py, ph3 = mlp.decoder_fwd_partial(w3, b3, w4, z, passes=3)
    assert torch.equal(torch.tanh(py + b4), y1) and torch.equal(ph3, h31)


# ----------------------------------------- one term a sum: bit for bit

def test_exact_forward_case_is_bit_for_bit_with_jax():
    """On ``chip_smoke.py`` 's built operands every product is one pair's
    three passes: the port's plain versions give the JAX kernels' bits (the
    card's kernels are held to the same plain versions there), and one
    fp32 pass moves many of them."""
    case = _smoke().exact_forward_case("cpu", 0, SEG, UNITS, LATENT)
    jx = {k: [jnp.asarray(t.numpy()) for t in v] for k, v in case.items()}
    with jax.default_matmul_precision("high"):
        jmu, jlv, jh = jmlp.encoder_fwd(*jx["encoder"])
        jy, jh3 = jmlp.decoder_fwd(*jx["decoder"])
        jdh = jmlp.matmul_nt2_mask(*jx["dh"])
        jdx = jmlp.matmul_nt(jdh, *jx["dx"])
    mu, lv, h = mlp.encoder_fwd(*case["encoder"], passes=3)
    y, h3 = mlp.decoder_fwd(*case["decoder"], passes=3)
    dh = mlp.matmul_nt2_mask(*case["dh"], passes=3)
    dx = mlp.matmul_nt(dh, *case["dx"], passes=3)
    for got, want in ((mu, jmu), (lv, jlv), (h, jh), (h3, jh3), (dh, jdh),
                      (dx, jdx)):
        np.testing.assert_array_equal(_np(got), _np(want))
        assert int((_np(want) != 0).sum()) > want.size // 4
    unsaturated = np.abs(_np(jy)) < 0.99
    assert unsaturated.mean() > 0.5
    assert int(_ulps(y, jy).max()) <= TANH_ULPS
    # the check has teeth: one pass moves h and mu, and y by more than the
    # tanh's own tolerance
    mu1, _, h1 = mlp.encoder_fwd(*case["encoder"])
    y1, _ = mlp.decoder_fwd(*case["decoder"])
    assert int((_np(h1) != _np(jh)).sum()) > h1.numel() // 10
    assert int((_np(mu1) != _np(jmu)).sum()) > mu1.numel() // 10
    assert int(_ulps(y1, jy)[unsaturated].max()) > 8 * TANH_ULPS


def test_the_ieee_forward_fails_the_three_pass_bound():
    """The fault this tier repairs: the forward the port ran under
    ``high`` before (one IEEE fp32 pass) is not JAX's function.  Rows with
    two terms that nearly cancel, x·w + x·(−w·(1 + 2^-7)): the 3-pass
    product drops lo·lo of each, ~2^-18 of a term, which does not cancel,
    so the IEEE sum is ~2^-11 of the result away; two terms are summed
    alike in any order, so the 3-pass plain version gives JAX's bits."""
    smoke = _smoke()
    g = torch.Generator().manual_seed(5)
    batch = 64
    x = torch.zeros((batch, SEG))
    # scaled by 2^6 (exactly): terms of 1 to 2^14, whose dropped lo·lo is
    # above the bound's absolute part
    x[:, 0] = x[:, 1] = smoke.split_probe_values(g, (batch,), "cpu") * 64
    w1 = torch.zeros((SEG, UNITS))
    w1[0] = smoke.split_probe_values(g, (UNITS,), "cpu")
    w1[1] = -w1[0] * (1 + 2.0 ** -7)
    b1 = torch.zeros(UNITS)
    heads = [torch.from_numpy(np.asarray(a)) for a in _rows(
        6, (UNITS, LATENT), (LATENT,), (UNITS, LATENT), (LATENT,))]
    args = (w1, b1, *heads, x)
    with jax.default_matmul_precision("high"):
        _, _, jh = jmlp.encoder_fwd(*(jnp.asarray(t.numpy()) for t in args))
    jh = _np(jh)
    _, _, h3 = mlp.encoder_fwd(*args, passes=3)
    _, _, h1 = mlp.encoder_fwd(*args)
    np.testing.assert_array_equal(_np(h3), jh)
    _close(h3, jh)
    bad = np.abs(_np(h1) - jh) > ATOL + RTOL * np.abs(jh)
    assert bad.sum() > (jh > 0).sum() // 2
    with pytest.raises(AssertionError):
        _close(h1, jh)


# ------------------------------------------------- where the tier reaches

def _cfg(precision, backend="pallas", micro=0, cls=Config):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = 64
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.learning_rate = 1e-3
    cfg.tpu.backend = backend
    cfg.tpu.precision = precision
    cfg.tpu.microbatch_size = micro
    return cfg


def test_the_tier_binds_three_passes_only_in_a_high_pallas_step():
    """``under_tier`` binds ``passes = 3`` for the dense model on the
    kernels under ``high`` and leaves every other tier, backend and family
    as ``build_model`` made it."""
    cfg = _cfg("high")
    model = build_model(cfg, "cpu")
    assert tier_passes(cfg, model) == 3
    bound = under_tier(model, cfg)
    assert bound.encode.keywords == {"mode": "full", "passes": 3}
    assert bound.decode.keywords == {"mode": "full", "passes": 3}
    # the ModelDef itself, which the server and the library path take,
    # keeps one pass
    assert model.encode.keywords == {"mode": "full"}
    for precision, backend, arch in (
            ("highest", "pallas", "dense"), ("float32", "pallas", "dense"),
            ("bfloat16", "pallas", "dense"), ("high", "xla", "dense"),
            ("high", "best", "dense"), ("high", "pallas", "deep")):
        cfg = _cfg(precision, backend)
        cfg.vae.arch = arch
        cfg.vae.hidden_dims = "32,16"
        model = build_model(cfg, "cpu")
        assert tier_passes(cfg, model) == 1
        assert under_tier(model, cfg) is model


@pytest.mark.parametrize("micro", [16, 0])
def test_high_pallas_train_step_matches_jax(micro, monkeypatch):
    """The ``high`` pallas step (dense, JAX's eps injected, 16-row
    microbatches and one full batch) against JAX's: the forward, the full
    chains and Adam on both sides in the 3-pass tier; three coupled
    steps."""
    seed = 5
    jcfg = _cfg("high", micro=micro, cls=JConfig)
    jmodel = jbuild_model(jcfg)
    opt = jbuild_opt(jcfg)
    p = jmodel.init(jax.random.PRNGKey(seed))
    jstate = JState.create(p, opt.init(p), seed=seed)
    jstep = jbuild_step(jmodel, jcfg, opt, donate=False)

    def jax_eps(step, i, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        if i is not None:
            key = jax.random.fold_in(key, i)
        return torch.from_numpy(np.array(
            jax.random.normal(key, shape, dtype=jnp.float32)))

    cfg = _cfg("high", micro=micro)
    step = build_train_step(build_model(cfg, "cpu"), cfg, noise=jax_eps)
    state = TrainState.create(params_from_jax(jax.device_get(p)), seed)
    calls = []
    real = mlp.encoder_fwd_ref

    def spy(*a, **kw):
        calls.append(a[-1] if len(a) == 8 else kw.get("passes", 1))
        return real(*a, **kw)

    monkeypatch.setattr(mlp, "encoder_fwd_ref", spy)
    for k in range(3):
        x = np.random.default_rng(20 + k).uniform(
            -1, 1, (48, SEG)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, torch.from_numpy(x))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
        for name in sorted(state.params):
            for key in ("b", "w"):
                np.testing.assert_allclose(
                    state.params[name][key].numpy(),
                    np.asarray(jstate.params[name][key]), atol=1e-5, rtol=0)
    assert calls and set(calls) == {3}


def test_high_eval_step_runs_three_passes():
    """The eval step runs the forward under the tier too (JAX's eval step
    is traced in its scope): its reconstruction at z = mu is the 3-pass
    forward's, not the one-pass one's."""
    cfg = _cfg("high")
    cfg.tpu.deterministic_inference = True
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rows(7, (37, SEG))[0])
    got = build_eval_step(model, cfg)(params, None, x)
    enc = [params[n][k] for n in ENC for k in ("w", "b")]
    dec = [params[n][k] for n in DEC for k in ("w", "b")]
    mu3, _, _ = mlp.encoder_fwd_ref(*enc, x, passes=3)
    mu1, _, _ = mlp.encoder_fwd_ref(*enc, x)
    assert torch.equal(got, mlp.decoder_fwd_ref(*dec, mu3, passes=3)[0])
    assert not torch.equal(got, mlp.decoder_fwd_ref(*dec, mu1)[0])


def test_serving_and_the_library_keep_one_pass_under_high(monkeypatch):
    """JAX's server, ``infer/api.py`` and export run outside any precision
    scope, so a ``high`` config serves the one-pass forward: the same bits
    as the ``highest`` config's, and no call asks for three passes."""
    asked = []
    for name in ("encoder_fwd", "decoder_fwd"):
        real = getattr(mlp, name)

        def spy(*a, _real=real, **kw):
            asked.append(kw.get("passes", 1))
            return _real(*a, **kw)

        monkeypatch.setattr(mlp, name, spy)
    frames = _rows(8, (40, SEG))[0]
    audio = frames.reshape(-1)
    out = {}
    for precision in ("high", "highest"):
        model = build_model(_cfg(precision), "cpu")
        params = model.init(torch.Generator().manual_seed(1))
        mu, logvar = api.encode_trajectory(model, params, frames)
        y = api.decode_trajectory(model, params, mu)
        with InferenceServer(model, params, batch_size=16,
                             deterministic=True) as server:
            rec = server.reconstruct(audio).result(timeout=120)
        fwd = make_forward_fn(model, deterministic=True)
        exported = fwd(params, torch.from_numpy(frames))
        out[precision] = (mu, logvar, y, np.asarray(rec),
                          *(t.detach().numpy() for t in exported))
    assert asked and set(asked) == {1}
    for a, b in zip(out["high"], out["highest"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["float32", "highest", "bfloat16"])
def test_other_tiers_keep_their_forward_bit_for_bit(precision):
    """``float32``, ``highest`` and ``bfloat16`` run the forward they ran
    before the ``high`` tier had its 3-pass form: the one-pass arithmetic,
    written out here as it stood, in the step and outside it."""
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    cfg = _cfg(precision)
    model = build_model(cfg, "cpu")
    assert under_tier(model, cfg) is model
    params = model.init(torch.Generator().manual_seed(2))
    p = {n: {k: t.to(dt) for k, t in q.items()} for n, q in params.items()}
    x = torch.from_numpy(_rows(9, (37, SEG))[0]).to(dt)

    def f(t):
        return t.to(torch.float32)

    h = torch.relu(f(x) @ f(p["fc1"]["w"]) + f(p["fc1"]["b"])).to(dt)
    mu = (f(h) @ f(p["fc21"]["w"]) + f(p["fc21"]["b"])).to(dt)
    lv = (f(h) @ f(p["fc22"]["w"]) + f(p["fc22"]["b"])).to(dt)
    h3 = torch.relu(f(mu) @ f(p["fc3"]["w"]) + f(p["fc3"]["b"])).to(dt)
    y = torch.tanh(f(h3) @ f(p["fc4"]["w"]) + f(p["fc4"]["b"])).to(dt)
    gmu, glv = model.encode(p, x)
    assert torch.equal(gmu, mu) and torch.equal(glv, lv)
    assert torch.equal(model.decode(p, mu), y)


def test_three_passes_need_fp32_operands():
    x = torch.zeros((4, SEG), dtype=torch.bfloat16)
    w = torch.zeros((SEG, UNITS), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="passes"):
        mlp.matmul_nt(x, w.t().contiguous(), passes=3)
    with pytest.raises(ValueError, match="passes"):
        mlp.encoder_fwd_ref(w, w[0], w[:, :LATENT], w[0, :LATENT],
                            w[:, :LATENT], w[0, :LATENT], x, passes=3)
    with pytest.raises(ValueError, match="passes"):
        mlp.decoder_fwd(*(torch.zeros(s) for s in (
            (LATENT, UNITS), (UNITS,), (UNITS, SEG), (SEG,), (4, LATENT))),
            passes=2)


# ----------------------------------- what reaches the C entry points (meta)

SMS = 132
DENSE = (1024, 2048, 256)       # seg, units, latent
F32 = torch.float32


def _stand_in(monkeypatch, aligned=True):
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned",
                        lambda *t: aligned)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    monkeypatch.setattr(mlp._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _meta(*shapes):
    return [torch.empty(s, device="meta", dtype=F32) for s in shapes]


def _encoder_operands(batch, seg, units, latent):
    return _meta((seg, units), (units,), (units, latent), (latent,),
                 (units, latent), (latent,), (batch, seg))


def _decoder_operands(batch, seg, units, latent):
    return _meta((latent, units), (units,), (units, seg), (seg,),
                 (batch, latent))


def _tile(rows, n, outputs=1):
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    return tensor_cores.tile_n(outputs * -(-rows // 128), n, SMS,
                               tensor_cores.SPLIT_WIDTHS)


@pytest.mark.parametrize("batch", [8192, 4096, 4097])
def test_the_three_pass_encoder_takes_the_tensor_cores(monkeypatch, batch):
    """Dense widths: ``rvk_encoder_fwd3`` with code 1, the halves of x, W1,
    W21, W22 and h in one bf16 scratch, the tiles of the 3-pass widths (the
    heads two outputs of one walk); counted in ``split_launches``, never in
    ``sgemm_launches``; the partial form passes no head biases."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    launched = _stand_in(monkeypatch)
    seg, units, latent = DENSE
    f = mlp.encoder_fwd
    before = (f.launches, f.split_launches, f.sgemm_launches,
              f.tensor_core_launches, f.partial_launches)
    mu, logvar, h = mlp.encoder_fwd(*_encoder_operands(batch, *DENSE),
                                    passes=3)
    assert mu.dtype == logvar.dtype == h.dtype == F32
    name, args = launched.pop()
    assert name == "rvk_encoder_fwd3" and len(args) == 18
    assert args[11:] == (batch, seg, units, latent, _tile(batch, units),
                         _tile(batch, latent, 2),
                         tensor_cores.TENSOR_CORES)
    splits = args[10]
    assert splits.dtype == torch.bfloat16 and splits.shape == (2 * (
        batch * seg + seg * units + 2 * units * latent + batch * units),)
    mlp.encoder_fwd_partial(*_encoder_operands(batch, *DENSE)[:3],
                            *_encoder_operands(batch, *DENSE)[4:5],
                            _encoder_operands(batch, *DENSE)[6], passes=3)
    name, args = launched.pop()
    assert name == "rvk_encoder_fwd3" and args[4] is None and args[6] is None
    assert (f.launches, f.split_launches, f.sgemm_launches,
            f.tensor_core_launches, f.partial_launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3], before[4] + 1)


def test_the_three_pass_decoder_and_input_gradient_take_the_tensor_cores(
        monkeypatch):
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    launched = _stand_in(monkeypatch)
    seg, units, latent = DENSE
    batch = 8192
    tc = tensor_cores.TENSOR_CORES
    mlp.decoder_fwd(*_decoder_operands(batch, *DENSE), passes=3)
    name, args = launched.pop()
    assert name == "rvk_decoder_fwd3" and len(args) == 15
    assert args[8:] == (batch, latent, units, seg, _tile(batch, units),
                        _tile(batch, seg), tc)
    assert args[7].shape == (2 * (batch * latent + latent * units
                                  + units * seg + batch * units),)
    ops = _decoder_operands(batch, *DENSE)
    mlp.decoder_fwd_partial(*ops[:3], ops[4], passes=3)
    name, args = launched.pop()
    assert name == "rvk_decoder_fwd3" and args[4] is None
    # dh = where(h > 0, dmu·W21ᵀ + dlv·W22ᵀ, 0), then dx = dh·W1ᵀ
    dmu, w21, dlv, w22, h, w1 = _meta((batch, latent), (units, latent),
                                      (batch, latent), (units, latent),
                                      (batch, units), (seg, units))
    dh = mlp.matmul_nt2_mask(dmu, w21, dlv, w22, h, passes=3)
    name, args = launched.pop()
    assert name == "rvk_matmul_nt2_mask3" and len(args) == 12
    assert args[7:] == (batch, latent, units, _tile(batch, units), tc)
    assert args[6].shape == (2 * 2 * (batch * latent + units * latent),)
    assert dh.dtype == F32 and dh.shape == (batch, units)
    dx = mlp.matmul_nt(dh, w1, passes=3)
    name, args = launched.pop()
    assert name == "rvk_matmul_nt3" and len(args) == 9
    assert args[4:] == (batch, units, seg, _tile(batch, seg), tc)
    assert args[3].shape == (2 * (batch * units + seg * units),)
    assert dx.shape == (batch, seg)


@pytest.mark.parametrize("widths,aligned", [
    ((1020, 2048, 256), True), ((1024, 2044, 256), True),
    ((1024, 2048, 252), True), (DENSE, False)],
    ids=["seg", "units", "latent", "unaligned"])
def test_what_the_tensor_cores_cannot_take_runs_the_three_pass_first_version(
        monkeypatch, widths, aligned):
    """Widths no multiple of 8 and unaligned views take the first version's
    3-pass mode (code 0, no scratch): never the IEEE fp32 kernel.  Naming
    the tensor cores there, or the IEEE kernel anywhere, raises."""
    launched = _stand_in(monkeypatch, aligned)
    seg, units, latent = widths
    f = mlp.encoder_fwd
    before = (f.split_launches, f.sgemm_launches)
    mlp.encoder_fwd(*_encoder_operands(300, *widths), passes=3)
    name, args = launched.pop()
    assert name == "rvk_encoder_fwd3" and args[10] is None
    assert args[-3:] == (0, 0, 0)
    assert (f.split_launches, f.sgemm_launches) == before
    mlp.decoder_fwd(*_decoder_operands(300, *widths), passes=3)
    assert launched.pop()[1][-1] == 0
    with pytest.raises(ValueError, match="tensor_cores"):
        mlp.encoder_fwd(*_encoder_operands(300, *widths),
                        kernel="tensor_cores", passes=3)
    for kernel in ("sgemm", "narrow"):
        with pytest.raises(ValueError, match=kernel):
            mlp.encoder_fwd(*_encoder_operands(300, *DENSE), kernel=kernel,
                            passes=3)
    with pytest.raises(ValueError, match="sgemm"):
        mlp.matmul_nt(*_meta((300, 256), (1024, 256)), kernel="sgemm",
                      passes=3)
    # an empty batch launches nothing
    mlp.matmul_nt(*_meta((0, 256), (1024, 256)), passes=3)
    assert not launched


def test_the_three_pass_entry_points_never_reach_the_ieee_kernel():
    """The sources: the 3-pass C entry points launch full.cu's chains (code
    1) or gemm.cuh's 3-pass mode (code 0), and none names sgemm.cuh."""
    import re

    from rawaudiovae_kelsey_tpu_torch.ops import _build

    p, i = _build._P, _build._I
    assert _build._SIGNATURES["rvk_encoder_fwd3"] == [p] * 11 + [i] * 7 + [p]
    assert _build._SIGNATURES["rvk_decoder_fwd3"] == [p] * 8 + [i] * 7 + [p]
    assert _build._SIGNATURES["rvk_matmul_nt3"] == [p] * 4 + [i] * 5 + [p]
    assert _build._SIGNATURES["rvk_matmul_nt2_mask3"] == (
        [p] * 7 + [i] * 5 + [p])
    for src, names, chain in (
            ("mlp.cu", ("rvk_encoder_fwd3", "rvk_decoder_fwd3"),
             ("encoder_split", "decoder_split")),
            ("bwd.cu", ("rvk_matmul_nt3", "rvk_matmul_nt2_mask3"),
             ("matmul_nt_split",))):
        text = (_build.CSRC / src).read_text()
        for name in names:
            body = re.search(rf"^int {name}\(.*?^}}", text,
                             re.M | re.S).group(0)
            assert "sgemm" not in body and ", 3>(" in body, name
            assert any(c in body for c in chain), name
            assert "void* splits" in body
    full = (_build.CSRC / "full.cu").read_text()
    for chain in ("encoder_split", "decoder_split", "matmul_nt_split"):
        assert re.search(rf"^cudaError_t {chain}\(", full, re.M)
    assert "launch_split_fwd<tc::HeadsTiles, kActNone>" in full

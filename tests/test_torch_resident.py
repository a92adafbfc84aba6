"""The port's device-resident epoch engine (rawaudiovae_kelsey_tpu_torch/
parallel/resident.py, train/epoch.py ``_run_resident``) and the fp32
"primitive" backward (ops/mlp.py ``matmul_nt``, ``matmul_nt_mask``,
``matmul_nt2_mask`` — queue B rows 4-6) on the CPU, each against the JAX
package on the same numpy inputs.

On the CPU the JAX side runs its Pallas kernels in interpret mode and the
port's wrappers run their plain versions, because the tensors lie on the
CPU.  The two packages draw neither their noise nor their epoch
permutations from the same generator, so the tests compute JAX's — ``eps``
from ``fold_in(PRNGKey(seed), step)``, the permutation of epoch ``e`` from
``fold_in(fold_in(PRNGKey(seed), 0x5EED), e)`` — and inject them into the
port (``noise=``, ``perm=``).

Tolerances:
* kernels, fp32: ``atol = rtol = 1e-5`` (the same fp32 products, summed
  in another order); bf16: ``2^-6 · max|want|`` (one flipped bf16 ulp is
  2^-8 relative; a fault shows as O(max|want|));
* epochs at ``highest``: losses rel 1e-5 and params atol 1e-5 per the
  one-step bound of tests/test_torch_train_step.py, which still holds
  over the 57 coupled steps of three epochs (lr 1e-3: the fp32
  differences compound slowly);
* trainer histories across packages: rel 1e-4, as in
  tests/test_torch_train_e2e.py.
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
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu.parallel import resident as JR
from rawaudiovae_kelsey_tpu.parallel.step import make_loss_fn as jmake_loss_fn
from rawaudiovae_kelsey_tpu.train import TrainState as JState
from rawaudiovae_kelsey_tpu.train import build_optimizer as jbuild_opt
from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config, load_config
from rawaudiovae_kelsey_tpu_torch.io import read_wav, write_wav
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import make_loss_fn
from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
from rawaudiovae_kelsey_tpu_torch.train import TrainState, restore_checkpoint

SEG, HOP, UNITS, LATENT, BATCH, SEED, LR = 64, 32, 32, 8, 64, 3, 1e-3
BATCHES = [256, 100, 1]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = RTOL = 1e-5


# ------------------------------------------------------------ rows 4, 5, 6

def _arrays(seed, *shapes, relu=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, s in enumerate(shapes):
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.maximum(a, 0) if k in relu else a)
    return out


def _both(arrays, dtype):
    """The same values for both packages in ``dtype``: rounded once, by
    PyTorch, and handed to JAX as float32 that JAX casts exactly."""
    jdt, tdt = DTYPES[dtype]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in arrays]
    js = [jnp.asarray(t.to(torch.float32).numpy()).astype(jdt) for t in ts]
    return js, ts


def _check(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == DTYPES[dtype][1]
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    if dtype == "bf16":
        tol = 2.0 ** -6 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_matmul_nt_matches_jax_kernel(dtype, batch):
    js, ts = _both(_arrays(1, (batch, UNITS), (SEG, UNITS)), dtype)
    _check(mlp.matmul_nt(*ts), jmlp.matmul_nt(*js), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_matmul_nt_mask_matches_jax_kernel(dtype, batch):
    js, ts = _both(_arrays(2, (batch, SEG), (UNITS, SEG), (batch, UNITS),
                           relu=(2,)), dtype)
    _check(mlp.matmul_nt_mask(*ts), jmlp.matmul_nt_mask(*js), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_matmul_nt2_mask_matches_jax_kernel(dtype, batch):
    js, ts = _both(_arrays(3, (batch, LATENT), (UNITS, LATENT),
                           (batch, LATENT), (UNITS, LATENT), (batch, UNITS),
                           relu=(4,)), dtype)
    _check(mlp.matmul_nt2_mask(*ts), jmlp.matmul_nt2_mask(*js), dtype)


def test_gate_compares_in_fp32_and_zeroes_nonpositive_entries():
    a, w = (torch.from_numpy(x) for x in _arrays(4, (5, 7), (3, 7)))
    gate = torch.tensor([[1.0, 0.0, -1.0]] * 5)
    out = mlp.matmul_nt_mask(a, w, gate)
    assert torch.equal(out[:, 0], (a @ w.t())[:, 0])
    assert not out[:, 1:].any()
    tiny = torch.full((5, 3), 1e-30).to(torch.bfloat16)   # > 0 in bf16 too
    assert mlp.matmul_nt_mask(a.bfloat16(), w.bfloat16(), tiny).any()


@pytest.mark.parametrize("op,nargs", [("matmul_nt", 2), ("matmul_nt_mask", 3),
                                      ("matmul_nt2_mask", 5)])
def test_new_wrappers_refuse_tensors_off_cpu_and_cuda(op, nargs):
    t = torch.empty((8, 8), device="meta")
    before = getattr(mlp, op).launches
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mlp, op)(*[t] * nargs)
    getattr(mlp, op)(*[torch.zeros((8, 8))] * nargs)      # CPU: plain
    assert getattr(mlp, op).launches == before


# ------------------------------------------------- the primitive backward

@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT))


@pytest.mark.parametrize("batch", [100, 1])
def test_primitive_backward_matches_jax_grad_at_highest(jparams, batch):
    """``jax.grad`` of ``pallas_encode`` / ``pallas_decode`` at ``highest``
    takes the primitive composition (``pallas_mlp.py:996-1009``); the
    port's "primitive" mode gives the same weight, ``dx`` and ``dz``
    gradients."""
    x, z, dmu, dlv, dy = _arrays(6, (batch, SEG), (batch, LATENT),
                                 (batch, LATENT), (batch, LATENT),
                                 (batch, SEG))

    def jloss(p, xx, zz):
        mu, lv = jmlp.pallas_encode(p, xx)
        y = jmlp.pallas_decode(p, zz)
        return (mu * dmu).sum() + (lv * dlv).sum() + (y * dy).sum()

    assert jmlp._fusion(jnp.float32) == "primitive"
    with jax.default_matmul_precision("highest"):
        gp, gx, gz = jax.grad(jloss, argnums=(0, 1, 2))(
            jparams, jnp.asarray(x), jnp.asarray(z))

    p = params_from_jax(jparams)
    leaves = {n: {k: t.clone().requires_grad_() for k, t in q.items()}
              for n, q in p.items()}
    xx = torch.from_numpy(x).requires_grad_()
    zz = torch.from_numpy(z).requires_grad_()
    mu, lv = ops.encode(leaves, xx, mode="primitive")
    y = ops.decode(leaves, zz, mode="primitive")
    ((mu * torch.from_numpy(dmu)).sum() + (lv * torch.from_numpy(dlv)).sum()
     + (y * torch.from_numpy(dy)).sum()).backward()
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(gx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(zz.grad.numpy(), np.asarray(gz), atol=ATOL,
                               rtol=RTOL)
    for n in p:
        for k in p[n]:
            np.testing.assert_allclose(leaves[n][k].grad.numpy(),
                                       np.asarray(gp[n][k]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{n}.{k}")


def test_primitive_and_split_agree_in_fp32(jparams):
    """In fp32 ``dh`` / ``dh3`` are not rounded, so the two modes differ
    only in summation order."""
    p = params_from_jax(jparams)
    x, z = (torch.from_numpy(a) for a in _arrays(7, (50, SEG), (50, LATENT)))
    grads = {}
    for mode in mlp.BACKWARD_MODES:
        leaves = {n: {k: t.clone().requires_grad_() for k, t in q.items()}
                  for n, q in p.items()}
        xx = x.clone().requires_grad_()
        mu, lv = ops.encode(leaves, xx, mode=mode)
        y = ops.decode(leaves, z, mode=mode)
        (mu.sum() + lv.square().sum() + y.square().sum()).backward()
        grads[mode] = [xx.grad] + [leaves[n][k].grad for n in sorted(p)
                                   for k in sorted(p[n])]
    for a, b in zip(grads["primitive"], grads["split"]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_backward_mode_follows_the_jax_rule(monkeypatch):
    # the switch's "auto" (ops/mlp.py fusion, pallas_mlp.py _fusion)
    assert mlp.BWD_FUSION == "auto"
    assert mlp.fusion(torch.float32) == "primitive"
    assert mlp.fusion(torch.float32, 3) == "full"
    assert mlp.fusion(torch.bfloat16) == "split"
    # a forced mode holds for every dtype
    monkeypatch.setattr(mlp, "BWD_FUSION", "split")
    assert mlp.fusion(torch.float32) == "split"
    monkeypatch.setattr(mlp, "BWD_FUSION", "fused")
    with pytest.raises(ValueError, match="backward mode"):
        mlp.fusion(torch.float32)
    monkeypatch.setattr(mlp, "BWD_FUSION", "auto")
    cfg = Config()
    cfg.tpu.backend = "pallas"
    for precision, want in (("float32", "primitive"), ("highest",
                            "primitive"), ("high", "full"),
                            ("bfloat16", "split")):
        cfg.tpu.precision = precision
        model = build_model(cfg, "cpu")
        assert model.encode.keywords == {"mode": want}
        assert model.decode.keywords == {"mode": want}


# ------------------------------------------------------ layout and blocks

def test_choose_layout_equals_jax_over_a_grid():
    n = 0
    for n_samples in (0, 100, 1023, 1024, 5000, 40_000, 10 ** 6, 10 ** 8):
        for seg, hop in ((1024, 128), (64, 32), (512, 512)):
            for dtype_bytes in (2, 4):
                for budget in (0, 10 ** 3, 10 ** 5, 10 ** 7, 4 << 30):
                    args = (n_samples, seg, hop, dtype_bytes, budget)
                    assert R.choose_layout(*args) == JR.choose_layout(*args)
                    n += 1
    assert n == 240
    assert R.choose_layout(40_000, 64, 32, 4, 10 ** 6) == "frames"
    assert R.choose_layout(40_000, 64, 32, 4, 2 * 10 ** 5) == "corpus"
    assert R.choose_layout(40_000, 64, 32, 4, 10 ** 5) is None


def test_pick_block_rows_equals_jax_over_a_grid():
    seen = set()
    for n_frames in (10, 64, 100, 1249, 4096, 156_882, 10 ** 6):
        for batch in (32, 48, 64, 96, 512, 4096, 131_072):
            n_batches = n_frames // batch
            got = R.pick_block_rows(n_frames, n_batches, batch)
            assert got == JR.pick_block_rows(n_frames, n_batches, batch)
            seen.add(got)
    assert {1, 32}.issubset(seen)


# ------------------------------------------------------------- run_epochs

def _cfg(cls, precision="highest", shuffle="global", backend="xla"):
    cfg = cls()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.batch_size = BATCH
    cfg.training.learning_rate = LR
    cfg.tpu.precision = precision
    cfg.tpu.backend = backend
    cfg.tpu.resident_shuffle = shuffle
    cfg.tpu.seed = SEED
    return cfg


def _corpus():
    rng = np.random.default_rng(3)
    return (0.4 * np.sin(np.arange(40_000) / 30.0)
            + 0.05 * rng.standard_normal(40_000)).astype(np.float32)


def jax_eps(step, i, shape, seed=SEED):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, dtype=jnp.float32)))


def jax_perm(epoch, n, seed=SEED):
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED), epoch)
    return torch.from_numpy(np.array(jax.random.permutation(key, n))).long()


def _port_state(jp):
    return TrainState.create(params_from_jax(jax.device_get(jp)), SEED)


@pytest.mark.parametrize("layout,shuffle", [("frames", "global"),
                                            ("corpus", "global"),
                                            ("frames", "block")])
def test_run_epochs_matches_jax_resident_epoch(layout, shuffle):
    corpus = _corpus()
    jcfg = _cfg(JConfig, shuffle=shuffle)
    jmodel, opt = jbuild_model(jcfg), jbuild_opt(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(SEED))
    jstate = JState.create(jp, opt.init(jp), seed=SEED)
    jp = jax.device_get(jp)     # run_epochs donates the state's buffers
    jrun, jn = JR.build_resident_epoch(jmodel, jcfg, opt, len(corpus),
                                       layout=layout, group_k=3)
    jdata = JR.put_resident(corpus, jcfg, layout)
    jstate, jlosses = jrun(jstate, jdata, 0, k=3)
    jlosses = np.asarray(jax.device_get(jlosses))

    cfg = _cfg(Config, shuffle=shuffle, backend="pallas")
    model = build_model(cfg, "cpu")
    run, n_batches = R.build_resident_epoch(
        model, cfg, None, len(corpus), layout=layout, noise=jax_eps,
        perm=jax_perm)
    data = R.put_resident(corpus, cfg, layout, "cpu")
    assert n_batches == jn == 19
    assert tuple(data.shape) == tuple(jdata.shape)
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))

    state, losses = run(_port_state(jp), data, 0, k=3)
    assert losses.shape == (3, n_batches) and losses.dtype == torch.float32
    assert state.step == 3 * n_batches
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5, atol=0)
    want = jax.device_get(jstate.params)
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(state.params[n][k].numpy(),
                                       np.asarray(want[n][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{n}.{k}")

    # k = 3 equals three calls of k = 1
    s1 = _port_state(jp)
    rows = []
    for epoch in range(3):
        s1, row = run(s1, data, epoch)
        assert row.shape == (1, n_batches)
        rows.append(row[0])
    assert torch.equal(torch.stack(rows), losses)
    for n in state.params:
        for k in state.params[n]:
            assert torch.equal(s1.params[n][k], state.params[n][k])


def test_block_shuffle_draws_whole_blocks_and_drops_the_tail():
    cfg = _cfg(Config, shuffle="block")
    corpus = _corpus()
    model = build_model(cfg, "cpu")
    seen = []

    def spy_noise(step, i, shape):
        return torch.zeros(shape)

    run, n_batches = R.build_resident_epoch(
        model, cfg, None, len(corpus), layout="frames", noise=spy_noise,
        perm=lambda e, n: seen.append(n) or torch.arange(n))
    data = R.put_resident(corpus, cfg, "frames", "cpu")
    n_frames = data.shape[0]
    blk = R.pick_block_rows(n_frames, n_batches, BATCH)
    assert blk == 32 and n_frames == 1249
    run(_port_state(jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS,
                                    LATENT)), data, 0)
    assert seen == [n_frames // blk]      # shuffle units are whole blocks


def test_seeded_permutations_replay_and_differ_by_epoch():
    cfg = _cfg(Config)
    corpus = _corpus()
    model = build_model(cfg, "cpu")
    run, _ = R.build_resident_epoch(model, cfg, None, len(corpus))
    data = R.put_resident(corpus, cfg, "frames", "cpu")
    jp = jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT)
    _, a = run(_port_state(jp), data, 4)
    _, b = run(_port_state(jp), data, 4)
    _, c = run(_port_state(jp), data, 5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert R.perm_seed(SEED, 1) != R.perm_seed(SEED, 2)
    assert R.perm_seed(SEED, 1) != R.perm_seed(SEED + 1, 1)
    assert 0 <= R.perm_seed(2 ** 63, 2 ** 40) < 2 ** 63


def test_resident_builder_refuses_what_it_cannot_run():
    cfg = _cfg(Config)
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="frames < one batch"):
        R.build_resident_epoch(model, cfg, None, 500)
    cfg.tpu.microbatch_size = 16
    with pytest.raises(ValueError, match="microbatch"):
        R.build_resident_epoch(model, cfg, None, 40_000)
    cfg.audio.hop_length = 48
    with pytest.raises(ValueError, match="multiple of hop"):
        R.put_resident(_corpus(), cfg, "frames", "cpu")


def test_bf16_resident_batch_is_the_loss_target():
    """With ``precision = bfloat16`` the resident corpus is bf16 and the
    loss compares the reconstruction with that ROUNDED batch (JAX
    ``step.py:86-102``); the host-fed loop with ``feed_dtype = float32``
    compares with the unrounded one."""
    corpus = _corpus()
    cfg = _cfg(Config, precision="bfloat16")
    data = R.put_resident(corpus, cfg, "frames", "cpu")
    assert data.dtype == torch.bfloat16
    jdata = JR.put_resident(corpus, _cfg(JConfig, precision="bfloat16"),
                            "frames")
    np.testing.assert_array_equal(data.float().numpy(),
                                  np.asarray(jdata.astype(jnp.float32)))

    model = build_model(cfg, "cpu")
    jp = jvae.init_dense(jax.random.PRNGKey(1), SEG, UNITS, LATENT)
    params = params_from_jax(jax.device_get(jp))
    eps = jax_eps(0, None, (BATCH, LATENT))
    rounded = data[:BATCH]
    exact = torch.from_numpy(np.lib.stride_tricks.sliding_window_view(
        corpus, SEG)[::HOP][:BATCH].copy())
    assert torch.equal(exact.bfloat16(), rounded)
    loss_fn = make_loss_fn(model, cfg)
    l_rounded, (mse_r, _) = loss_fn(params, eps, rounded)
    l_exact, (mse_e, _) = loss_fn(params, eps, exact)
    assert float(mse_r) != float(mse_e)

    # the same forward by hand, target = the rounded batch in fp32
    cp = {n: {k: t.bfloat16() for k, t in q.items()}
          for n, q in params.items()}
    mu, lv = vae.encode(cp, rounded)
    z = vae.reparameterize(mu.float(), lv.float(), eps=eps).bfloat16()
    recon = vae.decode(cp, z).float()
    assert float(mse_r) == float(torch.mean((recon - rounded.float()) ** 2))

    # and the JAX step's loss on its bf16 resident batch
    jcfg = _cfg(JConfig, precision="bfloat16")
    jloss = jmake_loss_fn(jbuild_model(jcfg), jcfg)
    jl, _ = jloss(jp, jax.random.fold_in(jax.random.PRNGKey(SEED), 0),
                  jdata[:BATCH])
    assert float(l_rounded) == pytest.approx(float(jl), rel=1e-3)


def test_tpu_prng_step_draws_from_the_sampler():
    """``rng = tpu_prng``: the step's noise is the sampler's, keyed by both
    words of ``noise_seed(seed, step)``; ``noise=`` does not apply."""
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        noise_seed,
    )

    cfg = _cfg(Config, backend="pallas")
    cfg.tpu.rng = "tpu_prng"
    model = build_model(cfg, "cpu")
    jp = jvae.init_dense(jax.random.PRNGKey(2), SEG, UNITS, LATENT)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (BATCH, SEG)).astype(np.float32))

    def boom(*a):
        raise AssertionError("noise= must not be called under tpu_prng")

    state, m = build_train_step(model, cfg, noise=boom)(_port_state(jp), x)

    cfg.tpu.rng = "threefry"
    words = rng.seed_words(noise_seed(SEED, 0))
    assert words[1] != 0
    eps = rng.eps_ref(words, BATCH, LATENT)
    state2, m2 = build_train_step(
        build_model(cfg, "cpu"), cfg,
        noise=lambda s, i, shape: eps)(_port_state(jp), x)
    assert float(m["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    for n in state.params:
        for k in state.params[n]:
            torch.testing.assert_close(state.params[n][k],
                                       state2.params[n][k], atol=1e-6,
                                       rtol=0)


# ------------------------------------------------- the trainer, end to end

E_SEG, E_HOP, E_UNITS, E_LATENT, E_BATCH, E_SEED = 512, 128, 64, 16, 32, 0


@pytest.fixture
def scratch_dataset(tmp_path):
    """80 training frames (10624 samples), 6000 test samples."""
    rng = np.random.default_rng(7)
    (tmp_path / "audio").mkdir()
    (tmp_path / "test_audio").mkdir()
    for i, n in enumerate((3000, 3500, 4124)):
        wave = (0.5 * np.sin(np.linspace(0, 50 * (i + 1), n))
                ).astype(np.float32)
        write_wav(tmp_path / "audio" / f"train{i}.wav", wave, 44100)
    for i in range(2):
        wave = rng.uniform(-0.3, 0.3, 3000).astype(np.float32)
        write_wav(tmp_path / "test_audio" / f"test{i}.wav", wave, 44100)
    return tmp_path


def small_cfg(cfg, tmp_path, epochs=5, interval=2, description="res"):
    cfg.dataset.datapath = str(tmp_path)
    cfg.audio.segment_length = E_SEG
    cfg.audio.hop_length = E_HOP
    cfg.vae.n_units = E_UNITS
    cfg.vae.latent_dim = E_LATENT
    cfg.training.batch_size = E_BATCH
    cfg.training.epochs = epochs
    cfg.training.checkpoint_interval = interval
    cfg.training.save_best_model_after = 0
    cfg.training.learning_rate = 1e-3
    cfg.extra.description = description
    cfg.tpu.seed = E_SEED
    cfg.tpu.device_resident = "always"
    return cfg


def port_train(cfg):
    from rawaudiovae_kelsey_tpu_torch.train.epoch import train

    return train(cfg, verbose=False, device="cpu")


def jax_train(cfg):
    from rawaudiovae_kelsey_tpu.train.epoch import train

    return train(cfg, verbose=False)


def batch_losses(log_dir):
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    out = {}
    for f in sorted(log_dir.glob("events.out.tfevents.*")):
        for e in loader.LegacyEventFileLoader(str(f)).Load():
            for v in e.summary.value:
                if v.tag == "Loss/Batch":
                    out[e.step] = v.simple_value
    return out


def _same_params(a, b):
    for n in a:
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), f"{n}.{k}"


def test_resident_trainer_full_contract(scratch_dataset, capsys):
    cfg = small_cfg(Config(), scratch_dataset)
    cfg.tpu.rng = "tpu_prng"
    cfg.tpu.resident_shuffle = "block"
    ctx = port_train(cfg)
    ws = ctx.workspace
    out = capsys.readouterr().out
    assert "Device-resident corpus (frames layout)" in out
    assert "[drain] 3 epochs in" in out and "[drain] 2 epochs in" in out
    assert "====> Resident epochs e2e: 5 epochs in" in out
    assert "====> Epoch: 4 " in out

    snap = load_config(ws.config_path)
    assert snap.dataset.workspace == str(ws.workdir.resolve())
    assert snap.extra.start and snap.extra.end
    orig, sr = read_wav(ws.audio_log_dir / "test_original.wav")
    assert sr == 44100 and len(orig) == 6000
    names = [r.name for r in sorted(ws.audio_log_dir.glob("test_reconst_*"))]
    assert names == ["test_reconst_00002.wav", "test_reconst_00004.wav",
                     "test_reconst_00005.wav"]
    assert sorted(p.name for p in ws.checkpoint_dir.glob("ckpt_*.npz")) == [
        "ckpt_00002.npz", "ckpt_00004.npz", "ckpt_00005.npz"]
    assert (ws.model_dir / "best_model.npz").exists()
    assert (ws.model_dir / "last_model.npz").exists()
    losses = batch_losses(ws.log_dir)
    assert sorted(losses) == list(range(10))   # 5 epochs x 2 (drop_last)
    assert all(np.isfinite(v) for v in losses.values())
    assert ctx.state.step == 10


def test_auto_takes_the_resident_engine_under_the_jax_rule(scratch_dataset,
                                                           capsys):
    cfg = small_cfg(Config(), scratch_dataset, epochs=1, interval=0)
    cfg.tpu.device_resident = "auto"
    ctx = port_train(cfg)
    assert "Device-resident corpus" in capsys.readouterr().out
    assert ctx.state.step == 2            # drop_last: 80 // 32
    # a microbatch smaller than the batch keeps the host-fed step
    cfg = small_cfg(Config(), scratch_dataset, epochs=1, interval=0,
                    description="auto_micro")
    cfg.tpu.device_resident = "auto"
    cfg.tpu.microbatch_size = 16
    ctx = port_train(cfg)
    assert "Device-resident corpus" not in capsys.readouterr().out
    assert ctx.state.step == 3            # the ragged batch is kept


@pytest.mark.parametrize("budget,micro,match", [
    (1e-7, 0, "does not fit"), (4.0, 16, "microbatch_size is set")])
def test_always_raises_when_it_cannot(scratch_dataset, budget, micro, match):
    cfg = small_cfg(Config(), scratch_dataset)
    cfg.tpu.resident_budget_gb = budget
    cfg.tpu.microbatch_size = micro
    with pytest.raises(ValueError, match=match):
        port_train(cfg)


def test_small_budget_takes_the_corpus_layout(scratch_dataset, capsys):
    cfg = small_cfg(Config(), scratch_dataset, epochs=1, interval=0)
    # frames: 2 x 80 x 512 x 4 = 327,680 bytes; samples: 42,496 bytes
    cfg.tpu.resident_budget_gb = 100_000 / (1 << 30)
    port_train(cfg)
    assert "Device-resident corpus (corpus layout)" in capsys.readouterr().out


def test_resident_checkpoint_pipelining_bitexact(scratch_dataset):
    """The dispatch-ahead at checkpoint boundaries must not perturb
    training: a run WITH periodic checkpoints trains bit-identically to one
    without, and the boundary checkpoint holds exactly the boundary-epoch
    state (the snapshot, not the state advanced by the group queued ahead
    of the drain)."""
    ctx_a = port_train(small_cfg(Config(), scratch_dataset,
                                 description="pipe_ckpt"))
    ctx_b = port_train(small_cfg(Config(), scratch_dataset, interval=0,
                                 description="pipe_none"))
    _same_params(ctx_a.state.params, ctx_b.state.params)
    assert ctx_a.state.step == 10
    restored, meta = restore_checkpoint(
        ctx_a.workspace.checkpoint_dir / "ckpt_00002.npz", ctx_a.state)
    assert restored.step == 6 and meta["epoch"] == 2
    # the boundary state is what a 3-epoch run ends with
    ctx_c = port_train(small_cfg(Config(), scratch_dataset, epochs=3,
                                 interval=0, description="pipe_three"))
    _same_params(restored.params, ctx_c.state.params)


def test_async_boundary_matches_sync(scratch_dataset):
    runs = {}
    for mode in (True, False):
        cfg = small_cfg(Config(), scratch_dataset,
                        description=f"async_{mode}")
        cfg.tpu.async_checkpoint = mode
        runs[mode] = port_train(cfg)
    _same_params(runs[True].state.params, runs[False].state.params)
    assert runs[True].best_loss == runs[False].best_loss
    for rel in ("model/checkpoints/ckpt_00002.npz",
                "model/checkpoints/ckpt_00004.npz",
                "model/checkpoints/ckpt_00005.npz",
                "model/best_model.npz", "model/last_model.npz"):
        fa = runs[True].workspace.workdir / rel
        fb = runs[False].workspace.workdir / rel
        assert fa.read_bytes() == fb.read_bytes(), rel


def test_async_boundary_writer_error_surfaces(scratch_dataset, monkeypatch):
    from rawaudiovae_kelsey_tpu_torch.train import epoch as ep
    from rawaudiovae_kelsey_tpu_torch.train.loop import AsyncBoundaryWriter

    w = AsyncBoundaryWriter()

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="boundary I/O failed"):
        w.flush()
    seen = []
    w.submit(lambda: seen.append(1))
    w.flush()
    assert seen == [1]

    def explode(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ep.L, "save_periodic_checkpoint", explode)
    with pytest.raises((RuntimeError, OSError)):
        port_train(small_cfg(Config(), scratch_dataset, epochs=6,
                             description="async_err"))


def test_resident_interrupt_after_dispatch_ahead(scratch_dataset, capsys):
    """A stop signal landing AFTER the boundary's dispatch-ahead but BEFORE
    the stop check: the group already queued is folded in — its losses
    drain and the interrupt checkpoint holds the post-group state."""
    from rawaudiovae_kelsey_tpu_torch.train import epoch as ep

    class FlipStop:
        def __init__(self):
            self.calls = 0

        def __bool__(self):
            self.calls += 1
            return self.calls > 1

    cfg = small_cfg(Config(), scratch_dataset, description="pipe_stop")
    ctx = ep.L.setup(cfg, "cpu")
    try:
        ctx = ep._run(ctx, cfg, verbose=False, stop=FlipStop())
    finally:
        ep.L.finish(ctx)
    assert ctx.state.step == 10           # all 5 epochs trained
    path = ctx.workspace.checkpoint_dir / "ckpt_00004.npz"
    restored, _ = restore_checkpoint(path, ctx.state)
    assert restored.step == 10
    _same_params(restored.params, ctx.state.params)
    txt = capsys.readouterr().out
    assert "====> Epoch: 4 " in txt
    assert "Interrupted after epoch 4" in txt


def test_interrupt_before_a_boundary_checkpoints_the_live_state(
        scratch_dataset, capsys):
    from rawaudiovae_kelsey_tpu_torch.train import epoch as ep

    cfg = small_cfg(Config(), scratch_dataset, description="stop_now")
    ctx = ep.L.setup(cfg, "cpu")
    try:
        ctx = ep._run(ctx, cfg, verbose=False, stop=True)
    finally:
        ep.L.finish(ctx)
    assert ctx.state.step == 6            # the first group: epochs 0..2
    assert "Interrupted after epoch 2" in capsys.readouterr().out
    restored, _ = restore_checkpoint(
        ctx.workspace.checkpoint_dir / "ckpt_00002.npz", ctx.state)
    _same_params(restored.params, ctx.state.params)


@pytest.fixture
def jax_parity(monkeypatch):
    """The port's trainer starts from the JAX trainer's initial weights
    and its resident engine gets JAX's noise and permutations."""
    from rawaudiovae_kelsey_tpu_torch.models import registry
    from rawaudiovae_kelsey_tpu_torch.train import epoch, loop

    def build(cfg, device):
        model = registry.build_model(cfg, device)
        params = jax.device_get(jvae.init_dense(
            jax.random.PRNGKey(cfg.tpu.seed), E_SEG, E_UNITS, E_LATENT))
        return dataclasses.replace(
            model, init=lambda _g: params_from_jax(params, device))

    monkeypatch.setattr(loop, "build_model", build)
    monkeypatch.setattr(epoch.R, "build_resident_epoch", functools.partial(
        R.build_resident_epoch,
        noise=functools.partial(jax_eps, seed=E_SEED),
        perm=functools.partial(jax_perm, seed=E_SEED)))


def _close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-4), k


def test_resident_history_matches_the_jax_trainer(scratch_dataset,
                                                  jax_parity):
    jctx = jax_train(small_cfg(JConfig(), scratch_dataset, epochs=3,
                               interval=0))
    ctx = port_train(small_cfg(Config(), scratch_dataset, epochs=3,
                               interval=0))
    want = batch_losses(jctx.workspace.log_dir)
    assert len(want) == 6
    _close(batch_losses(ctx.workspace.log_dir), want)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resident_checkpoint_resumes_across_packages(scratch_dataset,
                                                     jax_parity, first):
    """Two resident epochs in one package, then ``resume`` in the other
    for a third: the resumed epoch's losses are the ones a straight
    three-epoch JAX run logs."""
    straight = jax_train(small_cfg(JConfig(), scratch_dataset, epochs=3,
                                   interval=0))
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 4}
    runs = {"jax": (JConfig, jax_train), "port": (Config, port_train)}
    cls, run = runs[first]
    run(small_cfg(cls(), scratch_dataset, epochs=2, interval=0))
    cls, run = runs["port" if first == "jax" else "jax"]
    cfg = small_cfg(cls(), scratch_dataset, epochs=3, interval=0)
    cfg.training.resume = True
    resumed = run(cfg)
    assert resumed.start_step == 4
    _close(batch_losses(resumed.workspace.log_dir), want)

"""The port's hand-written CUDA kernels on a GPU, against their plain
PyTorch versions on the same card.  Every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.

This file imports no JAX (the GPU machine has none).  tests/conftest.py
does, so on the GPU run this file alone without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance ``1e-4`` absolute: kernel and plain are both fp32 (TF32 off)
and form the same products, summed in another order over K <= 2048;
measured differences are ~1e-6, while an indexing or masking fault shows
as 1e-2 or more.  The backward kernels contract the batch (K up to 8192),
so their fp32 outputs are held relative to the output's largest value,
``1e-4 · max|want|``.  bf16 outputs (forward activations, ``dz``) may flip
by one bf16 ulp where the two fp32 sums straddle a rounding boundary, and
a rounded hidden cotangent can carry one more: ``2^-6 · max|want|``.
The sampler's ``z`` is held at ``1e-5 · (1 + |z|)``: the kernel and the
plain version run the same fp32 operations on the same bits, and differ
only in the last ulps of ``log`` / ``cos`` / ``exp``.
"""

import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

ATOL = 1e-4
ENC = [(layer, k) for layer in ("fc1", "fc21", "fc22") for k in ("w", "b")]
DEC = [(layer, k) for layer in ("fc3", "fc4") for k in ("w", "b")]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py checks the "
                    "kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _params(device, seg=1024, units=2048, latent=256):
    from rawaudiovae_kelsey_tpu_torch.models.vae import init_dense

    return init_dense(torch.Generator().manual_seed(0), seg, units, latent,
                      device)


@pytest.mark.parametrize("batch", [1, 100, 256, 300])
def test_kernels_match_plain_versions(cuda, batch):
    p = _params(cuda)
    g = torch.Generator(device=cuda).manual_seed(batch)
    x = torch.rand((batch, 1024), generator=g, device=cuda) * 2 - 1
    z = torch.randn((batch, 256), generator=g, device=cuda)
    qp = quant.quantize_decoder(p)
    before = [w.launches for w in ops.KERNEL_WRAPPERS]
    pairs = [
        (mlp.encoder_fwd(*[p[a][k] for a, k in ENC], x),
         mlp.encoder_fwd_ref(*[p[a][k] for a, k in ENC], x)),
        (mlp.decoder_fwd(*[p[a][k] for a, k in DEC], z),
         mlp.decoder_fwd_ref(*[p[a][k] for a, k in DEC], z)),
        ((quant.quantized_decoder_fwd(qp, z),),
         (quant.quantized_decode_ref(qp, z),)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.device == b.device
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == \
        [n + (w in ops.SERVING_KERNELS) for n, w in
         zip(before, ops.KERNEL_WRAPPERS)]


def test_kernels_at_odd_widths(cuda):
    """Every edge (batch, output width, depth) is masked in the kernel."""
    p = _params(cuda, seg=200, units=333, latent=37)
    x = torch.rand((45, 200), device=cuda)
    z = torch.randn((45, 37), device=cuda)
    for got, want in (
        (mlp.encoder_fwd(*[p[a][k] for a, k in ENC], x),
         mlp.encoder_fwd_ref(*[p[a][k] for a, k in ENC], x)),
        (mlp.decoder_fwd(*[p[a][k] for a, k in DEC], z),
         mlp.decoder_fwd_ref(*[p[a][k] for a, k in DEC], z)),
    ):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    p = _params(cuda, seg=256, units=512, latent=64)
    w = [p[a][k] for a, k in ENC]
    x = torch.zeros((4, 256), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        mlp.encoder_fwd(*w, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        mlp.encoder_fwd(*w, torch.zeros((256, 4), device=cuda).t())
    with pytest.raises(ValueError, match="shape"):
        mlp.encoder_fwd(*w, torch.zeros((4, 257), device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        mlp.encoder_fwd(*[t.cpu() for t in w], x)


def test_server_on_the_card_matches_the_plain_backend(cuda):
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.infer import InferenceServer
    from rawaudiovae_kelsey_tpu_torch.models import build_model

    cfg = Config()
    outs = {}
    audio = np.random.default_rng(0).uniform(-0.5, 0.5, 30000) \
        .astype(np.float32)
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        params = model.init(torch.Generator().manual_seed(3))
        with InferenceServer(model, params, deterministic=True) as s:
            outs[backend] = s.reconstruct(audio, hop=128, ola=True).result(60)
    np.testing.assert_allclose(outs["pallas"], outs["xla"], atol=ATOL)


BF16_REL = 2.0 ** -6
GRAD_REL = 1e-4


def _close_rel(got, want, rel):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        tol = rel * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol


def _backward_inputs(device, batch, dtype, seg=1024, units=2048,
                     latent=256):
    p = _params(device, seg, units, latent)
    g = torch.Generator(device=device).manual_seed(batch)

    def rnd(*shape, relu=False):
        t = torch.randn(shape, generator=g, device=device)
        return (t.clamp_min(0) if relu else t).to(dtype)

    w = {n: {k: t.to(dtype) for k, t in q.items()} for n, q in p.items()}
    return w, dict(x=rnd(batch, seg), h=rnd(batch, units, relu=True),
                   dmu=rnd(batch, latent), dlv=rnd(batch, latent),
                   da=rnd(batch, seg), h3=rnd(batch, units, relu=True),
                   z=rnd(batch, latent))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_backward_kernels_match_plain_versions(cuda, batch, dtype):
    """Queue B rows 7-10 at full width, the training microbatch (8192), a
    ragged batch and one row; each launches once."""
    w, t = _backward_inputs(cuda, batch, dtype)
    w21, w22, w3, w4 = (w[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))
    before = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
    cases = [
        (mlp.grad_accum(t["h3"], t["da"]),
         mlp.grad_accum_ref(t["h3"], t["da"])),
        (mlp.grad_accum2(t["h"], t["dmu"], t["dlv"]),
         mlp.grad_accum2_ref(t["h"], t["dmu"], t["dlv"])),
        (mlp.enc_bwd_dw1(t["x"], t["h"], t["dmu"], t["dlv"], w21, w22),
         mlp.enc_bwd_dw1_ref(t["x"], t["h"], t["dmu"], t["dlv"], w21, w22)),
    ]
    torch.cuda.synchronize()
    for got, want in cases:
        _close_rel(got, want, GRAD_REL if dtype == torch.float32
                   else BF16_REL)
    dz, dw3, db3 = mlp.dec_bwd_fused(t["da"], t["h3"], t["z"], w4, w3)
    rz, rw3, rb3 = mlp.dec_bwd_fused_ref(t["da"], t["h3"], t["z"], w4, w3)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    _close_rel((dz,), (rz,), 1e-4 if fp32 else BF16_REL)
    _close_rel((dw3, db3), (rw3, rb3), GRAD_REL if fp32 else BF16_REL)
    for name in ("grad_accum", "grad_accum2", "enc_bwd_dw1",
                 "dec_bwd_fused"):
        assert getattr(mlp, name).launches == before[name] + 1


@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_bf16_forward_kernels_match_plain_versions(cuda, batch):
    w, t = _backward_inputs(cuda, batch, torch.bfloat16)
    enc = [w[n][k] for n, k in ENC]
    dec = [w[n][k] for n, k in DEC]
    got = mlp.encoder_fwd(*enc, t["x"]) + mlp.decoder_fwd(*dec, t["z"])
    want = mlp.encoder_fwd_ref(*enc, t["x"]) + mlp.decoder_fwd_ref(*dec,
                                                                  t["z"])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close_rel((a,), (b,), BF16_REL)


def test_backward_kernels_are_deterministic(cuda):
    """Each block loops over the whole batch: no atomics, identical bits."""
    w, t = _backward_inputs(cuda, 4096, torch.bfloat16)
    runs = [mlp.enc_bwd_dw1(t["x"], t["h"], t["dmu"], t["dlv"],
                            w["fc21"]["w"], w["fc22"]["w"])
            + mlp.grad_accum(t["h3"], t["da"]) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_input_gradient_kernels_match_plain_versions(cuda, batch, dtype):
    """Queue B rows 4-6 at full width; each launches once."""
    w, t = _backward_inputs(cuda, batch, dtype)
    w1, w21, w22, w3, w4 = (w[n]["w"] for n in ("fc1", "fc21", "fc22", "fc3",
                                                "fc4"))
    before = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
    dh = mlp.matmul_nt2_mask_ref(t["dmu"], w21, t["dlv"], w22, t["h"])
    cases = [
        ((mlp.matmul_nt2_mask(t["dmu"], w21, t["dlv"], w22, t["h"]),),
         (dh,)),
        ((mlp.matmul_nt_mask(t["da"], w4, t["h3"]),),
         (mlp.matmul_nt_mask_ref(t["da"], w4, t["h3"]),)),
        ((mlp.matmul_nt(dh, w1),), (mlp.matmul_nt_ref(dh, w1),)),
    ]
    torch.cuda.synchronize()
    for got, want in cases:
        _close_rel(got, want, GRAD_REL if dtype == torch.float32
                   else BF16_REL)
    for name in ("matmul_nt", "matmul_nt_mask", "matmul_nt2_mask"):
        assert getattr(mlp, name).launches == before[name] + 1


def test_input_gradient_kernels_at_odd_widths(cuda):
    w, t = _backward_inputs(cuda, 45, torch.float32, 200, 333, 37)
    got = mlp.matmul_nt2_mask(t["dmu"], w["fc21"]["w"], t["dlv"],
                              w["fc22"]["w"], t["h"])
    want = mlp.matmul_nt2_mask_ref(t["dmu"], w["fc21"]["w"], t["dlv"],
                                   w["fc22"]["w"], t["h"])
    _close_rel((got,), (want,), GRAD_REL)
    _close_rel((mlp.matmul_nt(want, w["fc1"]["w"]),),
               (mlp.matmul_nt_ref(want, w["fc1"]["w"]),), GRAD_REL)


def test_encoder_input_grad_on_cuda(cuda):
    """``dx`` through ``mlp.encode`` on the card: rows 6 and 4 launch once
    each (split mode) and the result is the plain composition's."""
    w, t = _backward_inputs(cuda, 300, torch.float32, 64, 128, 16)
    for mode in mlp.BACKWARD_MODES:
        x = t["x"].clone().requires_grad_()
        before = (mlp.matmul_nt2_mask.launches, mlp.matmul_nt.launches)
        mu, lv = mlp.encode(w, x, fp32_backward=mode)
        (dx,) = torch.autograd.grad((mu * t["dmu"]).sum()
                                    + (lv * t["dlv"]).sum(), x)
        assert (mlp.matmul_nt2_mask.launches, mlp.matmul_nt.launches) == \
            (before[0] + 1, before[1] + 1)
        _, _, h = mlp.encoder_fwd_ref(*[w[a][k] for a, k in ENC], t["x"])
        want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
            t["dmu"], w["fc21"]["w"], t["dlv"], w["fc22"]["w"], h),
            w["fc1"]["w"])
        _close_rel((dx,), (want,), GRAD_REL)


@pytest.mark.parametrize("batch", [4096, 1000, 1])
def test_sampler_kernel_matches_plain_version(cuda, batch):
    """Queue B row 13: the kernel's Philox words equal the plain version's
    bit for bit; ``z`` within the ulp differences of log / cos / exp; two
    launches with one seed are identical; the high seed word matters."""
    from rawaudiovae_kelsey_tpu_torch.ops import rng

    seed = (0x9ABCDEF0 + batch, 0x12345678)
    assert torch.equal(rng.philox_words(seed, batch, 256, cuda),
                       rng.philox_words_ref(seed, batch, 256, cuda))
    g = torch.Generator(device=cuda).manual_seed(batch)
    mu = torch.randn((batch, 256), generator=g, device=cuda)
    logvar = torch.randn((batch, 256), generator=g, device=cuda) * 0.5
    before = rng.reparameterize_prng.launches
    z = rng.reparameterize_prng(seed, mu, logvar)
    assert rng.reparameterize_prng.launches == before + 1
    want = rng.reparameterize_prng_ref(seed, mu, logvar)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all())
    assert bool(((z - want).abs() <= 1e-5 * (1 + want.abs())).all())
    assert torch.equal(z, rng.reparameterize_prng(seed, mu, logvar))
    assert not torch.equal(
        z, rng.reparameterize_prng((seed[0], seed[1] + 1), mu, logvar))
    # the plain version on the CPU draws the same noise
    cpu = rng.reparameterize_prng_ref(seed, mu.cpu(), logvar.cpu())
    assert bool(((z.cpu() - cpu).abs() <= 1e-5 * (1 + cpu.abs())).all())


def test_sampler_backward_on_cuda(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import rng

    mu = torch.randn((100, 256), device=cuda, requires_grad=True)
    logvar = torch.randn((100, 256), device=cuda, requires_grad=True)
    cot = torch.randn((100, 256), device=cuda)
    z = rng.reparameterize((3, 4), mu, logvar)
    dmu, dlv = torch.autograd.grad((z * cot).sum(), (mu, logvar))
    eps = rng.eps_ref((3, 4), 100, 256, cuda)
    assert torch.equal(dmu, cot)
    torch.testing.assert_close(
        dlv, 0.5 * eps * torch.exp(0.5 * logvar.detach()) * cot,
        atol=1e-5, rtol=1e-4)


def test_resident_epoch_on_the_card(cuda):
    """A resident epoch at ``highest`` through the kernels launches the
    primitive backward once per step: rows 6, 5 and 4 (``dz``) once,
    ``grad_accum`` five times."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.precision, cfg.tpu.backend = "highest", "pallas"
    cfg.tpu.rng = "tpu_prng"
    cfg.training.batch_size = 512
    corpus = np.random.default_rng(0).uniform(
        -0.5, 0.5, 300_000).astype(np.float32)
    model = build_model(cfg, cuda)
    run, n_batches = R.build_resident_epoch(model, cfg, None, len(corpus))
    data = R.put_resident(corpus, cfg, "frames", cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)), 1)
    names = ("matmul_nt2_mask", "matmul_nt_mask", "matmul_nt", "grad_accum")
    before = [getattr(mlp, n).launches for n in names]
    sampler = ops.reparameterize_prng.launches
    state, losses = run(state, data, 0)
    torch.cuda.synchronize()
    assert losses.shape == (1, n_batches) and bool(losses.isfinite().all())
    got = [getattr(mlp, n).launches - b for n, b in zip(names, before)]
    assert got == [n_batches, n_batches, n_batches, 5 * n_batches]
    assert ops.reparameterize_prng.launches == sampler + n_batches


def test_train_step_on_the_card_matches_the_plain_backend(cuda):
    """One bf16 microbatched step through the kernels and one through the
    plain ops, same state and noise: losses within bf16 noise, updated
    params close (Adam's first step moves each by about lr)."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.precision = "bfloat16"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((2500, 1024), device=cuda) * 2 - 1
    out = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), seed=1)
        state, m = build_train_step(model, cfg)(state, x)
        out[backend] = (float(m["loss"]), state.params)
    assert out["pallas"][0] == pytest.approx(out["xla"][0], rel=1e-2)
    lr = cfg.training.learning_rate
    for n, q in out["pallas"][1].items():
        for k, p in q.items():
            assert float((p - out["xla"][1][n][k]).abs().max()) <= 2 * lr

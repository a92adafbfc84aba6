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


@pytest.mark.parametrize("dtype,passes,rel", [
    (torch.float32, 3, 1e-4), (torch.bfloat16, 1, 2.0 ** -6)],
    ids=["fp32-3pass", "bf16"])
@pytest.mark.parametrize("batch", [8192, 4096, 4097, 1])
def test_full_backward_chains_match_plain_versions(cuda, batch, dtype,
                                                   passes, rel):
    """Queue B rows 11-12 at full width, at the training microbatch, the
    stream's batch, a ragged one and 1: the 3-pass product of the ``high``
    tier on fp32 operands, one pass on bf16 operands; each chain launches
    once, and a second launch gives the same bits."""
    w, t = _backward_inputs(cuda, batch, dtype)
    w21, w22, w3, w4 = (w[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))
    before = (mlp.enc_bwd_full.launches, mlp.dec_bwd_full.launches)
    enc = (t["x"], t["h"], t["dmu"], t["dlv"], w21, w22)
    dec = (t["da"], t["h3"], t["z"], w4, w3)
    got_e, got_d = mlp.enc_bwd_full(*enc), mlp.dec_bwd_full(*dec)
    torch.cuda.synchronize()
    assert (mlp.enc_bwd_full.launches, mlp.dec_bwd_full.launches) == \
        (before[0] + 1, before[1] + 1)
    assert len(got_e) == 6 and len(got_d) == 5
    _close_rel(got_e, mlp.enc_bwd_full_ref(*enc, passes), rel)
    _close_rel(got_d, mlp.dec_bwd_full_ref(*dec, passes), rel)
    for a, b in zip(got_e + got_d,
                    mlp.enc_bwd_full(*enc) + mlp.dec_bwd_full(*dec)):
        assert torch.equal(a, b)


def _smoke():
    """``chip_smoke.py`` of the repository root, as a module."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("widths", [(1024, 2048, 256), (70, 130, 18)],
                         ids=["full-width", "odd-widths"])
def test_full_backward_chains_split_and_add_bit_for_bit(cuda, widths):
    """The 3-pass chains on operands built so that every sum has one
    non-zero term and a quarter of the values sit on the split's rounding
    tie: the kernels must give the bits of the 3-pass plain version.  A
    chain in one pass, or a device split that rounds to nearest even, moves
    a large share of the values (tests/test_torch_full_backward.py shows it
    on the plain versions)."""
    smoke = _smoke()
    cases = zip(("enc_bwd_full", "dec_bwd_full"),
                smoke.exact_split_case(cuda, 0, *widths))
    for name, case in cases:
        got = getattr(mlp, name)(*case)
        torch.cuda.synchronize()
        want = getattr(mlp, name + "_ref")(*case, 3)
        once = getattr(mlp, name + "_ref")(*case, 1)
        moved = total = 0
        for i, (a, b, c) in enumerate(zip(got, want, once)):
            if i in smoke.DENSE_SUMS[name]:
                _close_rel((a,), (b,), smoke.EXACT_DB_REL)
                continue
            assert torch.equal(a, b), (name, i, int((a != b).sum()))
            moved, total = moved + int((b != c).sum()), total + b.numel()
        assert moved > total // 10


def test_full_backward_chains_at_odd_widths_and_bad_passes(cuda):
    w, t = _backward_inputs(cuda, 37, torch.float32, 70, 130, 18)
    enc = (t["x"], t["h"], t["dmu"], t["dlv"], w["fc21"]["w"],
           w["fc22"]["w"])
    dec = (t["da"], t["h3"], t["z"], w["fc4"]["w"], w["fc3"]["w"])
    _close_rel(mlp.enc_bwd_full(*enc), mlp.enc_bwd_full_ref(*enc, 3), 1e-4)
    _close_rel(mlp.dec_bwd_full(*dec), mlp.dec_bwd_full_ref(*dec, 3), 1e-4)
    with pytest.raises(ValueError, match="passes"):
        mlp.enc_bwd_full_ref(*(a.bfloat16() for a in enc), 3)
    with pytest.raises(TypeError, match="dtype"):
        mlp.dec_bwd_full(t["da"], t["h3"].bfloat16(), *dec[2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [4096, 25_810, 1])
def test_loss_sums_kernel_matches_plain_version(cuda, batch, dtype):
    """Queue B row 14: both sums within rel 1e-5 of two ``torch.sum`` s,
    the same bits on a second launch, one launch a call."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    g = torch.Generator(device=cuda).manual_seed(batch)
    recon = torch.tanh(torch.randn((batch, 1024), generator=g,
                                   device=cuda)).to(dtype)
    x = (torch.rand((batch, 1024), generator=g, device=cuda) * 2 - 1).to(dtype)
    mu = torch.randn((batch, 256), generator=g, device=cuda).to(dtype)
    lv = (torch.randn((batch, 256), generator=g, device=cuda) * 0.5).to(dtype)
    before = loss.loss_sums.launches
    got = loss.loss_sums(recon, x, mu, lv)
    again = loss.loss_sums(recon, x, mu, lv)
    torch.cuda.synchronize()
    assert loss.loss_sums.launches == before + 2
    for a, b, c in zip(got, loss.loss_sums_ref(recon, x, mu, lv), again):
        assert a.dtype == torch.float32 and a.dim() == 0
        assert float(a) == pytest.approx(float(b), rel=1e-5)
        assert torch.equal(a, c)


def test_loss_sums_brings_mixed_dtypes_to_fp32(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    g = torch.Generator(device=cuda).manual_seed(5)
    recon, x = (torch.rand((333, 1024), generator=g, device=cuda).bfloat16()
                for _ in range(2))
    mu, lv = (torch.randn((333, 256), generator=g, device=cuda)
              for _ in range(2))
    got = loss.loss_sums(recon, x, mu, lv)
    want = loss.loss_sums(recon.float(), x.float(), mu, lv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_loss_on_the_card_matches_the_plain_loss(cuda):
    from rawaudiovae_kelsey_tpu_torch.models import vae
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    g = torch.Generator(device=cuda).manual_seed(3)
    recon = torch.tanh(torch.randn((1000, 1024), generator=g, device=cuda))
    x = torch.rand((1000, 1024), generator=g, device=cuda) * 2 - 1
    mu = torch.randn((1000, 256), generator=g, device=cuda)
    lv = torch.randn((1000, 256), generator=g, device=cuda) * 0.5
    for reduction in ("mean", "sum"):
        a = [t.clone().requires_grad_() for t in (recon, x, mu, lv)]
        b = [t.clone().requires_grad_() for t in (recon, x, mu, lv)]
        got = loss.fused_loss_components(*a, 1e-4, reduction)
        want = vae.loss_components(*b, 1e-4, 1024, reduction)
        for u, v in zip(got, want):
            assert float(u.detach()) == pytest.approx(float(v.detach()),
                                                      rel=1e-5)
        _close_rel(torch.autograd.grad(got[0], a),
                   torch.autograd.grad(want[0], b), 1e-5)


def test_high_step_on_the_card_runs_the_full_chains(cuda):
    """One ``precision = high`` step through the kernels and one through
    the plain ops, same state and noise: ``enc_bwd_full`` and
    ``dec_bwd_full`` launch once each and no split kernel does; the losses
    and the gradients agree."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.precision = "high"
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.rand((4096, 1024), generator=g, device=cuda) * 2 - 1
    names = ("enc_bwd_full", "dec_bwd_full", "enc_bwd_dw1", "grad_accum2",
             "dec_bwd_fused", "grad_accum")
    out = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), seed=1)
        before = [getattr(mlp, n).launches for n in names]
        state, m = build_train_step(model, cfg)(state, x)
        rose = [getattr(mlp, n).launches - b for n, b in zip(names, before)]
        assert rose == ([1, 1, 0, 0, 0, 0] if backend == "pallas"
                        else [0] * 6)
        # Adam's first moment after one step is (1 - b1) * gradient: linear
        # in the gradient, where the parameter update (lr * g / (|g| + eps))
        # turns the rounding of a near-zero gradient into a move of up to lr
        out[backend] = (float(m["loss"]), torch.cat(
            [t.ravel() for q in state.mu.values() for t in q.values()]))
    assert out["pallas"][0] == pytest.approx(out["xla"][0], rel=1e-5)
    gk, gx = out["pallas"][1], out["xla"][1]
    assert bool(torch.isfinite(gk).all()) and float(gx.norm()) > 0
    assert float((gk - gx).norm() / gx.norm()) <= 1e-4
    # the 3-pass product is off IEEE fp32 by ~2^-16 of each product's
    # scale, and the sums over 4096 rows cancel: measured 5.8e-4 of the
    # largest gradient on one element; a fault shows as O(1) of it
    assert float((gk - gx).abs().max()) <= 5e-3 * float(gx.abs().max())


def test_stream_trainer_on_the_card(cuda, tmp_path, capsys):
    """Twenty batches of the stream trainer at full width, bf16 through the
    kernels, then a resume for four more and ``eval`` on the run."""
    import json

    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.eval import cli as eval_cli
    from rawaudiovae_kelsey_tpu_torch.io import write_wav
    from rawaudiovae_kelsey_tpu_torch.train import stream

    rng = np.random.default_rng(0)
    (tmp_path / "audio").mkdir()
    (tmp_path / "test_audio").mkdir()
    for i, n in enumerate((400_000, 250_000, 500, 330_000)):
        wave = (0.4 * np.sin(np.linspace(0, 900 * (i + 1), n))
                + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(tmp_path / "audio" / f"a{i}.wav", wave, 44100)
    write_wav(tmp_path / "test_audio" / "t.wav",
              rng.uniform(-0.3, 0.3, 20_000).astype(np.float32), 44100)

    def cfg(batches):
        c = Config()
        c.dataset.datapath = str(tmp_path)
        c.training.batch_size = 4096
        c.training.total_num_frames = batches * 4096
        c.training.checkpoint_interval = 8
        c.extra.description = "cuda_stream"
        c.tpu.precision, c.tpu.backend = "bfloat16", "pallas"
        return c

    before = mlp.enc_bwd_dw1.launches
    ctx = stream.train(cfg(20), verbose=False, device=cuda)
    assert ctx.state.step == 20
    assert mlp.enc_bwd_dw1.launches == before + 20
    assert (ctx.workspace.checkpoint_dir / "ckpt_00016.npz").exists()
    more = cfg(24)
    more.training.resume = True
    ctx = stream.train(more, verbose=False, device=cuda)
    assert ctx.start_step == 20 and ctx.state.step == 24
    always = cfg(24)
    always.tpu.device_resident = "always"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stream.train(always, verbose=False, device=cuda)
    capsys.readouterr()
    eval_cli.main(["--run", str(ctx.workspace.workdir), "--deterministic"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 20 and 0 < report["recon_mse"] < 1

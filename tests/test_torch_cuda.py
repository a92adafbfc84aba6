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
        mu, lv = mlp.encode(w, x, mode=mode)
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


# ---- the `high` tier's 3-pass forms of rows 1, 2, 6 and 4 and of the
# row-parallel rows 1 and 2 (csrc/full.cu's chains on the tensor cores; the
# first version's 3-pass mode at other widths): 1e-4 · max|plain| of the
# 3-pass plain version (the same split and products, summed in another
# order), equal bits on a second launch, bit for bit on built operands

def _three_pass_cases(device, batch, seg, units, latent):
    w, t = _backward_inputs(device, batch, torch.float32, seg, units, latent)
    enc = [w[n][k] for n, k in ENC]
    dec = [w[n][k] for n, k in DEC]
    x = t["x"] * 0.3
    return {
        "encoder_fwd": (mlp.encoder_fwd, mlp.encoder_fwd_ref, (*enc, x)),
        "encoder_fwd_partial": (mlp.encoder_fwd_partial,
                                mlp.encoder_fwd_partial_ref,
                                (enc[0], enc[1], enc[2], enc[4], x)),
        "decoder_fwd": (mlp.decoder_fwd, mlp.decoder_fwd_ref,
                        (*dec, t["z"])),
        "decoder_fwd_partial": (mlp.decoder_fwd_partial,
                                mlp.decoder_fwd_partial_ref,
                                (*dec[:3], t["z"])),
        "matmul_nt2_mask": (mlp.matmul_nt2_mask, mlp.matmul_nt2_mask_ref,
                            (t["dmu"], w["fc21"]["w"], t["dlv"],
                             w["fc22"]["w"], t["h"])),
        "matmul_nt": (mlp.matmul_nt, mlp.matmul_nt_ref,
                      (t["h"] * 1e-2, w["fc1"]["w"])),
    }


def _counter(name):
    return getattr(mlp, name.replace("_partial", ""))


@pytest.mark.parametrize("widths", [(1024, 2048, 256), (70, 130, 18)],
                         ids=["full-width", "odd-widths"])
@pytest.mark.parametrize("batch", [4096, 4097, 1])
def test_three_pass_forms_match_their_plain_versions(cuda, batch, widths):
    on_tc = all(v % 8 == 0 for v in widths)
    for name, (fn, ref, args) in _three_pass_cases(cuda, batch,
                                                   *widths).items():
        f = _counter(name)
        before = (f.launches, f.split_launches, f.sgemm_launches)
        got = fn(*args, passes=3)
        again = fn(*args, passes=3)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = ref(*args, passes=3)
        want = want if isinstance(want, tuple) else (want,)
        _close_rel(got, want, 1e-4)
        for a, b in zip(got, again):
            assert torch.equal(a, b), name
        assert (f.launches - before[0], f.split_launches - before[1],
                f.sgemm_launches - before[2]) == (2, 2 * on_tc, 0), name
        with pytest.raises(ValueError, match="sgemm"):
            fn(*args, kernel="sgemm", passes=3)


@pytest.mark.parametrize("widths", [(1024, 2048, 256), (70, 130, 18)],
                         ids=["full-width", "odd-widths"])
def test_three_pass_forms_split_and_add_bit_for_bit(cuda, widths):
    """On ``chip_smoke.py`` 's exact_forward_case (every sum one term) the
    kernels give the 3-pass plain version's bits: h, mu, logvar, h3, dh
    and dx equal, y within 8 ulps (two tanh implementations)."""
    case = _smoke().exact_forward_case(cuda, 0, *widths)
    got = (*mlp.encoder_fwd(*case["encoder"], passes=3),
           mlp.decoder_fwd(*case["decoder"], passes=3)[1])
    want = (*mlp.encoder_fwd_ref(*case["encoder"], passes=3),
            mlp.decoder_fwd_ref(*case["decoder"], passes=3)[1])
    dh = mlp.matmul_nt2_mask(*case["dh"], passes=3)
    dx = mlp.matmul_nt(dh, *case["dx"], passes=3)
    want_dh = mlp.matmul_nt2_mask_ref(*case["dh"], passes=3)
    want_dx = mlp.matmul_nt_ref(want_dh, *case["dx"], passes=3)
    y = mlp.decoder_fwd(*case["decoder"], passes=3)[0]
    torch.cuda.synchronize()
    for a, b in zip((*got, dh, dx), (*want, want_dh, want_dx)):
        assert torch.equal(a, b), int((a != b).sum())
    want_y = mlp.decoder_fwd_ref(*case["decoder"], passes=3)[0]
    ulps = (y.view(torch.int32).long() - want_y.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 8
    once = mlp.encoder_fwd_ref(*case["encoder"])[2]
    assert int((once != want[2]).sum()) > once.numel() // 10


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


def _loss_operands(device, rows, kind, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    pair = torch.bfloat16 if kind == "bf16-fp32" else torch.float32
    recon = torch.tanh(torch.randn((rows, 1024), generator=g,
                                   device=device)).to(pair)
    x = (torch.rand((rows, 1024), generator=g, device=device) * 2
         - 1).to(pair)
    mu = torch.randn((rows, 256), generator=g, device=device)
    lv = torch.randn((rows, 256), generator=g, device=device) * 0.5
    return recon, x, mu, lv


@pytest.mark.parametrize("kind", ["bf16-fp32", "fp32"])
@pytest.mark.parametrize("rows", [8192, 4097])
def test_loss_grads_kernel_matches_plain_version(cuda, rows, kind):
    """Row 14's gradient at the training microbatch and a ragged batch,
    bf16 recon / x beside fp32 mu / logvar and all fp32, under a mean
    and a sum: ``d recon`` within one bf16 ulp (fp32: rel 1e-6), ``d mu``
    and ``d logvar`` within rel 1e-6 of the plain version; a second
    launch gives the same bits; one launch a call."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    recon, x, mu, lv = _loss_operands(cuda, rows, kind, rows)
    g_m = torch.tensor(1.25, device=cuda)
    g_k = torch.tensor(1e-4, device=cuda)
    for n_x, n_l in ((recon.numel(), mu.numel()), (1, 1)):
        before = loss.loss_grads.launches
        got = loss.loss_grads(recon, x, mu, lv, g_m, g_k, n_x, n_l)
        again = loss.loss_grads(recon, x, mu, lv, g_m, g_k, n_x, n_l)
        want = loss.loss_grads_ref(recon, x, mu, lv, g_m, g_k, n_x, n_l)
        torch.cuda.synchronize()
        assert loss.loss_grads.launches == before + 2
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        if kind == "bf16-fp32":
            assert got[0].dtype == torch.bfloat16
            ulps = (got[0].view(torch.int16).int()
                    - want[0].view(torch.int16).int()).abs()
            assert int(ulps.max()) <= 1
        else:
            _close_rel(got[:1], want[:1], 1e-6)
        _close_rel(got[1:], want[1:], 1e-6)


def test_loss_kernels_take_ragged_and_unaligned_operands(cuda):
    """Widths no multiple of 8 (the masked tails) and views off a 16-byte
    boundary (scalar loads): the sums give the bits of an aligned copy
    and of the fp32 copies, the gradients those of an aligned copy, both
    close to their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    g = torch.Generator(device=cuda).manual_seed(9)
    shapes = [(37, 1001), (37, 1001), (37, 13), (37, 13)]
    flat = [torch.randn(r * c + 1, generator=g, device=cuda)
            for r, c in shapes]
    flat[0], flat[1] = flat[0].tanh().bfloat16(), flat[1].bfloat16()
    off = [f[1:].view(s) for f, s in zip(flat, shapes)]
    on = [t.clone() for t in off]
    assert off[0].data_ptr() % 16 and on[0].data_ptr() % 16 == 0
    sums = loss.loss_sums(*off)
    assert all(torch.equal(a, b) for a, b in zip(sums, loss.loss_sums(*on)))
    fp32 = loss.loss_sums(on[0].float(), on[1].float(), *on[2:])
    assert all(torch.equal(a, b) for a, b in zip(sums, fp32))
    for a, b in zip(sums, loss.loss_sums_ref(*on)):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    g_m, g_k = (torch.tensor(v, device=cuda) for v in (0.5, 2e-4))
    n = (on[0].numel(), on[2].numel())
    got = loss.loss_grads(*off, g_m, g_k, *n)
    torch.cuda.synchronize()
    for a, b in zip(got, loss.loss_grads(*on, g_m, g_k, *n)):
        assert torch.equal(a, b)
    want = loss.loss_grads_ref(*on, g_m, g_k, *n)
    ulps = (got[0].view(torch.int16).int()
            - want[0].view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
    _close_rel(got[1:], want[1:], 1e-6)


def test_bf16_step_on_the_card_runs_its_loss_on_row_14(cuda, monkeypatch):
    """One ``backend = pallas`` dense bf16 step: ``loss_sums`` and
    ``loss_grads`` launch once each, on the decoder's bf16 output, and the
    step's loss, MSE and KLD equal ``models/vae.py`` ``loss_components``
    on the same tensors within rel 1e-6."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model, vae
    from rawaudiovae_kelsey_tpu_torch.ops import loss
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.precision, cfg.tpu.backend = "bfloat16", "pallas"
    g = torch.Generator(device=cuda).manual_seed(13)
    x = (torch.rand((4096, 1024), generator=g, device=cuda) * 2
         - 1).bfloat16()
    model = build_model(cfg, cuda)
    state = TrainState.create(
        model.init(torch.Generator().manual_seed(0)), seed=1)
    seen = []
    real = loss.fused_loss_components

    def spy(*args):
        seen.append([a.detach() if isinstance(a, torch.Tensor) else a
                     for a in args])
        return real(*args)

    monkeypatch.setattr(loss, "fused_loss_components", spy)
    before = (loss.loss_sums.launches, loss.loss_grads.launches)
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    assert (loss.loss_sums.launches - before[0],
            loss.loss_grads.launches - before[1]) == (1, 1)
    (recon, xx, mu, lv, beta, reduction), = seen
    assert recon.dtype == xx.dtype == torch.bfloat16
    assert mu.dtype == lv.dtype == torch.float32
    want = vae.loss_components(recon.float(), xx, mu, lv, beta, 1024,
                               reduction)
    for name, w in zip(("loss", "mse", "kld"), want):
        assert float(m[name]) == pytest.approx(float(w), rel=1e-6)
    assert all(bool(torch.isfinite(t).all())
               for q in state.params.values() for t in q.values())


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
    always.tpu.resident_budget_gb = 0.0
    with pytest.raises(ValueError, match="does not fit"):
        stream.train(always, verbose=False, device=cuda)
    capsys.readouterr()
    eval_cli.main(["--run", str(ctx.workspace.workdir), "--deterministic"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 20 and 0 < report["recon_mse"] < 1



def _stream_folder(root, rng):
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    (root / "audio").mkdir()
    (root / "test_audio").mkdir()
    for i, n in enumerate((400_000, 250_000, 500, 330_000)):
        wave = (0.4 * np.sin(np.linspace(0, 900 * (i + 1), n))
                + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(root / "audio" / f"a{i}.wav", wave, 44100)
    write_wav(root / "test_audio" / "t.wav",
              rng.uniform(-0.3, 0.3, 20_000).astype(np.float32), 44100)


@pytest.mark.parametrize("layout", ["samples", "frames"])
def test_resident_stream_on_the_card_equals_host_fed(cuda, tmp_path,
                                                     capsys, layout):
    """Twenty batches of the device-resident stream at full width, bf16
    through the kernels, against the host-fed stream with a bf16 feed
    (the same bf16 targets): equal losses and state, bit for bit; every
    step launches the split backward's kernels on the tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.train import stream
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    _stream_folder(tmp_path, np.random.default_rng(0))

    def cfg(mode):
        c = Config()
        c.dataset.datapath = str(tmp_path)
        c.dataset.generate_test = False
        c.training.batch_size = 4096
        c.training.total_num_frames = 20 * 4096
        c.training.checkpoint_interval = 8
        c.extra.description = f"cuda_resident_{mode}"
        c.tpu.precision, c.tpu.backend = "bfloat16", "pallas"
        c.tpu.device_resident, c.tpu.resident_layout = mode, layout
        c.tpu.feed_dtype = "bfloat16"
        return c

    kernels = (mlp.encoder_fwd, mlp.decoder_fwd, mlp.grad_accum,
               mlp.enc_bwd_dw1, mlp.grad_accum2, mlp.dec_bwd_fused)
    before = [(w.launches, w.tensor_core_launches) for w in kernels]
    res = stream.train(cfg("always"), verbose=False, device=cuda)
    assert f"on device, {layout} layout)" in capsys.readouterr().out
    for w, (n, tc) in zip(kernels, before):
        assert (w.launches - n, w.tensor_core_launches - tc) == (20, 20)
    fed = stream.train(cfg("never"), verbose=False, device=cuda)
    assert "Device-resident" not in capsys.readouterr().out
    assert res.state.step == fed.state.step == 20
    for a, b in zip(leaves((res.state.params, res.state.mu, res.state.nu)),
                    leaves((fed.state.params, fed.state.mu, fed.state.nu))):
        assert torch.equal(a, b)
    # the final checkpoints hold the state after 20 steps in both engines
    # (a host-fed boundary checkpoint at batch b holds b + 1 steps)
    ck = "ckpt_00020.npz"
    assert (res.workspace.checkpoint_dir / ck).read_bytes() == \
        (fed.workspace.checkpoint_dir / ck).read_bytes()


@pytest.mark.parametrize("arch", ["dense", "deep"])
def test_remat_step_on_the_card_equals_the_plain_step(cuda, arch):
    """A bf16 ``remat`` step through the kernels against the same step
    without it, same state and noise: equal loss, params and moments bit
    for bit; the forward kernels launch twice as often, the backward ones
    as often as before."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import linear
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    cfg = Config()
    cfg.tpu.precision, cfg.tpu.backend = "bfloat16", "pallas"
    cfg.tpu.microbatch_size = 1024
    rows = 2048
    if arch == "deep":
        cfg.vae.arch, cfg.audio.segment_length = "deep", 4096
        cfg.vae.hidden_dims = "4096,2048,1024,512"
        # phase 8's batch: 7 k-split and 4 whole-k launches a forward
        cfg.tpu.microbatch_size, rows = 0, 4096
        fwd, bwd = (linear.linear_ksplit_fwd, linear.linear_fwd), ()
    else:
        fwd = (mlp.encoder_fwd, mlp.decoder_fwd)
        bwd = (mlp.grad_accum, mlp.enc_bwd_dw1, mlp.grad_accum2,
               mlp.dec_bwd_fused)
    x = torch.rand((rows, cfg.audio.segment_length), device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              seed=1)
    out, counts = {}, {}
    for remat in (False, True):
        cfg.tpu.remat = remat
        before = [w.launches for w in fwd + bwd]
        s, m = build_train_step(build_model(cfg, cuda), cfg)(
            state.clone(), x)
        torch.cuda.synchronize()
        counts[remat] = [w.launches - n for w, n in zip(fwd + bwd, before)]
        out[remat] = (m["loss"], leaves((s.params, s.mu, s.nu)))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    nf = len(fwd)
    assert counts[True][:nf] == [2 * n for n in counts[False][:nf]]
    assert counts[True][nf:] == counts[False][nf:]
    assert all(counts[False])


# ----------------------------------------- the variants' kernels (rows 15-17)
# fp32 outputs within 1e-4 · max|want| (the same products in another order),
# bf16 within 2^-6 · max|want|; the 4-pass Toeplitz product within
# 1e-5 · max|want| of its 4-pass plain version; split-K: equal bits twice.

def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _linear_operands(device, batch, k, n, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, k), generator=g, device=device)
    w = torch.randn((k, n), generator=g, device=device) / k ** 0.5
    b = torch.randn((n,), generator=g, device=device) * 0.1
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("shape", [(4096, 1024, 512), (1024, 1088, 544),
                                   (96, 384, 640), (45, 333, 37), (1, 7, 1)])
def test_linear_kernels_match_plain_versions(cuda, shape, act, dtype, tol):
    """Both kernels at every shape, gate or no gate, odd widths included."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, *shape, dtype)
    for kernel, plain in ((linear.linear_fwd, linear.linear_fwd_ref),
                          (linear.linear_ksplit_fwd,
                           linear.linear_ksplit_fwd_ref)):
        before = kernel.launches
        got = kernel(x, w, b, act)
        torch.cuda.synchronize()
        want = plain(x, w, b, act)
        assert kernel.launches == before + 1
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel(got, want) <= tol


def test_linear_ksplit_is_deterministic_and_splits(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, 1024, 1088, 544, torch.float32)
    assert linear.ksplit_slices(1088) == 3
    a = linear.linear_ksplit_fwd(x, w, b, "relu")
    c = linear.linear_ksplit_fwd(x, w, b, "relu")
    torch.cuda.synchronize()
    assert torch.equal(a, c)
    # the dispatch takes it at this shape, the whole-k kernel below the gate
    n_k, n_w = linear.linear_ksplit_fwd.launches, linear.linear_fwd.launches
    assert torch.equal(linear.pallas_linear(x, w, b, "relu"), a)
    linear.pallas_linear(x[:100], w, b, "relu")
    assert (linear.linear_ksplit_fwd.launches, linear.linear_fwd.launches) \
        == (n_k + 1, n_w + 1)


def test_pallas_linear_gradients_on_the_card(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = (t.requires_grad_() for t in
               _linear_operands(cuda, 1024, 1088, 544, torch.float32))
    linear.pallas_linear(x, w, b, "tanh").square().mean().backward()
    got = [t.grad.clone() for t in (x, w, b)]
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    torch.tanh(x @ w + b).square().mean().backward()
    for g, t in zip(got, (x, w, b)):
        assert _rel(g, t.grad) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shift,t_out", [(0, None), (0, 13), (1, 9), (2, 5),
                                         (2, 12)])
@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
def test_toeplitz_kernel_matches_plain_version(cuda, act, shift, t_out,
                                               dtype, tol):
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((37, 9, 24), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 24, 40), generator=g, device=cuda) * 0.2).to(dtype)
    b = torch.randn((40,), generator=g, device=cuda).to(dtype)
    before = toeplitz.toeplitz_fwd.launches
    got = toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift)
    torch.cuda.synchronize()
    want = toeplitz.toeplitz_fwd_ref(x, w, b, act, t_out, shift)
    assert toeplitz.toeplitz_fwd.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("n", [4, 16, 40, 130])
def test_toeplitz_four_passes_on_the_card(cuda, n):
    """Each form in the 4-pass mode: n = 4 the narrow kernel, 16 and 40 the
    tensor cores on the operands' bf16 halves, 130 (no multiple of 8) the
    first version."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((300, 16, 48), generator=g, device=cuda)
    w = torch.randn((3, 48, n), generator=g, device=cuda) * 0.1
    b = torch.randn((n,), generator=g, device=cuda)
    before = toeplitz.toeplitz_fwd.split_launches
    four = toeplitz.toeplitz_fwd(x, w, b, "none", 16, 1, 4)
    assert toeplitz.toeplitz_fwd.split_launches - before == (n in (16, 40))
    one = toeplitz.toeplitz_fwd(x, w, b, "none", 16, 1, 1)
    torch.cuda.synchronize()
    assert _rel(four, toeplitz.toeplitz_fwd_ref(x, w, b, "none", 16, 1, 4)) \
        <= 1e-5
    assert _rel(four, one) <= 1e-5


@pytest.mark.parametrize("K,S,L", [(9, 4, 64), (5, 2, 48), (3, 4, 32),
                                   (7, 4, 64), (1, 2, 12), (2, 4, 12)])
def test_convolutions_on_the_toeplitz_kernel(cuda, K, S, L):
    """Both directions, forward and the three gradients, against the plain
    convolutions (cuDNN, TF32 off)."""
    from rawaudiovae_kelsey_tpu_torch.models import variants
    from rawaudiovae_kelsey_tpu_torch.ops import conv

    g = torch.Generator(device=cuda).manual_seed(K * 10 + S)
    x0 = torch.randn((5, L, 3), generator=g, device=cuda)
    w0 = torch.randn((K, 3, 6), generator=g, device=cuda) * 0.1
    b0 = torch.randn((6,), generator=g, device=cuda) * 0.1
    for op, plain in ((conv.conv1d_pallas, variants.conv_same),
                      (conv.conv1d_transpose_pallas,
                       variants.conv_transpose_same)):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        y = op(x, w, b, S, "relu")
        y.square().sum().backward()
        got = [y.detach(), x.grad, w.grad, b.grad]
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        y = torch.relu(plain({"w": w, "b": b}, x, S))
        y.square().sum().backward()
        for a, c in zip(got, [y.detach(), x.grad, w.grad, b.grad]):
            assert a.shape == c.shape and _rel(a, c) <= 1e-4


def test_variant_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear, toeplitz

    x, w, b = _linear_operands(cuda, 8, 16, 24, torch.float32)
    for fn in (linear.linear_fwd, linear.linear_ksplit_fwd):
        with pytest.raises(ValueError, match="unknown activation"):
            fn(x, w, b, "gelu")
        with pytest.raises(TypeError, match="dtype"):
            fn(x.double(), w, b)
        with pytest.raises(TypeError, match="dtype"):
            fn(x, w.bfloat16(), b)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((16, 8), device=cuda).t(), w, b)
        with pytest.raises(ValueError, match="shape"):
            fn(x, w, b[:5])
        with pytest.raises(ValueError, match="on cpu"):
            fn(x, w.cpu(), b)
    xt = torch.zeros((2, 6, 4), device=cuda)
    wt = torch.zeros((3, 4, 5), device=cuda)
    bt = torch.zeros((5,), device=cuda)
    with pytest.raises(ValueError, match="unknown activation"):
        toeplitz.toeplitz_fwd(xt, wt, bt, "gelu")
    with pytest.raises(ValueError, match="passes"):
        toeplitz.toeplitz_fwd(xt.bfloat16(), wt.bfloat16(), bt.bfloat16(),
                              "none", 4, 0, 4)
    with pytest.raises(ValueError, match="shift"):
        toeplitz.toeplitz_fwd(xt, wt, bt, "none", 4, 3)
    with pytest.raises(ValueError, match="shape"):
        toeplitz.toeplitz_fwd(xt, torch.zeros((3, 5, 5), device=cuda), bt)
    with pytest.raises(ValueError, match="contiguous"):
        toeplitz.toeplitz_fwd(torch.zeros((2, 4, 6), device=cuda)
                              .transpose(1, 2), wt, bt)
    with pytest.raises(TypeError, match="dtype"):
        toeplitz.toeplitz_fwd(xt, wt.bfloat16(), bt)


def _untied(cfg, x, device):
    """``x`` with every row that holds a tied ReLU gate replaced by a fresh
    row, the batch and so the dispatch unchanged (``probes/gate_ties.py``
    ``untie``).  The two backends sum each pre-activation in another order;
    where one lies within those last bits of zero, one backend passes it and
    the other does not, and that row's gradient moves by a whole term: 1e-4
    to 4e-4 of the moment's norm at these widths, with both backends right
    (PERF.md section 7).  ``untie`` raises where a flipped gate is no tie (its
    passed side above 1e-5 of the layer's largest output) or where a layer's
    outputs differ by more than that: a kernel fault still fails here."""
    from rawaudiovae_kelsey_tpu_torch.probes import gate_ties

    untied, _ = gate_ties.untie(cfg, x,
                                torch.Generator(device=device).manual_seed(7))
    return untied


def test_deep_model_kernels_match_plain_backend_on_the_card(cuda):
    """A deep model wide enough for the k-split gate: one fp32 step through
    the kernels against the plain backend, same noise (gradient norms, as
    Adam's first step turns rounding of a near-zero gradient into ±lr), on
    an input whose ReLU gates both backends decide alike (_untied)."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    cfg = Config()
    cfg.vae.arch, cfg.vae.hidden_dims = "deep", "1024,512"
    cfg.audio.segment_length, cfg.vae.latent_dim = 1024, 32
    cfg.tpu.precision = "highest"
    x = _untied(cfg, torch.rand((1024, 1024), device=cuda) * 2 - 1, cuda)

    def noise(step, i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(1))

    mus = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0)
        n_k = ops.linear_ksplit_fwd.launches
        state, m = build_train_step(model, cfg, noise=noise)(state, x)
        if backend == "pallas":
            # the encoder's 1024->1024 and 1024->512 and the decoder's
            # 1024->1024 take the k-split kernel
            assert ops.linear_ksplit_fwd.launches == n_k + 3
        mus[backend] = torch.cat([t.ravel() for t in leaves(state.mu)])
    err = float((mus["pallas"] - mus["xla"]).norm() / mus["xla"].norm())
    assert err <= 1e-4


# ---- the probes' kernels: dw_fused, dx_fused (csrc/linear_bwd.cu) and
# leaf_update (csrc/adam.cu).  The two products hold the tolerances of the
# other GEMM kernels (fp32 1e-4, bf16 2^-6, of max|want|) and equal bits on a
# second launch; the Adam kernel holds no tolerance: equal bits.

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh", "none"])
@pytest.mark.parametrize("shape", [(4096, 1024, 512), (4097, 1088, 544),
                                   (1000, 70, 33), (1, 5, 3), (64, 64, 64)])
def test_fused_linear_backward_matches_plain_versions(cuda, shape, act,
                                                      dtype, tol):
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd

    batch, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(batch + k)
    x = torch.randn((batch, k), generator=g, device=cuda).to(dtype)
    y = torch.randn((batch, n), generator=g, device=cuda).to(dtype)
    dy = (torch.randn((batch, n), generator=g, device=cuda) * 0.01).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.01).to(dtype)
    before = (ops.dw_fused.launches, ops.dx_fused.launches)
    dx, dw, db = linear_bwd.fused_bwd(x, y, dy, w, act)
    again = linear_bwd.fused_bwd(x, y, dy, w, act)
    torch.cuda.synchronize()
    assert (ops.dw_fused.launches, ops.dx_fused.launches) == \
        (before[0] + 2, before[1] + 2)
    for a, b in zip((dx, dw, db), again):
        assert torch.equal(a, b)
    want_dw, want_db = linear_bwd.dw_fused_ref(x, y, dy, act)
    want_dx = linear_bwd.dx_fused_ref(y, dy, w, act)
    for got, want in ((dx, want_dx), (dw, want_dw), (db, want_db)):
        assert got.shape == want.shape and got.dtype == want.dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()) + 1e-30
    # and within the same tolerance of the backward the model takes today
    for got, want in zip((dx, dw, db), linear_bwd.plain_bwd(x, y, dy, w,
                                                            act)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * float(want.float().abs().max()) + 1e-30


# the new forms: bf16 on the tensor cores (csrc/wgmma.cuh, da formed in
# registers), fp32 on csrc/sgemm.cuh (da formed as the slabs are read
# back).  The deep model's four large layers at batch 512, and ragged ones
FUSED_FORMS = {torch.bfloat16: ("tensor_cores", "tensor_core_launches",
                                2.0 ** -6),
               torch.float32: ("sgemm", "sgemm_launches", 1e-4)}
FUSED_SHAPES = [(512, 4096, 4096), (512, 4096, 2048), (512, 2048, 1024),
                (512, 1024, 512), (4097, 1088, 544), (1000, 136, 72),
                (130, 72, 8)]


def _fused_operands(device, batch, k, n, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((batch, k), generator=g, device=device).to(dtype),
            torch.randn((batch, n), generator=g, device=device).to(dtype),
            (torch.randn((batch, n), generator=g, device=device)
             * 0.01).to(dtype),
            (torch.randn((k, n), generator=g, device=device)
             * 0.01).to(dtype))


def _fused_close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()) + 1e-30


@pytest.mark.parametrize("dtype", list(FUSED_FORMS), ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", ["relu", "tanh", "none"])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_fused_new_forms_match_plain_and_first_versions(cuda, shape, act,
                                                        dtype):
    """Every launch takes the dtype's new form, counted in its counter;
    two launches give equal bits; dx, dW and db hold the plain versions'
    and the first versions' tolerance."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd

    form, counter, tol = FUSED_FORMS[dtype]
    x, y, dy, w = _fused_operands(cuda, *shape, dtype, sum(shape))
    ops_ = (ops.dw_fused, ops.dx_fused)
    before = [(op.launches, getattr(op, counter)) for op in ops_]
    got = linear_bwd.fused_bwd(x, y, dy, w, act)
    again = linear_bwd.fused_bwd(x, y, dy, w, act)
    torch.cuda.synchronize()
    assert [(op.launches - b[0], getattr(op, counter) - b[1])
            for op, b in zip(ops_, before)] == [(2, 2), (2, 2)]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want_dw, want_db = linear_bwd.dw_fused_ref(x, y, dy, act)
    want = (linear_bwd.dx_fused_ref(y, dy, w, act), want_dw, want_db)
    first = linear_bwd.fused_bwd(x, y, dy, w, act, kernel="cuda_cores")
    for a, p, f in zip(got, want, first):
        _fused_close(a, p, tol)
        _fused_close(a, f, tol)


@pytest.mark.parametrize("dtype", list(FUSED_FORMS), ids=["bf16", "fp32"])
def test_fused_forms_named_and_refused(cuda, dtype):
    """``kernel`` forces a form: ``cuda_cores`` the first version on any
    shape; the dtype's new form where it takes the operands, and a raise
    where it does not (a width no multiple of 8 or 4, a view off a 16-byte
    boundary, the other dtype's form)."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd

    form, counter, tol = FUSED_FORMS[dtype]
    other = "sgemm" if form == "tensor_cores" else "tensor_cores"
    x, y, dy, w = _fused_operands(cuda, 300, 136, 72, dtype, 3)
    before = (ops.dx_fused.launches, getattr(ops.dx_fused, counter))
    first = linear_bwd.dx_fused(y, dy, w, "tanh", kernel="cuda_cores")
    named = linear_bwd.dx_fused(y, dy, w, "tanh", kernel=form)
    torch.cuda.synchronize()
    assert (ops.dx_fused.launches - before[0],
            getattr(ops.dx_fused, counter) - before[1]) == (2, 1)
    _fused_close(named, first, tol)
    with pytest.raises(ValueError, match=other):
        linear_bwd.dw_fused(x, y, dy, "relu", kernel=other)
    with pytest.raises(ValueError, match=other):
        linear_bwd.dx_fused(y, dy, w, "relu", kernel=other)
    # k = 70: no multiple of 8 (bf16) nor of 4 (fp32)
    x, y, dy, w = _fused_operands(cuda, 300, 70, 72, dtype, 4)
    with pytest.raises(ValueError, match=form):
        linear_bwd.dw_fused(x, y, dy, "relu", kernel=form)
    with pytest.raises(ValueError, match=form):
        linear_bwd.dx_fused(y, dy, w, "relu", kernel=form)
    before = (ops.dw_fused.launches, getattr(ops.dw_fused, counter))
    dw, db = linear_bwd.dw_fused(x, y, dy, "relu")
    torch.cuda.synchronize()
    assert (ops.dw_fused.launches - before[0],
            getattr(ops.dw_fused, counter) - before[1]) == (1, 0)
    _fused_close(dw, linear_bwd.dw_fused_ref(x, y, dy, "relu")[0], tol)
    # a contiguous view 4 bytes off a 16-byte boundary
    x, y, dy, w = _fused_operands(cuda, 300, 136, 72, dtype, 5)
    buf = torch.empty(y.numel() + 8, device=cuda, dtype=dtype)
    off = buf[4 // y.element_size():][:y.numel()].view(y.shape)
    off.copy_(y)
    with pytest.raises(ValueError, match="aligned = False"):
        linear_bwd.dx_fused(off, dy, w, "relu", kernel=form)
    before = (ops.dx_fused.launches, getattr(ops.dx_fused, counter))
    got = linear_bwd.dx_fused(off, dy, w, "relu")
    torch.cuda.synchronize()
    assert (ops.dx_fused.launches - before[0],
            getattr(ops.dx_fused, counter) - before[1]) == (1, 0)
    _fused_close(got, linear_bwd.dx_fused_ref(y, dy, w, "relu"), tol)


@pytest.mark.parametrize("plan", [(256, 1), (256, 3), (128, 2), (64, 1),
                                  (64, 4)], ids=str)
def test_fused_tensor_core_plans_agree(cuda, monkeypatch, plan):
    """Each tile width of dx and each (tile width, slices) plan of dW, forced,
    holds the plain versions' tolerance at a ragged batch: the plan moves
    the bits, not the result."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd, tensor_cores

    x, y, dy, w = _fused_operands(cuda, 1000, 264, 392, torch.bfloat16, 6)
    monkeypatch.setattr(tensor_cores, "cotangent_wgrad_plan",
                        lambda *a: plan)
    monkeypatch.setattr(tensor_cores, "cotangent_tile_n", lambda *a: plan[0])
    dx, dw, db = linear_bwd.fused_bwd(x, y, dy, w, "tanh")
    want_dw, want_db = linear_bwd.dw_fused_ref(x, y, dy, "tanh")
    _fused_close(dx, linear_bwd.dx_fused_ref(y, dy, w, "tanh"), 2.0 ** -6)
    _fused_close(dw, want_dw, 2.0 ** -6)
    _fused_close(db, want_db, 2.0 ** -6)


def test_fused_linear_backward_raises_on_what_it_does_not_take(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd

    x = torch.zeros((8, 6), device=cuda)
    y = torch.zeros((8, 4), device=cuda)
    w = torch.zeros((6, 4), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        linear_bwd.dw_fused(x.double(), y.double(), y.double())
    with pytest.raises(TypeError, match="dtype"):
        linear_bwd.dw_fused(x, y.bfloat16(), y)
    with pytest.raises(ValueError, match="shape"):
        linear_bwd.dw_fused(x, y, y[:4])
    with pytest.raises(ValueError, match="on cpu"):
        linear_bwd.dw_fused(x, y.cpu(), y)
    with pytest.raises(ValueError, match="contiguous"):
        linear_bwd.dx_fused(y, y, torch.zeros((4, 6), device=cuda).t())
    with pytest.raises(ValueError, match="shape"):
        linear_bwd.dx_fused(y, y, w[:, :3].contiguous())
    with pytest.raises(ValueError, match="unknown activation"):
        linear_bwd.dx_fused(y, y, w, "gelu")


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (1027,),
                                   (4_000_003,), (7, 33, 5), (2048, 1024)])
def test_leaf_update_equals_the_plain_version_bit_for_bit(cuda, shape):
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    g = torch.Generator(device=cuda).manual_seed(len(shape))
    p = torch.randn(shape, generator=g, device=cuda)
    m = torch.zeros(shape, device=cuda)
    v = torch.zeros(shape, device=cuda)
    want = [p.clone(), m.clone(), v.clone()]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    before = ops.leaf_update.launches
    for step in range(1, 6):
        grad = torch.randn(shape, generator=g, device=cuda) \
            * 10.0 ** (step % 3 - 2)
        bc = [torch.full((), c, device=cuda)
              for c in adam.bias_corrections(0.9, 0.999, step)]
        adam.leaf_update(p, grad, m, v, *bc, **hyper)
        adam.leaf_update_ref(want[0], grad, want[1], want[2], *bc, **hyper)
    torch.cuda.synchronize()
    assert ops.leaf_update.launches == before + 5
    for got, ref in zip((p, m, v), want):
        assert torch.equal(got, ref)
        assert bool(torch.isfinite(got).all())


def test_leaf_update_takes_unaligned_views_and_raises_on_the_rest(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    bc = [torch.full((), c, device=cuda) for c in (0.1, 0.001)]
    buf = torch.rand(4 * 1001, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(0))
    views = [buf[i * 1001 + 1:(i + 1) * 1001] for i in range(4)]
    assert views[0].data_ptr() % 16 == 4
    want = [t.clone() for t in views]
    adam.leaf_update(*views, *bc, **hyper)
    adam.leaf_update_ref(*want, *bc, **hyper)
    for got, ref in zip(views, want):
        assert torch.equal(got, ref)
    t = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        adam.leaf_update(t, t.double(), t, t, *bc, **hyper)
    with pytest.raises(ValueError, match="shape"):
        adam.leaf_update(t, t[:2], t, t, *bc, **hyper)
    with pytest.raises(ValueError, match="contiguous"):
        adam.leaf_update(t, torch.zeros((3, 4), device=cuda).t(), t, t, *bc,
                         **hyper)
    with pytest.raises(ValueError, match="on cpu"):
        adam.leaf_update(t, t, t.cpu(), t, *bc, **hyper)
    with pytest.raises(ValueError, match="on cpu"):
        adam.leaf_update(t, t, t, t, bc[0].cpu(), bc[1], **hyper)
    with pytest.raises(TypeError, match="expected a tensor"):
        adam.leaf_update(t, t, t, t, 0.1, bc[1], **hyper)


@pytest.mark.parametrize("shape", [(1,), (255,), (1027,), (4_000_003,),
                                   (7, 33, 5)])
def test_leaf_update_first_version_equals_the_plain_version_bit_for_bit(
        cuda, shape):
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    g = torch.Generator(device=cuda).manual_seed(7 + len(shape))
    p = torch.randn(shape, generator=g, device=cuda)
    m = torch.zeros(shape, device=cuda)
    v = torch.zeros(shape, device=cuda)
    want = [p.clone(), m.clone(), v.clone()]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    before = ops.adam_tree.launches, ops.leaf_update.launches
    for step in range(1, 4):
        grad = torch.randn(shape, generator=g, device=cuda) \
            * 10.0 ** (step % 3 - 2)
        bc = [torch.full((), c, device=cuda)
              for c in adam.bias_corrections(0.9, 0.999, step)]
        adam.leaf_update(p, grad, m, v, *bc, kernel="first", **hyper)
        adam.leaf_update_ref(want[0], grad, want[1], want[2], *bc, **hyper)
    torch.cuda.synchronize()
    assert (ops.adam_tree.launches, ops.leaf_update.launches) == (
        before[0], before[1] + 3)
    for got, ref in zip((p, m, v), want):
        assert torch.equal(got, ref)


def _adam_tree_case(cuda, shapes, unaligned=()):
    """p, g, m, v of each shape, the leaves named in ``unaligned`` as views
    4 bytes past a 16-byte boundary (all four of the leaf, or only its
    gradient where the index is negative)."""
    gen = torch.Generator(device=cuda).manual_seed(len(shapes))
    tree = []
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        four = []
        for k in range(4):
            off = int(i in unaligned or (k == 1 and -i - 1 in unaligned))
            buf = torch.rand(n + 4, generator=gen, device=cuda)
            four.append(buf[off:off + n].view(shape))
        four[1].mul_(0.1)
        four[3].mul_(1e-3)
        tree.append(four)
    return [list(x) for x in zip(*tree)]


def test_adam_tree_on_a_mixed_tree_equals_the_plain_version_bit_for_bit(
        cuda):
    """Aligned leaves, unaligned ones (all four, or the gradient alone),
    empty ones and a strided gradient in one launch; three coupled
    steps."""
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    shapes = [(4096, 1024), (0,), (1,), (255,), (1027,), (7, 33, 5),
              (0, 3), (4097,), (300, 41), (2048,)]
    ps, gs, ms, vs = _adam_tree_case(cuda, shapes, unaligned=(2, 4, -8))
    assert gs[7].data_ptr() % 16 == 4 and ps[7].data_ptr() % 16 == 0
    gs[8] = gs[8].t().contiguous().t()       # strided: copied contiguous
    assert not gs[8].is_contiguous()
    want = [[t.clone() for t in x] for x in (ps, ms, vs)]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    before = ops.adam_tree.launches
    for step in range(1, 4):
        bc1, bc2 = adam.bias_corrections(0.9, 0.999, step)
        adam.adam_tree(ps, gs, ms, vs, bc1, bc2, **hyper)
        dev_bc = [torch.full((), c, device=cuda) for c in (bc1, bc2)]
        for p, g, m, v in zip(want[0], gs, want[1], want[2]):
            adam.leaf_update_ref(p, g, m, v, *dev_bc, **hyper)
    torch.cuda.synchronize()
    assert ops.adam_tree.launches == before + 3
    for got, ref in zip((ps, ms, vs), want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
            assert bool(torch.isfinite(a).all())


def test_adam_tree_past_k_max_leaves_launches_twice(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    k = adam.K_MAX_LEAVES
    shapes = [(1000 + 97 * i,) for i in range(k + 3)]
    ps, gs, ms, vs = _adam_tree_case(cuda, shapes, unaligned=(k + 1,))
    want = [[t.clone() for t in x] for x in (ps, ms, vs)]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    before = ops.adam_tree.launches
    bc1, bc2 = adam.bias_corrections(0.9, 0.999, 1)
    adam.adam_tree(ps, gs, ms, vs, bc1, bc2, **hyper)
    dev_bc = [torch.full((), c, device=cuda) for c in (bc1, bc2)]
    for p, g, m, v in zip(want[0], gs, want[1], want[2]):
        adam.leaf_update_ref(p, g, m, v, *dev_bc, **hyper)
    torch.cuda.synchronize()
    assert ops.adam_tree.launches == before + 2
    for got, ref in zip((ps, ms, vs), want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_adam_tree_raises_on_what_it_does_not_take(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import adam

    t = torch.zeros((4, 3), device=cuda)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    with pytest.raises(TypeError, match="dtype"):
        adam.adam_tree([t], [t.double()], [t], [t], 0.1, 0.01, **hyper)
    with pytest.raises(ValueError, match="shape"):
        adam.adam_tree([t], [t[:2]], [t], [t], 0.1, 0.01, **hyper)
    with pytest.raises(ValueError, match="on cpu"):
        adam.adam_tree([t], [t], [t.cpu()], [t], 0.1, 0.01, **hyper)
    with pytest.raises(ValueError, match="contiguous"):
        adam.adam_tree([t], [t], [t], [torch.zeros((3, 4), device=cuda).t()],
                       0.1, 0.01, **hyper)


@pytest.mark.parametrize("arch,backend", [("dense", "pallas"),
                                          ("deep", "xla"),
                                          ("conv1d", "xla")])
def test_fused_adam_in_the_train_step_equals_the_plain_one(cuda, arch,
                                                           backend):
    """Five coupled steps of the real step under each optimizer, small
    widths: 0 ULP on params and both moments."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import adam
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        build_optimizer,
    )
    from rawaudiovae_kelsey_tpu_torch.tree import flatten, leaves

    cfg = Config()
    cfg.vae.arch, cfg.vae.latent_dim = arch, 16
    cfg.audio.segment_length, cfg.vae.n_units = 256, 192
    cfg.vae.hidden_dims, cfg.vae.conv_channels = "192,96", "4,8"
    cfg.tpu.precision, cfg.tpu.backend = "bfloat16", backend
    if arch == "conv1d":
        torch.backends.cudnn.deterministic = True
    model = build_model(cfg, cuda)
    opt = build_optimizer(cfg)
    first = TrainState.create(model.init(torch.Generator().manual_seed(0)), 0)
    states = {"plain": first.clone(), "fused": first.clone()}
    steps = {"plain": build_train_step(model, cfg, optimizer=opt),
             "fused": build_train_step(model, cfg,
                                       optimizer=adam.FusedAdam(opt))}
    x = torch.rand((512, 256), device=cuda) * 2 - 1
    before = ops.adam_tree.launches, ops.leaf_update.launches
    for _ in range(5):
        for name in states:
            steps[name](states[name], x)
    torch.cuda.synchronize()
    # the whole tree in one launch a step, no launch a leaf
    assert len(leaves(first.params)) <= adam.K_MAX_LEAVES
    assert (ops.adam_tree.launches, ops.leaf_update.launches) == (
        before[0] + 5, before[1])
    for field in ("params", "mu", "nu"):
        for (name, a), (_, b) in zip(flatten(getattr(states["plain"], field)),
                                     flatten(getattr(states["fused"], field))):
            assert torch.equal(a, b), f"{field}.{name}"
    assert states["plain"].count == states["fused"].count == 5


# ---- the bf16 tensor-core kernels (csrc/wgmma.cuh) behind linear_ksplit_fwd
# and matmul_nt: within 2^-6 · max|plain| of the plain version and of the
# first version on the CUDA cores (the same products in another order: a
# flipped bf16 ulp), equal bits on a second launch.  Shapes (rows, k, n):
# the main path's; ragged rows (4097, 1000, 1); k a multiple of 8 but not
# of the 64-deep stage (1096) and shorter than one (24); n ragged against
# the tile (544, 520, 8).  The kernel picks 128 x 256 tiles at 4096 x 4096 ->
# 4096, 4096 x 2048 -> 4096 and matmul_nt's dx shape, 128 x 128 elsewhere.

BF16_REL = 2.0 ** -6
TC_SHAPES = [(4096, 4096, 4096), (4096, 1024, 512), (4096, 2048, 4096),
             (4097, 1088, 544), (1000, 1096, 520), (1, 24, 8),
             (130, 64, 264)]
NT_SHAPES = [(8192, 2048, 256), (8192, 2048, 1024), (4097, 1088, 544),
             (1000, 1096, 520), (1, 24, 8), (130, 64, 264)]


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
def test_tensor_core_ksplit_matches_plain_and_first_version(cuda, shape, act):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, *shape, torch.bfloat16)
    want = linear.linear_ksplit_fwd_ref(x, w, b, act)
    first = linear.linear_ksplit_fwd(x, w, b, act, kernel="cuda_cores")
    counts = (linear.linear_ksplit_fwd.launches,
              linear.linear_ksplit_fwd.tensor_core_launches)
    got = linear.linear_ksplit_fwd(x, w, b, act)        # auto: tensor cores
    torch.cuda.synchronize()
    assert (linear.linear_ksplit_fwd.launches - counts[0],
            linear.linear_ksplit_fwd.tensor_core_launches - counts[1]) \
        == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= BF16_REL
    assert _rel(got, first) <= BF16_REL
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, act))
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, act,
                                                     kernel="tensor_cores"))


@pytest.mark.parametrize("shape", NT_SHAPES, ids=str)
def test_tensor_core_matmul_nt_matches_plain_and_first_version(cuda, shape):
    rows, k, m = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((rows, k), generator=g, device=cuda).bfloat16()
    w = (torch.randn((m, k), generator=g, device=cuda) / k ** 0.5).bfloat16()
    want = mlp.matmul_nt_ref(a, w)
    first = mlp.matmul_nt(a, w, kernel="cuda_cores")
    counts = (mlp.matmul_nt.launches, mlp.matmul_nt.tensor_core_launches)
    got = mlp.matmul_nt(a, w)
    torch.cuda.synchronize()
    assert (mlp.matmul_nt.launches - counts[0],
            mlp.matmul_nt.tensor_core_launches - counts[1]) == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_REL
    assert _rel(got, first) <= BF16_REL
    assert torch.equal(got, mlp.matmul_nt(a, w))
    assert torch.equal(got, mlp.matmul_nt(a, w, kernel="tensor_cores"))


def test_tensor_core_kernels_on_an_all_zero_operand(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, 1000, 1096, 520, torch.bfloat16)
    zero = torch.zeros_like(x)
    got = linear.linear_ksplit_fwd(zero, w, b, "relu", kernel="tensor_cores")
    assert torch.equal(got, torch.relu(b).expand_as(got))
    wt = w.t().contiguous()
    assert not bool(mlp.matmul_nt(zero, wt, kernel="tensor_cores").any())
    assert not bool(mlp.matmul_nt(x, torch.zeros_like(wt),
                                  kernel="tensor_cores").any())


def test_tensor_core_dispatch_on_the_card(cuda):
    """What TMA cannot take keeps the first version under ``auto`` and
    raises when the tensor-core kernel is asked for by name: fp32, k or n no
    multiple of 8, a view that starts off a 16-byte boundary."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    def ran(fn, *args, **kw):
        before = (fn.launches, fn.tensor_core_launches)
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, (fn.launches - before[0],
                     fn.tensor_core_launches - before[1])

    for shape, dtype in (((1000, 70, 33), torch.bfloat16),
                         ((512, 1028, 520), torch.bfloat16),
                         ((512, 1024, 516), torch.bfloat16),
                         ((512, 1024, 512), torch.float32)):
        x, w, b = _linear_operands(cuda, *shape, dtype)
        got, rose = ran(linear.linear_ksplit_fwd, x, w, b, "tanh")
        assert rose == (1, 0), shape
        tol = BF16_REL if dtype == torch.bfloat16 else 1e-4
        assert _rel(got, linear.linear_ksplit_fwd_ref(x, w, b, "tanh")) <= tol
        with pytest.raises(ValueError, match="takes bf16 operands"):
            linear.linear_ksplit_fwd(x, w, b, "tanh", kernel="tensor_cores")
        wt = w.t().contiguous()
        got, rose = ran(mlp.matmul_nt, x, wt)
        assert rose == (1, 0), shape
        assert _rel(got, mlp.matmul_nt_ref(x, wt)) <= tol
        with pytest.raises(ValueError, match="takes bf16 operands"):
            mlp.matmul_nt(x, wt, kernel="tensor_cores")
    # contiguous, but two bytes off a 16-byte boundary
    x, w, b = _linear_operands(cuda, 256, 1024, 512, torch.bfloat16)
    off = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:] \
        .view_as(x).copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    got, rose = ran(linear.linear_ksplit_fwd, off, w, b, "relu")
    assert rose == (1, 0)
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, "relu",
                                                     kernel="cuda_cores"))
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_ksplit_fwd(off, w, b, "relu", kernel="tensor_cores")
    with pytest.raises(ValueError, match="unknown kernel"):
        linear.linear_ksplit_fwd(x, w, b, "relu", kernel="wgmma")
    # a zero-row batch launches nothing
    _, rose = ran(linear.linear_ksplit_fwd, x[:0], w, b, "relu")
    assert rose == (0, 0)
    _, rose = ran(mlp.matmul_nt, x[:0], w.t().contiguous())
    assert rose == (0, 0)


def test_pallas_linear_gradients_through_the_tensor_cores(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = (t.requires_grad_() for t in
               _linear_operands(cuda, 1024, 1088, 544, torch.bfloat16))
    on_tc = linear.linear_ksplit_fwd.tensor_core_launches
    y = linear.pallas_linear(x, w, b, "tanh")
    assert linear.linear_ksplit_fwd.tensor_core_launches == on_tc + 1
    y.float().square().mean().backward()
    got = [t.grad.clone() for t in (x, w, b)]
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    yp = torch.tanh(x.float() @ w.float() + b.float()).to(torch.bfloat16)
    yp.float().square().mean().backward()
    assert _rel(y, yp) <= BF16_REL
    for g, t in zip(got, (x, w, b)):
        assert g.dtype == torch.bfloat16
        assert _rel(g, t.grad) <= 2 * BF16_REL


def test_deep_bf16_forward_through_the_tensor_cores(cuda):
    """The deep model's forward at widths past the k-split gate, bf16: the
    kernel backend (k-split layers on the tensor cores) against the plain
    model on the same parameters."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import linear
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    cfg = Config()
    cfg.vae.arch, cfg.vae.hidden_dims = "deep", "2048,1024,512"
    cfg.audio.segment_length, cfg.vae.latent_dim = 2048, 64
    cfg.tpu.precision = "bfloat16"
    x = (torch.rand((1024, 2048), device=cuda) * 2 - 1).bfloat16()
    outs = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        params = tree_map(lambda t: t.to(torch.bfloat16), model.init(
            torch.Generator().manual_seed(0)))
        counts = (linear.linear_ksplit_fwd.launches,
                  linear.linear_ksplit_fwd.tensor_core_launches)
        with torch.no_grad():
            mu, logvar = model.encode(params, x)
            y = model.decode(params, mu)
        torch.cuda.synchronize()
        if backend == "pallas":
            # 2048->2048, 2048->1024, 1024->512 | 1024->2048, 2048->2048
            assert (linear.linear_ksplit_fwd.launches - counts[0],
                    linear.linear_ksplit_fwd.tensor_core_launches
                    - counts[1]) == (5, 5)
        outs[backend] = (mu, logvar, y)
    for got, want in zip(outs["pallas"], outs["xla"]):
        assert got.dtype == want.dtype == torch.bfloat16
        assert _rel(got, want) <= 4 * BF16_REL


# linear_fwd (row 16) and toeplitz_fwd (row 17) on the tensor cores: bf16
# operands TMA can take run csrc/wgmma.cuh, held within BF16_REL of the
# plain version and of the first version (kernel="cuda_cores"), equal bits
# on a second launch.  Shapes: the deep model's four whole-k layers at its
# batch and the server's largest layer; ragged rows, k and n; the six
# Toeplitz layers of configs/conv1d.ini that take the tensor cores (their
# dx launches have the same shapes, the forward and the transposed roles
# swapped) at batch 4096 and 4097; ragged Toeplitz plans: t_out below 64
# that does not divide it, above 64 and above 128, shift 0 and KB - 1, G no
# multiple of 64 (and below it), B = 1, output rows past nb.

WHOLE_K = [(4096, 512, 256), (4096, 256, 512), (4096, 512, 1024),
           (256, 4096, 4096), (4097, 1088, 544), (1000, 1096, 520),
           (1, 24, 8), (130, 64, 264)]
# (B, nb, G, KB, N, t_out, shift)
CONV_TC = [(4096, 64, 128, 3, 64, 64, 1), (4096, 16, 256, 3, 128, 16, 1),
           (4096, 4, 512, 3, 256, 4, 1), (4096, 4, 256, 3, 512, 4, 1),
           (4096, 16, 128, 3, 256, 16, 1), (4096, 64, 64, 3, 128, 64, 1),
           (4097, 16, 256, 3, 128, 16, 1)]
TOE_RAGGED = [(37, 48, 24, 3, 40, 48, 0), (5, 100, 72, 3, 136, 100, 2),
              (3, 200, 64, 5, 64, 200, 0), (9, 16, 128, 4, 256, 13, 3),
              (1, 64, 128, 3, 64, 64, 1), (6, 9, 16, 3, 24, 13, 2)]


def _toeplitz_operands(device, B, nb, G, kb, N, dtype=torch.bfloat16,
                       seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, nb, G), generator=g, device=device)
    w = torch.randn((kb, G, N), generator=g, device=device) / (kb * G) ** 0.5
    b = torch.randn((N,), generator=g, device=device) * 0.1
    return x.to(dtype), w.to(dtype), b.to(dtype)


def _ran(fn, *args, **kw):
    before = (fn.launches, fn.tensor_core_launches)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (fn.launches - before[0], fn.tensor_core_launches - before[1])


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("shape", WHOLE_K, ids=str)
def test_tensor_core_linear_fwd_matches_plain_and_first_version(cuda, shape,
                                                                act):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, *shape, torch.bfloat16)
    want = linear.linear_fwd_ref(x, w, b, act)
    first, rose = _ran(linear.linear_fwd, x, w, b, act, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran(linear.linear_fwd, x, w, b, act)      # auto
    assert rose == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= BF16_REL
    assert _rel(got, first) <= BF16_REL
    assert torch.equal(got, linear.linear_fwd(x, w, b, act))
    assert torch.equal(got, linear.linear_fwd(x, w, b, act,
                                              kernel="tensor_cores"))


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("case", CONV_TC + TOE_RAGGED, ids=str)
def test_tensor_core_toeplitz_matches_plain_and_first_version(cuda, case,
                                                              act):
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    B, nb, G, kb, N, t_out, shift = case
    x, w, b = _toeplitz_operands(cuda, B, nb, G, kb, N)
    want = toeplitz.toeplitz_fwd_ref(x, w, b, act, t_out, shift)
    first, rose = _ran(toeplitz.toeplitz_fwd, x, w, b, act, t_out, shift,
                       kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran(toeplitz.toeplitz_fwd, x, w, b, act, t_out, shift)
    assert rose == (1, 1)
    assert got.shape == want.shape == (B, t_out, N)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= BF16_REL
    assert _rel(got, first) <= BF16_REL
    assert torch.equal(got, toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift))


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("case", CONV_TC + TOE_RAGGED, ids=str)
def test_four_pass_toeplitz_on_the_tensor_cores(cuda, case, act):
    """fp32 in four passes (the `high` op-level step's wide layers; row 17's
    4-pass form: the split pass, then the Toeplitz walk's four products a
    stage): on the tensor cores (``split_launches``), within 1e-5 ·
    max|plain| of the 4-pass plain version and of the first version, equal
    bits on a second launch, and on single-term operands
    (``chip_smoke.py`` ``exact_toeplitz_case``) the plain version's bits."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    B, nb, G, kb, N, t_out, shift = case
    x, w, b = _toeplitz_operands(cuda, B, nb, G, kb, N, torch.float32)
    counts = (toeplitz.toeplitz_fwd.split_launches,
              toeplitz.toeplitz_fwd.tensor_core_launches)
    got = toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift, 4)
    torch.cuda.synchronize()
    assert (toeplitz.toeplitz_fwd.split_launches - counts[0],
            toeplitz.toeplitz_fwd.tensor_core_launches - counts[1]) == (1, 0)
    assert got.shape == (B, t_out, N) and got.dtype == torch.float32
    assert _rel(got, toeplitz.toeplitz_fwd_ref(x, w, b, act, t_out, shift,
                                               4)) <= 1e-5
    assert _rel(got, toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift, 4,
                                           kernel="cuda_cores")) <= 1e-5
    assert torch.equal(got, toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift,
                                                  4, kernel="tensor_cores"))
    xe, we, be = _smoke().exact_toeplitz_case(cuda, min(B, 64), nb, G, kb, N)
    assert torch.equal(
        toeplitz.toeplitz_fwd(xe, we, be, "relu", t_out, shift, 4),
        toeplitz.toeplitz_fwd_ref(xe, we, be, "relu", t_out, shift, 4))


def test_tensor_core_toeplitz_dispatch_on_the_card(cuda):
    """G = 4 (the first encoder layer), N = 4 (the last decoder layer),
    fp32 (one pass, and four where N is no multiple of 8) and a view off a
    16-byte boundary run another form than the tensor cores under ``auto``
    (the narrow one, the fp32 one, the first version) and raise when the
    tensor-core kernel is asked for by name."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    cases = [((64, 256, 4, 3, 32, 256, 1), torch.bfloat16, 1),
             ((64, 256, 32, 3, 4, 256, 1), torch.bfloat16, 1),
             ((64, 64, 128, 3, 64, 64, 1), torch.float32, 1),
             ((64, 64, 128, 3, 60, 64, 1), torch.float32, 4)]
    for (B, nb, G, kb, N, t_out, shift), dtype, passes in cases:
        x, w, b = _toeplitz_operands(cuda, B, nb, G, kb, N, dtype)
        got, rose = _ran(toeplitz.toeplitz_fwd, x, w, b, "relu", t_out,
                         shift, passes)
        assert rose == (1, 0), (G, N, dtype, passes)
        tol = BF16_REL if dtype == torch.bfloat16 else 1e-4
        assert _rel(got, toeplitz.toeplitz_fwd_ref(
            x, w, b, "relu", t_out, shift, passes)) <= tol
        with pytest.raises(ValueError, match="takes bf16 operands"):
            toeplitz.toeplitz_fwd(x, w, b, "relu", t_out, shift, passes,
                                  kernel="tensor_cores")
    x, w, b = _toeplitz_operands(cuda, 8, 64, 128, 3, 64)
    off = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:] \
        .view_as(x).copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    got, rose = _ran(toeplitz.toeplitz_fwd, off, w, b, "relu", 64, 1)
    assert rose == (1, 0)
    assert torch.equal(got, toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1,
                                                  kernel="cuda_cores"))
    with pytest.raises(ValueError, match="aligned = False"):
        toeplitz.toeplitz_fwd(off, w, b, "relu", 64, 1, kernel="tensor_cores")


def test_tensor_core_linear_fwd_dispatch_on_the_card(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    for shape, dtype in (((1000, 70, 33), torch.bfloat16),
                         ((512, 1028, 520), torch.bfloat16),
                         ((512, 1024, 516), torch.bfloat16),
                         ((512, 1024, 512), torch.float32)):
        x, w, b = _linear_operands(cuda, *shape, dtype)
        got, rose = _ran(linear.linear_fwd, x, w, b, "tanh")
        assert rose == (1, 0), shape
        tol = BF16_REL if dtype == torch.bfloat16 else 1e-4
        assert _rel(got, linear.linear_fwd_ref(x, w, b, "tanh")) <= tol
        with pytest.raises(ValueError, match="takes bf16 operands"):
            linear.linear_fwd(x, w, b, "tanh", kernel="tensor_cores")
    x, w, b = _linear_operands(cuda, 256, 1024, 512, torch.bfloat16)
    _, rose = _ran(linear.linear_fwd, x[:0], w, b, "relu")
    assert rose == (0, 0)


@pytest.mark.parametrize("width", [64, 128, 256])
def test_every_tile_width_matches_plain(cuda, width, monkeypatch):
    """The three tile widths of csrc/wgmma.cuh, forced, on both tile walks
    and both B layouts."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear, tensor_cores, \
        toeplitz

    monkeypatch.setattr(tensor_cores, "tile_n",
                        lambda tiles_m, n, sms: width)
    x, w, b = _linear_operands(cuda, 1000, 1096, 520, torch.bfloat16)
    for fn, plain in ((linear.linear_fwd, linear.linear_fwd_ref),
                      (linear.linear_ksplit_fwd,
                       linear.linear_ksplit_fwd_ref)):
        got, rose = _ran(fn, x, w, b, "relu")
        assert rose == (1, 1)
        assert _rel(got, plain(x, w, b, "relu")) <= BF16_REL
    wt = w.t().contiguous()
    got, rose = _ran(mlp.matmul_nt, x, wt)
    assert rose == (1, 1)
    assert _rel(got, mlp.matmul_nt_ref(x, wt)) <= BF16_REL
    for B, nb, G, kb, N, t_out, shift in (CONV_TC[1], TOE_RAGGED[1]):
        xs, ws, bs = _toeplitz_operands(cuda, B, nb, G, kb, N)
        got, rose = _ran(toeplitz.toeplitz_fwd, xs, ws, bs, "tanh", t_out,
                         shift)
        assert rose == (1, 1)
        assert _rel(got, toeplitz.toeplitz_fwd_ref(xs, ws, bs, "tanh", t_out,
                                                   shift)) <= BF16_REL


def test_conv1d_op_level_step_takes_the_tensor_cores(cuda):
    """configs/conv1d.ini's widths at a small batch, bf16, forward and
    backward through conv_encode_pallas / conv_decode_pallas: 8 + 7 Toeplitz
    launches, 12 of them on the tensor cores and the other 3 (the first
    encoder layer, G = 4, the last decoder layer, N = 4, and its dx, G =
    4) on the narrow-channel kernel, and the three whole-k linear launches
    all on the tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.models import variants
    from rawaudiovae_kelsey_tpu_torch.ops import conv, linear, toeplitz
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    params = tree_map(
        lambda t: t.to(cuda, torch.bfloat16).requires_grad_(),
        variants.init_conv1d(torch.Generator().manual_seed(0), 1024,
                             (32, 64, 128, 256), 9, 4, 256))
    x = (torch.rand((64, 1024), device=cuda) * 2 - 1).bfloat16()
    width = variants.conv_latent_width(1024, 4, 4)
    fns = (toeplitz.toeplitz_fwd, linear.linear_fwd)
    before = [(f.launches, f.tensor_core_launches) for f in fns]
    narrow = toeplitz.toeplitz_fwd.narrow_launches
    mu, _ = conv.conv_encode_pallas(params, x, 4)
    y = conv.conv_decode_pallas(params, mu, 4, width, 256)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    rose = [(f.launches - a, f.tensor_core_launches - c)
            for f, (a, c) in zip(fns, before)]
    assert rose == [(15, 12), (3, 3)]
    assert toeplitz.toeplitz_fwd.narrow_launches - narrow == 3
    # the plain convolutions on the same bf16 operands, rounded per layer
    fixed = tree_map(lambda t: t.detach(), params)
    with torch.no_grad():
        plain = variants.decode_conv1d(
            fixed, variants.encode_conv1d(fixed, x, 4)[0], 4, width, 256)
    assert y.shape == plain.shape
    assert _rel(y.detach(), plain) <= 4 * BF16_REL


# ---- toeplitz_fwd (row 17)'s narrow-channel form (csrc/narrow.cuh: G or N
# below 8, either dtype, passes 1 or 4) and its fp32 form (csrc/sgemm.cuh's
# mainloop with an implicit Toeplitz A, over the contraction window): both
# compute each output as the first version's FMA chain, so both give its
# bits (kernel="cuda_cores"), and equal bits on a second launch; within
# 1e-4 · max|plain| (fp32) / 2^-6 (bf16) of the plain version.  Shapes:
# every layer of configs/conv1d.ini at batch 64, forward (with its window)
# and dx; ragged ones (G or N of 3, 4, 6, 8; N = 40 over two column chunks;
# t_out past nb over three blocks of positions; batch 1); every column
# chunk and every fp32 tile forced.

CONV1D_LAYERS = [("conv", 1024, 1, 32), ("conv", 256, 32, 64),
                 ("conv", 64, 64, 128), ("conv", 16, 128, 256),
                 ("convT", 4, 256, 128), ("convT", 16, 128, 64),
                 ("convT", 64, 64, 32), ("convT", 256, 32, 1)]
# (B, nb, G, KB, N, t_out, shift)
FORMS_RAGGED = [(37, 9, 4, 3, 24, 13, 0), (1, 9, 24, 3, 4, 5, 2),
                (37, 40, 3, 3, 8, 40, 2), (5, 300, 6, 5, 40, 301, 4),
                (2, 20, 8, 3, 4, 17, 1), (3, 33, 12, 2, 6, 33, 1),
                (37, 9, 24, 3, 40, 13, 2), (4, 130, 16, 3, 72, 129, 0)]
FORM_COUNTERS = {"tensor_cores": "tensor_core_launches",
                 "sgemm": "sgemm_launches", "narrow": "narrow_launches"}


def _forms_rose(fn, *args, **kw):
    """``fn(*args, **kw)`` and the form its launch took."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    f = toeplitz.toeplitz_fwd
    before = {k: getattr(f, c) for k, c in FORM_COUNTERS.items()}
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    took = [k for k, c in FORM_COUNTERS.items() if getattr(f, c) > before[k]]
    return out, took[0] if took else "cuda_cores"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("layer", range(8))
def test_conv1d_layers_give_the_first_versions_bits(cuda, layer, dtype):
    from rawaudiovae_kelsey_tpu_torch.ops import conv, toeplitz

    direction, length, cin, cout = CONV1D_LAYERS[layer]
    g = torch.Generator(device=cuda).manual_seed(layer)
    x = torch.randn((64, length, cin), generator=g, device=cuda).to(dtype)
    w = (torch.randn((9, cin, cout), generator=g, device=cuda)
         / (9 * cin) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=cuda) * 0.1).to(dtype)
    if direction == "conv":
        xf, wp, t_out, shift = conv.pack_conv1d(x, w, 4)
        bp, window = b, conv.conv1d_window(length, 9, cin, 4)
    else:
        xf, wp, bp, t_out, shift = conv.pack_conv1d_transpose(x, w, b, 4)
        window = None
    wp = wp.contiguous()
    da = torch.randn((64, t_out, wp.shape[2]), generator=g,
                     device=cuda).to(dtype)
    wrev = wp.flip(0).transpose(1, 2).contiguous()
    zero = torch.zeros((wp.shape[1],), device=cuda, dtype=dtype)
    narrow = layer in (0, 7)
    want_form = "narrow" if narrow else \
        "sgemm" if dtype == torch.float32 else "tensor_cores"
    tol = 1e-4 if dtype == torch.float32 else BF16_REL
    for args, win in (((xf, wp, bp, "relu", t_out, shift), window),
                      ((da, wrev, zero, "none", xf.shape[1],
                        wp.shape[0] - 1 - shift), None)):
        got, form = _forms_rose(toeplitz.toeplitz_fwd, *args, window=win)
        assert form == want_form
        assert _rel(got, toeplitz.toeplitz_fwd_ref(*args)) <= tol
        assert torch.equal(got, toeplitz.toeplitz_fwd(*args, window=win))
        if form != "tensor_cores":
            assert torch.equal(got, toeplitz.toeplitz_fwd(
                *args, kernel="cuda_cores"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FORMS_RAGGED, ids=str)
def test_narrow_and_fp32_forms_at_ragged_shapes(cuda, case, dtype):
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    B, nb, G, kb, N, t_out, shift = case
    for passes in ((1, 4) if dtype == torch.float32 else (1,)):
        x, w, b = _toeplitz_operands(cuda, B, nb, G, kb, N, dtype,
                                     seed=passes)
        args = (x, w, b, "tanh", t_out, shift, passes)
        got, form = _forms_rose(toeplitz.toeplitz_fwd, *args)
        if min(G, N) < 8:
            assert form == "narrow"
        elif dtype == torch.float32 and passes == 1:
            assert form == "sgemm"
        tol = 1e-5 if passes == 4 else \
            1e-4 if dtype == torch.float32 else BF16_REL
        assert got.shape == (B, t_out, N)
        assert _rel(got, toeplitz.toeplitz_fwd_ref(*args)) <= tol
        if form in ("narrow", "sgemm"):
            assert torch.equal(got, toeplitz.toeplitz_fwd(
                *args, kernel="cuda_cores"))
            assert torch.equal(got, toeplitz.toeplitz_fwd(*args,
                                                          kernel=form))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_every_narrow_column_chunk_gives_the_same_bits(cuda, chunk,
                                                       monkeypatch):
    """N = 40 (five, three, two or two column chunks) at G = 4, both
    dtypes: the staged store where a whole chunk is wider than 16 bytes,
    the row's own stores elsewhere."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    monkeypatch.setattr(toeplitz, "narrow_chunk", lambda n: chunk)
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = _toeplitz_operands(cuda, 9, 300, 4, 3, 40, dtype)
        got, form = _forms_rose(toeplitz.toeplitz_fwd, x, w, b, "relu", 300,
                                1)
        assert form == "narrow"
        assert torch.equal(got, toeplitz.toeplitz_fwd(
            x, w, b, "relu", 300, 1, kernel="cuda_cores"))


@pytest.mark.parametrize("rows", [1, 2])
def test_both_narrow_row_counts_give_the_same_bits(cuda, rows, monkeypatch):
    """One or two positions a thread (one pass), at the conv1d model's two
    narrow shapes at batch 37 and t_out past nb, both dtypes."""
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    monkeypatch.setattr(toeplitz, "narrow_rows", lambda passes: rows)
    for dtype in (torch.float32, torch.bfloat16):
        for G, N in ((4, 32), (32, 4)):
            x, w, b = _toeplitz_operands(cuda, 37, 250, G, 3, N, dtype)
            got, form = _forms_rose(toeplitz.toeplitz_fwd, x, w, b, "tanh",
                                    257, 1)
            assert form == "narrow"
            assert torch.equal(got, toeplitz.toeplitz_fwd(
                x, w, b, "tanh", 257, 1, kernel="cuda_cores"))


@pytest.mark.parametrize("tile", [(128, 128), (128, 64), (64, 64)])
def test_every_fp32_toeplitz_tile_gives_the_same_bits(cuda, tile,
                                                      monkeypatch):
    """The fp32 form on each tile of SGEMM_TILES, forced: layer 1's shape
    at batch 37 over its window, and a ragged shape."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores, toeplitz

    monkeypatch.setattr(tensor_cores, "sgemm_whole_tile",
                        lambda rows, n, sms: tile)
    for (B, nb, G, kb, N, t_out, shift), window in (
            ((37, 64, 128, 3, 64, 64, 1), (64, 352)),
            ((5, 100, 24, 3, 40, 101, 2), None)):
        x, w, b = _toeplitz_operands(cuda, B, nb, G, kb, N, torch.float32)
        if window is not None:
            w.view(-1, N)[:window[0]] = 0
            w.view(-1, N)[window[1]:] = 0
        got, form = _forms_rose(toeplitz.toeplitz_fwd, x, w, b, "tanh",
                                t_out, shift, window=window)
        assert form == "sgemm"
        assert torch.equal(got, toeplitz.toeplitz_fwd(
            x, w, b, "tanh", t_out, shift, kernel="cuda_cores"))


def test_named_toeplitz_forms_raise_on_the_card(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import toeplitz

    x, w, b = _toeplitz_operands(cuda, 8, 64, 128, 3, 64)
    with pytest.raises(ValueError, match="'narrow' takes"):
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, kernel="narrow")
    with pytest.raises(ValueError, match="'sgemm' takes fp32"):
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, kernel="sgemm")
    with pytest.raises(ValueError, match="'sgemm' takes fp32"):
        toeplitz.toeplitz_fwd(x.float(), w.float(), b.float(), "relu", 64,
                              1, 4, kernel="sgemm")


# ---- fp32 linear_fwd (row 16) and matmul_nt (row 4) on the register-tiled
# fp32 kernel (csrc/sgemm.cuh): within 1e-4 · max|plain| of the plain
# version and of the first version (IEEE fp32 FFMAs, the sums in another
# order), equal bits on a second launch.  Shapes: the deep server's nine
# distinct layers at its batch of 256, the deep heads at 4096 rows,
# 4096^3, matmul_nt's dz and dx at the microbatch; ragged rows against the
# 128- and 64-row tiles (4097, 1000, 130, 7), k against the 16-deep slab
# (1088, 1096, 68, 12, 4 and 24 shorter than one), n against the tile (544,
# 520, 260, 20, 8); batch 1.  What the kernel cannot take (k or n no
# multiple of 4, a view off a 16-byte boundary) keeps the first version.

SGEMM_REL = 1e-4
SERVER_SHAPES = [(256, 4096, 4096), (256, 4096, 2048), (256, 2048, 1024),
                 (256, 1024, 512), (256, 512, 256), (256, 256, 512),
                 (256, 512, 1024), (256, 1024, 2048), (256, 2048, 4096)]
SGEMM_RAGGED = [(4097, 1088, 544), (1000, 1096, 520), (130, 68, 260),
                (7, 12, 20), (1, 24, 8), (1, 4, 4), (1, 4096, 4096)]
SGEMM_LINEAR = SERVER_SHAPES + [(4096, 512, 256),
                                (4096, 4096, 4096)] + SGEMM_RAGGED
SGEMM_NT = [(8192, 2048, 256), (8192, 2048, 1024)] + SGEMM_RAGGED


def _ran_sgemm(fn, *args, **kw):
    before = (fn.launches, fn.sgemm_launches)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (fn.launches - before[0], fn.sgemm_launches - before[1])


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("shape", SGEMM_LINEAR, ids=str)
def test_sgemm_linear_fwd_matches_plain_and_first_version(cuda, shape, act):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, *shape, torch.float32)
    want = linear.linear_fwd_ref(x, w, b, act)
    first, rose = _ran_sgemm(linear.linear_fwd, x, w, b, act,
                             kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_sgemm(linear.linear_fwd, x, w, b, act)     # auto
    assert rose == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= SGEMM_REL
    assert _rel(got, first) <= SGEMM_REL
    assert torch.equal(got, linear.linear_fwd(x, w, b, act))
    assert torch.equal(got, linear.linear_fwd(x, w, b, act, kernel="sgemm"))


@pytest.mark.parametrize("shape", SGEMM_NT, ids=str)
def test_sgemm_matmul_nt_matches_plain_and_first_version(cuda, shape):
    rows, k, m = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn((rows, k), generator=g, device=cuda)
    w = torch.randn((m, k), generator=g, device=cuda) / k ** 0.5
    want = mlp.matmul_nt_ref(a, w)
    first, rose = _ran_sgemm(mlp.matmul_nt, a, w, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_sgemm(mlp.matmul_nt, a, w)
    assert rose == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= SGEMM_REL
    assert _rel(got, first) <= SGEMM_REL
    assert torch.equal(got, mlp.matmul_nt(a, w))
    assert torch.equal(got, mlp.matmul_nt(a, w, kernel="sgemm"))


@pytest.mark.parametrize("tile", [(128, 128), (128, 64), (64, 64)])
def test_every_sgemm_tile_matches_plain(cuda, tile, monkeypatch):
    """The three tiles of csrc/sgemm.cuh, forced, on both B layouts and a
    ragged shape."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear, tensor_cores

    monkeypatch.setattr(tensor_cores, "sgemm_tile",
                        lambda rows, n, sms: tile)
    x, w, b = _linear_operands(cuda, 1000, 1096, 520, torch.float32)
    got, rose = _ran_sgemm(linear.linear_fwd, x, w, b, "tanh")
    assert rose == (1, 1)
    assert _rel(got, linear.linear_fwd_ref(x, w, b, "tanh")) <= SGEMM_REL
    wt = w.t().contiguous()
    got, rose = _ran_sgemm(mlp.matmul_nt, x, wt)
    assert rose == (1, 1)
    assert _rel(got, mlp.matmul_nt_ref(x, wt)) <= SGEMM_REL


def test_sgemm_dispatch_on_the_card(cuda):
    """k or n no multiple of 4 and a view off a 16-byte boundary keep the
    first version under ``auto`` and raise when the fp32 kernel is asked
    for by name; bf16 operands never take it; a zero-row batch launches
    nothing."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    for shape in ((1000, 70, 36), (1000, 72, 33), (512, 1026, 520)):
        x, w, b = _linear_operands(cuda, *shape, torch.float32)
        got, rose = _ran_sgemm(linear.linear_fwd, x, w, b, "relu")
        assert rose == (1, 0), shape
        assert _rel(got, linear.linear_fwd_ref(x, w, b, "relu")) <= SGEMM_REL
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
            linear.linear_fwd(x, w, b, "relu", kernel="sgemm")
        wt = w.t().contiguous()
        got, rose = _ran_sgemm(mlp.matmul_nt, x, wt)
        assert rose == (1, 0), shape
        assert _rel(got, mlp.matmul_nt_ref(x, wt)) <= SGEMM_REL
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
            mlp.matmul_nt(x, wt, kernel="sgemm")
    # contiguous, but four bytes off a 16-byte boundary
    x, w, b = _linear_operands(cuda, 256, 1024, 512, torch.float32)
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    got, rose = _ran_sgemm(linear.linear_fwd, off, w, b, "relu")
    assert rose == (1, 0)
    assert torch.equal(got, linear.linear_fwd(x, w, b, "relu",
                                              kernel="cuda_cores"))
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_fwd(off, w, b, "relu", kernel="sgemm")
    got, rose = _ran_sgemm(mlp.matmul_nt, off, w.t().contiguous())
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="aligned = False"):
        mlp.matmul_nt(off, w.t().contiguous(), kernel="sgemm")
    xb, wb, bb = (t.bfloat16() for t in (x, w, b))
    _, rose = _ran_sgemm(linear.linear_fwd, xb, wb, bb, "relu")
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        linear.linear_fwd(xb, wb, bb, "relu", kernel="sgemm")
    _, rose = _ran_sgemm(linear.linear_fwd, x[:0], w, b, "relu")
    assert rose == (0, 0)
    _, rose = _ran_sgemm(mlp.matmul_nt, x[:0], w.t().contiguous())
    assert rose == (0, 0)


def test_deep_fp32_server_forward_takes_the_sgemm_kernel(cuda):
    """The deep model's fp32 forward at the server's batch through the
    kernel backend: eleven whole-k launches, all on the fp32 kernel,
    against the plain model on the same parameters."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    cfg = Config()
    cfg.vae.arch = "deep"
    cfg.audio.segment_length, cfg.vae.latent_dim = 4096, 256
    x = torch.rand((256, 4096), device=cuda) * 2 - 1
    outs = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        params = model.init(torch.Generator().manual_seed(0))
        counts = (linear.linear_fwd.launches,
                  linear.linear_fwd.sgemm_launches,
                  linear.linear_ksplit_fwd.launches)
        with torch.inference_mode():
            mu, logvar = model.encode(params, x)
            y = model.decode(params, mu)
        torch.cuda.synchronize()
        if backend == "pallas":
            assert (linear.linear_fwd.launches - counts[0],
                    linear.linear_fwd.sgemm_launches - counts[1],
                    linear.linear_ksplit_fwd.launches - counts[2]) \
                == (11, 11, 0)
        outs[backend] = (mu, logvar, y)
    for got, want in zip(outs["pallas"], outs["xla"]):
        assert _rel(got, want) <= SGEMM_REL


# ---- row 15 in fp32 on csrc/sgemm.cuh and row 1 in bf16 on csrc/wgmma.cuh.
# fp32 linear_ksplit_fwd takes the fp32 kernel of linear_fwd (the same
# launch): within SGEMM_REL of its plain version (the per-slice partials
# added in slice order) and of the first version (the split-K partials),
# equal bits with linear_fwd(kernel="sgemm") and on a second launch.  bf16
# encoder_fwd runs h and both heads on the tensor cores: every output within
# BF16_REL of its plain version and of the first version, equal bits on a
# second launch; shapes: the training microbatch, the ragged 1000, batch 1,
# latents that are no multiple of the tile width (72, 200) and a narrow
# model (ragged rows, k and n against the tile).

SGEMM_KSPLIT = [(4096, 4096, 4096), (4096, 1024, 512), (4096, 2048, 1024),
                (4097, 1088, 544), (1000, 1096, 520), (130, 68, 260),
                (7, 12, 20), (1, 24, 8)]


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("shape", SGEMM_KSPLIT, ids=str)
def test_sgemm_ksplit_matches_plain_and_linear_fwd(cuda, shape, act):
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    x, w, b = _linear_operands(cuda, *shape, torch.float32)
    want = linear.linear_ksplit_fwd_ref(x, w, b, act)
    first, rose = _ran_sgemm(linear.linear_ksplit_fwd, x, w, b, act,
                             kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_sgemm(linear.linear_ksplit_fwd, x, w, b, act)   # auto
    assert rose == (1, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= SGEMM_REL
    assert _rel(got, first) <= SGEMM_REL
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, act))
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, act,
                                                     kernel="sgemm"))
    assert torch.equal(got, linear.linear_fwd(x, w, b, act, kernel="sgemm"))


def test_sgemm_ksplit_dispatch_on_the_card(cuda):
    """k or n no multiple of 4 and an unaligned view keep the split-K first
    version under ``auto`` and raise for ``kernel="sgemm"``; bf16 raises
    too; the deep config's k-split layers in a ``highest`` step take it."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    for shape in ((1000, 70, 36), (1000, 72, 33), (512, 1026, 520)):
        x, w, b = _linear_operands(cuda, *shape, torch.float32)
        got, rose = _ran_sgemm(linear.linear_ksplit_fwd, x, w, b, "relu")
        assert rose == (1, 0), shape
        assert _rel(got, linear.linear_ksplit_fwd_ref(x, w, b, "relu")) \
            <= SGEMM_REL
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
            linear.linear_ksplit_fwd(x, w, b, "relu", kernel="sgemm")
    x, w, b = _linear_operands(cuda, 1024, 1024, 512, torch.float32)
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
    got, rose = _ran_sgemm(linear.linear_ksplit_fwd, off, w, b, "relu")
    assert rose == (1, 0)
    assert torch.equal(got, linear.linear_ksplit_fwd(x, w, b, "relu",
                                                     kernel="cuda_cores"))
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_ksplit_fwd(off, w, b, "relu", kernel="sgemm")
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        linear.linear_ksplit_fwd(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                                 "relu", kernel="sgemm")


def test_deep_highest_step_runs_the_ksplit_layers_on_sgemm(cuda):
    """The deep model's ``highest`` step at widths past the k-split gate:
    every k-split launch on the fp32 kernel, against the plain backend, on
    an input whose ReLU gates both backends decide alike (_untied)."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import linear
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    cfg = Config()
    cfg.vae.arch, cfg.vae.hidden_dims = "deep", "2048,1024,512"
    cfg.audio.segment_length, cfg.vae.latent_dim = 2048, 64
    cfg.tpu.precision = "highest"
    x = _untied(cfg, torch.rand((1024, 2048), device=cuda) * 2 - 1, cuda)

    def noise(step, i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(1))

    mus = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0)
        counts = (linear.linear_ksplit_fwd.launches,
                  linear.linear_ksplit_fwd.sgemm_launches)
        state, _ = build_train_step(model, cfg, noise=noise)(state, x)
        torch.cuda.synchronize()
        if backend == "pallas":
            # 2048->2048, 2048->1024, 1024->512 | 1024->2048, 2048->2048
            assert (linear.linear_ksplit_fwd.launches - counts[0],
                    linear.linear_ksplit_fwd.sgemm_launches - counts[1]) \
                == (5, 5)
        mus[backend] = torch.cat([t.ravel() for t in leaves(state.mu)])
    err = float((mus["pallas"] - mus["xla"]).norm() / mus["xla"].norm())
    assert err <= 1e-4


ENCODER_TC = [(8192, 1024, 2048, 256), (1000, 1024, 2048, 256),
              (1, 1024, 2048, 256), (1000, 1024, 2048, 72),
              (4097, 256, 512, 200), (130, 72, 136, 8)]


def _encoder_operands(device, batch, seg, units, latent, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = (((seg, units), seg ** -0.5), ((units,), 0.1),
              ((units, latent), units ** -0.5), ((latent,), 0.1),
              ((units, latent), units ** -0.5), ((latent,), 0.1),
              ((batch, seg), 0.5))
    return [(torch.randn(s, generator=g, device=device) * scale).bfloat16()
            for s, scale in shapes]


def _ran_tc(fn, *args, **kw):
    before = (fn.launches, fn.tensor_core_launches)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (fn.launches - before[0], fn.tensor_core_launches - before[1])


@pytest.mark.parametrize("shape", ENCODER_TC, ids=str)
def test_tensor_core_encoder_matches_plain_and_first_version(cuda, shape):
    ops_ = _encoder_operands(cuda, *shape)
    want = mlp.encoder_fwd_ref(*ops_)
    first, rose = _ran_tc(mlp.encoder_fwd, *ops_, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_tc(mlp.encoder_fwd, *ops_)                       # auto
    assert rose == (1, 1)
    for g, w, f in zip(got, want, first):          # mu, logvar, h
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BF16_REL
        assert _rel(g, f) <= BF16_REL
    for g, a in zip(got, mlp.encoder_fwd(*ops_, kernel="tensor_cores")):
        assert torch.equal(g, a)


def test_tensor_core_encoder_dispatch_on_the_card(cuda):
    """fp32, a latent no multiple of 8 and an unaligned view keep the first
    version under ``auto`` and raise for ``kernel="tensor_cores"``; a
    zero-row batch launches nothing."""
    ops_ = _encoder_operands(cuda, 1000, 1024, 2048, 36)
    got, rose = _ran_tc(mlp.encoder_fwd, *ops_)
    assert rose == (1, 0)
    for g, w in zip(got, mlp.encoder_fwd_ref(*ops_)):
        assert _rel(g, w) <= BF16_REL
    with pytest.raises(ValueError, match="latent 36"):
        mlp.encoder_fwd(*ops_, kernel="tensor_cores")
    ops_ = _encoder_operands(cuda, 256, 1024, 2048, 256)
    f32 = [t.float() for t in ops_]
    _, rose = _ran_tc(mlp.encoder_fwd, *f32)
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="takes bf16 operands"):
        mlp.encoder_fwd(*f32, kernel="tensor_cores")
    x = ops_[-1]
    off = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:] \
        .view_as(x).copy_(x)
    got, rose = _ran_tc(mlp.encoder_fwd, *ops_[:-1], off)
    assert rose == (1, 0)
    for g, f in zip(got, mlp.encoder_fwd(*ops_, kernel="cuda_cores")):
        assert torch.equal(g, f)
    with pytest.raises(ValueError, match="aligned = False"):
        mlp.encoder_fwd(*ops_[:-1], off, kernel="tensor_cores")
    _, rose = _ran_tc(mlp.encoder_fwd, *ops_[:-1], x[:0])
    assert rose == (0, 0)


@pytest.mark.parametrize("width", [64, 128, 256])
def test_every_heads_tile_width_matches_plain(cuda, width, monkeypatch):
    """The tensor-core encoder with the tile width of both launches forced:
    the heads' walk at 1, 2 and 4 tile columns a head (latent 256)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "tile_n",
                        lambda tiles_m, n, sms: width)
    ops_ = _encoder_operands(cuda, 1000, 1024, 2048, 256, seed=3)
    got, rose = _ran_tc(mlp.encoder_fwd, *ops_)
    assert rose == (1, 1)
    for g, w in zip(got, mlp.encoder_fwd_ref(*ops_)):
        assert _rel(g, w) <= BF16_REL


def test_bf16_dense_step_runs_the_encoder_on_the_tensor_cores(cuda):
    """One bf16 step of the dense kernel backend at batch 3 x 1024 with
    microbatch 1024 plus a ragged tail: every encoder_fwd launch on the
    tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "bfloat16"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    before = (mlp.encoder_fwd.launches, mlp.encoder_fwd.tensor_core_launches)
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    assert (mlp.encoder_fwd.launches - before[0],
            mlp.encoder_fwd.tensor_core_launches - before[1]) == (4, 4)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- rows 2 and 10 in bf16 on csrc/wgmma.cuh.  decoder_fwd runs h3 and y on
# the tensor cores (the linear layer's launch), dec_bwd_fused dh3 (the gate
# in the epilogue), dz and the weight gradient (an M-major A, fp32 output,
# the batch cut into slices added in order): every output within BF16_REL
# of its plain version and of the first version, equal bits on a second
# launch; shapes (batch, latent, units, seg): the training microbatch, the
# ragged 1000, batch 1, a ragged width TMA takes and a narrow model.

DECODER_TC = [(8192, 256, 2048, 1024), (1000, 256, 2048, 1024),
              (1, 256, 2048, 1024), (1000, 72, 520, 264),
              (4097, 256, 2048, 1024), (130, 8, 136, 72)]


def _decoder_operands(device, batch, latent, units, seg, seed=0):
    """(w3, b3, w4, b4, z) and (da, h3, z, w4, w3), bf16."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=g, device=device) * scale
        return (t.clamp_min(0) if relu else t).bfloat16()

    w3, b3 = rnd(latent, units, scale=latent ** -0.5), rnd(units, scale=0.1)
    w4, b4 = rnd(units, seg, scale=units ** -0.5), rnd(seg, scale=0.1)
    z = rnd(batch, latent)
    da, h3 = rnd(batch, seg, scale=1e-2), rnd(batch, units, relu=True)
    return (w3, b3, w4, b4, z), (da, h3, z, w4, w3)


@pytest.mark.parametrize("shape", DECODER_TC, ids=str)
def test_tensor_core_decoder_matches_plain_and_first_version(cuda, shape):
    fwd, bwd = _decoder_operands(cuda, *shape)
    for op, plain, ops_ in ((mlp.decoder_fwd, mlp.decoder_fwd_ref, fwd),
                            (mlp.dec_bwd_fused, mlp.dec_bwd_fused_ref, bwd)):
        want = plain(*ops_)
        first, rose = _ran_tc(op, *ops_, kernel="cuda_cores")
        assert rose == (1, 0)
        got, rose = _ran_tc(op, *ops_)                                # auto
        assert rose == (1, 1)
        for g, w, f in zip(got, want, first):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert bool(torch.isfinite(g).all())
            assert _rel(g, w) <= BF16_REL
            assert _rel(g, f) <= BF16_REL
        for g, a in zip(got, op(*ops_, kernel="tensor_cores")):
            assert torch.equal(g, a)


def test_tensor_core_decoder_dispatch_on_the_card(cuda):
    """fp32, a latent no multiple of 8 and an unaligned view keep the first
    version under ``auto`` and raise for ``kernel="tensor_cores"``; a
    zero-row batch launches no decoder and gives zero gradients."""
    fwd, bwd = _decoder_operands(cuda, 1000, 36, 2048, 1024)
    for op, plain, ops_ in ((mlp.decoder_fwd, mlp.decoder_fwd_ref, fwd),
                            (mlp.dec_bwd_fused, mlp.dec_bwd_fused_ref, bwd)):
        got, rose = _ran_tc(op, *ops_)
        assert rose == (1, 0)
        for g, w in zip(got, plain(*ops_)):
            assert _rel(g, w) <= BF16_REL
        with pytest.raises(ValueError, match="latent 36"):
            op(*ops_, kernel="tensor_cores")
    fwd, bwd = _decoder_operands(cuda, 256, 256, 2048, 1024)
    for op, ops_, at in ((mlp.decoder_fwd, fwd, 4), (mlp.dec_bwd_fused, bwd,
                                                     0)):
        f32 = [t.float() for t in ops_]
        _, rose = _ran_tc(op, *f32)
        assert rose == (1, 0)
        with pytest.raises(ValueError, match="takes bf16 operands"):
            op(*f32, kernel="tensor_cores")
        x = ops_[at]
        off = torch.empty(x.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view_as(x).copy_(x)
        moved = [off if i == at else t for i, t in enumerate(ops_)]
        got, rose = _ran_tc(op, *moved)
        assert rose == (1, 0)
        for g, f in zip(got, op(*ops_, kernel="cuda_cores")):
            assert torch.equal(g, f)
        with pytest.raises(ValueError, match="aligned = False"):
            op(*moved, kernel="tensor_cores")
    _, rose = _ran_tc(mlp.decoder_fwd, *fwd[:-1], fwd[-1][:0])
    assert rose == (0, 0)
    dz, dw3, db3 = mlp.dec_bwd_fused(*(t[:0] for t in bwd[:3]), *bwd[3:])
    torch.cuda.synchronize()
    assert dz.shape == (0, 256)
    assert not dw3.any() and not db3.any()


@pytest.mark.parametrize("plan", [(256, 8), (256, 1), (128, 4), (64, 3),
                                  (64, 16)])
def test_every_weight_gradient_plan_matches_plain(cuda, plan, monkeypatch):
    """The weight gradient with the plan forced: one slice, slices that cut
    the ragged batch unevenly, every tile width; equal bits twice."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "wgrad_plan",
                        lambda m, n, k, sms, outputs=1: plan)
    _, bwd = _decoder_operands(cuda, 8100, 256, 2048, 1024, seed=5)
    got, rose = _ran_tc(mlp.dec_bwd_fused, *bwd)
    assert rose == (1, 1)
    for g, w in zip(got, mlp.dec_bwd_fused_ref(*bwd)):
        assert _rel(g, w) <= BF16_REL
    for g, a in zip(got, mlp.dec_bwd_fused(*bwd)):
        assert torch.equal(g, a)


def test_bf16_dense_step_runs_the_decoder_on_the_tensor_cores(cuda):
    """One bf16 step of the dense kernel backend at batch 3 x 1024 with
    microbatch 1024 plus a ragged tail: every decoder_fwd and
    dec_bwd_fused launch on the tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "bfloat16"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    ops_ = (mlp.decoder_fwd, mlp.dec_bwd_fused)
    before = [(f.launches, f.tensor_core_launches) for f in ops_]
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    for f, (n, n_tc) in zip(ops_, before):
        assert (f.launches - n, f.tensor_core_launches - n_tc) == (4, 4)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- rows 7 and 8 in bf16 on csrc/wgmma.cuh.  grad_accum is the weight
# gradient's launch alone (dW4 = h3ᵀ da at the step); enc_bwd_dw1 runs dh as
# one product joined along k (dmu and w21, then dlv and w22) with the gate
# in its epilogue, then that weight gradient: every output within BF16_REL
# of its plain version and of the first version, equal bits on a second
# launch; shapes (batch, latent, units, seg) as DECODER_TC's (latent 8: one
# k-step a product, zero-filled past column 8).

def _weight_gradient_operands(device, batch, latent, units, seg, seed=0):
    """(x, h, dmu, dlv, w21, w22) for enc_bwd_dw1 and (h3, da) for
    grad_accum, bf16."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=g, device=device) * scale
        return (t.clamp_min(0) if relu else t).bfloat16()

    x, h = rnd(batch, seg, scale=0.3), rnd(batch, units, relu=True)
    dmu, dlv = rnd(batch, latent), rnd(batch, latent)
    w21 = rnd(units, latent, scale=units ** -0.5)
    w22 = rnd(units, latent, scale=units ** -0.5)
    h3, da = rnd(batch, units, relu=True), rnd(batch, seg, scale=1e-2)
    return (x, h, dmu, dlv, w21, w22), (h3, da)


def _weight_gradient_ops(cuda, shape, seed=0):
    enc, dec = _weight_gradient_operands(cuda, *shape, seed=seed)
    return ((mlp.grad_accum, mlp.grad_accum_ref, dec),
            (mlp.enc_bwd_dw1, mlp.enc_bwd_dw1_ref, enc))


@pytest.mark.parametrize("shape", DECODER_TC, ids=str)
def test_tensor_core_weight_gradients_match_plain_and_first_version(cuda,
                                                                   shape):
    for op, plain, ops_ in _weight_gradient_ops(cuda, shape):
        want = plain(*ops_)
        first, rose = _ran_tc(op, *ops_, kernel="cuda_cores")
        assert rose == (1, 0)
        got, rose = _ran_tc(op, *ops_)                                # auto
        assert rose == (1, 1)
        for g, w, f in zip(got, want, first):
            assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
            assert bool(torch.isfinite(g).all())
            assert _rel(g, w) <= BF16_REL
            assert _rel(g, f) <= BF16_REL
        for g, a in zip(got, op(*ops_, kernel="tensor_cores")):
            assert torch.equal(g, a)


def test_tensor_core_weight_gradient_dispatch_on_the_card(cuda):
    """A width no multiple of 8, fp32 and an unaligned view keep the first
    version under ``auto`` and raise for ``kernel="tensor_cores"``; a
    zero-row batch gives zero gradients."""
    (enc, dec) = _weight_gradient_operands(cuda, 1000, 36, 2048, 1020)
    for op, plain, ops_, what in (
            (mlp.grad_accum, mlp.grad_accum_ref, dec, "m 1020"),
            (mlp.enc_bwd_dw1, mlp.enc_bwd_dw1_ref, enc, "seg 1020")):
        got, rose = _ran_tc(op, *ops_)
        assert rose == (1, 0)
        for g, w in zip(got, plain(*ops_)):
            assert _rel(g, w) <= BF16_REL
        with pytest.raises(ValueError, match=what):
            op(*ops_, kernel="tensor_cores")
    for (op, _, ops_), at in zip(
            _weight_gradient_ops(cuda, (256, 256, 2048, 1024)), (1, 0)):
        f32 = [t.float() for t in ops_]
        _, rose = _ran_tc(op, *f32)
        assert rose == (1, 0)
        with pytest.raises(ValueError, match="takes bf16 operands"):
            op(*f32, kernel="tensor_cores")
        t = ops_[at]
        off = torch.empty(t.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view_as(t).copy_(t)
        moved = [off if i == at else u for i, u in enumerate(ops_)]
        got, rose = _ran_tc(op, *moved)
        assert rose == (1, 0)
        for g, f in zip(got, op(*ops_, kernel="cuda_cores")):
            assert torch.equal(g, f)
        with pytest.raises(ValueError, match="aligned = False"):
            op(*moved, kernel="tensor_cores")
        empty = [u[:0] if u.shape[0] == 256 else u for u in ops_]
        for g in op(*empty):
            torch.cuda.synchronize()
            assert not g.any()


@pytest.mark.parametrize("plan", [(256, 8), (256, 1), (128, 4), (64, 3),
                                  (64, 16)])
def test_every_plan_of_rows_7_and_8_matches_plain(cuda, plan, monkeypatch):
    """grad_accum and enc_bwd_dw1 with the weight gradient's plan forced at
    the ragged 8100 rows: one slice, uneven slices, every tile width; equal
    bits twice."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "wgrad_plan",
                        lambda m, n, k, sms, outputs=1: plan)
    for op, plain, ops_ in _weight_gradient_ops(
            cuda, (8100, 256, 2048, 1024), seed=5):
        got, rose = _ran_tc(op, *ops_)
        assert rose == (1, 1)
        for g, w in zip(got, plain(*ops_)):
            assert _rel(g, w) <= BF16_REL
        for g, a in zip(got, op(*ops_)):
            assert torch.equal(g, a)


@pytest.mark.parametrize("width", [64, 128, 256])
def test_every_joined_dh_tile_width_matches_plain(cuda, width, monkeypatch):
    """enc_bwd_dw1 with dh's tile width forced (the weight gradient's plan
    as the rule gives it)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "tile_n",
                        lambda tiles_m, n, sms: width)
    enc, _ = _weight_gradient_operands(cuda, 1000, 72, 2048, 1024, seed=7)
    got, rose = _ran_tc(mlp.enc_bwd_dw1, *enc)
    assert rose == (1, 1)
    for g, w in zip(got, mlp.enc_bwd_dw1_ref(*enc)):
        assert _rel(g, w) <= BF16_REL


def test_bf16_dense_step_runs_the_weight_gradients_on_the_tensor_cores(cuda):
    """One bf16 step of the dense kernel backend at batch 3 x 1024 with
    microbatch 1024 plus a ragged tail: every grad_accum and enc_bwd_dw1
    launch on the tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "bfloat16"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    ops_ = (mlp.grad_accum, mlp.enc_bwd_dw1)
    before = [(f.launches, f.tensor_core_launches) for f in ops_]
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    for f, (n, n_tc) in zip(ops_, before):
        assert (f.launches - n, f.tensor_core_launches - n_tc) == (4, 4)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- row 9, bf16 grad_accum2: both heads' weight gradients in one launch
# of the tensor-core weight gradient (csrc/wgmma.cuh launch_wgrad2), every
# output within BF16_REL of its plain version and of the first version,
# equal bits on a second launch; shapes (batch, units, latent).

GRAD2_TC = [(8192, 2048, 256), (1000, 2048, 256), (1, 2048, 256),
            (1000, 520, 72), (8100, 2048, 8)]


def _grad_accum2_operands(device, batch, units, latent, seed=0,
                          dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((batch, units), generator=g, device=device).clamp_min(0)
    dmu = torch.randn((batch, latent), generator=g, device=device)
    dlv = torch.randn((batch, latent), generator=g, device=device)
    return tuple(t.to(dtype) for t in (h, dmu, dlv))


@pytest.mark.parametrize("shape", GRAD2_TC, ids=str)
def test_tensor_core_grad_accum2_matches_plain_and_first_version(cuda,
                                                                 shape):
    ops_ = _grad_accum2_operands(cuda, *shape)
    want = mlp.grad_accum2_ref(*ops_)
    first, rose = _ran_tc(mlp.grad_accum2, *ops_, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_tc(mlp.grad_accum2, *ops_)                      # auto
    assert rose == (1, 1)
    for g, w, f in zip(got, want, first):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BF16_REL
        assert _rel(g, f) <= BF16_REL
    for g, a in zip(got, mlp.grad_accum2(*ops_, kernel="tensor_cores")):
        assert torch.equal(g, a)
    # each head's pair is the one-output weight gradient of that head
    for head, pair in ((1, got[:2]), (2, got[2:])):
        for g, w in zip(pair, mlp.grad_accum_ref(ops_[0], ops_[head])):
            assert _rel(g, w) <= BF16_REL


@pytest.mark.parametrize("plan", [(256, 8), (256, 1), (128, 4), (128, 2),
                                  (64, 3), (64, 1), (64, 16)])
def test_every_grad_accum2_plan_matches_plain(cuda, plan, monkeypatch):
    """grad_accum2 with the plan forced at the ragged 8100 rows: one slice,
    slices that cut the batch unevenly, every tile width; equal bits
    twice."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "wgrad_plan",
                        lambda m, n, k, sms, outputs=1: plan)
    ops_ = _grad_accum2_operands(cuda, 8100, 2048, 256, seed=5)
    got, rose = _ran_tc(mlp.grad_accum2, *ops_)
    assert rose == (1, 1)
    for g, w in zip(got, mlp.grad_accum2_ref(*ops_)):
        assert _rel(g, w) <= BF16_REL
    for g, a in zip(got, mlp.grad_accum2(*ops_)):
        assert torch.equal(g, a)


def test_tensor_core_grad_accum2_dispatch_on_the_card(cuda):
    """A latent no multiple of 8, fp32 and an unaligned view keep the first
    version under ``auto`` and raise for ``kernel="tensor_cores"``; a
    zero-row batch gives zero gradients; the fp32 form takes no bf16
    operands."""
    ops_ = _grad_accum2_operands(cuda, 1000, 2048, 36)
    got, rose = _ran_tc(mlp.grad_accum2, *ops_)
    assert rose == (1, 0)
    for g, w in zip(got, mlp.grad_accum2_ref(*ops_)):
        assert _rel(g, w) <= BF16_REL
    with pytest.raises(ValueError, match="m 36"):
        mlp.grad_accum2(*ops_, kernel="tensor_cores")
    ops_ = _grad_accum2_operands(cuda, 256, 2048, 256)
    f32 = [t.float() for t in ops_]
    _, rose = _ran_tc(mlp.grad_accum2, *f32)
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="takes bf16 operands"):
        mlp.grad_accum2(*f32, kernel="tensor_cores")
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        mlp.grad_accum2(*ops_, kernel="sgemm")
    for at in range(3):
        t = ops_[at]
        off = torch.empty(t.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view_as(t).copy_(t)
        moved = [off if i == at else u for i, u in enumerate(ops_)]
        got, rose = _ran_tc(mlp.grad_accum2, *moved)
        assert rose == (1, 0)
        for g, f in zip(got, mlp.grad_accum2(*ops_, kernel="cuda_cores")):
            assert torch.equal(g, f)
        with pytest.raises(ValueError, match="aligned = False"):
            mlp.grad_accum2(*moved, kernel="tensor_cores")
    for g in mlp.grad_accum2(*(t[:0] for t in ops_)):
        torch.cuda.synchronize()
        assert not g.any()


def test_bf16_dense_step_runs_grad_accum2_on_the_tensor_cores(cuda):
    """One bf16 step of the dense kernel backend at batch 3 x 1024 with
    microbatch 1024 plus a ragged tail: every grad_accum2 launch on the
    tensor cores."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "bfloat16"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    f = mlp.grad_accum2
    before = (f.launches, f.tensor_core_launches)
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.tensor_core_launches - before[1]) \
        == (4, 4)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- row 7, fp32 grad_accum on csrc/sgemm.cuh (launch_wgrad: aᵀ read
# M-major, the batch cut into slices added in order, the column sums from
# the staged b), within SGEMM_REL of the plain version and of the first
# version, equal bits on a second launch; shapes (batch, n, m).  The first
# four are the `highest` step's five weight gradients at the microbatch
# (dW21 and dW22 share a shape).

SGEMM_WGRAD = [(8192, 1024, 2048), (8192, 2048, 256), (8192, 256, 2048),
               (8192, 2048, 1024), (1000, 2048, 256), (1, 2048, 1024),
               (4097, 1088, 544), (130, 68, 260), (7, 12, 20)]


def _grad_accum_operands(device, batch, n, m, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((batch, n), generator=g, device=device).clamp_min(0)
    b = torch.randn((batch, m), generator=g, device=device) * 1e-2
    return a, b


@pytest.mark.parametrize("shape", SGEMM_WGRAD, ids=str)
def test_sgemm_grad_accum_matches_plain_and_first_version(cuda, shape):
    a, b = _grad_accum_operands(cuda, *shape)
    want = mlp.grad_accum_ref(a, b)
    first, rose = _ran_sgemm(mlp.grad_accum, a, b, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_sgemm(mlp.grad_accum, a, b)                    # auto
    assert rose == (1, 1)
    for g, w, f in zip(got, want, first):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= SGEMM_REL
        assert _rel(g, f) <= SGEMM_REL
    for g, again in zip(got, mlp.grad_accum(a, b, kernel="sgemm")):
        assert torch.equal(g, again)


@pytest.mark.parametrize("plan", [(0, 1), (0, 4), (0, 8), (1, 3), (2, 1),
                                  (2, 16)])
def test_every_sgemm_weight_gradient_plan_matches_plain(cuda, plan,
                                                        monkeypatch):
    """fp32 grad_accum with the plan (tile index, slices) forced at the
    ragged 8100 rows: every tile, one slice, slices that cut the batch
    unevenly; equal bits twice."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "sgemm_wgrad_plan",
                        lambda m, n, k, sms: plan)
    a, b = _grad_accum_operands(cuda, 8100, 2048, 260, seed=5)
    got, rose = _ran_sgemm(mlp.grad_accum, a, b)
    assert rose == (1, 1)
    for g, w in zip(got, mlp.grad_accum_ref(a, b)):
        assert _rel(g, w) <= SGEMM_REL
    for g, again in zip(got, mlp.grad_accum(a, b)):
        assert torch.equal(g, again)


def test_sgemm_grad_accum_dispatch_on_the_card(cuda):
    """n or m no multiple of 4 and a view off a 16-byte boundary keep the
    first version under ``auto`` and raise for ``kernel="sgemm"``; bf16
    operands never take it; a zero-row batch gives zero gradients."""
    for shape in ((1000, 2048, 1022), (1000, 70, 256)):
        a, b = _grad_accum_operands(cuda, *shape)
        got, rose = _ran_sgemm(mlp.grad_accum, a, b)
        assert rose == (1, 0), shape
        for g, w in zip(got, mlp.grad_accum_ref(a, b)):
            assert _rel(g, w) <= SGEMM_REL
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
            mlp.grad_accum(a, b, kernel="sgemm")
    a, b = _grad_accum_operands(cuda, 256, 2048, 256)
    for at in range(2):
        t = (a, b)[at]
        off = torch.empty(t.numel() + 1, device=cuda)[1:].view_as(t).copy_(t)
        moved = [off if i == at else u for i, u in enumerate((a, b))]
        got, rose = _ran_sgemm(mlp.grad_accum, *moved)
        assert rose == (1, 0)
        for g, f in zip(got, mlp.grad_accum(a, b, kernel="cuda_cores")):
            assert torch.equal(g, f)
        with pytest.raises(ValueError, match="aligned = False"):
            mlp.grad_accum(*moved, kernel="sgemm")
    _, rose = _ran_sgemm(mlp.grad_accum, a.bfloat16(), b.bfloat16())
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        mlp.grad_accum(a.bfloat16(), b.bfloat16(), kernel="sgemm")
    for g in mlp.grad_accum(a[:0], b[:0]):
        torch.cuda.synchronize()
        assert not g.any()


def test_highest_step_runs_grad_accum_on_sgemm(cuda):
    """One `highest` step of the dense kernel backend at batch 3 x 1024
    with microbatch 1024 plus a ragged tail: the primitive backward's five
    weight gradients a microbatch, every one on csrc/sgemm.cuh."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "highest"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    f = mlp.grad_accum
    before = (f.launches, f.sgemm_launches)
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.sgemm_launches - before[1]) \
        == (20, 20)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- rows 1 and 2 in fp32 on csrc/sgemm.cuh.  encoder_fwd runs h, then both
# heads in one grid; decoder_fwd h3, then y; each product on the tile and
# slices of its contraction that tensor_cores.sgemm_fwd_plan picks, a split
# product's slices added in order with the bias and the activation after
# them.  Within ATOL of the plain version at the server's batch and below,
# SGEMM_REL of max|want| elsewhere, of the first version too; equal bits on
# a second launch.  Shapes (batch, seg, units, latent): the dense model at
# the server's batch, a ragged 100, 1 and the microbatch; narrow widths at
# batch 300 (latent 8 and 72: one and two tile columns a head).

SGEMM_DENSE = [(256, 1024, 2048, 256), (100, 1024, 2048, 256),
               (1, 1024, 2048, 256), (8192, 1024, 2048, 256),
               (300, 64, 128, 8), (300, 64, 128, 72), (130, 68, 260, 12)]


def _dense_fp32_operands(device, kind, batch, seg, units, latent, seed=0):
    """The encoder's (w1, b1, w21, b21, w22, b22, x) or the decoder's (w3,
    b3, w4, b4, z), fp32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    if kind == "encoder":
        return [rnd(seg, units, scale=seg ** -0.5), rnd(units, scale=0.1),
                rnd(units, latent, scale=units ** -0.5),
                rnd(latent, scale=0.1),
                rnd(units, latent, scale=units ** -0.5),
                rnd(latent, scale=0.1), rnd(batch, seg, scale=0.5)]
    return [rnd(latent, units, scale=latent ** -0.5), rnd(units, scale=0.1),
            rnd(units, seg, scale=units ** -0.5), rnd(seg, scale=0.1),
            rnd(batch, latent)]


def _dense_fp32(kind):
    return ((mlp.encoder_fwd, mlp.encoder_fwd_ref) if kind == "encoder"
            else (mlp.decoder_fwd, mlp.decoder_fwd_ref))


def _held_fp32(got, want, batch):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        if batch <= 256:
            assert float((g - w).abs().max()) <= ATOL
        assert _rel(g, w) <= SGEMM_REL


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("shape", SGEMM_DENSE, ids=str)
def test_sgemm_dense_forward_matches_plain_and_first_version(cuda, kind,
                                                             shape):
    op, plain = _dense_fp32(kind)
    ops_ = _dense_fp32_operands(cuda, kind, *shape)
    first, rose = _ran_sgemm(op, *ops_, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_sgemm(op, *ops_)                                 # auto
    assert rose == (1, 1)
    _held_fp32(got, plain(*ops_), shape[0])
    _held_fp32(got, first, shape[0])
    for g, again in zip(got, op(*ops_, kernel="sgemm")):
        assert torch.equal(g, again)


def _largest_valid_split(k, split):
    """The most slices, at most ``split``, that leave no slice of a
    contraction of ``k`` empty (steps of 64)."""
    steps = -(-k // 64)
    while split > 1 and (split > steps
                         or -(-steps // -(-steps // split)) != split):
        split -= 1
    return split


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("plan", [(0, 1), (0, 4), (1, 2), (2, 1), (2, 3),
                                  (2, 8)])
def test_every_sgemm_forward_plan_matches_plain(cuda, kind, plan,
                                                monkeypatch):
    """The fp32 encoder and decoder with every product's plan (tile index,
    slices) forced at the ragged 300 rows and full width: every tile, one
    slice, slices that cut the contraction unevenly; equal bits twice."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(
        tensor_cores, "sgemm_fwd_plan",
        lambda rows, k, n, sms, outputs=1: (plan[0], _largest_valid_split(
            k, plan[1])))
    op, plain = _dense_fp32(kind)
    ops_ = _dense_fp32_operands(cuda, kind, 300, 1024, 2048, 256, seed=7)
    got, rose = _ran_sgemm(op, *ops_)
    assert rose == (1, 1)
    _held_fp32(got, plain(*ops_), 300)
    for g, again in zip(got, op(*ops_)):
        assert torch.equal(g, again)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_sgemm_dense_forward_dispatch_on_the_card(cuda, kind):
    """A latent no multiple of 4 and a view off a 16-byte boundary keep the
    first version under ``auto`` and raise for ``kernel="sgemm"``; bf16
    operands never take it; a zero-row batch launches nothing."""
    op, plain = _dense_fp32(kind)
    ops_ = _dense_fp32_operands(cuda, kind, 100, 1024, 2048, 38)
    got, rose = _ran_sgemm(op, *ops_)
    assert rose == (1, 0)
    _held_fp32(got, plain(*ops_), 100)
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        op(*ops_, kernel="sgemm")
    ops_ = _dense_fp32_operands(cuda, kind, 256, 1024, 2048, 256)
    x = ops_[-1]
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
    got, rose = _ran_sgemm(op, *ops_[:-1], off)
    assert rose == (1, 0)
    for g, f in zip(got, op(*ops_, kernel="cuda_cores")):
        assert torch.equal(g, f)
    with pytest.raises(ValueError, match="aligned = False"):
        op(*ops_[:-1], off, kernel="sgemm")
    _, rose = _ran_sgemm(op, *[t.bfloat16() for t in ops_])
    assert rose == (1, 0)
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        op(*[t.bfloat16() for t in ops_], kernel="sgemm")
    _, rose = _ran_sgemm(op, *ops_[:-1], x[:0])
    assert rose == (0, 0)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_fp32_steps_run_the_dense_forward_on_sgemm(cuda, precision):
    """One fp32 step of the dense kernel backend at batch 3 x 1024 with
    microbatch 1024 plus a ragged tail: the encoder and the decoder once a
    microbatch, every launch on csrc/sgemm.cuh under ``highest``, and on
    the 3-pass tensor-core chains (``split_launches``), none on sgemm.cuh,
    under ``high``, whose step binds three passes."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", precision
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    fns = (mlp.encoder_fwd, mlp.decoder_fwd)
    before = [(f.launches, f.sgemm_launches, f.split_launches) for f in fns]
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    want = (4, 0, 4) if precision == "high" else (4, 4, 0)
    for f, (n, n_sgemm, n_split) in zip(fns, before):
        assert (f.launches - n, f.sgemm_launches - n_sgemm,
                f.split_launches - n_split) == want
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- rows 5 and 6, the gated input gradients: bf16 on the tensor cores
# (matmul_nt_mask: dec_bwd_fused's dh3 launch; matmul_nt2_mask:
# enc_bwd_dw1's k-joined dh launch, both with the gate in the epilogue),
# fp32 on csrc/sgemm.cuh's gated product (matmul_nt2_mask with both
# operands joined along k).  Held against the plain version and the first
# version (bf16 within BF16_REL: a flipped ulp; fp32 within SGEMM_REL:
# sums in another order), equal bits on a second launch.  Shapes (batch, n,
# m): the dense model's dh3 (n = seg) and dh (n = latent, a pair's) at the
# microbatch, 1000 and 1, and a ragged width both new forms take.

GATED_SHAPES = {"matmul_nt_mask": [(8192, 1024, 2048), (1000, 1024, 2048),
                                   (1, 1024, 2048), (1000, 264, 520)],
                "matmul_nt2_mask": [(8192, 256, 2048), (1000, 256, 2048),
                                    (1, 256, 2048), (1000, 264, 520)]}
GATED_FORMS = {torch.bfloat16: ("tensor_cores", "tensor_core_launches",
                                BF16_REL),
               torch.float32: ("sgemm", "sgemm_launches", SGEMM_REL)}


def _gated_operands(device, op, batch, n, m, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    pairs = 1 if op == "matmul_nt_mask" else 2
    ops_ = []
    for _ in range(pairs):
        ops_ += [rnd(batch, n), rnd(m, n, scale=n ** -0.5)]
    return [t.to(dtype) for t in ops_ + [rnd(batch, m).clamp_min(0)]]


def _ran_gated(op, counter, *args, **kw):
    fn = getattr(mlp, op)
    before = (fn.launches, getattr(fn, counter))
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (fn.launches - before[0], getattr(fn, counter) - before[1])


@pytest.mark.parametrize("dtype", list(GATED_FORMS), ids=["bf16", "fp32"])
@pytest.mark.parametrize("op,shape", [(op, s) for op, shapes in
                                      GATED_SHAPES.items() for s in shapes],
                         ids=str)
def test_gated_new_forms_match_plain_and_first_version(cuda, op, shape,
                                                       dtype):
    kernel, counter, tol = GATED_FORMS[dtype]
    fn = getattr(mlp, op)
    args = _gated_operands(cuda, op, *shape, dtype, seed=shape[0])
    want = getattr(mlp, f"{op}_ref")(*args)
    first, rose = _ran_gated(op, counter, *args, kernel="cuda_cores")
    assert rose == (1, 0)
    got, rose = _ran_gated(op, counter, *args)                  # auto
    assert rose == (1, 1)
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol
    assert _rel(got, first) <= tol
    assert torch.equal(got, fn(*args))
    assert torch.equal(got, fn(*args, kernel=kernel))


@pytest.mark.parametrize("tile", [64, 128, 256, (128, 128), (128, 64),
                                  (64, 64)], ids=str)
def test_every_gated_tile_matches_plain(cuda, tile, monkeypatch):
    """The tensor cores' three tile widths (bf16) and sgemm.cuh's three
    tiles (fp32), forced, on both gated forms at a ragged width."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    wide = isinstance(tile, int)
    rule = "tile_n" if wide else "sgemm_tile"
    monkeypatch.setattr(tensor_cores, rule, lambda *args: tile)
    dtype = torch.bfloat16 if wide else torch.float32
    _, counter, tol = GATED_FORMS[dtype]
    for op in GATED_SHAPES:
        args = _gated_operands(cuda, op, 1000, 264, 520, dtype)
        got, rose = _ran_gated(op, counter, *args)
        assert rose == (1, 1)
        assert _rel(got, getattr(mlp, f"{op}_ref")(*args)) <= tol


@pytest.mark.parametrize("dtype", list(GATED_FORMS), ids=["bf16", "fp32"])
def test_gated_forms_named_and_refused(cuda, dtype):
    """A pair's n no multiple of 8 (bf16: 36) or of 4 (fp32: 38), and a
    gate off a 16-byte boundary, keep the first version under ``auto`` and
    raise for the new form by name; each dtype refuses the other's form; a
    zero-row batch launches nothing."""
    kernel, counter, tol = GATED_FORMS[dtype]
    other = "sgemm" if kernel == "tensor_cores" else "tensor_cores"
    odd = 36 if dtype == torch.bfloat16 else 38
    for op in GATED_SHAPES:
        fn = getattr(mlp, op)
        args = _gated_operands(cuda, op, 1000, odd, 520, dtype)
        got, rose = _ran_gated(op, counter, *args)
        assert rose == (1, 0)
        assert _rel(got, getattr(mlp, f"{op}_ref")(*args)) <= tol
        with pytest.raises(ValueError, match=f"'{kernel}' takes"):
            fn(*args, kernel=kernel)
        args = _gated_operands(cuda, op, 1000, 264, 520, dtype)
        gate = args[-1]
        off = torch.empty(gate.numel() + 8, device=cuda,
                          dtype=dtype)[1:1 + gate.numel()].view_as(gate)
        off.copy_(gate)
        got, rose = _ran_gated(op, counter, *args[:-1], off)
        assert rose == (1, 0)
        assert torch.equal(got, fn(*args, kernel="cuda_cores"))
        with pytest.raises(ValueError, match="aligned = False"):
            fn(*args[:-1], off, kernel=kernel)
        with pytest.raises(ValueError, match=f"'{other}' takes"):
            fn(*args, kernel=other)
        _, rose = _ran_gated(op, counter, *[t[:0] if t.shape[0] == 1000
                                            else t for t in args])
        assert rose == (0, 0)


def test_highest_step_runs_the_gated_products_on_sgemm(cuda):
    """One `highest` step of the dense kernel backend at batch 3 x 1024
    with microbatch 1024 plus a ragged tail: the primitive backward's dh3
    and dh once a microbatch, every one on csrc/sgemm.cuh; and the bf16
    ``dx`` of the encoder takes the tensor cores for its dh."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = Config()
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "highest"
    cfg.tpu.microbatch_size = 1024
    x = torch.rand((3 * 1024 + 100, cfg.audio.segment_length),
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    fns = (mlp.matmul_nt_mask, mlp.matmul_nt2_mask)
    before = [(f.launches, f.sgemm_launches, f.tensor_core_launches)
              for f in fns]
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    for f, (n, n_sgemm, n_tc) in zip(fns, before):
        assert (f.launches - n, f.sgemm_launches - n_sgemm,
                f.tensor_core_launches - n_tc) == (4, 4, 0)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))
    w, t = _backward_inputs(cuda, 300, torch.bfloat16, 64, 128, 16)
    xx = t["x"].clone().requires_grad_()
    f = mlp.matmul_nt2_mask
    before = (f.launches, f.tensor_core_launches)
    mu, lv = mlp.encode(w, xx)
    torch.autograd.grad((mu.float() * t["dmu"].float()).sum()
                        + (lv.float() * t["dlv"].float()).sum(), xx)
    assert (f.launches - before[0], f.tensor_core_launches - before[1]) \
        == (1, 1)


# ---- rows 11 and 12 on the tensor cores: fp32 operands the 3-pass chain
# of csrc/full.cu (the split pass, then every product as three bf16 passes
# in three fp32 accumulators, (hh + hl) + lh), bf16 operands the split
# backward's tensor-core launches.  Held within 1e-4 of max|want| of the
# 3-pass plain version and of the first version (fp32; the same bf16 x bf16
# products added in another order), 2^-6 in bf16; equal bits on a second
# launch; every tile width the plans may take.

FULL_OPS = ("enc_bwd_full", "dec_bwd_full")


def _full_args(t, w, op):
    if op == "enc_bwd_full":
        return (t["x"], t["h"], t["dmu"], t["dlv"], w["fc21"]["w"],
                w["fc22"]["w"])
    return (t["da"], t["h3"], t["z"], w["fc4"]["w"], w["fc3"]["w"])


@pytest.mark.parametrize("op", FULL_OPS)
@pytest.mark.parametrize("dtype,passes,rel", [
    (torch.float32, 3, 1e-4), (torch.bfloat16, 1, 2.0 ** -6)],
    ids=["fp32-3pass", "bf16"])
@pytest.mark.parametrize("batch", [4096, 8192, 4097, 1])
def test_full_chains_on_the_tensor_cores(cuda, op, batch, dtype, passes,
                                         rel):
    w, t = _backward_inputs(cuda, batch, dtype)
    args = _full_args(t, w, op)
    f = getattr(mlp, op)
    before = (f.launches, f.tensor_core_launches)
    got = f(*args)
    again = f(*args)
    first = f(*args, kernel="cuda_cores")
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.tensor_core_launches - before[1]) \
        == (3, 2)
    want = getattr(mlp, op + "_ref")(*args, passes)
    _close_rel(got, want, rel)
    _close_rel(got, first, rel)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", FULL_OPS)
@pytest.mark.parametrize("widths", [(128,), (64,)], ids=["128", "64"])
@pytest.mark.parametrize("batch", [4096, 4097])
def test_full_chains_at_every_3_pass_width(cuda, monkeypatch, op, widths,
                                           batch):
    """Each tile width of the 3-pass mode forced on every product and
    weight gradient of the chain (the plans recomputed for it)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(tensor_cores, "SPLIT_WIDTHS", widths)
    w, t = _backward_inputs(cuda, batch, torch.float32)
    args = _full_args(t, w, op)
    f = getattr(mlp, op)
    before = f.tensor_core_launches
    got = f(*args)
    torch.cuda.synchronize()
    assert f.tensor_core_launches == before + 1
    _close_rel(got, getattr(mlp, op + "_ref")(*args, 3), 1e-4)


@pytest.mark.parametrize("op", FULL_OPS)
def test_full_chains_refuse_the_tensor_cores_at_odd_widths(cuda, op):
    w, t = _backward_inputs(cuda, 37, torch.float32, 70, 130, 18)
    args = _full_args(t, w, op)
    with pytest.raises(ValueError, match="takes fp32 or bf16"):
        getattr(mlp, op)(*args, kernel="tensor_cores")


@pytest.mark.parametrize("shape", [(4096, 2048), (4097, 256), (1, 8),
                                   (64, 1024)])
def test_split_pass_on_the_card(cuda, shape):
    """The split pass alone: both halves bit for bit the plain split's, the
    column sums of the unsplit values within 1e-5 of max|sum(0)| (fp32 in
    another order), equal bits on a second launch."""
    smoke = _smoke()
    v = smoke.split_probe_values(
        torch.Generator(device=cuda).manual_seed(shape[0]), shape, cuda)
    hi, lo, colsum = mlp.split_pass(v, sums=True)
    again = mlp.split_pass(v, sums=True)
    torch.cuda.synchronize()
    want = mlp.split_pass_ref(v)
    assert torch.equal(hi.view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(lo.view(torch.int16), want[1].view(torch.int16))
    _close_rel((colsum,), (want[2],), 1e-5)
    for a, b in zip((hi, lo, colsum), again):
        assert torch.equal(a, b)
    assert mlp.split_pass(v)[2] is None


def test_high_step_runs_the_full_chains_on_the_tensor_cores(cuda):
    """The default ``high`` step (configs/default.ini's batch 131072 in
    microbatches of 8192, at ``precision = high``): all 16 + 16 launches of
    the full chains on the tensor cores, the loss finite."""
    from pathlib import Path

    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    cfg = load_config(Path(__file__).resolve().parents[1] / "configs"
                      / "default.ini")
    cfg.tpu.backend, cfg.tpu.precision = "pallas", "high"
    batch, micro = cfg.training.batch_size, cfg.tpu.microbatch_size
    assert (batch, micro) == (131072, 8192)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand((batch, cfg.audio.segment_length), generator=g,
                   device=cuda) * 2 - 1
    model = build_model(cfg, cuda)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    chains = (mlp.enc_bwd_full, mlp.dec_bwd_full)
    before = [(f.launches, f.tensor_core_launches) for f in chains]
    fwd = (mlp.encoder_fwd, mlp.decoder_fwd)
    fwd_before = [(f.launches, f.split_launches, f.sgemm_launches)
                  for f in fwd]
    state, m = build_train_step(model, cfg)(state, x)
    torch.cuda.synchronize()
    for f, (n, tc) in zip(chains, before):
        assert (f.launches - n, f.tensor_core_launches - tc) == (16, 16)
    # the forward: 16 of 16 on the 3-pass tensor-core chains
    for f, (n, split, sgemm) in zip(fwd, fwd_before):
        assert (f.launches - n, f.split_launches - split,
                f.sgemm_launches - sgemm) == (16, 16, 0)
    assert bool(torch.isfinite(torch.as_tensor(float(m["loss"]))))


# ---- row 3, the int8 decoder on csrc/sgemm.cuh (an int8 B dequantized as
# its slabs are read back, the fp32 decoder's plans): bit for bit the fp32
# decoder of sgemm.cuh on the dequantized weights, within ATOL of plain

def _quantized(device, batch, latent=256, units=2048, seg=1024, seed=0):
    p = _params(device, seg, units, latent)
    qp = quant.quantize_decoder(p)
    g = torch.Generator(device=device).manual_seed(seed)
    return qp, torch.randn((batch, latent), generator=g, device=device)


def _dequantized_decoder(qp, z, **kw):
    w3, w4 = (quant.dequantize_weight(qp[n]["q"], qp[n]["scale"])
              for n in ("fc3", "fc4"))
    y, _ = mlp.decoder_fwd(w3, qp["fc3"]["b"], w4, qp["fc4"]["b"], z, **kw)
    return y


@pytest.mark.parametrize("batch", [256, 33, 1, 100, 8192])
def test_sgemm_quantized_decoder_is_the_fp32_decoder_bit_for_bit(cuda,
                                                                 batch):
    qp, z = _quantized(cuda, batch, seed=batch)
    got, rose = _ran_sgemm(quant.quantized_decoder_fwd, qp, z)
    assert rose == (1, 1)
    assert got.shape == (batch, 1024) and bool(torch.isfinite(got).all())
    assert torch.equal(got, _dequantized_decoder(qp, z, kernel="sgemm"))
    assert float((got - quant.quantized_decode_ref(qp, z)).abs().max()) \
        <= ATOL
    assert torch.equal(got, quant.quantized_decoder_fwd(qp, z,
                                                        kernel="sgemm"))


@pytest.mark.parametrize("plan", [(0, 1), (0, 8), (1, 2), (2, 1), (2, 3),
                                  (2, 16)])
def test_every_quantized_plan_is_the_fp32_decoders(cuda, plan, monkeypatch):
    """Every product's plan (tile index, slices) forced at the ragged 300
    rows: every tile, one slice, slices that cut k unevenly; the same bits
    as the fp32 decoder on the same plans."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    monkeypatch.setattr(
        tensor_cores, "sgemm_fwd_plan",
        lambda rows, k, n, sms, outputs=1: (plan[0], _largest_valid_split(
            k, plan[1])))
    qp, z = _quantized(cuda, 300, seed=7)
    got, rose = _ran_sgemm(quant.quantized_decoder_fwd, qp, z)
    assert rose == (1, 1)
    assert torch.equal(got, _dequantized_decoder(qp, z))
    assert float((got - quant.quantized_decode_ref(qp, z)).abs().max()) \
        <= ATOL


def test_quantized_decoder_first_version_and_dispatch_on_the_card(cuda):
    """The first version by name; a latent no multiple of 4 and a view off
    a 16-byte boundary keep it under ``auto`` and raise for
    ``kernel="sgemm"``; no tensor-core form; no rows, no launch."""
    qp, z = _quantized(cuda, 256)
    want = quant.quantized_decode_ref(qp, z)
    first, rose = _ran_sgemm(quant.quantized_decoder_fwd, qp, z,
                             kernel="cuda_cores")
    assert rose == (1, 0)
    assert float((first - want).abs().max()) <= ATOL
    with pytest.raises(ValueError, match="no tensor-core form"):
        quant.quantized_decoder_fwd(qp, z, kernel="tensor_cores")
    qo, zo = _quantized(cuda, 100, latent=38)
    got, rose = _ran_sgemm(quant.quantized_decoder_fwd, qo, zo)
    assert rose == (1, 0)
    assert float((got - quant.quantized_decode_ref(qo, zo)).abs().max()) \
        <= ATOL
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        quant.quantized_decoder_fwd(qo, zo, kernel="sgemm")
    off = torch.empty(z.numel() + 1, device=cuda)[1:].view_as(z).copy_(z)
    got, rose = _ran_sgemm(quant.quantized_decoder_fwd, qp, off)
    assert rose == (1, 0)
    assert torch.equal(got, first)
    with pytest.raises(ValueError, match="aligned = False"):
        quant.quantized_decoder_fwd(qp, off, kernel="sgemm")
    _, rose = _ran_sgemm(quant.quantized_decoder_fwd, qp, z[:0])
    assert rose == (0, 0)


def test_quantized_server_launches_only_the_new_form(cuda):
    """``InferenceServer(quantize=True)`` decodes every batch through the
    int8 decoder on csrc/sgemm.cuh."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.infer import InferenceServer
    from rawaudiovae_kelsey_tpu_torch.models import build_model

    cfg = Config()
    cfg.tpu.backend = "pallas"
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator().manual_seed(3))
    audio = np.random.default_rng(1).uniform(-0.5, 0.5, 30000) \
        .astype(np.float32)
    f = quant.quantized_decoder_fwd
    before = (f.launches, f.sgemm_launches)
    with InferenceServer(model, params, deterministic=True,
                         quantize=True) as s:
        out = s.reconstruct(audio, hop=128, ola=True).result(60)
    rose = (f.launches - before[0], f.sgemm_launches - before[1])
    assert rose[0] > 0 and rose[0] == rose[1]
    assert bool(np.isfinite(out).all())


# ---- rows 8-10 in fp32: sgemm.cuh's launches one after another, each
# equal bit for bit to the same launches called one by one at their plans

@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_sgemm_backward_forms_are_their_launches_one_by_one(cuda, batch):
    w, t = _backward_inputs(cuda, batch, torch.float32)
    w21, w22, w3, w4 = (w[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))
    x, h, dmu, dlv, da, h3, z = (t[k] for k in ("x", "h", "dmu", "dlv",
                                                "da", "h3", "z"))
    dh = mlp.matmul_nt2_mask(dmu, w21, dlv, w22, h, kernel="sgemm")
    dh3 = mlp.matmul_nt_mask(da, w4, h3, kernel="sgemm")
    cases = (
        (mlp.enc_bwd_dw1, (x, h, dmu, dlv, w21, w22),
         mlp.grad_accum(x, dh, kernel="sgemm")),
        (mlp.grad_accum2, (h, dmu, dlv),
         (*mlp.grad_accum(h, dmu, kernel="sgemm"),
          *mlp.grad_accum(h, dlv, kernel="sgemm"))),
        (mlp.dec_bwd_fused, (da, h3, z, w4, w3),
         (mlp.matmul_nt(dh3, w3, kernel="sgemm"),
          *mlp.grad_accum(z, dh3, kernel="sgemm"))),
    )
    for op, ops_, one_by_one in cases:
        got, rose = _ran_sgemm(op, *ops_)
        assert rose == (1, 1)
        for g, a in zip(got, one_by_one):
            assert torch.equal(g, a)
        want = getattr(mlp, f"{op.__name__}_ref")(*ops_)
        _close_rel(got, want, GRAD_REL)
        first, rose = _ran_sgemm(op, *ops_, kernel="cuda_cores")
        assert rose == (1, 0)
        _close_rel(got, first, GRAD_REL)
        for g, a in zip(got, op(*ops_, kernel="sgemm")):
            assert torch.equal(g, a)


def test_sgemm_backward_forms_dispatch_on_the_card(cuda):
    """A latent no multiple of 4 keeps the first version under ``auto``
    and raises for ``kernel="sgemm"``."""
    w, t = _backward_inputs(cuda, 300, torch.float32, latent=38)
    w21, w22, w3, w4 = (w[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))
    for op, ops_ in (
            (mlp.enc_bwd_dw1, (t["x"], t["h"], t["dmu"], t["dlv"], w21,
                               w22)),
            (mlp.grad_accum2, (t["h"], t["dmu"], t["dlv"])),
            (mlp.dec_bwd_fused, (t["da"], t["h3"], t["z"], w4, w3))):
        got, rose = _ran_sgemm(op, *ops_)
        assert rose == (1, 0)
        _close_rel(got, getattr(mlp, f"{op.__name__}_ref")(*ops_), GRAD_REL)
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
            op(*ops_, kernel="sgemm")


# ------------------------------------------------- the library path (infer/)

def _library_model(device, arch):
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model

    cfg = Config()
    cfg.audio.segment_length = 1024
    cfg.vae.arch = arch
    cfg.vae.n_units, cfg.vae.latent_dim = 2048, 256
    cfg.vae.hidden_dims = "1024,512"
    cfg.tpu.backend = "pallas"
    return build_model(cfg, device)


@pytest.mark.parametrize("arch", ["dense", "deep"])
@pytest.mark.parametrize("hop", [None, 256])
def test_encode_trajectory_on_the_card_matches_the_cpu(cuda, arch, hop):
    """``encode_trajectory`` / ``decode_trajectory`` of a ``backend =
    pallas`` model on the card (the dense model's ``encoder_fwd`` /
    ``decoder_fwd``, the deep model's ``linear_fwd``, all on
    ``csrc/sgemm.cuh``) against the same calls on the CPU (the plain
    versions); ragged last batches included."""
    from rawaudiovae_kelsey_tpu_torch.infer import api
    from rawaudiovae_kelsey_tpu_torch.ops import linear
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    cpu = _library_model("cpu", arch)
    card = _library_model(cuda, arch)
    params = cpu.init(torch.Generator().manual_seed(1))
    on_card = tree_map(lambda t: t.to(cuda), params)
    audio = np.random.default_rng(2).uniform(
        -0.5, 0.5, 1024 * 300 + 77).astype(np.float32)
    wrappers = ((ops.encoder_fwd, ops.decoder_fwd) if arch == "dense"
                else (linear.linear_fwd,))
    before = [(w.launches, w.sgemm_launches) for w in wrappers]
    mu, lv = api.encode_trajectory(card, on_card, audio, batch_size=256,
                                   hop=hop)
    want_mu, want_lv = api.encode_trajectory(cpu, params, audio, hop=hop)
    np.testing.assert_allclose(mu, want_mu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lv, want_lv, atol=ATOL, rtol=0)
    y = api.decode_trajectory(card, on_card, want_mu, batch_size=100)
    np.testing.assert_allclose(y, api.decode_trajectory(cpu, params, want_mu),
                               atol=ATOL, rtol=0)
    for w, (n, s) in zip(wrappers, before):
        rose = w.launches - n
        assert rose > 0 and w.sgemm_launches - s == rose, w.__name__


@pytest.mark.parametrize("grid,iters,seed", [((3, 3), 120, 1),
                                             ((4, 2), 60, 0),
                                             ((2, 2), 1, 3)])
def test_som_fit_on_the_card_matches_the_cpu(cuda, grid, iters, seed):
    """``train_som`` (the init drawn on the CPU, the fit on the card)
    against the same call on the CPU, on the well-separated blobs of
    tests/test_torch_som.py.  The BMU search's ``‖x‖² − 2·x·wᵀ + ‖w‖²``
    cancels, so where two units sit within its rounding of a sample (units
    drawn from one sample, a tight cluster) the two devices may pick
    different winners and the fits part ways: these blobs have none.  The
    ``som`` command's own shape, which has such units, is held by
    :func:`test_som_fit_at_the_command_shape_on_the_card`."""
    from rawaudiovae_kelsey_tpu_torch.infer import som_train

    rng = np.random.default_rng(seed)
    centers = np.zeros((3, 4), np.float32)
    centers[0, 0], centers[1, 0], centers[2, 1] = 5, -5, 8
    feats = np.concatenate([c + 0.3 * rng.standard_normal(
        (30, 4)).astype(np.float32) for c in centers])
    got = som_train.train_som(feats, grid=grid, iters=iters, seed=seed,
                              device=cuda)
    want = som_train.train_som(feats, grid=grid, iters=iters, seed=seed,
                               device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        som_train.assign_clusters(feats, got, cuda),
        som_train.assign_clusters(feats, want, "cpu"))


@pytest.mark.parametrize("n", [12, 200])
def test_som_fit_at_the_command_shape_on_the_card(cuda, n):
    """``train_som`` on the card at the ``som`` command's shape (8x8 units,
    200 iterations, ``n`` features of 256; units drawn from one sample, so
    the fp32 search's rounding picks the winners among them and the fit
    parts from any other device's or summation order's value by value)
    against the float64 fit on the CPU from the same initial codebook: its
    quantization error within 5 % of the data's spread of the float64
    fit's, and every feature's BMU, searched on the card, at its true least
    distance (to 1e-5 of ``‖x‖² + ‖w‖²``)."""
    from rawaudiovae_kelsey_tpu_torch.infer import som_train

    grid, iters = (8, 8), 200
    feats = np.random.default_rng(0).standard_normal(
        (n, 256)).astype(np.float32)
    got = som_train.train_som(feats, grid=grid, iters=iters, device=cuda)
    w0 = som_train.initial_codebook(torch.from_numpy(feats), grid)
    w64 = som_train.fit_som(torch.from_numpy(feats).double(), w0.double(),
                            grid, iters).numpy()
    qe64, _ = som_train.fit_quality(
        feats, w64, som_train.assign_clusters(feats, w64, "cpu"))
    qe, gap = som_train.fit_quality(
        feats, got, som_train.assign_clusters(feats, got, cuda))
    spread = np.linalg.norm(feats - feats.mean(axis=0), axis=1).mean()
    assert abs(qe - qe64) <= 0.05 * spread, (qe, qe64, spread)
    assert gap <= 1e-5, gap


# ----------------------------------------------------- data parallelism

@pytest.mark.parametrize("precision,tol", [("bfloat16", 5e-2),
                                           ("highest", 1e-3)])
def test_mesh_step_on_the_card_two_ranks_over_gloo(cuda, tmp_path,
                                                   precision, tol):
    """Two ranks share the card on a gloo group (tests/torch_ranks.py):
    their mesh step against the one-device step on the whole batch, within
    the training-correctness bound (PERF.md §2); the ranks' updates equal
    bit for bit; the kernels launched on each rank; each rank's sampler
    words (its folded seed) from the kernel equal the plain Philox, and
    differ between the ranks."""
    import torch_ranks

    runs = torch_ranks.launch(torch_ranks.cuda_mesh_step, 2, tmp_path,
                              precision)
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[0]["rel"] <= tol
    assert runs[0]["loss"] == pytest.approx(runs[0]["one_loss"], rel=tol)
    for r in runs:
        assert r["launches"]["encoder_fwd"] == 4     # 4 microbatches
        assert r["words_equal"]
    assert runs[0]["words"] != runs[1]["words"]


def test_mesh_step_on_one_nccl_rank_equals_the_plain_step(cuda, tmp_path):
    """NCCL at one rank a card: the one-rank mesh step (its all-reduce on
    NCCL) gives the plain step's update bit for bit."""
    import torch_ranks

    (run,) = torch_ranks.launch(torch_ranks.cuda_mesh_step, 1, tmp_path,
                                "bfloat16", backend="nccl")
    assert run["rel"] == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_forms_match_their_plain_versions(cuda, dtype):
    """The row-parallel forms of rows 1, 2 and 15-16 at model 2's shards
    (units 1024 of 2048; deep_wide's 4096x2048->2048), the kernel "auto"
    picks and the first version (``kernel="cuda_cores"``): the fp32
    partial sums within 1e-5 of the largest of the sums on the kernel's
    own hidden layer (the same products of the same rounded operands in
    another order), the hidden layer as the full form rounds it (within
    2^-6 of the plain version's largest in bf16, where an element may sit
    a bf16 ulp off; 1e-4 in fp32), ``linear_partial`` within 1e-5 of its
    plain version, equal bits on a second launch."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear

    g = torch.Generator(device=cuda).manual_seed(24)

    def rnd(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g, device=cuda) * 2 - 1)
                * scale).to(dtype)

    def near(got, want, rel):
        return float((got.float() - want.float()).abs().max()) <= rel * \
            float(want.float().abs().max())

    enc = (rnd(1024, 1024, scale=0.03), rnd(1024, scale=0.1),
           rnd(1024, 256, scale=0.03), rnd(1024, 256, scale=0.03))
    dec = (rnd(256, 1024, scale=0.06), rnd(1024, scale=0.1),
           rnd(1024, 1024, scale=0.03))
    hidden_tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for kernel in ("auto", "cuda_cores"):
        for batch in (8192, 1000):
            x, z = rnd(batch, 1024), rnd(batch, 256)
            for got, want, rows in (
                    (mlp.encoder_fwd_partial(*enc, x, kernel=kernel),
                     mlp.encoder_fwd_partial_ref(*enc, x), enc[2:]),
                    (mlp.decoder_fwd_partial(*dec, z, kernel=kernel),
                     mlp.decoder_fwd_partial_ref(*dec, z), dec[2:])):
                for t, w in zip(got[:-1], rows):
                    assert t.dtype == torch.float32
                    assert near(t, got[-1].float() @ w.float(), 1e-5)
                assert near(got[-1], want[-1], hidden_tol)
            assert all(torch.equal(a, b) for a, b in zip(
                mlp.encoder_fwd_partial(*enc, x, kernel=kernel),
                mlp.encoder_fwd_partial(*enc, x, kernel=kernel)))
        x, w = rnd(4096, 2048), rnd(2048, 2048, scale=2048 ** -0.5)
        for ksplit in (False, True):
            got = linear.linear_partial(x, w, ksplit, kernel)
            assert near(got, linear.linear_partial_ref(x, w, ksplit), 1e-5)
            assert torch.equal(got, linear.linear_partial(x, w, ksplit,
                                                          kernel))


# ---- the backward-fusion switch (ops/mlp.py BWD_FUSION): the 3-pass forms
# of rows 5 and 7-10 (csrc/full.cu's parts of the chains on the tensor
# cores; the first version's 3-pass mode at other widths) and the full
# chains in one fp32 pass (rows 11-12 on sgemm.cuh), each against its plain
# version: 1e-4 · max|plain|, equal bits on a second launch, bit for bit on
# built operands where every sum has one term

def _backward_forms(device, batch, seg, units, latent):
    w, t = _backward_inputs(device, batch, torch.float32, seg, units, latent)
    w21, w22, w3, w4 = (w[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))
    return {
        "matmul_nt_mask": (t["da"], w4, t["h3"]),
        "grad_accum": (t["h3"], t["da"]),
        "grad_accum2": (t["h"], t["dmu"], t["dlv"]),
        "enc_bwd_dw1": (t["x"], t["h"], t["dmu"], t["dlv"], w21, w22),
        "dec_bwd_fused": (t["da"], t["h3"], t["z"], w4, w3),
    }


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("widths", [(1024, 2048, 256), (70, 130, 18)],
                         ids=["full-width", "odd-widths"])
@pytest.mark.parametrize("batch", [8192, 4097, 1])
def test_backward_three_pass_forms_match_their_plain_versions(cuda, batch,
                                                              widths):
    on_tc = all(v % 8 == 0 for v in widths)
    for name, args in _backward_forms(cuda, batch, *widths).items():
        f = getattr(mlp, name)
        before = (f.launches, f.split_launches, f.sgemm_launches)
        got = _outs(f(*args, passes=3))
        again = _outs(f(*args, passes=3))
        torch.cuda.synchronize()
        want = _outs(getattr(mlp, name + "_ref")(*args, passes=3))
        _close_rel(got, want, 1e-4)
        for a, b in zip(got, again):
            assert torch.equal(a, b), name
        assert (f.launches - before[0], f.split_launches - before[1],
                f.sgemm_launches - before[2]) == (2, 2 * on_tc, 0), name
        first = _outs(f(*args, kernel="cuda_cores", passes=3))
        _close_rel(first, want, 1e-4)
        with pytest.raises(ValueError, match="sgemm"):
            f(*args, kernel="sgemm", passes=3)
        if not on_tc:
            with pytest.raises(ValueError, match="tensor_cores"):
                f(*args, kernel="tensor_cores", passes=3)


@pytest.mark.parametrize("widths", [(1024, 2048, 256), (70, 130, 18)],
                         ids=["full-width", "odd-widths"])
def test_backward_three_pass_forms_split_and_add_bit_for_bit(cuda, widths):
    """On exact_split_case every sum has one term but the bias gradients of
    a dense hidden cotangent (db1, db3): the forms give the 3-pass plain
    version's bits, which one pass would move."""
    smoke = _smoke()
    enc, dec = smoke.exact_split_case(cuda, 0, *widths)
    x, h, dmu, dlv = enc[:4]
    da, h3 = dec[:2]
    cases = {"enc_bwd_dw1": (enc, (1,)), "dec_bwd_fused": (dec, (2,)),
             "grad_accum2": ((h, dmu, dlv), ()),
             "grad_accum": ((h3, da), ()),
             "matmul_nt_mask": ((da, dec[3], h3), ())}
    for name, (args, dense) in cases.items():
        for kernel in ("auto", "cuda_cores"):
            got = _outs(getattr(mlp, name)(*args, kernel=kernel, passes=3))
            torch.cuda.synchronize()
            want = _outs(getattr(mlp, name + "_ref")(*args, passes=3))
            once = _outs(getattr(mlp, name + "_ref")(*args))
            moved = total = 0
            for i, (a, b, c) in enumerate(zip(got, want, once)):
                if i in dense:
                    _close_rel((a,), (b,), smoke.EXACT_DB_REL)
                    continue
                assert torch.equal(a, b), (name, kernel, i,
                                           int((a != b).sum()))
                moved, total = moved + int((b != c).sum()), total + b.numel()
            assert moved > total // 10, name


@pytest.mark.parametrize("op", FULL_OPS)
@pytest.mark.parametrize("widths", [(1024, 2048, 256), (72, 136, 20)],
                         ids=["full-width", "widths-of-4"])
@pytest.mark.parametrize("batch", [8192, 4097, 1])
def test_full_chains_in_one_fp32_pass(cuda, op, batch, widths):
    """Rows 11-12 under ``float32`` / ``highest`` with "full" forced: the
    split kernels' fp32 launches on sgemm.cuh in turn, the same bits as
    those kernels one by one, within 1e-4 · max|plain| of the one-pass
    plain version; the first version in one pass likewise."""
    w, t = _backward_inputs(cuda, batch, torch.float32, *widths)
    args = _full_args(t, w, op)
    f = getattr(mlp, op)
    before = (f.launches, f.sgemm_launches, f.tensor_core_launches)
    got = f(*args, passes=1)
    again = f(*args, passes=1)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.sgemm_launches - before[1],
            f.tensor_core_launches - before[2]) == (2, 2, 0)
    want = getattr(mlp, op + "_ref")(*args, 1)
    _close_rel(got, want, 1e-4)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _close_rel(f(*args, kernel="cuda_cores", passes=1), want, 1e-4)
    if op == "enc_bwd_full":
        parts = (*mlp.enc_bwd_dw1(*args), *mlp.grad_accum2(*args[1:4]))
    else:
        parts = (*mlp.dec_bwd_fused(*args), *mlp.grad_accum(args[1],
                                                            args[0]))
    for a, b in zip(got, parts):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tensor_cores"):
        f(*args, kernel="tensor_cores", passes=1)


@pytest.mark.parametrize("mode", ["primitive", "split", "full"])
@pytest.mark.parametrize("precision", ["bfloat16", "high", "highest"])
def test_forced_modes_step_on_the_card(cuda, monkeypatch, mode, precision):
    """One step of default.ini's model at batch 1024 for each forced mode
    and tier: every launch of the mode's backward kernels on the form the
    tier takes (bf16 the tensor cores, `high` the 3-pass tensor cores,
    `highest` sgemm.cuh), none on the first version; the loss and the
    gradient (Adam's first moment, linear in it) within PERF §2's bound of
    the plain backend's step (the update itself, ``lr·g/(|g| + eps)``,
    turns bf16 noise on a near-zero gradient into a move of up to lr)."""
    from rawaudiovae_kelsey_tpu_torch.config import Config
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    monkeypatch.setattr(mlp, "BWD_FUSION", mode)
    cfg = Config()
    cfg.tpu.precision = precision
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.rand((1024, 1024), generator=g, device=cuda) * 2 - 1
    kernels = {"primitive": ("matmul_nt2_mask", "matmul_nt_mask",
                             "grad_accum"),
               "split": ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused",
                         "grad_accum"),
               "full": ("enc_bwd_full", "dec_bwd_full")}[mode]
    fast = {"bfloat16": "tensor_core_launches", "high": "split_launches",
            "highest": "sgemm_launches"}[precision]
    if mode == "full" and precision == "high":
        fast = "tensor_core_launches"
    out = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, cuda)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), seed=1)
        before = {n: (getattr(mlp, n).launches,
                      getattr(getattr(mlp, n), fast)) for n in kernels}

        def noise(step, i, shape):
            return torch.randn(shape, generator=torch.Generator(
                device=cuda).manual_seed(7), device=cuda)

        state, m = build_train_step(model, cfg, noise=noise)(state, x)
        torch.cuda.synchronize()
        for n in kernels:
            all_, on = (getattr(mlp, n).launches - before[n][0],
                        getattr(getattr(mlp, n), fast) - before[n][1])
            if backend == "pallas":
                assert all_ > 0 and on == all_, (n, all_, on)
            else:
                assert all_ == 0, n
        out[backend] = (float(m["loss"]), torch.cat(
            [t.ravel() for q in state.mu.values() for t in q.values()]))
    tol = 5e-2 if precision == "bfloat16" else 1e-3
    (lk, dk), (lx, dx) = out["pallas"], out["xla"]
    assert abs(lk / lx - 1) <= tol
    assert float((dk - dx).norm() / dx.norm()) <= tol


# ---------------------------------------------------- row 21: SnakeBeta

def _snake_inputs(shape, dtype, device):
    g = torch.Generator().manual_seed(sum(shape))
    x = (2.0 * torch.randn(shape, generator=g)).to(device, dtype)
    dy = torch.randn(shape, generator=g).to(device, dtype)
    alpha = (0.5 * torch.randn(shape[1], generator=g)).to(device, dtype)
    beta = (0.5 * torch.randn(shape[1], generator=g)).to(device, dtype)
    return x, alpha, beta, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128, 65536), (3, 2048, 32),
                                   (2, 5, 37)],
                         ids=["stage1", "deepest", "odd"])
def test_snake_kernels_match_plain_versions(cuda, dtype, shape):
    """Row 21 against its plain version in float64 on the same rounded
    inputs.  The kernel rounds ``t = e^alpha · x`` to fp32, and sin(t)
    moves by |t| times that rounding, so each bound carries the
    arguments' size: y within ``tol · (|x| + inv · (1 + 2|t|))``, dx within
    ``tol · |dy| · (1 + inv · A · (1 + 2|t|))``, tol 4e-7 (about 3 fp32
    ulps) in fp32 and 2^-8 (two roundings to bf16) in bf16; d alpha and
    d beta, sums over B·L terms, within 1e-5 of the sum of the terms'
    bounds (fp32 partial sums), plus one bf16 rounding in bf16."""
    from rawaudiovae_kelsey_tpu_torch.ops import snake

    x, alpha, beta, dy = _snake_inputs(shape, dtype, cuda)
    launched = (snake.snake_fwd.launches, snake.snake_bwd.launches)
    y = snake.snake_fwd(x, alpha, beta)
    dx, da, db = snake.snake_bwd(x, alpha, beta, dy)
    assert (snake.snake_fwd.launches - launched[0],
            snake.snake_bwd.launches - launched[1]) == (1, 1)
    assert y.dtype == dx.dtype == dtype and da.dtype == db.dtype == dtype
    d = [t.double() for t in (x, alpha, beta, dy)]
    want_y = snake.snake_ref(*d[:3])
    want_dx, want_da, want_db = snake.snake_bwd_ref(*d)
    a = torch.exp(d[1])[:, None]
    eb = torch.exp(d[2])
    inv = (1.0 / (eb + 1e-9))[:, None]
    t = a * d[0]
    grow = 1.0 + 2.0 * t.abs()
    tol = 4e-7 if dtype == torch.float32 else 2.0 ** -8
    assert bool(((y.double() - want_y).abs()
                 <= tol * (d[0].abs() + inv * grow)).all())
    assert bool(((dx.double() - want_dx).abs()
                 <= tol * d[3].abs() * (1.0 + inv * a * grow)).all())
    g = d[3].abs() * grow
    ptol = 1e-5 if dtype == torch.float32 else 1e-5 + 2.0 ** -8
    bound_a = inv[:, 0] * (g * t.abs()).sum(dim=(0, 2)) + want_da.abs()
    bound_b = inv[:, 0] ** 2 * eb * g.sum(dim=(0, 2)) + want_db.abs()
    assert bool(((da.double() - want_da).abs() <= ptol * bound_a).all())
    assert bool(((db.double() - want_db).abs() <= ptol * bound_b).all())
    # the order of the sums is a function of the shape: equal bits again
    again = snake.snake_bwd(x, alpha, beta, dy)
    for first, second in zip((dx, da, db), again):
        assert torch.equal(first, second)


def test_snake_function_saves_its_input_and_runs_both_kernels(cuda):
    from rawaudiovae_kelsey_tpu_torch.ops import snake

    x, alpha, beta, dy = _snake_inputs((2, 64, 4096), torch.bfloat16, cuda)
    x.requires_grad_(True)
    alpha.requires_grad_(True)
    beta.requires_grad_(True)
    before = snake.snake_bwd.launches
    y = snake.snake(x, alpha, beta)
    y.backward(dy)
    assert snake.snake_bwd.launches == before + 1
    want = snake.snake_bwd(x.detach(), alpha.detach(), beta.detach(), dy)
    for got, w in zip((x.grad, alpha.grad, beta.grad), want):
        assert torch.equal(got, w)


def test_adam_updates_a_tree_of_many_leaves_through_row_20(cuda):
    """A tree of more leaves than one launch of row 20 takes (the Oobleck
    model's 365) is updated by ``adam_tree``: the same bits as the eager
    leaf-by-leaf update, over three coupled steps."""
    from rawaudiovae_kelsey_tpu_torch.ops import adam as adam_ops
    from rawaudiovae_kelsey_tpu_torch.train.optim import (
        FUSED_MIN_LEAVES,
        Adam,
    )
    from rawaudiovae_kelsey_tpu_torch.train.state import TrainState

    g = torch.Generator().manual_seed(5)
    shapes = [(7,), (64, 3, 5), (128,), (1, 1), (33, 17)]
    params = {f"l{i}": torch.randn(shapes[i % 5], generator=g).to(cuda)
              for i in range(FUSED_MIN_LEAVES + 11)}
    grads = [{k: torch.randn(v.shape, generator=g).to(cuda)
              for k, v in params.items()} for _ in range(3)]
    fused = TrainState.create(params, seed=0)
    plain = fused.clone()
    opt = Adam(learning_rate=1e-3)
    before = adam_ops.adam_tree.launches
    for gr in grads:
        opt.update(fused, gr)
        opt.update_leafwise(plain, gr)
    assert adam_ops.adam_tree.launches - before == 3 * 2  # 60 leaves: 2
    assert fused.count == plain.count == 3
    for a, b in ((fused.params, plain.params), (fused.mu, plain.mu),
                 (fused.nu, plain.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k

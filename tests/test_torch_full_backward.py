"""The ``high`` tier's backward in the port (rawaudiovae_kelsey_tpu_torch/ops
/mlp.py: ``enc_bwd_full``, ``dec_bwd_full`` — queue B rows 11-12 — and the
"full" mode of ``Encode`` / ``Decode``) against the JAX package's Pallas
kernels.

On the CPU the JAX side runs its kernels in interpret mode, under
``jax.default_matmul_precision("high")`` for the 3-pass cases (as
tests/test_pallas.py does), and the port's wrappers run their plain
versions, because the tensors lie on the CPU.  Inputs come from numpy seeds
and go to both packages; batches 64 and 37 (ragged: JAX pads it, the port's
kernels mask it).

Tolerances:
* the split itself: bit for bit.  Both sides round hi with the same integer
  arithmetic and lo to nearest even.
* 3-pass, fp32 operands: ``atol=2e-5, rtol=2e-5`` — the same split and the
  same three bf16 x bf16 products (exact in fp32), summed in another order.
* one pass, bf16 operands: the hidden cotangent is rounded to bf16 first
  (pallas_mlp.py:777, 874); where the two fp32 sums straddle a rounding
  boundary one element flips by a bf16 ulp, so every output is held at
  ``2^-6 · max|want|``; a fault shows as O(max|want|).
* ``Encode`` / ``Decode`` in mode "full" with the forward at ``passes =
  3`` (what a ``high`` step binds, ``models/registry.py`` ``under_tier``)
  against ``pallas_encode`` / ``pallas_decode`` under ``high``: the
  forward, ``dx`` and the chains all take the 3-pass product on both sides,
  so every output is held at the 3-pass bound above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.ops import mlp

SEG, UNITS, LATENT = 64, 96, 16
BATCHES = [64, 37]
ATOL = RTOL = 2e-5
LAYERS = ("fc1", "fc21", "fc22", "fc3", "fc4")


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT))


def _arrays(seed, *shapes, relu=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, s in enumerate(shapes):
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.maximum(a, 0) if k in relu else a)
    return out


def _both(arrays, bf16=False):
    """The same values for both packages: rounded once, by PyTorch, and
    handed to JAX as float32 that JAX casts exactly."""
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in arrays]
    js = [jnp.asarray(t.to(torch.float32).numpy()).astype(jdt) for t in ts]
    return js, ts


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close3(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2.0 ** -6 * float(np.abs(want).max()))


# ---------------------------------------------------------------- the split

def _edge_values():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2 ** 32, size=10_000, dtype=np.uint64).astype(
        np.uint32)
    # finite values only: drop exponent 0xFF (inf / nan)
    bits = bits[(bits >> 23) & 0xFF != 0xFF]
    edges = np.array([
        0x00000000, 0x80000000,              # ±0
        0x00000001, 0x80000001, 0x007FFFFF,  # subnormals
        0x00008000, 0x00018000,              # subnormal ties
        0x3F808000, 0xBF808000, 0x3F818000,  # low 16 bits exactly 0x8000
        0x3F807FFF, 0x3F808001, 0x3FFF8000,  # around the tie; carries up
        0x7F7F0000, 0x00800000,              # large; smallest normal
    ], dtype=np.uint32)
    half = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    return np.concatenate([edges, bits, half]).view(np.float32)


def test_split_hi_lo_equals_the_jax_split_bit_for_bit():
    v = _edge_values()
    jhi, jlo = jmlp._split_hi_lo(jnp.asarray(v))
    hi, lo = mlp.split_hi_lo(torch.from_numpy(v.copy()))
    want_hi = np.asarray(jhi.astype(jnp.float32)).view(np.uint32)
    want_lo = np.asarray(jlo.astype(jnp.float32)).view(np.uint32)
    got_hi, got_lo = (t.numpy().view(np.uint32) for t in (hi, lo))
    # hi is integer arithmetic on the bits: equal everywhere, subnormals
    # included
    np.testing.assert_array_equal(got_hi, want_hi)
    # lo = bf16(v - hi) is float arithmetic.  XLA's CPU backend treats
    # subnormal inputs as zero and flushes subnormal results to zero;
    # PyTorch (and the CUDA kernel, built without -ftz) keep them.  Where
    # neither v nor the residual v - hi is subnormal the two are equal bit
    # for bit; elsewhere both are below 2^-125 in magnitude.
    tiny = np.float32(2.0 ** -126)
    resid = v - hi.numpy()
    flushed = ((np.abs(v) < tiny) & (v != 0)) \
        | ((np.abs(resid) < tiny) & (resid != 0))
    assert flushed.sum() < 0.05 * len(v)
    np.testing.assert_array_equal(got_lo[~flushed], want_lo[~flushed])
    for side in (got_lo, want_lo):
        assert (np.abs(side.view(np.float32)[flushed]) <= 2 * tiny).all()
    # both halves hold bf16 values
    assert not (got_hi & 0xFFFF).any()
    assert not (got_lo & 0xFFFF).any()


def test_split_rounds_half_up_on_the_magnitude():
    v = torch.tensor(np.array([0x3F808000, 0x3F818000, 0xBF808000],
                              np.uint32).view(np.float32))
    hi, _ = mlp.split_hi_lo(v)
    # nearest-even would keep 0x3F80 for the first tie; the split carries
    assert hi.numpy().view(np.uint32).tolist() == [
        0x3F810000, 0x3F820000, 0xBF810000]


def test_mm3_is_the_three_pass_product():
    a, b = (torch.from_numpy(x) for x in _arrays(5, (37, 64), (64, 48)))
    ah, al = mlp.split_hi_lo(a)
    bh, bl = mlp.split_hi_lo(b)
    want = (ah @ bh + ah @ bl) + al @ bh
    assert torch.equal(mlp.mm3(a, b), want)
    exact = a.double() @ b.double()
    err3 = float((mlp.mm3(a, b).double() - exact).abs().max())
    err1 = float(((ah @ bh).double() - exact).abs().max())
    # ~2^-16 of the product's scale (|a·b| ~ 8 here), against ~2^-9 for
    # one bf16 pass
    assert err3 < 1e-3 < 1e-2 < err1


# --------------------------------------------------------- the two kernels

def _enc_inputs(jparams, batch):
    arrays = _arrays(3, (batch, SEG), (batch, UNITS), (batch, LATENT),
                     (batch, LATENT), relu=(1,))
    return arrays + [jparams["fc21"]["w"], jparams["fc22"]["w"]]


def _dec_inputs(jparams, batch):
    arrays = _arrays(4, (batch, SEG), (batch, UNITS), (batch, LATENT),
                     relu=(1,))
    return arrays + [jparams["fc4"]["w"], jparams["fc3"]["w"]]


@pytest.mark.parametrize("batch", BATCHES)
def test_enc_bwd_full_three_pass_matches_jax_kernel(jparams, batch):
    js, ts = _both(_enc_inputs(jparams, batch))
    with jax.default_matmul_precision("high"):
        want = jmlp.enc_bwd_full(*js)
    got = mlp.enc_bwd_full(*ts)
    assert len(got) == 6 and all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, want):
        _close3(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_dec_bwd_full_three_pass_matches_jax_kernel(jparams, batch):
    js, ts = _both(_dec_inputs(jparams, batch))
    with jax.default_matmul_precision("high"):
        want = jmlp.dec_bwd_full(*js)
    got = mlp.dec_bwd_full(*ts)
    assert len(got) == 5 and all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, want):
        _close3(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_enc_bwd_full_single_pass_bf16_matches_jax_kernel(jparams, batch):
    js, ts = _both(_enc_inputs(jparams, batch), bf16=True)
    got = mlp.enc_bwd_full(*ts)
    assert all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, jmlp.enc_bwd_full(*js)):
        _close_bf16(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_dec_bwd_full_single_pass_bf16_matches_jax_kernel(jparams, batch):
    js, ts = _both(_dec_inputs(jparams, batch), bf16=True)
    got = mlp.dec_bwd_full(*ts)
    assert got[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[1:])
    for g, w in zip(got, jmlp.dec_bwd_full(*js)):
        _close_bf16(g, w)


@pytest.mark.parametrize("batch", BATCHES)
def test_full_single_pass_fp32_is_the_primitive_composition(jparams, batch):
    """One pass on fp32 operands rounds nothing: the chain equals the
    primitive kernels' plain versions."""
    _, ts = _both(_enc_inputs(jparams, batch))
    x, h, dmu, dlv, w21, w22 = ts
    dh = mlp.matmul_nt2_mask_ref(dmu, w21, dlv, w22, h)
    want = (*mlp.grad_accum_ref(x, dh), *mlp.grad_accum_ref(h, dmu),
            *mlp.grad_accum_ref(h, dlv))
    for g, w in zip(mlp.enc_bwd_full_ref(*ts, passes=1), want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    _, ts = _both(_dec_inputs(jparams, batch))
    da, h3, z, w4, w3 = ts
    dh3 = mlp.matmul_nt_mask_ref(da, w4, h3)
    want = (mlp.matmul_nt_ref(dh3, w3), *mlp.grad_accum_ref(z, dh3),
            *mlp.grad_accum_ref(h3, da))
    for g, w in zip(mlp.dec_bwd_full_ref(*ts, passes=1), want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_three_passes_need_fp32_operands(jparams):
    _, ts = _both(_enc_inputs(jparams, 8), bf16=True)
    with pytest.raises(ValueError, match="passes"):
        mlp.enc_bwd_full_ref(*ts, passes=3)
    _, ts = _both(_dec_inputs(jparams, 8))
    with pytest.raises(ValueError, match="passes"):
        mlp.dec_bwd_full_ref(*ts, passes=2)
    # the wrappers take the count from the operand dtype
    assert mlp.full_passes(torch.float32) == 3
    assert mlp.full_passes(torch.bfloat16) == 1


def test_bias_gradients_sum_the_unsplit_values(jparams):
    """db21 / db22 / db4 of the 3-pass form are plain fp32 column sums of
    the cotangents, not sums of hi + lo."""
    _, ts = _both(_enc_inputs(jparams, 37))
    got = mlp.enc_bwd_full(*ts)
    assert torch.equal(got[3], ts[2].sum(0))
    assert torch.equal(got[5], ts[3].sum(0))
    _, ts = _both(_dec_inputs(jparams, 37))
    assert torch.equal(mlp.dec_bwd_full(*ts)[4], ts[0].sum(0))


# ------------------------------------------------- Encode / Decode, "full"

@pytest.mark.parametrize("batch", BATCHES)
def test_encode_decode_full_mode_match_pallas_under_high(jparams, batch):
    x_np, z_np, cmu, clv, cy = _arrays(
        6, (batch, SEG), (batch, LATENT), (batch, LATENT), (batch, LATENT),
        (batch, SEG))

    def jloss(p, x, z):
        mu, logvar = jmlp.pallas_encode(p, x)
        y = jmlp.pallas_decode(p, z)
        return (jnp.sum(mu * cmu) + jnp.sum(logvar * clv)
                + jnp.sum(y * cy)), (mu, logvar, y)

    with jax.default_matmul_precision("high"):
        (_, (jmu, jlv, jy)), (jg, jdx, jdz) = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jparams, jnp.asarray(x_np), jnp.asarray(z_np))

    params = params_from_jax(jparams, "cpu")
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_()
    x = torch.from_numpy(x_np).requires_grad_()
    z = torch.from_numpy(z_np).requires_grad_()
    mu, logvar = mlp.encode(params, x, mode="full", passes=3)
    y = mlp.decode(params, z, mode="full", passes=3)
    loss = ((mu * torch.from_numpy(cmu)).sum()
            + (logvar * torch.from_numpy(clv)).sum()
            + (y * torch.from_numpy(cy)).sum())
    loss.backward()

    # forward, dx and the full chains: the 3-pass products on both sides
    _close3(mu, jmu)
    _close3(logvar, jlv)
    _close3(y, jy)
    _close3(x.grad, jdx)
    _close3(z.grad, jdz)
    for name in LAYERS:
        for k in ("w", "b"):
            _close3(params[name][k].grad, jg[name][k])


def test_full_mode_runs_the_full_kernels_and_nothing_else(jparams,
                                                          monkeypatch):
    calls = []
    for name in ("enc_bwd_full", "dec_bwd_full", "enc_bwd_full_ref",
                 "dec_bwd_full_ref", "enc_bwd_dw1",
                 "grad_accum2", "dec_bwd_fused", "grad_accum",
                 "matmul_nt2_mask", "matmul_nt_mask", "matmul_nt"):
        real = getattr(mlp, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("passes", a[-1] if isinstance(
                a[-1], int) else None)))
            return _real(*a, **kw)

        monkeypatch.setattr(mlp, name, spy)
    params = params_from_jax(jparams, "cpu")
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_()
    x, z = (torch.from_numpy(a) for a in _arrays(8, (8, SEG), (8, LATENT)))
    mu, logvar = mlp.encode(params, x, mode="full", passes=3)
    (mu.sum() + logvar.sum()
     + mlp.decode(params, z, mode="full", passes=3).sum()).backward()
    # fp32 operands in the `high` tier: three passes, the forward's (on the
    # CPU the wrapper hands the count to its plain version)
    assert sorted(calls) == [
        ("dec_bwd_full", 3), ("dec_bwd_full_ref", 3),
        ("enc_bwd_full", 3), ("enc_bwd_full_ref", 3)]
    # bf16 operands reach the full chains only by name, in one pass
    calls.clear()
    bparams = {n: {k: t.detach().bfloat16().requires_grad_()
                   for k, t in p.items()} for n, p in params.items()}
    mu, logvar = mlp.encode(bparams, x.bfloat16(), mode="full")
    (mu.float().sum() + logvar.float().sum()
     + mlp.decode(bparams, z.bfloat16(),
                  mode="full").float().sum()).backward()
    assert sorted(calls) == [
        ("dec_bwd_full", 1), ("dec_bwd_full_ref", 1),
        ("enc_bwd_full", 1), ("enc_bwd_full_ref", 1)]


# ------------------------------------------------------------ the registry

@pytest.mark.parametrize("precision,want", [
    ("high", "full"), ("highest", "primitive"), ("float32", "primitive"),
    ("bfloat16", "primitive")])
def test_build_model_picks_full_for_high_only(precision, want):
    cfg = Config()
    cfg.tpu.backend = "pallas"
    cfg.tpu.precision = precision
    model = build_model(cfg, "cpu")
    # `want` is the fp32 tiers' mode under the switch's "auto"; the bf16
    # tier's operands take "split" (ops/mlp.py fusion)
    mode = "split" if precision == "bfloat16" else want
    assert model.encode.keywords == {"mode": mode}
    assert model.decode.keywords == {"mode": mode}
    assert mlp.fusion(torch.bfloat16) == "split"
    if precision != "bfloat16":
        assert mlp.fusion(torch.float32,
                          3 if precision == "high" else 1) == want


def test_unknown_backward_mode_raises():
    with pytest.raises(ValueError, match="backward mode"):
        mlp.check_mode("fused")
    x = torch.zeros((4, 8))
    params = {n: {"w": torch.zeros(s), "b": torch.zeros(s[1])} for n, s in
              (("fc1", (8, 8)), ("fc21", (8, 4)), ("fc22", (8, 4)))}
    with pytest.raises(ValueError, match="backward mode"):
        mlp.encode(params, x, mode="fused")


# ------------------------------------- the built operands of the card check

def _smoke():
    """``chip_smoke.py`` of the repository root, as a module: it builds the
    operands on which the card holds the 3-pass chains bit for bit."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _terms(a, b):
    """The largest number of non-zero terms in any sum of ``a @ b``."""
    return int(((a != 0).double() @ (b != 0).double()).max())


def test_exact_split_case_has_one_term_per_sum():
    enc, dec = _smoke().exact_split_case("cpu", 0, SEG, UNITS, LATENT)
    x, h, dmu, dlv, w21, w22 = enc
    assert x.shape == (LATENT, SEG) and h.shape == (LATENT, UNITS)
    # dh: the two heads joined along k, as the kernel contracts them
    dh_terms = _terms(torch.cat([dmu, dlv], 1), torch.cat([w21, w22], 1).t())
    dh = torch.where(h > 0, mlp.mm3(dmu, w21.t()) + mlp.mm3(dlv, w22.t()), 0.)
    assert dh_terms == 1 and int((dh != 0).sum()) > dh.numel() // 4
    assert _terms(x.t(), dh) == _terms(h.t(), dmu) == _terms(h.t(), dlv) == 1
    assert int((dmu != 0).sum(0).max()) == int((dlv != 0).sum(0).max()) == 1
    da, h3, z, w4, w3 = dec
    dh3 = torch.where(h3 > 0, mlp.mm3(da, w4.t()), 0.)
    assert _terms(da, w4.t()) == _terms(dh3, w3.t()) == 1
    assert _terms(z.t(), dh3) == _terms(h3.t(), da) == 1
    assert int((da != 0).sum(0).max()) == 1
    # the values: a quarter on the tie of the split, none subnormal or huge
    v = _smoke().split_probe_values(
        torch.Generator().manual_seed(1), (4096,), "cpu")
    low = v.view(torch.int32) & 0xFFFF
    assert 0.2 < float((low == 0x8000).float().mean()) < 0.3
    assert 2.0 ** -3 <= float(v.abs().min()) and float(v.abs().max()) < 16


def test_exact_split_case_leaves_no_room_for_summation_order():
    """With one term a sum, the three partial products summed in any order
    (here in float64, then rounded) give the bits of the plain version: what
    the card's kernels, which add in their own order, are held to."""
    enc, dec = _smoke().exact_split_case("cpu", 0, SEG, UNITS, LATENT)

    def mm3_any_order(a, b):
        (ah, al), (bh, bl) = mlp.split_hi_lo(a), mlp.split_hi_lo(b)
        hh, hl, lh = ((p.double().flip(1) @ q.double().flip(0)).float()
                      for p, q in ((ah, bh), (ah, bl), (al, bh)))
        return (hh + hl) + lh

    x, h, dmu, dlv, w21, w22 = enc
    want = mlp.enc_bwd_full_ref(*enc, passes=3)
    dh = torch.where(h > 0, mm3_any_order(
        torch.cat([dmu, dlv], 1), torch.cat([w21, w22], 1).t()), 0.)
    assert torch.equal(mm3_any_order(x.t(), dh), want[0])
    assert torch.equal(mm3_any_order(h.t(), dmu), want[2])
    assert torch.equal(mm3_any_order(h.t(), dlv), want[4])
    da, h3, z, w4, w3 = dec
    want = mlp.dec_bwd_full_ref(*dec, passes=3)
    dh3 = torch.where(h3 > 0, mm3_any_order(da, w4.t()), 0.)
    assert torch.equal(mm3_any_order(dh3, w3.t()), want[0])
    assert torch.equal(mm3_any_order(z.t(), dh3), want[1])
    assert torch.equal(mm3_any_order(h3.t(), da), want[3])


@pytest.mark.parametrize("fault", ["one-pass", "nearest-even"])
def test_exact_split_case_tells_a_wrong_split_apart(monkeypatch, fault):
    """The bit-for-bit check has teeth: a chain in one fp32 pass, or one
    whose split rounds hi to nearest even, gives other bits on it."""
    smoke = _smoke()
    cases = dict(zip(("enc_bwd_full", "dec_bwd_full"),
                     smoke.exact_split_case("cpu", 0, SEG, UNITS, LATENT)))
    refs = {"enc_bwd_full": mlp.enc_bwd_full_ref,
            "dec_bwd_full": mlp.dec_bwd_full_ref}
    want = {n: refs[n](*c, passes=3) for n, c in cases.items()}
    if fault == "nearest-even":
        def split(v):
            hi = v.bfloat16().float()
            return hi, (v - hi).bfloat16().float()
        monkeypatch.setattr(mlp, "split_hi_lo", split)
    passes = 1 if fault == "one-pass" else 3
    for name, case in cases.items():
        got = refs[name](*case, passes=passes)
        exact = [i for i in range(len(got))
                 if i not in smoke.DENSE_SUMS[name]]
        moved = sum(int((got[i] != want[name][i]).sum()) for i in exact)
        total = sum(got[i].numel() for i in exact)
        assert moved > total // 50, (name, moved, total)

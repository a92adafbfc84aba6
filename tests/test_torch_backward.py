"""The port's backward kernels' plain versions (rawaudiovae_kelsey_tpu_torch
/ops/mlp.py: grad_accum, grad_accum2, enc_bwd_dw1, dec_bwd_fused — queue B
rows 7-10) against the JAX package's Pallas kernels, and the autograd
Functions ``Encode`` / ``Decode`` against ``torch.autograd`` of the plain
forward.

On the CPU the JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas.py does) and the port's wrappers run their plain
versions, because the tensors lie on the CPU.  Inputs come from numpy
seeds and go to both packages; batches 256 (a whole JAX batch tile), 100
(ragged: JAX pads it, the port masks it) and 1.

Tolerances:
* fp32: ``atol=1e-5, rtol=1e-5`` — tests/test_pallas.py's bound between
  the JAX package's own fused and primitive backward: the same fp32
  products, summed over the batch in another order.
* bf16 operands: the products of two bf16 values are exact in fp32, so
  ``grad_accum`` / ``grad_accum2`` differ only in summation order and keep
  the fp32 bound.  ``enc_bwd_dw1`` / ``dec_bwd_fused`` round the hidden
  cotangent to bf16 first (pallas_mlp.py:535, 686); where the two fp32
  sums straddle a rounding boundary one element flips by one bf16 ulp
  (2^-8 relative), so those outputs are held at ``rtol=0, atol=2^-7 ·
  max|want|`` (measured ≤ 2.3e-3 · max|want|: one flipped ulp); a fault
  shows as O(max|want|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch import ops
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import mlp

SEG, UNITS, LATENT = 256, 512, 64
BATCHES = [256, 100, 1]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(
        jvae.init_dense(jax.random.PRNGKey(0), SEG, UNITS, LATENT))


def _arrays(seed, *shapes, relu=()):
    """Seeded float32 arrays; the indices in ``relu`` are ReLU outputs
    (about half zeros), as h and h3 are."""
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


def _check(got, want, dtype, rounded=False):
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.to(torch.float32).numpy()
        assert g.shape == w.shape
        if dtype == "bf16" and rounded:
            tol = 2.0 ** -7 * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_grad_accum_matches_jax_kernel(dtype, batch):
    (ja, jb), (ta, tb) = _both(_arrays(1, (batch, UNITS), (batch, SEG),
                                       relu=(0,)), dtype)
    dw, db = mlp.grad_accum(ta, tb)
    assert dw.dtype == db.dtype == torch.float32
    _check((dw, db), jmlp.grad_accum(ja, jb), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_grad_accum2_matches_jax_kernel(dtype, batch):
    (ja, jb1, jb2), (ta, tb1, tb2) = _both(_arrays(
        2, (batch, UNITS), (batch, LATENT), (batch, LATENT), relu=(0,)),
        dtype)
    got = mlp.grad_accum2(ta, tb1, tb2)
    assert all(t.dtype == torch.float32 for t in got)
    _check(got, jmlp.grad_accum2(ja, jb1, jb2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_enc_bwd_dw1_matches_jax_kernel(jparams, dtype, batch):
    arrays = _arrays(3, (batch, SEG), (batch, UNITS), (batch, LATENT),
                     (batch, LATENT), relu=(1,))
    arrays += [jparams["fc21"]["w"], jparams["fc22"]["w"]]
    js, ts = _both(arrays, dtype)
    got = mlp.enc_bwd_dw1(*ts)
    assert all(t.dtype == torch.float32 for t in got)
    _check(got, jmlp.enc_bwd_dw1(*js), dtype, rounded=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", BATCHES)
def test_dec_bwd_fused_matches_jax_kernel(jparams, dtype, batch):
    arrays = _arrays(4, (batch, SEG), (batch, UNITS), (batch, LATENT),
                     relu=(1,))
    arrays += [jparams["fc4"]["w"], jparams["fc3"]["w"]]
    js, ts = _both(arrays, dtype)
    dz, dw3, db3 = mlp.dec_bwd_fused(*ts)
    assert dz.dtype == DTYPES[dtype][1] and dw3.dtype == torch.float32
    _check((dz, dw3, db3), jmlp.dec_bwd_fused(*js), dtype, rounded=True)


def test_plain_versions_round_where_the_tpu_kernels_round():
    """In bf16 the hidden cotangent is rounded before the contraction, so
    ``db1`` is the column sum of bf16 values (pallas_mlp.py:535-538)."""
    x, h, dmu, dlv, w21, w22 = _both(_arrays(
        5, (64, SEG), (64, UNITS), (64, LATENT), (64, LATENT),
        (UNITS, LATENT), (UNITS, LATENT), relu=(1,)), "bf16")[1]
    dh = mlp.matmul_nt2_mask_ref(dmu, w21, dlv, w22, h)
    assert dh.dtype == torch.bfloat16
    dw1, db1 = mlp.enc_bwd_dw1(x, h, dmu, dlv, w21, w22)
    assert torch.equal(db1, dh.float().sum(0))
    assert torch.equal(dw1, x.float().t() @ dh.float())


@pytest.mark.parametrize("batch", [100, 1])
def test_autograd_functions_match_autograd_of_the_plain_forward(jparams,
                                                                batch):
    """fp32: the Functions' weight and input gradients equal
    ``torch.autograd`` through ``models.vae`` to the fp32 bound."""
    p = params_from_jax(jparams)
    x, z, dmu, dlv, dy = (torch.from_numpy(a) for a in _arrays(
        6, (batch, SEG), (batch, LATENT), (batch, LATENT), (batch, LATENT),
        (batch, SEG)))

    def grads(encode, decode):
        leaves = {n: {k: t.clone().requires_grad_() for k, t in q.items()}
                  for n, q in p.items()}
        xx, zz = x.clone().requires_grad_(), z.clone().requires_grad_()
        mu, lv = encode(leaves, xx)
        y = decode(leaves, zz)
        loss = (mu * dmu).sum() + (lv * dlv).sum() + (y * dy).sum()
        loss.backward()
        return [xx.grad, zz.grad] + [leaves[n][k].grad for n in sorted(p)
                                     for k in sorted(p[n])]

    for got, want in zip(grads(ops.encode, ops.decode),
                         grads(vae.encode, vae.decode)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_bf16_functions_return_grads_in_the_params_dtype(jparams):
    """In bf16 the weight gradients come back rounded to the params' dtype
    (pallas_mlp.py:1042-1049, 1092-1099), the fp32 master params then get
    them through the cast's own backward."""
    master = params_from_jax(jparams)
    leaves = {n: {k: t.clone().requires_grad_() for k, t in q.items()}
              for n, q in master.items()}
    cparams = {n: {k: t.to(torch.bfloat16) for k, t in q.items()}
               for n, q in leaves.items()}
    x, z = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        7, (32, SEG), (32, LATENT)))
    mu, lv = ops.encode(cparams, x)
    y = ops.decode(cparams, z)
    assert mu.dtype == lv.dtype == y.dtype == torch.bfloat16
    (mu.float().sum() + lv.float().square().sum()
     + y.float().square().sum()).backward()
    want = {}
    for n in ("fc1", "fc21", "fc22", "fc3", "fc4"):
        g = leaves[n]["w"].grad
        assert g.dtype == torch.float32
        assert torch.equal(g, g.to(torch.bfloat16).float())   # bf16 values
        want[n] = g
    # against autograd of the plain bf16 forward, in bf16 tolerance
    ref = {n: {k: t.clone().requires_grad_() for k, t in q.items()}
           for n, q in master.items()}
    cref = {n: {k: t.to(torch.bfloat16) for k, t in q.items()}
            for n, q in ref.items()}
    mu, lv, _ = mlp.encoder_fwd_ref(*[cref[n][k] for n in ("fc1", "fc21",
                                                          "fc22")
                                      for k in ("w", "b")], x)
    y, _ = mlp.decoder_fwd_ref(*[cref[n][k] for n in ("fc3", "fc4")
                                 for k in ("w", "b")], z)
    (mu.float().sum() + lv.float().square().sum()
     + y.float().square().sum()).backward()
    for n, g in want.items():
        r = ref[n]["w"].grad
        err = float((g - r).norm() / r.norm())
        assert err < 2e-2, (n, err)


def test_input_grad_on_cuda_raises_naming_the_kernels_to_port():
    """The encoder's dx runs queue B rows 6 and 4 (``matmul_nt2_mask``,
    then ``matmul_nt``), which are ported: off the CPU it goes to their
    kernels and never to the plain version, so a tensor that is on neither
    the CPU nor a CUDA device is refused by the first of them (here a meta
    tensor); on the CPU it is the plain composition."""
    t = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="matmul_nt2_mask.*CUDA"):
        mlp.encode_input_grad(t, t, t, t, t, t)
    h, dmu, dlv, w1, w21, w22 = (torch.from_numpy(a) for a in _arrays(
        9, (6, UNITS), (6, LATENT), (6, LATENT), (SEG, UNITS),
        (UNITS, LATENT), (UNITS, LATENT), relu=(0,)))
    dh = torch.where(h > 0, dmu @ w21.t() + dlv @ w22.t(), 0.0)
    torch.testing.assert_close(
        mlp.encode_input_grad(h, dmu, dlv, w1, w21, w22), dh @ w1.t(),
        atol=ATOL, rtol=RTOL)


def test_cpu_backward_wrappers_launch_nothing(jparams):
    before = [w.launches for w in ops.KERNEL_WRAPPERS]
    x, h, dmu, dlv, da, h3, z = (torch.from_numpy(a) for a in _arrays(
        8, (16, SEG), (16, UNITS), (16, LATENT), (16, LATENT), (16, SEG),
        (16, UNITS), (16, LATENT), relu=(1, 5)))
    p = params_from_jax(jparams)
    mlp.grad_accum(h, da)
    mlp.grad_accum2(h, dmu, dlv)
    mlp.enc_bwd_dw1(x, h, dmu, dlv, p["fc21"]["w"], p["fc22"]["w"])
    mlp.dec_bwd_fused(da, h3, z, p["fc4"]["w"], p["fc3"]["w"])
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == before


@pytest.mark.parametrize("op", ["grad_accum", "grad_accum2", "enc_bwd_dw1",
                                "dec_bwd_fused"])
def test_backward_wrappers_refuse_tensors_off_cpu_and_cuda(op):
    t = torch.empty((8, 8), device="meta")
    args = {"grad_accum": 2, "grad_accum2": 3, "enc_bwd_dw1": 6,
            "dec_bwd_fused": 5}[op]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mlp, op)(*[t] * args)

"""The port's fused loss ops (rawaudiovae_kelsey_tpu_torch/ops/loss.py:
``loss_sums``, ``fused_loss``, ``fused_loss_components`` — queue B row 14)
against the JAX package's ``ops/pallas_loss.py`` and against both packages'
``models/vae.py`` loss, on the cases of tests/test_pallas.py.

On the CPU the JAX side runs its Pallas kernel in interpret mode and the
port's wrapper runs its plain version, because the tensors lie on the CPU.
Inputs come from numpy seeds and go to both packages.

Tolerances: values rel 1e-6 (fp32 sums in another order); the closed-form
input gradients ``atol=1e-7, rtol=1e-5`` — the same elementwise formula on
both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import loss

# the module: ``rawaudiovae_kelsey_tpu.ops`` re-exports a function of the
# same name over it
jloss = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_loss")

SEG, LATENT, BETA = 64, 16, 1e-4
BATCHES = [200, 64, 37]     # 200, 37: not a multiple of the JAX 128-row tile
REDUCTIONS = ["mean", "sum"]


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, SEG)).astype(np.float32),
            rng.uniform(-1, 1, (n, SEG)).astype(np.float32),
            rng.standard_normal((n, LATENT)).astype(np.float32),
            (rng.standard_normal((n, LATENT)) * 0.3).astype(np.float32))


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("n", BATCHES)
def test_loss_sums_match_jax_kernel(n):
    arrays = _inputs(0, n)
    sq, kl = loss.loss_sums(*_t(arrays))
    jsq, jkl, jn = jloss._loss_sums(*map(jnp.asarray, arrays))
    assert int(jn) == n
    assert sq.dtype == kl.dtype == torch.float32 and sq.dim() == 0
    assert float(sq) == pytest.approx(float(jsq), rel=1e-6)
    assert float(kl) == pytest.approx(float(jkl), rel=1e-6)


def test_loss_sums_take_bf16_and_mixed_inputs():
    arrays = _inputs(3, 37)
    r, x, mu, lv = _t(arrays)
    want = loss.loss_sums_ref(r.bfloat16(), x.bfloat16(), mu, lv)
    got = loss.loss_sums(r.bfloat16(), x.bfloat16(), mu, lv)
    assert all(t.dtype == torch.float32 for t in loss._same_dtype(
        r.bfloat16(), x.bfloat16(), mu, lv))
    assert all(t.dtype == torch.bfloat16 for t in loss._same_dtype(
        r.bfloat16(), x.bfloat16()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    jsq, jkl, _ = jloss._loss_sums(
        jnp.asarray(arrays[0]).astype(jnp.bfloat16),
        jnp.asarray(arrays[1]).astype(jnp.bfloat16),
        jnp.asarray(arrays[2]), jnp.asarray(arrays[3]))
    # bf16 differences are coarse (2^-8 steps), so the order of the fp32
    # additions shows a little more: rel 1e-5 (measured 1.5e-6)
    assert float(got[0]) == pytest.approx(float(jsq), rel=1e-5)
    assert float(got[1]) == pytest.approx(float(jkl), rel=1e-5)
    # mixed dtypes are brought to fp32
    mixed = loss.loss_sums(r, x.bfloat16(), mu.bfloat16(), lv)
    want = loss.loss_sums_ref(r, x.bfloat16().float(), mu.bfloat16().float(),
                              lv)
    assert all(torch.equal(a, b) for a, b in zip(mixed, want))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("n", BATCHES)
def test_fused_loss_value_and_grads_match_jax_and_vae(n, reduction):
    arrays = _inputs(0, n)
    js = list(map(jnp.asarray, arrays))
    ts = _t(arrays, grad=True)
    got = loss.fused_loss(*ts, BETA, reduction)
    want = float(jloss.pallas_loss(*js, BETA, reduction))
    value = float(got.detach())
    assert value == pytest.approx(want, rel=1e-6)
    for ref in (float(jvae.loss_fn(*js, BETA, SEG, reduction)),
                float(vae.loss_fn(*_t(arrays), BETA, SEG, reduction))):
        assert value == pytest.approx(ref, rel=1e-6)

    got.backward()
    jg = jax.grad(lambda *a: jloss.pallas_loss(*a, BETA, reduction),
                  argnums=(0, 1, 2, 3))(*js)
    vg = jax.grad(lambda *a: jvae.loss_fn(*a, BETA, SEG, reduction),
                  argnums=(0, 1, 2, 3))(*js)
    for t, a, b in zip(ts, jg, vg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b),
                                   atol=1e-7, rtol=1e-5)
    # against autograd of the port's own plain loss
    ps = _t(arrays, grad=True)
    vae.loss_fn(*ps, BETA, SEG, reduction).backward()
    for t, p in zip(ts, ps):
        torch.testing.assert_close(t.grad, p.grad, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_fused_loss_components_match_jax_and_vae(reduction):
    arrays = _inputs(1, 64)
    js = list(map(jnp.asarray, arrays))
    ts = _t(arrays, grad=True)
    got = loss.fused_loss_components(*ts, BETA, reduction)
    want = jloss.pallas_loss_components(*js, BETA, reduction)
    ref = jvae.loss_components(*js, BETA, SEG, reduction)
    mine = vae.loss_components(*_t(arrays), BETA, SEG, reduction)
    for g, w, r, m in zip(got, want, ref, mine):
        g = float(g.detach())
        assert g == pytest.approx(float(w), rel=1e-6)
        assert g == pytest.approx(float(r), rel=1e-6)
        assert g == pytest.approx(float(m), rel=1e-6)

    # cotangents on all three outputs combine linearly
    c = (1.0, 0.5, -2.0)
    sum(ci * gi for ci, gi in zip(c, got)).backward()

    def jtotal(*a):
        out = jloss.pallas_loss_components(*a, BETA, reduction)
        return sum(ci * oi for ci, oi in zip(c, out))

    def vtotal(*a):
        out = jvae.loss_components(*a, BETA, SEG, reduction)
        return sum(ci * oi for ci, oi in zip(c, out))

    jg = jax.grad(jtotal, argnums=(0, 1, 2, 3))(*js)
    vg = jax.grad(vtotal, argnums=(0, 1, 2, 3))(*js)
    for t, a, b in zip(ts, jg, vg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b),
                                   atol=1e-7, rtol=1e-5)


def test_fused_loss_skips_gradients_nobody_asked_for():
    r, x, mu, lv = _t(_inputs(2, 8))
    r.requires_grad_()
    loss.fused_loss(r, x, mu, lv, BETA).backward()
    assert r.grad is not None and x.grad is None and mu.grad is None


def test_unknown_reduction_raises():
    ts = _t(_inputs(2, 8))
    with pytest.raises(ValueError, match="reduction"):
        loss.fused_loss(*ts, BETA, "median")
    with pytest.raises(ValueError, match="reduction"):
        loss.fused_loss_components(*ts, BETA, "median")


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """On a CPU tensor the wrapper takes the plain version; the checks that
    guard the kernel are plain Python and run here."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    with pytest.raises(ValueError, match="CUDA"):
        mlp.cuda_device(torch.zeros(2, 2), "recon")
    with pytest.raises(TypeError, match="dtype"):
        mlp.operand_dtype(torch.zeros(2, 2, dtype=torch.float64), "recon")
    assert loss.loss_sums.launches == 0

"""The port's fused linear layer (rawaudiovae_kelsey_tpu_torch/ops/linear.py)
against the JAX package's ``ops/pallas_linear.py`` on the same seeded
inputs.  On the CPU the JAX kernels run in interpret mode and the port's
wrappers run their plain versions, so this holds the plain versions (which
chip_smoke.py holds the CUDA kernels against) to the TPU kernels'
arithmetic.

Shapes are tests/test_pallas.py's: 96×384→640 for the whole-k kernel, the
k-split gate shape 1024×1088→544 (ragged k and n).  Tolerances are that
file's: atol 2e-4, rtol 1e-4 forward, rtol 1e-3 for the gradients.  bf16:
both sides accumulate in fp32 and round once, so outputs agree to one bf16
step (rtol 2^-7).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.ops import linear

# the module: the JAX package's ops/__init__ rebinds the name to a function
jlin = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_linear")

ACTS = ("none", "relu", "tanh")


def _operands(seed, batch, k, n, sx=1.0, sw=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, k)).astype(np.float32) * sx,
            rng.standard_normal((k, n)).astype(np.float32) * sw,
            rng.standard_normal(n).astype(np.float32) * 0.1)


SMALL = _operands(0, 96, 384, 640)
GATE = _operands(1, 1024, 1088, 544, sx=0.1, sw=0.02)


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("act", ACTS)
def test_linear_fwd_matches_jax_kernel(act):
    want = np.asarray(jlin.linear_fwd(*_j(SMALL), act))
    for fn in (linear.linear_fwd_ref, linear.linear_fwd,
               linear.pallas_linear):
        np.testing.assert_allclose(fn(*_t(SMALL), act).numpy(), want,
                                   atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ACTS)
def test_linear_ksplit_fwd_matches_jax_kernel(act):
    want = np.asarray(jlin.linear_ksplit_fwd(*_j(GATE), act))
    for fn in (linear.linear_ksplit_fwd_ref, linear.linear_ksplit_fwd,
               linear.pallas_linear):
        np.testing.assert_allclose(fn(*_t(GATE), act).numpy(), want,
                                   atol=2e-4, rtol=1e-4)


def test_ksplit_ref_adds_the_slices_in_order():
    """Three slices at k = 1088 (512, 512, 64); the ragged one contributes
    only its 64 columns."""
    assert linear.ksplit_slices(1088) == 3
    assert linear.ksplit_slices(1024) == 2 and linear.ksplit_slices(1) == 1
    x, w, b = _t(GATE)
    parts = [x[:, s:s + 512] @ w[s:s + 512] for s in (0, 512, 1024)]
    want = torch.relu(((parts[0] + parts[1]) + parts[2]) + b)
    assert torch.equal(linear.linear_ksplit_fwd_ref(x, w, b, "relu"), want)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("operands", [SMALL, GATE], ids=["whole-k", "k-split"])
def test_pallas_linear_gradients_match_jax(act, operands):
    def jloss(x, w, b):
        return jnp.mean(jnp.square(jlin.pallas_linear(x, w, b, act)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(operands))
    x, w, b = (t.requires_grad_() for t in _t(operands))
    linear.pallas_linear(x, w, b, act).square().mean().backward()
    for got, ref in zip((x.grad, w.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=1e-3)


def test_pallas_linear_gradients_match_autograd_of_the_plain_layer():
    x, w, b = (t.requires_grad_() for t in _t(SMALL))
    torch.tanh(x @ w + b).square().mean().backward()
    want = [t.grad.clone() for t in (x, w, b)]
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    linear.pallas_linear(x, w, b, "tanh").square().mean().backward()
    for got, ref in zip((x.grad, w.grad, b.grad), want):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("shape", [
    (4096, 4096, 4096), (4096, 1024, 512), (4096, 512, 256),
    (4096, 256, 512), (256, 4096, 4096), (1024, 1024, 512),
    (1023, 1024, 512), (1024, 1023, 512), (1024, 1024, 511),
    (1024, 1088, 544), (96, 384, 640)])
def test_dispatch_rule_is_the_jax_one(shape, monkeypatch):
    batch, k, n = shape
    called = []
    monkeypatch.setattr(jlin, "linear_ksplit_fwd",
                        lambda *a: called.append("ksplit"))
    monkeypatch.setattr(jlin, "linear_fwd", lambda *a: called.append("whole"))
    x = jax.ShapeDtypeStruct((batch, k), jnp.float32)
    w = jax.ShapeDtypeStruct((k, n), jnp.float32)
    jlin._dispatch_fwd(x, w, None, "none")
    assert linear.takes_ksplit(batch, k, n) == (called == ["ksplit"])
    assert (linear.KSPLIT_BLOCK_B, linear.KSPLIT_BLOCK,
            linear.KSPLIT_BLOCK_K) == (jlin.KSPLIT_BLOCK_B,
                                       jlin.KSPLIT_BLOCK,
                                       jlin.KSPLIT_BLOCK_K)


def test_dispatch_calls_the_kernel_it_names(monkeypatch):
    seen = []
    monkeypatch.setattr(linear, "linear_ksplit_fwd",
                        lambda *a: seen.append("ksplit") or a[0])
    monkeypatch.setattr(linear, "linear_fwd",
                        lambda *a: seen.append("whole") or a[0])
    linear.dispatch_fwd(*_t(GATE), "none")
    linear.dispatch_fwd(*_t(SMALL), "none")
    assert seen == ["ksplit", "whole"]


@pytest.mark.parametrize("operands,jfn,fn", [
    (SMALL, jlin.linear_fwd, linear.linear_fwd),
    (GATE, jlin.linear_ksplit_fwd, linear.linear_ksplit_fwd)],
    ids=["whole-k", "k-split"])
def test_bf16_in_bf16_out(operands, jfn, fn):
    want = jfn(*_j(operands, jnp.bfloat16), "relu")
    got = fn(*_t(operands, torch.bfloat16), "relu")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-3, rtol=2 ** -7)


def test_bf16_gradients_keep_the_operand_dtypes():
    x, w, b = (t.requires_grad_() for t in _t(SMALL, torch.bfloat16))
    linear.pallas_linear(x, w, b, "relu").float().sum().backward()
    assert {x.grad.dtype, w.grad.dtype, b.grad.dtype} == {torch.bfloat16}


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        linear.linear_fwd(*_t(SMALL), "gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        linear.linear_ksplit_fwd_ref(*_t(SMALL), "gelu")


def test_deep_model_on_the_fused_layer_matches_jax():
    from rawaudiovae_kelsey_tpu.models import variants as jvariants
    from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax

    jp = jvariants.init_deep(jax.random.PRNGKey(0), 256, (128, 64), 16)
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(2).uniform(-1, 1, (40, 256)).astype(np.float32)
    jmu, jlv = jlin.deep_encode_pallas(jp, jnp.asarray(x))
    mu, lv = linear.deep_encode_pallas(tp, torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), atol=1e-5)
    np.testing.assert_allclose(
        linear.deep_decode_pallas(tp, mu).numpy(),
        np.asarray(jlin.deep_decode_pallas(jp, jmu)), atol=1e-5)

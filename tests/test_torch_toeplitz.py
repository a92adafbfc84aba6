"""The port's block-Toeplitz product and the two convolutions on it
(rawaudiovae_kelsey_tpu_torch/ops/toeplitz.py, ops/conv.py) against the JAX
package's ``ops/pallas_toeplitz.py`` and ``ops/pallas_conv.py`` on the same
seeded inputs, and against the plain convolutions of both packages.  On the
CPU the JAX kernel runs in interpret mode and the port's wrapper runs its
plain version, so this holds the plain version (which chip_smoke.py holds
the CUDA kernel against) to the TPU kernel's arithmetic.

Tolerances are tests/test_pallas.py's: atol 2e-5, rtol 1e-4 forward; atol
5e-5, rtol 1e-4 for the gradients (fp32 sums in different orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.models import variants as jvariants
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.models import variants
from rawaudiovae_kelsey_tpu_torch.ops import conv, linear, toeplitz

jtoep = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_toeplitz")
jconv = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_conv")

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-4)
GEOMETRIES = [(9, 4, 64), (5, 2, 48), (3, 4, 32), (7, 4, 64)]
SMALL_KERNELS = [(1, 2, 12), (1, 4, 12), (2, 4, 12), (3, 4, 12), (4, 4, 12),
                 (5, 4, 12)]


def _toeplitz_operands(seed=0, B=3, nb=10, G=6, kb=3, N=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nb, G)).astype(np.float32),
            (rng.standard_normal((kb, G, N)) * 0.2).astype(np.float32),
            (rng.standard_normal(N) * 0.1).astype(np.float32))


def _conv_operands(seed, K, L, B=2, cin=3, cout=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, cin)).astype(np.float32),
            (rng.standard_normal((K, cin, cout)) * 0.1).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("t_out", [None, 5, 10, 13])
@pytest.mark.parametrize("passes", [1, 4])
def test_toeplitz_ref_matches_jax_kernel(shift, t_out, passes):
    """Every shift 0…KB-1; t_out below, at (None = nb-KB+1 = 8) and above
    nb-KB+1, beyond nb too (rows with no tap in range are act(bias))."""
    ops = _toeplitz_operands()
    want = np.asarray(jtoep.toeplitz_fwd(*_j(ops), "relu", t_out, shift,
                                         passes))
    for fn in (toeplitz.toeplitz_fwd_ref, toeplitz.toeplitz_fwd,
               toeplitz.toeplitz_matmul):
        got = fn(*_t(ops), "relu", t_out, shift, passes)
        np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
def test_toeplitz_ref_every_activation(act):
    ops = _toeplitz_operands(1)
    want = np.asarray(jtoep.toeplitz_fwd(*_j(ops), act, 10, 1))
    np.testing.assert_allclose(
        toeplitz.toeplitz_fwd_ref(*_t(ops), act, 10, 1).numpy(), want, **FWD)


def test_toeplitz_four_passes_is_the_hi_lo_arithmetic():
    """passes = 4 stays within 1e-6 relative of the IEEE product where one
    bf16 pass would be off by 2^-9, and differs from it in the last bits."""
    ops = _t(_toeplitz_operands(2, nb=16, G=32, N=8))
    one = toeplitz.toeplitz_fwd_ref(*ops, "none", 16, 1, 1)
    four = toeplitz.toeplitz_fwd_ref(*ops, "none", 16, 1, 4)
    scale = float(one.abs().max())
    assert float((four - one).abs().max()) <= 1e-5 * scale
    assert not torch.equal(four, one)
    with pytest.raises(ValueError, match="passes"):
        toeplitz.toeplitz_fwd_ref(*_t(_toeplitz_operands(), torch.bfloat16),
                                  "none", 8, 0, 4)
    with pytest.raises(ValueError, match="passes"):
        toeplitz.toeplitz_fwd_ref(*ops, "none", 16, 1, 3)


def test_tap_ranges_is_the_jax_table():
    for kb, shift, t, nb in ((3, 1, 10, 10), (3, 0, 13, 10), (3, 2, 5, 10),
                             (1, 0, 4, 4), (4, 3, 2, 9), (3, 1, 1, 1)):
        assert toeplitz.tap_ranges(kb, shift, t, nb) == \
            jtoep._tap_ranges(kb, shift, t, nb)


def test_toeplitz_bf16_in_bf16_out():
    ops = _toeplitz_operands(3)
    want = jtoep.toeplitz_fwd(*_j(ops, jnp.bfloat16), "relu", 10, 1)
    got = toeplitz.toeplitz_fwd(*_t(ops, torch.bfloat16), "relu", 10, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-3, rtol=2 ** -7)


@pytest.mark.parametrize("act", ["relu", "tanh", "none"])
@pytest.mark.parametrize("shift,t_out", [(1, 10), (0, 8), (2, 13)])
def test_toeplitz_matmul_gradients_match_jax(act, shift, t_out):
    ops = _toeplitz_operands(4)

    def jloss(x, w, b):
        return 0.5 * jnp.sum(
            jtoep.toeplitz_matmul(x, w, b, act, t_out, shift) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(ops))
    x, w, b = (t.requires_grad_() for t in _t(ops))
    (0.5 * toeplitz.toeplitz_matmul(x, w, b, act, t_out, shift)
     .square().sum()).backward()
    for got, ref in zip((x.grad, w.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


@pytest.mark.parametrize("K,S,L", GEOMETRIES + SMALL_KERNELS)
def test_conv1d_pallas_matches_jax_and_plain(K, S, L):
    x, w, b = _conv_operands(K * 10 + S, K, L)
    want = np.asarray(jconv.conv1d_pallas(*_j((x, w, b)), S, "none"))
    plain_j = np.asarray(jvariants._conv(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), S))
    tx, tw, tb = _t((x, w, b))
    got = conv.conv1d_pallas(tx, tw, tb, S, "none").numpy()
    plain = variants.conv_same({"w": tw, "b": tb}, tx, S).numpy()
    assert got.shape == (2, -(-L // S), 6)
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got, plain, **FWD)
    np.testing.assert_allclose(plain, plain_j, **FWD)


@pytest.mark.parametrize("K,S,L", GEOMETRIES + SMALL_KERNELS)
def test_conv1d_transpose_pallas_matches_jax_and_plain(K, S, L):
    """Includes K < S and K = 1 (tests/test_pallas.py
    test_conv_transpose_small_kernel is the JAX regression)."""
    x, w, b = _conv_operands(K * 10 + S + 1, K, L)
    want = np.asarray(jconv.conv1d_transpose_pallas(*_j((x, w, b)), S,
                                                    "none"))
    plain_j = np.asarray(jvariants._conv_transpose(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), S))
    tx, tw, tb = _t((x, w, b))
    got = conv.conv1d_transpose_pallas(tx, tw, tb, S, "none").numpy()
    plain = variants.conv_transpose_same({"w": tw, "b": tb}, tx, S).numpy()
    assert got.shape == (2, L * S, 6)
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got, plain, **FWD)
    np.testing.assert_allclose(plain, plain_j, **FWD)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convT"])
@pytest.mark.parametrize("K,S,L", GEOMETRIES)
def test_conv_gradients_match_jax_and_autograd(K, S, L, transpose):
    """x, w and b gradients through ToeplitzMatmul (ReLU epilogue) against
    the JAX op's custom VJP and against autograd of the plain
    convolution."""
    ops = _conv_operands(K + S, K, L, B=3, cin=5)
    jop = jconv.conv1d_transpose_pallas if transpose else jconv.conv1d_pallas
    op = conv.conv1d_transpose_pallas if transpose else conv.conv1d_pallas
    plain = variants.conv_transpose_same if transpose else variants.conv_same

    want = jax.grad(lambda x, w, b: 0.5 * jnp.sum(jop(x, w, b, S, "relu")
                                                  ** 2),
                    argnums=(0, 1, 2))(*_j(ops))
    x, w, b = (t.requires_grad_() for t in _t(ops))
    (0.5 * op(x, w, b, S, "relu").square().sum()).backward()
    got = [t.grad.clone() for t in (x, w, b)]
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    (0.5 * torch.relu(plain({"w": w, "b": b}, x, S)).square().sum()
     ).backward()
    for g, ref, auto in zip(got, want, (x.grad, w.grad, b.grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GRAD)
        np.testing.assert_allclose(g.numpy(), auto.numpy(), **GRAD)


def test_length_not_divisible_by_stride_takes_im2col(monkeypatch):
    x, w, b = _conv_operands(9, 5, 30)          # 30 % 4 != 0
    want = np.asarray(jconv.conv1d_pallas(*_j((x, w, b)), 4, "relu"))
    calls = []
    real = conv._conv1d_im2col
    monkeypatch.setattr(conv, "_conv1d_im2col",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(conv, "toeplitz_matmul", None)   # must not be used
    tx, tw, tb = _t((x, w, b))
    got = conv.conv1d_pallas(tx, tw, tb, 4, "relu")
    assert calls == [1] and got.shape == (2, 8, 6)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_allclose(
        got.numpy(),
        torch.relu(variants.conv_same({"w": tw, "b": tb}, tx, 4)).numpy(),
        **FWD)


def test_transpose_plan_is_the_jax_one():
    for K, S in ((9, 4), (5, 2), (3, 4), (7, 4), (1, 2), (2, 4), (4, 4)):
        got = conv._transpose_plan(K, S, 3, 5)
        want = jconv._transpose_plan(K, S, 3, 5)
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)
        assert conv._same_pad(64, K, S) == jconv._same_pad(64, K, S)


@pytest.mark.parametrize("passes", [1, 4])
def test_conv_model_on_the_toeplitz_path_matches_the_conv1d_model(passes):
    jp = jvariants.init_conv1d(jax.random.PRNGKey(0), 256, (8, 16), 9, 4, 16)
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(2).uniform(-1, 1, (6, 256)).astype(np.float32)
    width = variants.conv_latent_width(256, 2, 4)
    jmu, jlv = jconv.conv_encode_pallas(jp, jnp.asarray(x), 4)
    mu, lv = conv.conv_encode_pallas(tp, torch.from_numpy(x), 4, passes)
    pmu, plv = variants.encode_conv1d(tp, torch.from_numpy(x), 4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **FWD)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **FWD)
    np.testing.assert_allclose(mu.numpy(), pmu.numpy(), **FWD)
    np.testing.assert_allclose(lv.numpy(), plv.numpy(), **FWD)
    y = conv.conv_decode_pallas(tp, mu, 4, width, 16, passes)
    np.testing.assert_allclose(
        y.numpy(),
        np.asarray(jconv.conv_decode_pallas(jp, jmu, 4, width, 16)), **FWD)
    np.testing.assert_allclose(
        y.numpy(), variants.decode_conv1d(tp, mu, 4, width, 16).numpy(),
        **FWD)


def test_conv_model_heads_go_through_the_fused_linear(monkeypatch):
    seen = []
    real = linear.pallas_linear
    monkeypatch.setattr(conv, "pallas_linear",
                        lambda *a: seen.append(a[3]) or real(*a))
    tp = variants.init_conv1d(torch.Generator().manual_seed(0), 64, (4, 8),
                              5, 4, 8)
    mu, _ = conv.conv_encode_pallas(tp, torch.zeros(2, 64), 4)
    conv.conv_decode_pallas(tp, mu, 4, 4, 8)
    assert seen == ["none", "none", "relu"]


# The tensor-core kernel's tile walk (csrc/wgmma.cuh ToeplitzTiles), emulated
# in fp32 on the CPU: each half tile of toeplitz.tile_plan is one 3-D box of
# x, zero outside the tensor, at (g0, t0 - shift + j, b0) for k-step (tap j,
# channels g0..g0+63), against rows j·G + g0 .. + 63 of w viewed as (KB·G,
# N), zero past its end; the sum over the k-steps in order, then bias,
# activation and the clipped store.  Held against the plain version and the
# JAX kernel at small widths: shifts 0 .. KB-1, t_out that does not divide
# the half, above 64 and past nb, G below 64 and no multiple of it.

def _box(x, g0, t0, b0, t_half, b_half):
    """The (b_half · t_half, 64) rows a TMA box of x brings, zero outside."""
    B, nb, G = x.shape
    out = torch.zeros((b_half, t_half, 64), dtype=torch.float32)
    b1, t1, g1 = min(b0 + b_half, B), min(t0 + t_half, nb), min(g0 + 64, G)
    ta, ga = max(t0, 0), max(g0, 0)
    if b1 > b0 and t1 > ta and g1 > ga:
        out[:b1 - b0, ta - t0:t1 - t0, ga - g0:g1 - g0] = \
            x[b0:b1, ta:t1, ga:g1].float()
    return out.reshape(b_half * t_half, 64)


def _tile_walk(x, w, b, act, t_out, shift):
    B, nb, G = x.shape
    kb, _, N = w.shape
    t_half, b_half = toeplitz.tile_plan(t_out)
    w_rows = torch.cat([w.reshape(kb * G, N).float(),
                        torch.zeros((64, N))])        # zero past the end
    y = torch.zeros((B, t_out, N), dtype=torch.float32)
    for h in range(toeplitz.tile_halves(B, t_out, t_half, b_half)):
        b0, t0 = toeplitz.half_origin(h, t_out, t_half, b_half)
        acc = torch.zeros((b_half * t_half, N))
        for step in range(kb * -(-G // 64)):
            j, g0 = toeplitz.k_step(step, G)
            acc += _box(x, g0, t0 - shift + j, b0, t_half, b_half) \
                @ w_rows[j * G + g0:j * G + g0 + 64]
        out = linear.apply_act(act, acc + b.float()).reshape(
            b_half, t_half, N)
        nb_, nt_ = min(b_half, B - b0), min(t_half, t_out - t0)
        y[b0:b0 + nb_, t0:t0 + nt_] = out[:nb_, :nt_]
    return y.to(x.dtype)


@pytest.mark.parametrize("B,nb,G,kb,N,t_out,shift", [
    (3, 10, 8, 3, 16, 10, 1),         # G below 64; t_out below 64
    (2, 12, 72, 3, 8, 13, 2),         # G no multiple of 64; t_out past nb
    (5, 9, 24, 4, 24, 9, 0),          # shift 0, four taps
    (5, 9, 24, 4, 24, 9, 3),          # shift KB - 1
    (2, 70, 16, 3, 8, 70, 1),         # t_out above 64: two halves a row
    (17, 4, 64, 3, 40, 4, 1),         # 16 batch rows a half, ragged B
    (1, 6, 128, 2, 16, 5, 1),         # B = 1
], ids=str)
def test_the_tensor_core_tile_walk_matches_plain_and_jax(B, nb, G, kb, N,
                                                         t_out, shift):
    x, w, b = _toeplitz_operands(B * 100 + G, B, nb, G, kb, N)
    got = _tile_walk(*_t((x, w, b)), "relu", t_out, shift)
    want = toeplitz.toeplitz_fwd_ref(*_t((x, w, b)), "relu", t_out, shift)
    assert got.shape == want.shape == (B, t_out, N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    jwant = np.asarray(jtoep.toeplitz_fwd(*_j((x, w, b)), "relu", t_out,
                                          shift))
    np.testing.assert_allclose(got.numpy(), jwant, **FWD)

"""The port's fused linear backward (rawaudiovae_kelsey_tpu_torch/ops/
linear_bwd.py) against the TPU kernels ``dw_fused`` / ``dx_fused`` of
benchmarks/deep_bwd_probe.py on the same seeded inputs.  On the CPU the JAX
kernels run in interpret mode (their own ``_interpret()`` switch) and the
port's wrappers run their plain versions, so this holds the plain versions
(which chip_smoke.py holds the CUDA kernels against) to the TPU kernels'
arithmetic.

Tolerances.  fp32: both sides form the same products and sum them in
another order: 2e-5 · max|want|.  bf16: ``da`` is rounded at the same place
on both sides and the products of two bf16 values are exact in fp32, so
``dW`` and ``db`` (fp32) differ by summation order only and ``dx`` by at
most one bf16 step where the two fp32 sums straddle a rounding boundary:
2^-6 · max|want| covers all three.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.ops import linear, linear_bwd

REPO = Path(__file__).resolve().parents[1]
ACTS = ("relu", "tanh", "none")
REL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "deep_bwd_probe", REPO / "benchmarks" / "deep_bwd_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() is guarded
    return mod


@pytest.fixture(scope="module")
def probe():
    return _load_probe()


def _operands(seed, batch, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, k)).astype(np.float32),
            rng.standard_normal((batch, n)).astype(np.float32),
            rng.standard_normal((batch, n)).astype(np.float32) * 0.01,
            rng.standard_normal((k, n)).astype(np.float32) * 0.01)


def _t(arrays, dtype):
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]


def _j(arrays, dtype):
    return [jnp.asarray(a, JDT[dtype]) for a in arrays]


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_dw_fused_matches_the_tpu_kernel(probe, act, dtype):
    x, y, dy, _ = _operands(0, 512, 256, 512)
    jdw, jdb = probe.dw_fused(*_j((x, y, dy), dtype), act=act, block_b=256,
                              block_n=256)
    dw, db = linear_bwd.dw_fused(*_t((x, y, dy), dtype), act)
    assert dw.dtype == db.dtype == torch.float32
    _close(dw, jdw, REL[dtype])
    _close(db, jdb, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_dx_fused_matches_the_tpu_kernel(probe, act, dtype):
    _, y, dy, w = _operands(1, 512, 256, 512)
    jdx = probe.dx_fused(*_j((y, dy, w), dtype), act=act, block_b=256,
                         block_n=128)
    dx = linear_bwd.dx_fused(*_t((y, dy, w), dtype), act)
    assert dx.dtype == TDT[dtype] and tuple(dx.shape) == (512, 256)
    _close(dx, np.asarray(jdx.astype(jnp.float32)), REL[dtype])


@pytest.mark.parametrize("act", ACTS)
def test_cotangent_is_the_probes_da(probe, act):
    """``cotangent`` equals ``_da`` bit for bit in bf16: fp32 arithmetic,
    one rounding."""
    _, y, dy, _ = _operands(2, 64, 8, 96)
    jy, jdy = _j((y, dy * 100), "bfloat16")
    want = np.asarray(probe._da(act, jy, jdy, jnp.bfloat16)
                      .astype(jnp.float32))
    ty, tdy = _t((y, dy * 100), "bfloat16")
    got = linear_bwd.cotangent(act, ty, tdy)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cotangent_differs_from_act_backward_only_in_bf16_tanh():
    _, y, dy, _ = _operands(3, 128, 8, 64)
    for dtype in ("float32", "bfloat16"):
        ty, tdy = _t((y, dy), dtype)
        for act in ACTS:
            same = torch.equal(linear_bwd.cotangent(act, ty, tdy),
                               linear.act_backward(act, ty, tdy))
            assert same == (not (dtype == "bfloat16" and act == "tanh"))


@pytest.mark.parametrize("act", ACTS)
def test_fused_bwd_matches_plain_bwd_and_autograd(act):
    """fp32: the fused pair, the plain backward and autograd through
    ``PallasLinear`` agree."""
    x, _, dy, w = _operands(4, 96, 40, 72)
    x, dy, w = _t((x, dy * 100, w * 10), "float32")
    b = torch.linspace(-0.1, 0.1, 72)
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y = linear.pallas_linear(xg, wg, bg, act)
    y.backward(dy)
    fused = linear_bwd.fused_bwd(x, y.detach(), dy, w, act)
    plain = linear_bwd.plain_bwd(x, y.detach(), dy, w, act)
    for got, want, auto in zip(fused, plain, (xg.grad, wg.grad, bg.grad)):
        _close(got, want.numpy(), 2e-5)
        _close(got, auto.numpy(), 2e-5)


def test_fused_bwd_contract_in_bf16():
    x, y, dy, w = _t(_operands(5, 64, 48, 40), "bfloat16")
    dx, dw, db = linear_bwd.fused_bwd(x, y, dy, w, "relu")
    px, pw, pb = linear_bwd.plain_bwd(x, y, dy, w, "relu")
    assert dx.dtype == px.dtype == torch.bfloat16
    assert dw.dtype == pw.dtype == db.dtype == pb.dtype == torch.float32
    for got, want in ((dx, px), (dw, pw), (db, pb)):
        _close(got, want.float().numpy(), 2.0 ** -6)


@pytest.mark.parametrize("shape", [(33, 17, 5), (1, 70, 33), (130, 1, 67)])
@pytest.mark.parametrize("act", ACTS)
def test_ragged_shapes_against_a_float64_product(shape, act):
    """No size need divide a tile (the TPU kernels need B % block_b == 0 and
    n % block_n == 0)."""
    batch, k, n = shape
    x, y, dy, w = _operands(6, batch, k, n)
    y64, dy64 = y.astype(np.float64), dy.astype(np.float64)
    da = {"relu": np.where(y64 > 0, dy64, 0.0),
          "tanh": dy64 * (1 - y64 * y64), "none": dy64}[act]
    tx, ty, tdy, tw = _t((x, y, dy, w), "float32")
    dx, dw, db = linear_bwd.fused_bwd(tx, ty, tdy, tw, act)
    assert tuple(dx.shape) == (batch, k) and tuple(dw.shape) == (k, n)
    assert tuple(db.shape) == (n,)
    _close(dx, da @ w.astype(np.float64).T, 2e-5)
    _close(dw, x.astype(np.float64).T @ da, 2e-5)
    _close(db, da.sum(0), 2e-5)


def test_unknown_activation_raises():
    x, y, dy, w = _t(_operands(7, 4, 3, 2), "float32")
    with pytest.raises(ValueError, match="unknown activation"):
        linear_bwd.dw_fused(x, y, dy, "gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        linear_bwd.dx_fused(y, dy, w, "gelu")


@pytest.mark.parametrize("device", ["meta"])
def test_wrappers_refuse_what_is_neither_cpu_nor_cuda(device):
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor the kernel takes, or the wrapper raises."""
    x = torch.empty((4, 3), device=device)
    y = torch.empty((4, 2), device=device)
    w = torch.empty((3, 2), device=device)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        linear_bwd.dw_fused(x, y, y, "relu")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        linear_bwd.dx_fused(y, y, w, "relu")


def test_wrappers_check_dtype_shape_and_contiguity(monkeypatch):
    """The checks a CUDA tensor passes through before a launch, exercised
    here with the device check stood in for (no launch is reached)."""
    monkeypatch.setattr(linear_bwd, "cuda_device",
                        lambda t, name: t.device)
    x, y, dy, w = (torch.empty(s, device="meta")
                   for s in ((8, 6), (8, 4), (8, 4), (6, 4)))
    with pytest.raises(TypeError, match="dtype"):
        linear_bwd.dw_fused(x.double(), y.double(), dy.double(), "relu")
    with pytest.raises(TypeError, match="dtype"):
        linear_bwd.dw_fused(x, y.to(torch.bfloat16), dy, "relu")
    with pytest.raises(ValueError, match="shape"):
        linear_bwd.dw_fused(x, y, dy[:4], "relu")
    with pytest.raises(ValueError, match="contiguous"):
        linear_bwd.dw_fused(x, y.t().contiguous().t(), dy, "relu")
    with pytest.raises(ValueError, match="shape"):
        linear_bwd.dx_fused(y, dy, w[:, :3], "relu")
    with pytest.raises(TypeError, match="dtype"):
        linear_bwd.dx_fused(y, dy, w.to(torch.bfloat16), "relu")
    with pytest.raises(ValueError, match="contiguous"):
        linear_bwd.dx_fused(y, dy, w.t().contiguous().t(), "relu")


def test_cpu_calls_count_no_launch():
    x, y, dy, w = _t(_operands(8, 8, 6, 4), "float32")
    before = (linear_bwd.dw_fused.launches, linear_bwd.dx_fused.launches)
    linear_bwd.fused_bwd(x, y, dy, w, "relu")
    assert (linear_bwd.dw_fused.launches,
            linear_bwd.dx_fused.launches) == before

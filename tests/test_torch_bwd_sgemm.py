"""The fp32 forms of ``enc_bwd_dw1``, ``grad_accum2`` and ``dec_bwd_fused``
(rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu, kernel code 2): the launches of
csrc/sgemm.cuh that ``matmul_nt2_mask``, ``matmul_nt_mask``, ``matmul_nt``
and ``grad_accum`` make in fp32, one after another.  Modelled in Python:
the dispatch (``mlp.resolve_enc_bwd_dw1`` / ``resolve_grad_accum2`` /
``resolve_dec_bwd``), the plans they pass to the C entry points — each
launch at the plan its own op would take — and the composition of the
launches at a small width against the plain versions and the JAX kernels
in interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3b).

Tolerance: atol 1e-5.  The model forms the plain version's fp32 products
(each rounded once, as an FFMA adds it unrounded: within the tolerance)
and adds them in the kernels' order — k in order for the gated products,
the batch cut into slices added in order for the weight gradients — another
order than one fp32 dot of at most 300 terms of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import mlp, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
SGEMM, TENSOR_CORES = tensor_cores.SGEMM, tensor_cores.TENSOR_CORES
SLICE_ROWS = 64                   # csrc/sgemm.cuh kSliceRows
SMS = 132
ATOL = 1e-5
DENSE = (1024, 2048, 256)         # configs/default.ini: seg, units, latent
OPS = ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused")


def _resolve(op, kernel, dtype, batch, seg, units, latent, aligned=True):
    """Each op's rule at the dense model's widths: grad_accum2 contracts
    h (units) against the heads' cotangents (latent)."""
    if op == "grad_accum2":
        return mlp.resolve_grad_accum2(kernel, dtype, batch, units, latent,
                                       aligned)
    rule = mlp.resolve_enc_bwd_dw1 if op == "enc_bwd_dw1" \
        else mlp.resolve_dec_bwd
    return rule(kernel, dtype, batch, seg, units, latent, aligned)


# ---- the dispatch

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_fp32_dense_widths_take_the_fp32_kernel(op, batch):
    assert op in tensor_cores.SGEMM_OPS
    assert _resolve(op, "auto", F32, batch, *DENSE) == SGEMM
    assert _resolve(op, "sgemm", F32, batch, *DENSE) == SGEMM
    assert _resolve(op, "cuda_cores", F32, batch, *DENSE) == 0
    # bf16 keeps the tensor cores
    assert _resolve(op, "auto", BF16, batch, *DENSE) == TENSOR_CORES


# (seg, units, latent) no multiple of 4 in a width each op reads
# (grad_accum2 reads units and latent only)
ODD = [(op, widths) for op in OPS
       for widths in ((1024, 2048, 38), (1024, 2046, 256), (1022, 2048, 256))
       if op != "grad_accum2" or widths[0] == 1024]


@pytest.mark.parametrize("op,widths", ODD, ids=str)
def test_fp32_widths_no_multiple_of_4_keep_the_first_version(op, widths):
    assert _resolve(op, "auto", F32, 1000, *widths) == 0
    with pytest.raises(ValueError, match=f"{op}: kernel 'sgemm' takes fp32"):
        _resolve(op, "sgemm", F32, 1000, *widths)


@pytest.mark.parametrize("op", OPS)
def test_unaligned_fp32_views_and_no_rows_keep_the_first_version(op):
    assert _resolve(op, "auto", F32, 1000, *DENSE, False) == 0
    assert _resolve(op, "auto", F32, 0, *DENSE) == 0
    with pytest.raises(ValueError, match="'sgemm' takes fp32"):
        _resolve(op, "sgemm", BF16, 1000, *DENSE)


# ---- what reaches the C entry points: each launch at its own op's plan

def _stand_in(monkeypatch):
    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    monkeypatch.setattr(mlp._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _meta(*shapes):
    return [torch.empty(s, device="meta", dtype=F32) for s in shapes]


@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_enc_bwd_dw1_passes_its_launches_own_plans(monkeypatch, batch):
    launched = _stand_in(monkeypatch)
    seg, units, latent = DENSE
    x, h, dmu, dlv, w21, w22 = _meta((batch, seg), (batch, units),
                                     (batch, latent), (batch, latent),
                                     (units, latent), (units, latent))
    before = mlp.enc_bwd_dw1.sgemm_launches
    mlp.enc_bwd_dw1(x, h, dmu, dlv, w21, w22)
    name, args = launched.pop()
    assert name == "rvk_enc_bwd_dw1" and len(args) == 19
    mlp.matmul_nt2_mask(dmu, w21, dlv, w22, h)
    gated = launched.pop()[1]
    mlp.grad_accum(x, torch.empty((batch, units), device="meta"))
    wgrad = launched.pop()[1]
    # x, ..., dh, dw1, db1, workspace | batch, seg, units, latent, dtype,
    # tile_dh, tile_dw, split, kernel
    assert args[10:] == (batch, *DENSE, 0, gated[10], *wgrad[9:11], SGEMM)
    assert gated[-1] == wgrad[-1] == SGEMM
    assert (args[9] is None) == (wgrad[4] is None)
    if args[9] is not None:
        assert args[9].shape == wgrad[4].shape
    assert mlp.enc_bwd_dw1.sgemm_launches - before == 1


@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_grad_accum2_passes_grad_accums_plan_and_one_workspace(monkeypatch,
                                                               batch):
    """The fp32 form is grad_accum's launch twice: its plan, and a
    workspace of one output's slices that the two take in turn."""
    launched = _stand_in(monkeypatch)
    units, latent = DENSE[1], DENSE[2]
    a, b1, b2 = _meta((batch, units), (batch, latent), (batch, latent))
    before = mlp.grad_accum2.sgemm_launches
    mlp.grad_accum2(a, b1, b2)
    name, args = launched.pop()
    assert name == "rvk_grad_accum2" and len(args) == 15
    mlp.grad_accum(a, b1)
    one = launched.pop()[1]
    # a, b1, b2, dw1, db1, dw2, db2, workspace | batch, n, m, dtype,
    # tile_dw, split, kernel
    assert args[8:] == (batch, units, latent, 0, *one[9:11], SGEMM)
    assert (args[7] is None) == (one[4] is None)
    if args[7] is not None:
        assert args[7].shape == one[4].shape == (
            one[10], units * latent + latent)
    assert mlp.grad_accum2.sgemm_launches - before == 1


@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_dec_bwd_fused_passes_its_launches_own_plans(monkeypatch, batch):
    launched = _stand_in(monkeypatch)
    seg, units, latent = DENSE
    da, h3, z, w4, w3 = _meta((batch, seg), (batch, units), (batch, latent),
                              (units, seg), (latent, units))
    before = mlp.dec_bwd_fused.sgemm_launches
    mlp.dec_bwd_fused(da, h3, z, w4, w3)
    name, args = launched.pop()
    assert name == "rvk_dec_bwd_fused" and len(args) == 20
    dh3 = torch.empty((batch, units), device="meta")
    mlp.matmul_nt_mask(da, w4, h3)
    gated = launched.pop()[1]
    mlp.matmul_nt(dh3, w3)
    dz = launched.pop()[1]
    mlp.grad_accum(z, dh3)
    wgrad = launched.pop()[1]
    # da, ..., dh3, dz, dw3, db3, workspace | batch, seg, units, latent,
    # dtype, tile_dh3, tile_dz, tile_dw, split, kernel
    assert args[10:] == (batch, *DENSE, 0, gated[8], dz[7], *wgrad[9:11],
                         SGEMM)
    assert gated[-1] == dz[-1] == wgrad[-1] == SGEMM
    assert (args[9] is None) == (wgrad[4] is None)
    assert mlp.dec_bwd_fused.sgemm_launches - before == 1


# ---- the launches, composed

def _slices(k, split):
    """The batch rows of each slice as launch_wgrad cuts them: runs of
    ceil(ceil(k / 64) / split) steps of 64."""
    steps = -(-k // SLICE_ROWS)
    per = -(-steps // split)
    return [range(z * per * SLICE_ROWS, min(k, (z + 1) * per * SLICE_ROWS))
            for z in range(split)]


def _fma_dot(a, b):
    """a (M, K) · b (K, N), each output one fp32 accumulator adding its
    products in k order (exact in fp64, rounded once: an FFMA)."""
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64) + a[:, k, None].astype(np.float64)
               * b[None, k, :].astype(np.float64)).astype(np.float32)
    return acc


def _gated(pairs, gate):
    """launch_gated: where(gate > 0, [a1 a2] · [w1 w2]ᵀ, 0), the pairs
    joined along k (the first pair's k, then the second's) into one
    accumulator."""
    a = np.concatenate([p[0] for p in pairs], axis=1)
    w = np.concatenate([p[1] for p in pairs], axis=1)
    return np.where(gate > 0, _fma_dot(a, w.T), np.float32(0))


def _wgrad(a, b, split):
    """launch_wgrad: (aᵀ b, colsum(b)), the batch cut into ``split``
    slices, each an accumulator in batch order, the slices added in
    order."""
    dw = np.zeros((a.shape[1], b.shape[1]), dtype=np.float32)
    db = np.zeros(b.shape[1], dtype=np.float32)
    for rows in _slices(a.shape[0], split):
        rows = list(rows)
        dw = dw + _fma_dot(a[rows].T, b[rows])
        col = np.zeros(b.shape[1], dtype=np.float32)
        for r in rows:
            col = col + b[r]
        db = db + col
    return dw, db


def _split(batch, m, n):
    """The slices sgemm_wgrad_plan picks for dW (m, n) over ``batch``."""
    return tensor_cores.sgemm_wgrad_plan(m, n, batch, SMS)[1]


def _arrays(seed, *shapes, relu=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, s in enumerate(shapes):
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.maximum(a, 0) if k in relu else a)
    return out


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float32).reshape(g.shape)
        assert float(np.abs(g - w).max()) <= ATOL


def _refs(name, arrays):
    """The plain version and the JAX kernel in interpret mode."""
    plain = getattr(mlp, f"{name}_ref")(*map(torch.from_numpy, arrays))
    jax_ = getattr(jmlp, name)(*map(jnp.asarray, arrays))
    return [t.numpy() for t in plain], [np.asarray(t) for t in jax_]


SEG, UNITS, LATENT = 64, 128, 32  # the dense model cut down


@pytest.mark.parametrize("batch,split", [(300, None), (300, 3), (1, None)])
def test_the_composed_enc_bwd_dw1_matches_plain_and_jax(batch, split):
    """dh = gated([dmu w21] [dlv w22]) into the scratch, then dW1 and db1
    over the batch's slices (the rule's, or 3 of 128, 128 and 44 rows)."""
    x, h, dmu, dlv, w21, w22 = _arrays(
        batch, (batch, SEG), (batch, UNITS), (batch, LATENT),
        (batch, LATENT), (UNITS, LATENT), (UNITS, LATENT), relu=(1,))
    x, dmu, dlv = x * 0.3, dmu * 0.3, dlv * 0.3
    w21, w22 = w21 / LATENT ** 0.5, w22 / LATENT ** 0.5
    dh = _gated([(dmu, w21), (dlv, w22)], h)
    got = _wgrad(x, dh, split or _split(batch, SEG, UNITS))
    for want in _refs("enc_bwd_dw1", [x, h, dmu, dlv, w21, w22]):
        _close(got, want)


@pytest.mark.parametrize("batch,split", [(300, None), (300, 3), (1, None)])
def test_the_composed_grad_accum2_matches_plain_and_jax(batch, split):
    """grad_accum's launch for each head, the same slices."""
    h, dmu, dlv = _arrays(batch + 1, (batch, UNITS), (batch, LATENT),
                          (batch, LATENT), relu=(0,))
    split = split or _split(batch, UNITS, LATENT)
    got = (*_wgrad(h, dmu * 0.1, split), *_wgrad(h, dlv * 0.1, split))
    for want in _refs("grad_accum2", [h, dmu * 0.1, dlv * 0.1]):
        _close(got, want)


@pytest.mark.parametrize("batch,split", [(300, None), (300, 3), (1, None)])
def test_the_composed_dec_bwd_fused_matches_plain_and_jax(batch, split):
    """dh3 = gated(da w4) into the scratch, dz = dh3 w3ᵀ, then dW3 and db3
    over the batch's slices."""
    da, h3, z, w4, w3 = _arrays(batch + 2, (batch, SEG), (batch, UNITS),
                                (batch, LATENT), (UNITS, SEG),
                                (LATENT, UNITS), relu=(1,))
    da, w4, w3 = da * 0.1, w4 / SEG ** 0.5, w3 / UNITS ** 0.5
    dh3 = _gated([(da, w4)], h3)
    dz = _fma_dot(dh3, w3.T)
    got = (dz, *_wgrad(z, dh3, split or _split(batch, LATENT, UNITS)))
    for want in _refs("dec_bwd_fused", [da, h3, z, w4, w3]):
        _close(got, want)

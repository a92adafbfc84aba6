"""The tensor-core forms of bf16 ``dec_bwd_fused``, ``grad_accum`` and
``enc_bwd_dw1`` (rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu on
csrc/wgmma.cuh), modelled in Python: the M-major A staging of the weight
gradient, its split of the batch and the fixed-order sums of the slices and
of the column-sum groups, the k-joined walk of ``enc_bwd_dw1`` 's dh (which
map and columns each k-step reads), and the launches emulated at a small
width against the plain versions and the JAX kernels.  The kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 3b).

Tolerances.  The emulation forms the same fp32 sums of exact bf16 products
as the plain version, cut along the batch and the columns and added in
another order: dz (bf16) may flip one bf16 ulp where the two sums straddle a
rounding boundary, ``2^-8 · max|plain|``; a weight gradient from exact bf16
products (dW3 and db3 from the emulated dh3, dW4 and db4, dW1 and db1 from
the emulated dh) is an fp32 sum of at most 300 terms, ``1e-5 · max|plain|``
(measured ~1e-7).  Outputs behind a rounded hidden cotangent held against
a version that rounds its own (the JAX kernel in interpret mode, the plain
``enc_bwd_dw1``) take tests/test_torch_backward.py's bound, ``2^-7 ·
max|JAX|``: one element of dh may flip by a bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import mlp, tensor_cores

BF16 = torch.bfloat16
TILE_M, TILE_K, CHUNK = 128, 64, 64 * 128   # csrc/wgmma.cuh kTileM, kTileK,
#                                             kChunkBytes


# ---- the M-major A staging (WgradTiles::load_a, stage_product with kAT)

def _stage_a(zb: np.ndarray, m0: int, k0: int) -> np.ndarray:
    """The 128 x 64 A tile of k-step k0 and tile rows m0.. as TMA stages it
    from the (K, M) matrix ``zb`` (uint16 bf16 bits): two 64 x 64 boxes at
    (m0, k0) and (m0 + 64, k0), chunk h at h · 8192 bytes, k-row r of a
    chunk at r · 128, its 16-byte unit u at (u ^ (r % 8)) · 16; what lies
    outside ``zb`` is zero."""
    K, M = zb.shape
    smem = np.zeros(2 * CHUNK // 2, dtype=np.uint16)     # in bf16 elements
    for h in range(2):
        for r in range(64):
            for mi in range(64):
                k, m = k0 + r, m0 + 64 * h + mi
                v = zb[k, m] if k < K and m < M else 0
                byte = h * CHUNK + r * 128 + ((mi // 8) ^ (r % 8)) * 16 \
                    + (mi % 8) * 2
                smem[byte // 2] = v
    return smem


def _read_a(smem: np.ndarray, wg: int, kk: int) -> np.ndarray:
    """The 64 x 16 A operand (m, k) of k16 step kk that warpgroup wg's wgmma
    reads through its descriptor: start = chunk wg + kk · 2048 bytes (128
    units of 16), SBO 1024 between groups of eight k-rows, a k-row 128
    bytes, the 128-byte swizzle on the 16-byte unit of m; one chunk of 64 m
    (the LBO is never stepped over)."""
    start = wg * CHUNK + kk * 128 * 16
    out = np.zeros((64, 16), dtype=np.uint16)
    for m in range(64):
        for k in range(16):
            byte = start + (k // 8) * 1024 + (k % 8) * 128 \
                + ((m // 8) ^ (k % 8)) * 16 + (m % 8) * 2
            out[m, k] = smem[byte // 2]
    return out


@settings(max_examples=40, deadline=None)
@given(K=st.integers(1, 200), M=st.integers(1, 40).map(lambda v: 8 * v),
       data=st.data())
def test_m_major_a_staging_reads_the_transpose(K, M, data):
    """Every (m, k) the wgmma reads from a staged tile is zᵀ[m, k] (zero
    past the matrix), for a k-step and tile row of the (K, M) matrix."""
    rng = np.random.default_rng(K * 1000 + M)
    zb = rng.integers(1, 2 ** 16, size=(K, M), dtype=np.uint16)
    tm = data.draw(st.integers(0, -(-M // TILE_M) - 1))
    kb = data.draw(st.integers(0, -(-K // TILE_K) - 1))
    m0, k0 = tm * TILE_M, kb * TILE_K
    smem = _stage_a(zb, m0, k0)
    padded = np.zeros((k0 + 64, m0 + 128), dtype=np.uint16)
    kk_end, mm_end = min(K, k0 + 64), min(M, m0 + 128)
    padded[:kk_end, :mm_end] = zb[:kk_end, :mm_end]
    want = padded[k0:k0 + 64, m0:m0 + 128].T           # (128 m, 64 k)
    for wg in range(2):
        for kk in range(4):
            got = _read_a(smem, wg, kk)
            assert np.array_equal(
                got, want[64 * wg:64 * wg + 64, 16 * kk:16 * kk + 16])


def test_every_staged_a_byte_is_read_once_a_stage():
    """The two warpgroups' four k16 steps read each of the 8192 bf16 values
    of the staged A tile exactly once: no overlap, no gap."""
    seen = np.zeros(2 * CHUNK // 2, dtype=np.int64)
    for wg in range(2):
        for kk in range(4):
            start = wg * CHUNK + kk * 128 * 16
            for m in range(64):
                for k in range(16):
                    byte = start + (k // 8) * 1024 + (k % 8) * 128 \
                        + ((m // 8) ^ (k % 8)) * 16 + (m % 8) * 2
                    seen[byte // 2] += 1
    assert (seen == 1).all()


# ---- the split of the batch (tensor_cores.wgrad_plan, launch_wgrad)

def _slices(k, split):
    """The k-steps of each slice as launch_wgrad cuts them."""
    total = -(-k // TILE_K)
    steps = -(-total // split)
    return [list(range(s * steps, min(total, (s + 1) * steps)))
            for s in range(split)]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 64).map(lambda v: 8 * v),
       n=st.integers(1, 600).map(lambda v: 8 * v),
       k=st.integers(1, 70000), sms=st.sampled_from([8, 66, 114, 132]))
def test_the_batch_split_covers_every_k_step_once(m, n, k, sms):
    width, split = tensor_cores.wgrad_plan(m, n, k, sms)
    assert width in tensor_cores.TILE_WIDTHS and split >= 1
    total = -(-k // TILE_K)
    # launch_wgrad's own check: no slice is empty
    steps = -(-total // split)
    assert -(-total // steps) == split
    runs = _slices(k, split)
    assert all(runs) and sum(runs, []) == list(range(total))
    tiles = -(-m // TILE_M) * -(-n // width)
    # more than one slice only where one wave has room, each slice at least
    # WGRAD_MIN_STEPS k-steps long (the last may be shorter)
    if split > 1:
        assert tiles * split <= max(sms, tiles)
        assert steps >= tensor_cores.WGRAD_MIN_STEPS


@pytest.mark.parametrize("batch,plan", [(8192, (128, 4)), (1000, (64, 1)),
                                        (1, (64, 1)), (4096, (64, 2))])
def test_the_weight_gradient_plan_at_the_main_path(batch, plan):
    """dW3 (256 x 2048) on 132 SMs: at the microbatch 32 tiles of 128 x 128
    times 4 slices of 2048 rows, one wave of 128 blocks (16 tiles of 256
    would leave half the card idle at that slice length)."""
    assert tensor_cores.wgrad_plan(256, 2048, batch, 132) == plan


def test_the_weight_gradient_plan_for_the_first_version_is_zeros():
    assert tensor_cores.wgrad(0, torch.device("meta"), 256, 2048, 8192) \
        == (0, 0)


# ---- the three launches, emulated

def _gate_tile(da, w4, h3, m0, n0, bn):
    """dh3 of one 128 x bn tile: the fp32 sum over seg, then where(gate >
    0, ·, 0) with the gate read as bf16 from h3's box, rounded once."""
    rows = slice(m0, m0 + TILE_M)
    cols = slice(n0, n0 + bn)
    prod = da[rows].float() @ w4[cols].float().t()
    return torch.where(h3[rows, cols].float() > 0, prod, 0.0).to(BF16)


def _wgrad(a, b, bn_dw, split):
    """(dW, db) = (aᵀ b, colsum(b)) in fp32 as launch_wgrad computes them
    from bf16 a (K, M) and b (K, N): slice by slice (each slice's tiles a
    whole fp32 dW, the slices added in order: sum_slices); db from the
    staged b of dW's first tile row, summed per thread over the rows of its
    group in k order, the groups in order, then the slices in order."""
    batch, m, n = a.shape[0], a.shape[1], b.shape[1]
    groups, rows_a_group = 512 // bn_dw, bn_dw // 8
    work = torch.zeros((split, m * n + n))
    for s, steps in enumerate(_slices(batch, split)):
        rows = slice(steps[0] * TILE_K, min(batch, (steps[-1] + 1) * TILE_K))
        part = a[rows].float().t() @ b[rows].float()
        work[s, :m * n] = part.reshape(-1)
        sums = torch.zeros((groups, n))
        for kb in steps:
            stage = torch.zeros((TILE_K, n))
            k0 = kb * TILE_K
            stage[:min(batch, k0 + TILE_K) - k0] = b[k0:k0 + TILE_K].float()
            for g in range(groups):
                for r in range(g * rows_a_group, (g + 1) * rows_a_group):
                    sums[g] += stage[r]
        col = torch.zeros(n)
        for g in range(groups):
            col += sums[g]
        work[s, m * n:] = col
    total = work[0].clone()
    for s in range(1, split):
        total += work[s]
    return total[:m * n].reshape(m, n), total[m * n:]


def _emulate(da, h3, z, w4, w3, bn_dh3, bn_dz, bn_dw, split):
    """(dz, dW3, db3) as tensor_core_dec_bwd's three launches compute them:
    dh3 and dz tile by tile, then dW3 and db3 as launch_wgrad does
    (_wgrad)."""
    batch, units, latent = h3.shape[0], h3.shape[1], z.shape[1]
    dh3 = torch.empty((batch, units), dtype=BF16)
    for m0 in range(0, batch, TILE_M):
        for n0 in range(0, units, bn_dh3):
            dh3[m0:m0 + TILE_M, n0:n0 + bn_dh3] = _gate_tile(da, w4, h3, m0,
                                                            n0, bn_dh3)
    dz = torch.empty((batch, latent), dtype=BF16)
    for m0 in range(0, batch, TILE_M):
        for n0 in range(0, latent, bn_dz):
            dz[m0:m0 + TILE_M, n0:n0 + bn_dz] = (
                dh3[m0:m0 + TILE_M].float()
                @ w3[n0:n0 + bn_dz].float().t()).to(BF16)
    return (dz, *_wgrad(z, dh3, bn_dw, split))


def _operands(batch, seg, units, latent, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((batch, seg)) * 1e-2,
              np.maximum(rng.standard_normal((batch, units)), 0),
              rng.standard_normal((batch, latent)),
              rng.standard_normal((units, seg)) / seg ** 0.5,
              rng.standard_normal((latent, units)) / units ** 0.5]
    return [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrays]


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("bn_dh3,bn_dz,bn_dw,split", [
    (64, 64, 64, 1), (64, 64, 64, 2), (128, 64, 256, 3), (256, 128, 128, 5)])
def test_the_emulated_launches_compute_dec_bwd_fused(bn_dh3, bn_dz, bn_dw,
                                                     split):
    """Batch 300 (five k-steps of 64, the last ragged), latent 24, units
    72, seg 40: tile widths wider than the outputs and slices that cut the
    batch unevenly, against the plain version and the JAX kernel in
    interpret mode."""
    ops = _operands(300, 40, 72, 24)
    da, h3, z, w4, w3 = ops
    assert all(_slices(300, split))        # a split launch_wgrad takes
    got = _emulate(da, h3, z, w4, w3, bn_dh3, bn_dz, bn_dw, split)
    want = mlp.dec_bwd_fused_ref(*ops)
    assert got[0].dtype == BF16 and got[1].dtype == got[2].dtype \
        == torch.float32
    assert _rel(got[0], want[0]) <= 2.0 ** -8
    assert _rel(got[1], want[1]) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-5
    jax_ops = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in ops]
    for g, w in zip(got, jmlp.dec_bwd_fused(*jax_ops)):
        w = torch.from_numpy(np.array(jnp.asarray(w).astype(jnp.float32)))
        assert g.shape == w.shape
        assert _rel(g, w) <= 2.0 ** -7


def test_db3_sums_the_rounded_dh3_and_skips_the_ragged_rows():
    """db3 is the column sum of the bf16 dh3 the gate wrote (not of its fp32
    sums), and the rows past the batch in the last k-step add nothing."""
    ops = _operands(100, 16, 8, 8, seed=3)
    da, h3, z, w4, w3 = ops
    dh3 = mlp.matmul_nt_mask_ref(da, w4, h3)
    _, _, db3 = _emulate(*ops, 64, 64, 64, 1)
    assert _rel(db3, dh3.float().sum(0)) <= 1e-6
    prod = (da.float() @ w4.float().t()) * (h3.float() > 0)
    assert not torch.equal(prod.sum(0), dh3.float().sum(0))


def test_the_slice_workspace_layout_is_sum_slices():
    """Slice s writes dW at s · (M·N + N) and its column sums right after;
    sum_slices adds the slices in order and sends the first M·N values to
    dW, the next N to db."""
    M, N, split = 16, 24, 3
    g = torch.Generator().manual_seed(0)
    work = torch.randn((split, M * N + N), generator=g)
    flat = work.reshape(-1)
    stride = M * N + N
    dw, db = torch.empty(M * N), torch.empty(N)
    for i in range(0, M * N + N, 4):
        acc = flat[i:i + 4].clone()
        for s in range(1, split):
            acc += flat[s * stride + i:s * stride + i + 4]
        (dw[i:i + 4] if i < M * N else db[i - M * N:i - M * N + 4])[:] = acc
    total = work[0] + work[1] + work[2]
    assert torch.equal(dw, total[:M * N]) and torch.equal(db, total[M * N:])


# ---- rows 7 and 8: grad_accum on launch_wgrad alone, enc_bwd_dw1 as the
# k-joined gated dh, then launch_wgrad

def _joined_steps(latent):
    """The loads of each k-step of the k-joined walk (JoinedKTiles) for a
    contraction of ``latent`` columns a product: (pair, A's first column,
    B's first column); pair 0 is (dmu, w21), pair 1 (dlv, w22)."""
    steps = -(-latent // TILE_K)
    out = []
    for kb in range(2 * steps):
        second = kb >= steps
        col = (kb - steps if second else kb) * TILE_K
        out.append((int(second), col, col))
    return out


@pytest.mark.parametrize("latent", [256, 72, 8])
def test_the_joined_walk_reads_every_column_of_both_products_once(latent):
    """Each product's k-steps come in a run, the first pair's first; A and
    B of a step start at the same column; every column below ``latent`` of
    dmu / w21 and of dlv / w22 is read by exactly one step, and the
    columns of the last box past ``latent`` (TMA's zeros) by none."""
    walk = _joined_steps(latent)
    steps = -(-latent // TILE_K)
    assert len(walk) == 2 * steps
    assert [p for p, _, _ in walk] == [0] * steps + [1] * steps
    for pair in (0, 1):
        seen = np.zeros(steps * TILE_K, dtype=np.int64)
        for p, col_a, col_b in walk:
            if p == pair:
                assert col_a == col_b
                seen[col_a:col_a + TILE_K] += 1
        assert (seen == 1).all()
        assert steps * TILE_K - latent == {256: 0, 72: 56, 8: 56}[latent]


def _joined_dh_tile(dmu, dlv, w21, w22, h, m0, n0, bn):
    """dh of one 128 x bn tile as the k-joined walk forms it: one fp32
    accumulator that adds each k-step's 64 columns, TMA's zeros past
    ``latent`` included, the first pair's steps first; then where(h > 0,
    ·, 0) with the gate read as bf16 from h's box, rounded once."""
    rows, cols = slice(m0, m0 + TILE_M), slice(n0, n0 + bn)
    latent = dmu.shape[1]
    boxes = -(-latent // TILE_K) * TILE_K
    acc = torch.zeros((dmu[rows].shape[0], w21[cols].shape[0]))
    for pair, col, _ in _joined_steps(latent):
        a, b = (dmu, w21) if pair == 0 else (dlv, w22)
        sa = torch.zeros((acc.shape[0], boxes))
        sb = torch.zeros((acc.shape[1], boxes))
        sa[:, :latent], sb[:, :latent] = a[rows].float(), b[cols].float()
        acc += sa[:, col:col + TILE_K] @ sb[:, col:col + TILE_K].t()
    return torch.where(h[rows, cols].float() > 0, acc, 0.0).to(BF16)


def _emulate_enc(x, h, dmu, dlv, w21, w22, bn_dh, bn_dw, split):
    """(dW1, db1) and the rounded dh as tensor_core_enc_bwd_dw1's launches
    compute them: dh tile by tile (_joined_dh_tile), then launch_wgrad
    (_wgrad) of x and dh."""
    batch, units = h.shape
    dh = torch.empty((batch, units), dtype=BF16)
    for m0 in range(0, batch, TILE_M):
        for n0 in range(0, units, bn_dh):
            dh[m0:m0 + TILE_M, n0:n0 + bn_dh] = _joined_dh_tile(
                dmu, dlv, w21, w22, h, m0, n0, bn_dh)
    return _wgrad(x, dh, bn_dw, split), dh


def _enc_operands(batch, seg, units, latent, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((batch, seg)) * 0.3,
              np.maximum(rng.standard_normal((batch, units)), 0),
              rng.standard_normal((batch, latent)),
              rng.standard_normal((batch, latent)),
              rng.standard_normal((units, latent)) / units ** 0.5,
              rng.standard_normal((units, latent)) / units ** 0.5]
    return [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrays]


def _to_jax(ops):
    return [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ops]


def _from_jax(w):
    return torch.from_numpy(np.array(jnp.asarray(w).astype(jnp.float32)))


def test_the_joined_dh_is_the_sum_of_both_products():
    """The k-joined tile's fp32 sum (before the gate and the rounding)
    equals dmu @ w21ᵀ + dlv @ w22ᵀ: the zero-filled columns past a
    ragged latent add nothing."""
    x, h, dmu, dlv, w21, w22 = _enc_operands(130, 16, 40, 72, seed=2)
    ones = torch.ones_like(h)
    got = _joined_dh_tile(dmu, dlv, w21, w22, ones, 0, 0, 64).float()
    want = (dmu[:128].float() @ w21.float().t()
            + dlv[:128].float() @ w22.float().t())
    assert got.shape == want.shape == (128, 40)
    assert _rel(got, want.to(BF16)) <= 2.0 ** -8


@pytest.mark.parametrize("latent", [72, 8])
@pytest.mark.parametrize("bn_dh,bn_dw,split", [
    (64, 64, 1), (64, 256, 2), (128, 128, 3), (256, 64, 5)])
def test_the_emulated_launches_compute_enc_bwd_dw1(latent, bn_dh, bn_dw,
                                                    split):
    """Batch 300 (five k-steps of 64, the last ragged), seg 40, units 72
    and a latent of two zero-filled k-steps a product (72) or one (8):
    the weight gradient from the emulated dh against the plain product of
    that dh, and the whole against the plain version and the JAX kernel in
    interpret mode."""
    ops = _enc_operands(300, 40, 72, latent)
    (dw1, db1), dh = _emulate_enc(*ops, bn_dh, bn_dw, split)
    assert dw1.dtype == db1.dtype == torch.float32
    exact = mlp.grad_accum_ref(ops[0], dh)
    assert _rel(dw1, exact[0]) <= 1e-5 and _rel(db1, exact[1]) <= 1e-5
    assert _rel(dh, mlp.matmul_nt2_mask_ref(ops[2], ops[4], ops[3], ops[5],
                                            ops[1])) <= 2.0 ** -8
    for g, w in zip((dw1, db1), mlp.enc_bwd_dw1_ref(*ops)):
        assert g.shape == w.shape and _rel(g, w) <= 2.0 ** -7
    for g, w in zip((dw1, db1), jmlp.enc_bwd_dw1(*_to_jax(ops))):
        w = _from_jax(w)
        assert g.shape == w.shape and _rel(g, w) <= 2.0 ** -7


@pytest.mark.parametrize("batch", [300, 1000, 1])
@pytest.mark.parametrize("bn_dw,split", [(64, 1), (128, 2), (256, 3)])
def test_the_emulated_weight_gradient_computes_grad_accum(batch, bn_dw,
                                                          split):
    """grad_accum's one launch (launch_wgrad of h3 and da) at a ragged
    batch, slices that cut it unevenly and tile widths wider than the
    output, against the plain version and the JAX kernel in interpret
    mode: fp32 sums of exact bf16 products."""
    # a split that would leave a slice empty is one launch_wgrad refuses
    # (wgrad_plan never gives it): batch 1 takes one slice
    if not all(_slices(batch, split)):
        split = len([s for s in _slices(batch, split) if s])
    rng = np.random.default_rng(batch + split)
    h3 = np.maximum(rng.standard_normal((batch, 72)), 0)
    da = rng.standard_normal((batch, 40)) * 1e-2
    ops = [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in (h3, da)]
    got = _wgrad(*ops, bn_dw, split)
    for g, w in zip(got, mlp.grad_accum_ref(*ops)):
        assert g.dtype == torch.float32 and _rel(g, w) <= 1e-5
    for g, w in zip(got, jmlp.grad_accum(*_to_jax(ops))):
        w = _from_jax(w)
        assert g.shape == w.shape and _rel(g, w) <= 1e-5

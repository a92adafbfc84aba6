"""Two weight-gradient forms, modelled in Python: bf16 ``grad_accum2`` as one
tensor-core launch with both heads' outputs side by side
(rawaudiovae_kelsey_tpu_torch/csrc/wgmma.cuh ``launch_wgrad2``), and fp32
``grad_accum`` on the CUDA cores' mainloop (csrc/sgemm.cuh
``launch_wgrad``: an M-major A staged as it lies, the batch cut into
slices, the column sums from the staged B).  The tile walks, the staging
and the slices are checked element for element; the launches are emulated
at a small width against the plain versions and the JAX kernels in
interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3b and 3c).

Tolerances.  The emulations form the plain version's fp32 sums of the same
products (exact for bf16 operands; rounded once each for fp32 ones), cut
along the batch and the columns and added in another order: an fp32 sum of
at most 300 terms, ``1e-5 · max|plain|``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import mlp, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
TILE_M, TILE_K = 128, 64          # csrc/wgmma.cuh kTileM, kTileK
SLICE_ROWS = 64                   # csrc/sgemm.cuh kSliceRows
THREADS, STAGES = 256, 4          # csrc/sgemm.cuh kThreads, kStages
# csrc/sgemm.cuh kTiles and the slab depth of each (kSlabDepth)
SGEMM_TILES = {(128, 128): 16, (128, 64): 32, (64, 64): 32}


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def _to_jax(ops, dtype):
    return [jnp.asarray(t.float().numpy()).astype(dtype) for t in ops]


def _from_jax(w):
    return torch.from_numpy(np.array(jnp.asarray(w).astype(jnp.float32)))


def _slices(k, split, unit=TILE_K):
    """The k-steps of each slice as launch_wgrad_outs and sgemm.cuh's
    launch_wgrad cut them: runs of ceil(ceil(k / 64) / split) steps."""
    total = -(-k // unit)
    steps = -(-total // split)
    return [list(range(s * steps, min(total, (s + 1) * steps)))
            for s in range(split)]


# ---- row 9: the two-output walk (WgradTiles<2>, the mainloop's tile
# columns, WgradOut's outputs)

def _tile_origin(tile, tiles_m, tiles_n):
    """csrc/wgmma.cuh tile_origin: groups of eight tile rows, down the rows
    first."""
    per_group = 8 * tiles_n
    group = tile // per_group
    first = group * 8
    rows = min(tiles_m - first, 8)
    in_group = tile - group * per_group
    return first + in_group % rows, in_group // rows


def _walk(m, n, k, bn, split, outs=2):
    """Each tile of the launch as the mainloop sees it: (output, slice,
    first row of dW, first column of dW, sums the columns)."""
    m_tiles = -(-m // TILE_M)
    per_out = -(-n // bn)
    tiles_m, tiles_n = m_tiles * split, outs * per_out
    out = []
    for tile in range(tiles_m * tiles_n):
        tm, tn = _tile_origin(tile, tiles_m, tiles_n)
        o = tn // per_out
        out.append((o, tm // m_tiles, (tm % m_tiles) * TILE_M,
                    (tn - o * per_out) * bn, tm % m_tiles == 0))
    return out


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 40).map(lambda v: 8 * v),
       n=st.integers(1, 80).map(lambda v: 8 * v),
       bn=st.sampled_from(tensor_cores.TILE_WIDTHS),
       split=st.integers(1, 6))
def test_the_two_output_walk_writes_every_tile_once(m, n, bn, split):
    """Every (output, slice, tile row, tile column) of both weight
    gradients is one tile of the walk; tile column tn reads output tn //
    ceil(n / bn)'s B and writes its (dW, db); the column sums of each
    output's slice come from that output's first tile row, once per
    column block."""
    walk = _walk(m, n, 64 * split, bn, split)
    keys = [t[:4] for t in walk]
    assert len(keys) == len(set(keys))
    assert set(keys) == {(o, s, r, c) for o in range(2)
                         for s in range(split)
                         for r in range(0, m, TILE_M)
                         for c in range(0, n, bn)}
    sums = [(o, s, c) for o, s, r, c, summed in walk if summed]
    assert sorted(sums) == sorted({(o, s, c) for o, s, _, c, _ in walk})
    assert all(r == 0 for _, _, r, _, summed in walk if summed)


def _wgrad2(a, b1, b2, bn, split):
    """(dW1, db1, dW2, db2) as launch_wgrad2 computes them from bf16 a (K,
    M), b1 and b2 (K, N): the walk's tiles write slice s of output o at row
    o · split + s of the workspace (each a whole fp32 dW of the slice's
    k-steps, then its column sums: per thread over the rows of its group in
    k order, the groups in order, from the staged B of that output's first
    tile row); sum_slices adds each output's slices in order."""
    batch, m, n = a.shape[0], a.shape[1], b1.shape[1]
    groups, group_rows = 512 // bn, bn // 8
    work = torch.full((2 * split, m * n + n), float("nan"))
    runs = _slices(batch, split)
    for o, s, r0, c0, summed in _walk(m, n, batch, bn, split):
        b = (b1, b2)[o]
        rows = slice(runs[s][0] * TILE_K,
                     min(batch, (runs[s][-1] + 1) * TILE_K))
        part = (a[rows, r0:r0 + TILE_M].float().t()
                @ b[rows, c0:c0 + bn].float())
        dw = work[o * split + s, :m * n].view(m, n)
        dw[r0:r0 + TILE_M, c0:c0 + bn] = part
        if summed:
            cols = min(n, c0 + bn) - c0
            acc = torch.zeros((groups, cols))
            for kb in runs[s]:
                stage = torch.zeros((TILE_K, cols))
                k0 = kb * TILE_K
                stage[:min(batch, k0 + TILE_K) - k0] = \
                    b[k0:k0 + TILE_K, c0:c0 + cols].float()
                for g in range(groups):
                    for r in range(g * group_rows, (g + 1) * group_rows):
                        acc[g] += stage[r]
            col = torch.zeros(cols)
            for g in range(groups):
                col += acc[g]
            work[o * split + s, m * n + c0:m * n + c0 + cols] = col
    assert not torch.isnan(work).any()        # every value written once
    out = []
    for o in range(2):
        total = work[o * split].clone()
        for s in range(1, split):
            total += work[o * split + s]
        out += [total[:m * n].reshape(m, n), total[m * n:]]
    return out


def _grad2_operands(batch, units, latent, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [np.maximum(rng.standard_normal((batch, units)), 0),
              rng.standard_normal((batch, latent)),
              rng.standard_normal((batch, latent))]
    return [torch.from_numpy(x.astype(np.float32)).to(BF16) for x in arrays]


@pytest.mark.parametrize("latent", [8, 72, 256])
@pytest.mark.parametrize("bn,split", [(64, 1), (128, 2), (256, 3), (64, 5)])
def test_the_emulated_launch_computes_grad_accum2(latent, bn, split):
    """Batch 300 (five k-steps of 64, the last ragged), units 136 (two tile
    rows, the second ragged) and a latent of one ragged tile column (8, 72)
    or several (256): both outputs against the plain version and the JAX
    kernel in interpret mode."""
    ops = _grad2_operands(300, 136, latent)
    assert all(_slices(300, split))       # a split launch_wgrad2 takes
    got = _wgrad2(*ops, bn, split)
    want = mlp.grad_accum2_ref(*ops)
    for g, w in zip(got, want):
        assert g.dtype == F32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-5
    for g, w in zip(got, jmlp.grad_accum2(*_to_jax(ops, jnp.bfloat16))):
        w = _from_jax(w).reshape(g.shape)
        assert _rel(g, w) <= 1e-5


def test_each_head_sums_its_own_cotangent():
    """db1 is the column sum of dmu and db2 of dlogvar, whichever head's
    tiles run first: heads with different column sums stay apart."""
    h, dmu, dlv = _grad2_operands(130, 16, 8, seed=3)
    dlv = (dlv.float() + 5).to(BF16)
    _, db1, _, db2 = _wgrad2(h, dmu, dlv, 64, 1)
    assert _rel(db1, dmu.float().sum(0)) <= 1e-6
    assert _rel(db2, dlv.float().sum(0)) <= 1e-6
    assert not torch.allclose(db1, db2)


# ---- row 7 in fp32: csrc/sgemm.cuh's M-major A (Operand<BM, false, kBK>)

def _stage(a, r0, k0, R, bk, k_end):
    """The ring slab of k-step slab k0 / bk and rows r0.. as the block's
    cp.async copies stage an M-major (or N-major) operand from the (K, R')
    matrix ``a``: thread t's i-th copy is index t + 256 · i, k-row idx //
    (R / 4), rows 4 · (idx % (R / 4)) ..; the slab holds element (k, r) at
    k · R + r; copies past the matrix or at k >= k_end are zero fills.
    Returns the slab and how often each float was written."""
    K, width = a.shape
    slab = np.full(R * bk, np.nan, dtype=np.float32)
    written = np.zeros(R * bk, dtype=np.int64)
    for t in range(THREADS):
        for i in range(R * bk // 4 // THREADS):
            idx = t + i * THREADS
            kq, r = idx // (R // 4), (idx % (R // 4)) * 4
            k, row = k0 + kq, r0 + r
            valid = row < width and k < k_end
            at = kq * R + r
            slab[at:at + 4] = a[k, row:row + 4] if valid else 0.0
            written[at:at + 4] += 1
    return slab, written


@pytest.mark.parametrize("tile", list(SGEMM_TILES), ids=str)
@pytest.mark.parametrize("K,M,r0,k0,k_end", [
    (300, 136, 0, 0, 300), (300, 136, 128, 256, 300),
    (100, 64, 0, 96, 100), (5000, 260, 128, 1024, 1088)])
def test_the_m_major_a_is_staged_as_it_lies(tile, K, M, r0, k0, k_end):
    """Every float of a slab is written by one copy, and the fragment a
    lane reads at k-row k, rows r .. r + 3 (Operand::frag without the
    K-major swizzle) is aᵀ[r0 + r .., k0 + k]: zero past the matrix and past
    the slice's end."""
    bm, _ = tile
    bk = SGEMM_TILES[tile]
    rng = np.random.default_rng(K + M)
    a = rng.standard_normal((K + bk, M)).astype(np.float32)
    slab, written = _stage(a, r0, k0, bm, bk, min(k_end, K))
    assert (written == 1).all()
    padded = np.zeros((k0 + bk, r0 + bm), dtype=np.float32)
    kk, mm = min(k_end, K, k0 + bk), min(M, r0 + bm)
    padded[k0:kk, r0:mm] = a[k0:kk, r0:mm]
    want = padded[k0:k0 + bk, r0:r0 + bm].T            # (rows, k)
    for k in range(bk):
        for r in range(0, bm, 4):
            assert np.array_equal(slab[k * bm + r:k * bm + r + 4],
                                  want[r:r + 4, k])


@pytest.mark.parametrize("tile", list(SGEMM_TILES), ids=str)
def test_the_lanes_read_every_row_of_the_tile(tile):
    """The 256 threads' fragments (warp w, lane l: rows (w / 4) · BM / 2 +
    (l % 8) · 4 + 32 · i and columns (w % 4) · BN / 4 + (l / 8) · 4 + 16 ·
    j) cover the BM x BN tile once, so the M-major A's rows all reach an
    accumulator."""
    bm, bn = tile
    seen = np.zeros((bm, bn), dtype=np.int64)
    for t in range(THREADS):
        warp, lane = t // 32, t % 32
        am = (warp // 4) * (bm // 2) + (lane % 8) * 4
        an = (warp % 4) * (bn // 4) + (lane // 8) * 4
        for i in range(bm // 64):
            for j in range(bn // 64):
                r, c = am + 32 * i, an + 16 * j
                seen[r:r + 4, c:c + 4] += 1
    assert (seen == 1).all()


def _slab_walk(K, rows, z, bk):
    """The k values slice z of sgemm_kernel computes: slabs from z · rows /
    bk up to ceil(min(K, (z + 1) · rows) / bk), each k < that end."""
    k_end = min(K, (z + 1) * rows)
    first = z * rows // bk
    slabs = -(-k_end // bk) - first
    return [k for slab in range(first, first + slabs)
            for k in range(slab * bk, (slab + 1) * bk) if k < k_end]


@settings(max_examples=300, deadline=None)
@given(K=st.integers(1, 70000), split=st.integers(1, 40),
       bk=st.sampled_from([16, 32]))
def test_the_fp32_slices_cover_every_k_once(K, split, bk):
    """With a split sgemm.cuh's launch_wgrad takes (no empty slice), the
    slices' slabs visit every k of the batch exactly once, in order, each
    slice a whole number of slabs from a multiple of 64."""
    total = -(-K // SLICE_ROWS)
    split = min(split, total)
    steps = -(-total // split)
    split = -(-total // steps)             # launch_wgrad's own check
    rows = steps * SLICE_ROWS
    walk = [k for z in range(split) for k in _slab_walk(K, rows, z, bk)]
    assert walk == list(range(K))
    assert all(_slab_walk(K, rows, z, bk) for z in range(split))


def _sgemm_wgrad(a, b, tile, split):
    """(dW, db) = (aᵀ b, colsum(b)) in fp32 as sgemm.cuh's launch_wgrad
    computes them: slice by slice, each output one accumulator adding its
    products in k order (each product rounded once, as an FFMA adds it
    unrounded: within the tolerance); db from the staged B of dW's first
    tile row, thread t adding column t % BN over the rows of group t / BN
    of each slab in k order, the groups in order; then the slices in
    order."""
    batch, m, n = a.shape[0], a.shape[1], b.shape[1]
    bm, bn = tile
    bk = SGEMM_TILES[tile]
    groups = THREADS // bn
    group_rows = bk // groups
    runs = _slices(batch, split, SLICE_ROWS)
    rows = len(runs[0]) * SLICE_ROWS
    work = torch.zeros((split, m * n + n))
    for z in range(split):
        ks = _slab_walk(batch, rows, z, bk)
        acc = torch.zeros((m, n))
        for k in ks:
            acc += a[k].float()[:, None] * b[k].float()[None, :]
        work[z, :m * n] = acc.reshape(-1)
        sums = torch.zeros((groups, n))
        first = z * rows // bk
        for slab in range(first, -(-min(batch, (z + 1) * rows) // bk)):
            stage = torch.zeros((bk, n))
            k0, k_end = slab * bk, min(batch, (z + 1) * rows)
            stage[:max(0, min(k_end, k0 + bk) - k0)] = \
                b[k0:min(k_end, k0 + bk)].float()
            for g in range(groups):
                for r in range(g * group_rows, (g + 1) * group_rows):
                    sums[g] += stage[r]
        col = torch.zeros(n)
        for g in range(groups):
            col += sums[g]
        work[z, m * n:] = col
    total = work[0].clone()
    for z in range(1, split):
        total += work[z]
    return total[:m * n].reshape(m, n), total[m * n:]


@pytest.mark.parametrize("batch", [300, 1])
@pytest.mark.parametrize("tile,split", [((128, 128), 1), ((128, 64), 2),
                                        ((64, 64), 5)], ids=str)
def test_the_emulated_fp32_weight_gradient_computes_grad_accum(batch, tile,
                                                               split):
    """fp32 grad_accum's one launch at a ragged batch (300: five k-steps of
    64, the last ragged; 1), slices that cut it unevenly, against the plain
    version and the JAX kernel in interpret mode."""
    if not all(_slices(batch, split, SLICE_ROWS)):
        split = len([s for s in _slices(batch, split, SLICE_ROWS) if s])
    rng = np.random.default_rng(batch + split)
    a = np.maximum(rng.standard_normal((batch, 72)), 0)
    b = rng.standard_normal((batch, 40)) * 1e-2
    ops = [torch.from_numpy(x.astype(np.float32)) for x in (a, b)]
    got = _sgemm_wgrad(*ops, tile, split)
    for g, w in zip(got, mlp.grad_accum_ref(*ops)):
        assert g.dtype == F32 and _rel(g, w) <= 1e-5
    for g, w in zip(got, jmlp.grad_accum(*_to_jax(ops, jnp.float32))):
        w = _from_jax(w).reshape(g.shape)
        assert _rel(g, w) <= 1e-5


# ---- the plan rules (tensor_cores.wgrad_plan with two outputs,
# tensor_cores.sgemm_wgrad_plan)

@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 64).map(lambda v: 8 * v),
       n=st.integers(1, 100).map(lambda v: 8 * v),
       k=st.integers(1, 70000), sms=st.sampled_from([8, 66, 114, 132]))
def test_the_two_output_plan_leaves_no_slice_empty(m, n, k, sms):
    width, split = tensor_cores.wgrad_plan(m, n, k, sms, 2)
    assert width in tensor_cores.TILE_WIDTHS and split >= 1
    runs = _slices(k, split)
    assert all(runs) and sum(runs, []) == list(range(-(-k // TILE_K)))
    tiles = 2 * -(-m // TILE_M) * -(-n // width)
    if split > 1:
        assert tiles * split <= max(sms, tiles)
        assert len(runs[0]) >= tensor_cores.WGRAD_MIN_STEPS


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 600).map(lambda v: 4 * v),
       n=st.integers(1, 600).map(lambda v: 4 * v),
       k=st.integers(1, 70000), sms=st.sampled_from([8, 66, 114, 132]))
def test_the_fp32_plan_leaves_no_slice_empty(m, n, k, sms):
    index, split = tensor_cores.sgemm_wgrad_plan(m, n, k, sms)
    bm, bn = tensor_cores.SGEMM_TILES[index]
    runs = _slices(k, split, SLICE_ROWS)
    assert all(runs) and sum(runs, []) == list(range(-(-k // SLICE_ROWS)))
    tiles = -(-m // bm) * -(-n // bn)
    # one wave of two blocks an SM (the kernel's launch bounds)
    if split > 1:
        assert tiles * split <= max(2 * sms, tiles)
        assert len(runs[0]) >= tensor_cores.SGEMM_WGRAD_MIN_STEPS


# the rules' picks at the main path's shapes on 132 SMs: grad_accum2 (dW21
# and dW22, 2048 x 256 each) in bf16, at the microbatch 64 tiles of 128 x
# 128 times 2 slices (one wave, tied on the cost with one slice of 128 x 64
# and 4 of 128 x 256, both slower on an H100: chip_smoke.py phase 3b's
# sweep); the `highest` step's five fp32 weight gradients (dW1 1024 x 2048,
# dW21 and dW22, dW3 256 x 2048, dW4 2048 x 1024) as (tile of SGEMM_TILES,
# slices), two blocks an SM (phase 3c's sweep)
@pytest.mark.parametrize("batch,plan", [(8192, (128, 2)), (4096, (128, 2)),
                                        (1000, (64, 1)), (1, (64, 1))])
def test_the_two_output_plan_at_the_main_path(batch, plan):
    assert tensor_cores.wgrad_plan(2048, 256, batch, 132, 2) == plan


@pytest.mark.parametrize("m,n,batch,plan", [
    (1024, 2048, 8192, ((128, 128), 2)), (2048, 1024, 8192, ((128, 128), 2)),
    (2048, 256, 8192, ((128, 128), 8)), (256, 2048, 8192, ((128, 128), 8)),
    (2048, 256, 1000, ((64, 64), 2)), (2048, 256, 1, ((64, 64), 1))],
    ids=["dW1", "dW4", "dW21", "dW3", "dW21@1000", "dW21@1"])
def test_the_fp32_plan_at_the_main_path(m, n, batch, plan):
    index, split = tensor_cores.sgemm_wgrad_plan(m, n, batch, 132)
    assert (tensor_cores.SGEMM_TILES[index], split) == plan


def test_the_plans_for_the_first_version_are_zeros():
    dev = torch.device("meta")
    assert tensor_cores.wgrad(0, dev, 2048, 256, 8192, outputs=2) == (0, 0)
    assert tensor_cores.wgrad(0, dev, 2048, 1024, 8192) == (0, 0)

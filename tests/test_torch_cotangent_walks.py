"""The fused linear backward's new forms (``dw_fused``, ``dx_fused``),
modelled in Python.

The tensor-core forms (rawaudiovae_kelsey_tpu_torch/csrc/wgmma.cuh, a walk
with ``kFormed``) take A as the cotangent ``da = act'(y)·dy``, formed in
registers from the staged ``y`` and ``dy``: ``formed_product`` reads each
k16 fragment with one ``ldmatrix`` of each (``.trans`` for dW, whose A is
``daᵀ``), and hands it to ``wgmma`` in the register layout of A; dW is
stored transposed (``store_f32_t``) and db is the row sums of ``daᵀ``
(``finish_rows``).  The fp32 forms (csrc/sgemm.cuh ``Operand`` with
``kForm``) form ``da`` as the K-major slab is transposed, or in place of
``y`` in the N-major ring.  The walks are checked element for element, the
launches emulated at a small width against the plain versions and the JAX
kernels of benchmarks/deep_bwd_probe.py in interpret mode, and the choice
of form and plan held at the deep model's layers and past each edge.  The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3f).

Tolerances.  The emulations form the plain version's products of the same
rounded ``da`` (exact for bf16 operands), summed in another order over at
most 384 rows: ``1e-5 · max|want|`` for fp32 outputs; the bf16 ``dx`` may
flip one bf16 step where two fp32 sums straddle a rounding boundary,
``2^-6 · max|want|`` as in tests/test_torch_linear_bwd.py.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd, tensor_cores

REPO = Path(__file__).resolve().parents[1]
ACTS = ("relu", "tanh", "none")
TILE_M, TILE_K = 128, 64          # csrc/wgmma.cuh kTileM, kTileK
THREADS = 256                     # csrc/sgemm.cuh kThreads
SLICE_ROWS = 64                   # csrc/sgemm.cuh kSliceRows


def _probe():
    spec = importlib.util.spec_from_file_location(
        "deep_bwd_probe", REPO / "benchmarks" / "deep_bwd_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # main() is guarded
    return mod


@pytest.fixture(scope="module")
def probe():
    return _probe()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---- the register A: ldmatrix from the swizzled stage, wgmma's layout

def _swizzled(r, c):
    """The byte offset of bf16 element (r, c) of a box of 128-byte rows in
    TMA's 128-byte swizzle: eight rows to a 1024-byte atom, the 16-byte
    unit c // 8 XORed with r % 8."""
    return r * 128 + (((c // 8) ^ (r % 8)) << 4) + (c % 8) * 2


def _stage(rows):
    """A staged box of ``rows`` x 64 elements: byte offset → (row, col)."""
    return {_swizzled(r, c): (r, c) for r in range(rows) for c in range(64)}


def _ldmatrix_x4(mem, addrs, trans):
    """ldmatrix.sync.aligned.m8n8.x4 (.trans): lanes 8q .. 8q + 7 give the
    addresses of the eight 16-byte rows of matrix q; lane l receives, in
    register q, row l / 4 (of the transpose with .trans), columns 2 (l % 4)
    and the next."""
    regs = [[None] * 4 for _ in range(32)]
    for q in range(4):
        rows = [[mem[addrs[8 * q + i] + 2 * j] for j in range(8)]
                for i in range(8)]
        if trans:
            rows = [list(col) for col in zip(*rows)]
        for lane in range(32):
            row = rows[lane // 4]
            regs[lane][q] = (row[2 * (lane % 4)], row[2 * (lane % 4) + 1])
    return regs


def _address(warp, kk, lane, trans):
    """formed_product's address of lane ``lane`` of warp ``warp`` (of the
    warpgroup) for k16 step ``kk``, from the start of its 64-row tile."""
    q, i = lane // 8, lane % 8
    if trans:
        return (16 * kk + 8 * (q // 2) + i) * 128 \
            + (((2 * warp + q % 2) ^ i) << 4)
    return (16 * warp + 8 * (q % 2) + i) * 128 \
        + (((2 * kk + q // 2) ^ i) << 4)


def _a_layout(warp, lane, reg, half):
    """The PTX ISA's register layout of A for wgmma m64nNk16 (bf16): the
    element of the 64 x 16 fragment that half ``half`` of register ``reg``
    of lane ``lane`` of warp ``warp`` holds, as (row, column)."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * (reg % 2), 2 * t + half + 8 * (reg // 2)


def test_the_register_layout_holds_each_element_of_a_once():
    """Each element of a 64 x 16 A fragment comes from exactly one (thread,
    register, half) of the warpgroup."""
    seen = np.zeros((64, 16), dtype=np.int64)
    for warp in range(4):
        for lane in range(32):
            for reg in range(4):
                for half in range(2):
                    seen[_a_layout(warp, lane, reg, half)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("trans", [False, True], ids=["dx", "dw"])
def test_ldmatrix_gives_each_lane_its_fragment(trans):
    """For every warp and k16 step, the registers ldmatrix fills at
    formed_product's addresses hold the elements the register layout of A
    asks for: dx's A is the staged (64 rows x 64 k) box as it lies; dW's is
    daᵀ, read transposed from the (64 k-rows x 64 n) chunk.  Over the four
    steps every staged element enters the product once."""
    mem = _stage(64)
    seen = np.zeros((64, 64), dtype=np.int64)
    for warp in range(4):
        for kk in range(TILE_K // 16):
            addrs = [_address(warp, kk, lane, trans) for lane in range(32)]
            regs = _ldmatrix_x4(mem, addrs, trans)
            for lane in range(32):
                for reg in range(4):
                    for half in range(2):
                        row, col = _a_layout(warp, lane, reg, half)
                        got = regs[lane][reg][half]
                        # A[row, 16 kk + col]: the staged (row, k) for dx,
                        # the staged (k, n = row) for daᵀ
                        want = (16 * kk + col, row) if trans \
                            else (row, 16 * kk + col)
                        assert got == want
                        seen[got] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("trans", [False, True], ids=["dx", "dw"])
def test_each_quarter_warp_reads_eight_distinct_bank_groups(trans):
    """The eight addresses of each ldmatrix matrix fall in eight distinct
    16-byte units of the 128-byte bank line: no bank conflict."""
    for warp in range(4):
        for kk in range(4):
            for q in range(4):
                units = {(_address(warp, kk, 8 * q + i, trans) % 128) // 16
                         for i in range(8)}
                assert len(units) == 8


def _quad_sum(v):
    """finish_rows' reduction of a quad's four partial sums: lane l adds
    lane l ^ 1's, then lane l ^ 2's (fp32)."""
    v = [np.float32(x) for x in v]
    v = [v[i] + v[i ^ 1] for i in range(4)]
    return [v[i] + v[i ^ 2] for i in range(4)]


def test_the_row_sums_of_the_formed_fragments_are_db():
    """Each thread adds, over the k16 steps, the rounded daᵀ values of its
    two rows (formed_product's rs0, rs1); the quad's sums, added as
    finish_rows adds them, equal the row sums, the same on every lane of
    the quad (so the lane that stores them is immaterial)."""
    rng = np.random.default_rng(5)
    chunk = rng.standard_normal((64, 64)).astype(np.float32)  # (k, n)
    mem = _stage(64)
    rows = np.zeros(64, np.float32)
    for warp in range(4):
        sums = {lane: [np.float32(0), np.float32(0)] for lane in range(32)}
        for kk in range(4):
            addrs = [_address(warp, kk, lane, True) for lane in range(32)]
            regs = _ldmatrix_x4(mem, addrs, True)
            for lane in range(32):
                for reg in range(4):
                    for half in range(2):
                        k, n = regs[lane][reg][half]
                        sums[lane][reg % 2] += chunk[k, n]
        for quad in range(8):
            for which in range(2):
                total = _quad_sum([sums[4 * quad + t][which]
                                   for t in range(4)])
                assert len(set(total)) == 1
                rows[16 * warp + quad + 8 * which] = total[0]
    np.testing.assert_allclose(rows, chunk.sum(0), rtol=0,
                               atol=1e-5 * np.abs(chunk.sum(0)).max())


@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("rows,n_edge", [(64, None), (37, None), (64, 40)])
def test_the_transposed_store_writes_each_element_once(bn, rows, n_edge):
    """store_f32_t: the warpgroup's accumulators of dWᵀ rows m0 .. m0 +
    rows - 1, columns n0 .. below N, land once each at dW[n, m] (ld = the
    width of dWᵀ), and nothing else is written."""
    m0, n0, ld = 64, bn, 192
    N = n0 + (bn if n_edge is None else n_edge)
    want = np.arange(64 * bn, dtype=np.int64).reshape(64, bn)  # dWᵀ half
    out = np.full((N, ld), -1, dtype=np.int64)
    for t in range(128):
        r, col = 16 * (t // 32) + (t % 32) // 4, 2 * (t % 4)
        for j in range(bn // 8):
            n = n0 + col + 8 * j
            if n >= N:
                continue
            for dr, dn in ((0, 0), (0, 1), (8, 0), (8, 1)):
                if r + dr < rows:
                    assert out[n + dn, m0 + r + dr] == -1
                    out[n + dn, m0 + r + dr] = want[r + dr, n + dn - n0]
    cols = min(bn, N - n0)
    assert (out[n0:n0 + cols, m0:m0 + rows] == want[:rows, :cols].T).all()
    assert (out[:n0] == -1).all() and (out[:, :m0] == -1).all()
    assert (out[:, m0 + rows:] == -1).all()


# ---- the launches, emulated against the JAX kernels

def _operands(seed, batch, k, n, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((batch, k)),
              rng.standard_normal((batch, n)),
              rng.standard_normal((batch, n)) * 0.01,
              rng.standard_normal((k, n)) * 0.01)
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _jax(ts, dtype):
    return [jnp.asarray(t.float().numpy()).astype(dtype) for t in ts]


def _slices(k, split):
    total = -(-k // TILE_K)
    steps = -(-total // split)
    return [range(s * steps * TILE_K, min(k, (s + 1) * steps * TILE_K))
            for s in range(split)]


def _emulated_dw(x, y, dy, act, bn, split):
    """The tensor-core dw_fused as its walk computes it: dWᵀ = daᵀ · x in
    tiles of 128 rows of daᵀ (n) by ``bn`` columns (k), each slice of the
    batch one fp32 sum, slices added in order, each tile stored
    transposed; db the row sums of daᵀ from the first tile column."""
    batch, k = x.shape
    n = y.shape[1]
    da = linear_bwd.cotangent(act, y, dy).float()
    dwt = torch.zeros((n, k))
    db = torch.zeros(n)
    for rows in _slices(batch, split):
        rows = list(rows)
        part = torch.zeros((n, k))
        for m0 in range(0, n, TILE_M):
            for c0 in range(0, k, bn):
                part[m0:m0 + TILE_M, c0:c0 + bn] = \
                    da[rows, m0:m0 + TILE_M].t() @ x[rows, c0:c0 + bn].float()
        dwt += part
        db += da[rows].sum(0)
    return dwt.t(), db


def _emulated_dx(y, dy, w, act, bn):
    """The tensor-core dx_fused: dx = da · wᵀ in 128 x ``bn`` tiles, one
    fp32 sum over all of n a tile, rounded once."""
    batch, n = y.shape
    k = w.shape[0]
    da = linear_bwd.cotangent(act, y, dy).float()
    dx = torch.zeros((batch, k))
    for r0 in range(0, batch, TILE_M):
        for c0 in range(0, k, bn):
            dx[r0:r0 + TILE_M, c0:c0 + bn] = \
                da[r0:r0 + TILE_M] @ w[c0:c0 + bn].float().t()
    return dx.to(y.dtype)


# the JAX kernels' grids take whole blocks of 128: batch 384 (six k-steps of
# 64), k 192 (no multiple of a 256-wide tile), n 256

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bn,split", [(64, 1), (128, 2), (256, 3)])
def test_the_emulated_tensor_core_dw_matches_the_tpu_kernel(probe, act, bn,
                                                            split):
    x, y, dy, _ = _operands(11, 384, 192, 256, torch.bfloat16)
    dw, db = _emulated_dw(x, y, dy, act, bn, split)
    want_dw, want_db = probe.dw_fused(*_jax((x, y, dy), jnp.bfloat16),
                                      act=act, block_n=128, block_b=128)
    assert _rel(dw.numpy(), want_dw) <= 1e-5
    assert _rel(db.numpy(), np.asarray(want_db).reshape(-1)) <= 1e-5


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bn", [64, 128, 256])
def test_the_emulated_tensor_core_dx_matches_the_tpu_kernel(probe, act, bn):
    _, y, dy, w = _operands(12, 384, 192, 256, torch.bfloat16)
    dx = _emulated_dx(y, dy, w, act, bn)
    want = probe.dx_fused(*_jax((y, dy, w), jnp.bfloat16), act=act,
                          block_b=128, block_n=128)
    assert _rel(dx.float().numpy(), np.asarray(want, np.float32)) <= 2.0 ** -6


# ---- the fp32 forms: sgemm.cuh's formed operand

def _formed_slab(y, dy, act, r0, k0, R, bk, k_major):
    """The compute buffer of one slab of a formed operand as sgemm.cuh
    stages it: each thread's 16-byte copies of y and dy (Operand::place),
    read back by the same thread and formed into da; a K-major operand's
    stored k-major and swizzled (Operand::transpose), an N-major one's in
    place of y.  y, dy (rows, K) for K-major, (K, rows) for N-major.
    Returns the buffer and how often each float was written."""
    quads = bk // 4
    buf = np.full(R * bk, np.nan, dtype=np.float32)
    written = np.zeros(R * bk, dtype=np.int64)
    da = linear_bwd.cotangent(act, torch.from_numpy(y),
                              torch.from_numpy(dy)).numpy()
    for t in range(THREADS):
        for i in range(R * bk // 4 // THREADS):
            idx = t + i * THREADS
            if k_major:
                r, kq = idx // quads, (idx % quads) * 4
                for j in range(4):
                    k = kq + j
                    swz = ((k >> 2) & (quads - 1)) * (8 // quads)
                    at = k * R + (((r >> 2) ^ swz) << 2) + (r & 3)
                    buf[at] = da[r0 + r, k0 + k]
                    written[at] += 1
            else:
                kq, r = idx // (R // 4), (idx % (R // 4)) * 4
                at = kq * R + r
                buf[at:at + 4] = da[k0 + kq, r0 + r:r0 + r + 4]
                written[at:at + 4] += 1
    return buf, written


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("R,bk", [(128, 16), (64, 32)])
@pytest.mark.parametrize("k_major", [True, False], ids=["dx", "dw"])
def test_the_fp32_formed_slab_holds_da(act, R, bk, k_major):
    """Every float of a formed slab is written once, and the fragment a
    lane reads (Operand::frag: rows r .. r + 3 at k-row k, unswizzled for
    the N-major ring) is da at those rows and k, formed from y and dy with
    the plain version's arithmetic (fp32: no rounding)."""
    rng = np.random.default_rng(R + bk)
    shape = (R + 8, bk + 16) if k_major else (bk + 16, R + 8)
    y = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    buf, written = _formed_slab(y, dy, act, 8, 16, R, bk, k_major)
    assert (written == 1).all()
    da = linear_bwd.cotangent(act, torch.from_numpy(y),
                              torch.from_numpy(dy)).numpy()
    quads = bk // 4
    for k in range(bk):
        swz = ((k >> 2) & (quads - 1)) * (8 // quads)
        for r in range(0, R, 4):
            at = k * R + (((r >> 2) ^ swz) << 2 if k_major else r)
            want = da[8 + r:12 + r, 16 + k] if k_major \
                else da[16 + k, 8 + r:12 + r]
            assert np.array_equal(buf[at:at + 4], want)


def test_the_fp32_forms_keep_two_blocks_an_sm():
    """sgemm_fused_kernel's shared memory at 128 x 128 (16-deep slabs): dx
    (two K-major operands, A formed: 2 x 3 ring slabs and 2 compute buffers;
    B 3 + 2) is 104 KB with three stages, dW (A as it lies, 4 slabs; B
    formed in place, 2 x 4) 96 KB: two blocks an SM fit in 228 KB, each
    with its 1 KB reserve."""
    slab = 128 * 16 * 4
    dx = (2 * 3 + 2) * slab + (3 + 2) * slab
    dw = 4 * slab + 2 * 4 * slab
    assert (dx, dw) == (104 * 1024, 96 * 1024)
    assert 2 * (max(dx, dw) + 1024) <= 228 * 1024


# ---- which form a shape takes, and the plans

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,k,n,aligned,code", [
    (BF16, 4096, 4096, True, 1), (BF16, 1024, 512, True, 1),
    (BF16, 1088, 544, True, 1), (BF16, 72, 8, True, 1),
    (BF16, 70, 33, True, 0), (BF16, 1092, 544, True, 0),
    (BF16, 1088, 548, True, 0), (BF16, 1088, 544, False, 0),
    (F32, 4096, 4096, True, 2), (F32, 1092, 548, True, 2),
    (F32, 70, 33, True, 0), (F32, 1090, 544, True, 0),
    (F32, 1088, 546, True, 0), (F32, 1088, 544, False, 0)])
def test_which_form_a_shape_takes(dtype, k, n, aligned, code):
    """bf16 takes the tensor cores (code 1) with k and n multiples of 8 and
    aligned pointers, fp32 csrc/sgemm.cuh (code 2) with multiples of 4;
    every other shape the first version (0), for both ops alike."""
    assert linear_bwd.resolve_dw_fused("auto", dtype, 1000, k, n,
                                       aligned) == code
    assert tensor_cores.resolve_kernel("dx_fused", "auto", dtype, 1000, n, k,
                                       aligned) == code


@pytest.mark.parametrize("kernel,dtype,k", [
    ("tensor_cores", torch.float32, 64), ("tensor_cores", torch.bfloat16, 70),
    ("sgemm", torch.bfloat16, 64), ("sgemm", torch.float32, 70),
    ("wgmma", torch.bfloat16, 64)])
def test_naming_a_form_that_cannot_take_the_operands_raises(kernel, dtype, k):
    with pytest.raises(ValueError):
        linear_bwd.resolve_dw_fused(kernel, dtype, 100, k, 64)
    with pytest.raises(ValueError):
        tensor_cores.resolve_kernel("dx_fused", kernel, dtype, 100, 64, k)


def test_the_cpu_wrappers_check_the_kernel_name():
    x, y, dy, w = _operands(3, 8, 6, 4, torch.float32)
    with pytest.raises(ValueError, match="unknown kernel"):
        linear_bwd.dw_fused(x, y, dy, "relu", kernel="wgmma")
    with pytest.raises(ValueError, match="unknown kernel"):
        linear_bwd.dx_fused(y, dy, w, "relu", kernel="wgmma")
    dx, dw, db = linear_bwd.fused_bwd(x, y, dy, w, "relu",
                                      kernel="tensor_cores")
    assert _rel(dx, linear_bwd.dx_fused_ref(y, dy, w, "relu")) == 0.0


# the deep model's layers (k, n) at batch 4096 on 132 SMs: dW's walk (dWᵀ,
# n rows) and dx's tile width
@pytest.mark.parametrize("k,n,plan", [
    (4096, 4096, (256, 1)), (4096, 2048, (256, 1)), (2048, 1024, (256, 2)),
    (1024, 512, (64, 2)), (1088, 544, (128, 2)), (64, 64, (64, 2))])
def test_the_formed_weight_gradient_plan(k, n, plan):
    """A tie of wgrad_plan's cost goes to the wider tile, then to fewer
    slices: 4096 x 4096 is 512 tiles of 128 x 256 (one slice, four waves),
    2048 x 1024 64 tiles cut in two slices, 1024 x 512 64 x 64 tiles in
    two."""
    assert tensor_cores.cotangent_wgrad_plan(n, k, 4096, 132) == plan


@pytest.mark.parametrize("m,n,k,sms", [(512, 1024, 4096, 132),
                                       (72, 136, 1000, 132),
                                       (4096, 4096, 64, 132),
                                       (544, 1088, 4097, 114),
                                       (8, 8, 1, 132)])
def test_the_formed_plan_leaves_no_slice_empty(m, n, k, sms):
    """launch_dw_fused's own check: ceil(k-steps / ceil(k-steps / split))
    == split, and a width the kernel has."""
    width, split = tensor_cores.cotangent_wgrad_plan(m, n, k, sms)
    steps = -(-k // TILE_K)
    per = -(-steps // split)
    assert width in tensor_cores.TILE_WIDTHS and -(-steps // per) == split
    assert per >= min(steps, tensor_cores.WGRAD_MIN_STEPS)


@pytest.mark.parametrize("k,width", [(4096, 256), (2048, 256), (1024, 256),
                                     (512, 128), (136, 64)])
def test_the_formed_dx_tile_width(k, width):
    """dx (4096, k) takes tile_n's width: 128 x 256 tiles at the deep
    layers (the widest on a tie: da is formed once a tile)."""
    assert tensor_cores.cotangent_tile_n(32, k, 132) == width


def test_the_plans_of_the_other_forms():
    """The fp32 form takes sgemm.cuh's plans, the first version zeros."""
    dev = torch.device("cuda", 0)
    tensor_cores._sm_counts[0] = 132
    try:
        assert tensor_cores.cotangent_wgrad(2, dev, 4096, 4096, 4096) == \
            tensor_cores.sgemm_wgrad_plan(4096, 4096, 4096, 132)
        assert tensor_cores.cotangent_tile(2, dev, 4096, 4096, 4096) == \
            tensor_cores.SGEMM_TILES.index(
                tensor_cores.sgemm_tile(4096, 4096, 132))
        assert tensor_cores.cotangent_wgrad(0, dev, 64, 64, 64) == (0, 0)
        assert tensor_cores.cotangent_tile(0, dev, 64, 64, 64) == 0
        assert tensor_cores.cotangent_wgrad(1, dev, 1024, 512, 4096) == \
            (64, 2)
        assert tensor_cores.cotangent_tile(1, dev, 4096, 4096, 4096) == 256
    finally:
        tensor_cores._sm_counts.pop(0, None)

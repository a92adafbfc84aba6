"""Rows 5 and 6, the gated input gradients ``matmul_nt_mask`` (``where(gate
> 0, a @ wᵀ, 0)``) and ``matmul_nt2_mask`` (the same of ``a1 @ w1ᵀ + a2 @
w2ᵀ``), on their new forms: bf16 on the tensor cores (csrc/wgmma.cuh, the
launches of ``dec_bwd_fused`` 's dh3 and ``enc_bwd_dw1`` 's k-joined dh),
fp32 on csrc/sgemm.cuh's gated product (``launch_gated``: the gate read
where the output goes; the two pairs joined along k as the slabs are
copied).  Here, without a card: the dispatch (``tensor_cores.
resolve_kernel``), what reaches the C entry points, and the fp32 walk
modelled in numpy (the joined operand's chunk selection and the gated
epilogue) at a small width, against the plain versions and the JAX
kernels in interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3c).

Tolerances: fp32 atol 1e-5 (the emulation adds the products exactly in
fp64 and rounds once a k, as an FFMA does, in k order: ~1e-7 from the
plain version's fp32 dot of 48 terms of order 1); bf16 within one bf16
ulp of the plain version (both round one fp32 sum once).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
CUDA_CORES, TENSOR_CORES, SGEMM = 0, tensor_cores.TENSOR_CORES, \
    tensor_cores.SGEMM
SMS = 132                         # an H100's SMs
THREADS = 256                     # csrc/sgemm.cuh kThreads
ATOL = 1e-5
OPS = ("matmul_nt_mask", "matmul_nt2_mask")
# the dense model's dh3 (n = seg, m = units) and dh (n = latent, a pair's)
DENSE = {"matmul_nt_mask": (1024, 2048), "matmul_nt2_mask": (256, 2048)}


# ---- the dispatch

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("batch", [8192, 1000, 1])
def test_dense_widths_take_the_new_forms(op, batch):
    n, m = DENSE[op]
    assert tensor_cores.resolve_kernel(op, "auto", F32, batch, n, m) == SGEMM
    assert tensor_cores.resolve_kernel(op, "auto", BF16, batch, n, m) \
        == TENSOR_CORES
    assert tensor_cores.resolve_kernel(op, "sgemm", F32, batch, n, m) \
        == SGEMM
    assert tensor_cores.resolve_kernel(op, "cuda_cores", F32, batch, n,
                                       m) == CUDA_CORES


# (dtype, n, m, aligned) → the code "auto" takes: bf16 needs n and m
# multiples of 8, fp32 multiples of 4, both every pointer on a 16-byte
# boundary; everything else keeps the first version
TABLE = [(BF16, 264, 520, True, TENSOR_CORES), (F32, 264, 520, True, SGEMM),
         (BF16, 36, 520, True, CUDA_CORES), (F32, 38, 520, True, CUDA_CORES),
         (BF16, 1020, 2048, True, CUDA_CORES), (F32, 1020, 2048, True, SGEMM),
         (BF16, 1024, 2044, True, CUDA_CORES),
         (F32, 1024, 2046, True, CUDA_CORES),
         (BF16, 1024, 2048, False, CUDA_CORES),
         (F32, 1024, 2048, False, CUDA_CORES)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype,n,m,aligned,code", TABLE, ids=str)
def test_the_dispatch_table(op, dtype, n, m, aligned, code):
    assert tensor_cores.resolve_kernel(op, "auto", dtype, 1000, n, m,
                                       aligned) == code
    for name, fast in (("tensor_cores", TENSOR_CORES), ("sgemm", SGEMM)):
        if code == fast:
            assert tensor_cores.resolve_kernel(op, name, dtype, 1000, n, m,
                                               aligned) == fast
        else:
            with pytest.raises(ValueError, match=f"{op}: kernel '{name}' "
                               "takes"):
                tensor_cores.resolve_kernel(op, name, dtype, 1000, n, m,
                                            aligned)


def test_both_ops_have_the_fp32_form():
    assert set(OPS) <= tensor_cores.SGEMM_OPS


@pytest.mark.parametrize("op", OPS)
def test_an_unknown_kernel_name_raises_before_anything_runs(op):
    args = [torch.zeros((4, 4))] * (3 if op == "matmul_nt_mask" else 5)
    with pytest.raises(ValueError, match="unknown kernel 'tensor'"):
        getattr(mlp, op)(*args, kernel="tensor")


# ---- what reaches the C entry points

def _stand_in(monkeypatch, aligned=True):
    launched, seen = [], []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)

    def pointers_aligned(*tensors):
        seen.append(tensors)
        return aligned

    monkeypatch.setattr(tensor_cores, "pointers_aligned", pointers_aligned)
    monkeypatch.setattr(mlp._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched, seen


def _meta(op, batch, n, m, dtype):
    shapes = [(batch, n), (m, n)] * (1 if op == "matmul_nt_mask" else 2)
    return [torch.empty(s, device="meta", dtype=dtype)
            for s in shapes + [(batch, m)]]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype,code", [(F32, SGEMM), (BF16, TENSOR_CORES)],
                         ids=["fp32", "bf16"])
def test_the_entry_points_get_dtype_then_tile_then_kernel(monkeypatch, op,
                                                          dtype, code):
    """``…, batch, n, m, dtype, tile_n, kernel``: the tile index of
    ``sgemm_tile`` (128 x 128 at the microbatch) for the fp32 form, the
    width of ``tile_n`` for the tensor cores, 0 for the first version; the
    alignment rule sees every operand, the gate included; the counters
    follow the kernel that ran."""
    launched, seen = _stand_in(monkeypatch)
    n, m = DENSE[op]
    fn = getattr(mlp, op)
    operands = _meta(op, 8192, n, m, dtype)
    before = (fn.launches, fn.tensor_core_launches, fn.sgemm_launches)
    out = fn(*operands)
    assert out.shape == (8192, m) and out.dtype == dtype
    name, args = launched.pop()
    assert name == f"rvk_{op}"
    assert args[:len(operands)] == tuple(operands)
    assert args[len(operands)] is not None
    assert args[len(operands) + 1:] == (
        8192, n, m, mlp.DTYPE_CODES[dtype],
        tensor_cores.tile(code, torch.device("meta"), 8192, m), code)
    want_tile = (tensor_cores.SGEMM_TILES.index((128, 128)) if code == SGEMM
                 else tensor_cores.tile_n(64, m, SMS))
    assert args[-2] == want_tile
    assert seen.pop() == tuple(operands)
    assert (fn.launches - before[0], fn.tensor_core_launches - before[1],
            fn.sgemm_launches - before[2]) == (
        1, int(code == TENSOR_CORES), int(code == SGEMM))
    fn(*operands, kernel="cuda_cores")
    assert launched.pop()[1][-2:] == (0, CUDA_CORES)
    assert (fn.launches - before[0], fn.tensor_core_launches - before[1],
            fn.sgemm_launches - before[2]) == (
        2, int(code == TENSOR_CORES), int(code == SGEMM))
    # a zero-row batch launches nothing
    fn(*_meta(op, 0, n, m, dtype))
    assert not launched and fn.launches - before[0] == 2


@pytest.mark.parametrize("op", OPS)
def test_an_unaligned_operand_keeps_the_first_version(monkeypatch, op):
    launched, _ = _stand_in(monkeypatch, aligned=False)
    fn = getattr(mlp, op)
    n, m = DENSE[op]
    fn(*_meta(op, 1000, n, m, F32))
    assert launched.pop()[1][-2:] == (0, CUDA_CORES)
    with pytest.raises(ValueError, match="aligned = False"):
        fn(*_meta(op, 1000, n, m, F32), kernel="sgemm")


def _exported(name):
    text = (_build.CSRC / "bwd.cu").read_text()
    params = re.search(rf"^int {name}\(([^)]*)\)\s*\{{", text, re.M).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("op,pointers", [("matmul_nt_mask", 4),
                                         ("matmul_nt2_mask", 6)])
def test_the_signatures_match_the_extern_c_declarations(op, pointers):
    p, i = _build._P, _build._I
    # the operands, the gate and out | batch, n, m, dtype, tile_n, kernel |
    # stream
    assert _build._SIGNATURES[f"rvk_{op}"] == [p] * pointers + [i] * 6 + [p]
    params = _exported(f"rvk_{op}")
    assert params[pointers:] == ["int batch", "int n", "int m", "int dtype",
                                 "int tile_n", "int kernel", "void* stream"]
    assert params[pointers - 2:pointers] == ["const void* gate", "void* out"]


def test_the_new_forms_are_the_launches_named():
    """Code 1 is the dh3 and dh launches of the fused kernels (the gated
    epilogue; dh joined along k), code 2 sgemm.cuh's gated product."""
    text = (_build.CSRC / "bwd.cu").read_text()
    one = text.split("int rvk_matmul_nt_mask(")[1].split(
        "int rvk_matmul_nt2_mask(")[0]
    two = text.split("int rvk_matmul_nt2_mask(")[1].split(
        "int rvk_grad_accum(")[0]
    assert "rvk::sgemm::launch_gated<false>(" in one
    assert "rvk::tc::launch_wgmma<false>(" in one and "GatePair{}" in one
    assert "rvk::sgemm::launch_gated<true>(" in two
    assert "rvk::tc::launch_joined(" in two and "GatePair{}" in two
    sgemm = (_build.CSRC / "sgemm.cuh").read_text()
    assert "__launch_bounds__(kThreads, 2)\nsgemm_gated_kernel(" in sgemm


# ---- the fp32 walk, modelled

def _depth(bm, bn):
    """csrc/sgemm.cuh kSlabDepth: 16 deep at 128 x 128, 32 below."""
    return 16 if bm * bn >= 128 * 128 else 32


def _staged(pairs, rows, r0, bk, bm):
    """A joined K-major operand as Operand<bm, true, bk, 4, false,
    true>::issue copies it, slab by slab: thread t's i-th 16-byte copy of
    a slab is row idx / (bk / 4), k-quad idx % (bk / 4) (idx = t + 256 ·
    i); k below ld (a pair's k) from the first matrix, the rest from the
    second at k - ld; rows past ``rows`` and k past 2 · ld zero fills.
    Returns the rows r0 .. r0 + bm of the whole contraction, slabs side by
    side, and how often each element was copied."""
    ld = pairs[0].shape[1]
    k_total = len(pairs) * ld
    slabs = -(-k_total // bk)
    quads = bk // 4
    copies = bm * bk // 4 // THREADS
    out = np.full((bm, slabs * bk), np.nan, np.float32)
    count = np.zeros((bm, slabs * bk), np.int64)
    for slab in range(slabs):
        for t in range(THREADS):
            for i in range(copies):
                idx = t + i * THREADS
                r, kq = idx // quads, (idx % quads) * 4
                row, k = r0 + r, slab * bk + kq
                valid = row < rows and k < k_total
                second = k >= ld
                src = pairs[int(second)]
                kk = k - ld if second else k
                out[r, k:k + 4] = src[row, kk:kk + 4] if valid else 0.0
                count[r, k:k + 4] += 1
    return out, count


@pytest.mark.parametrize("tile", [(128, 128), (64, 64)], ids=str)
@pytest.mark.parametrize("n", [24, 32, 4])
def test_the_join_reads_each_k_once_from_its_pair(tile, n):
    """Every k of [a1 a2] is copied once, from the right pair, in order;
    k past 2n and rows past the batch are zeros."""
    rng = np.random.default_rng(n)
    batch = 100
    a1, a2 = (rng.standard_normal((batch, n)).astype(np.float32)
              for _ in range(2))
    bm, bn = tile
    bk = _depth(bm, bn)
    joined = np.concatenate([a1, a2], axis=1)
    for r0 in range(0, batch, bm):
        got, count = _staged([a1, a2], batch, r0, bk, bm)
        assert (count == 1).all()
        want = np.zeros_like(got)
        rows = joined[r0:r0 + bm]
        want[:rows.shape[0], :2 * n] = rows
        np.testing.assert_array_equal(got, want)


def _gated_walk(pairs_a, pairs_b, gate, tile):
    """sgemm_gated_kernel, tile by tile: each block's 256 threads, their
    4 x 4 sub-tiles (a lane's rows am + 32 i + u, columns bn + 16 j .. + 3),
    one accumulator an output adding a[m, k] · b[n, k] over the joined k
    in order (exact in fp64, rounded once: an FFMA), then the epilogue: the
    gate's 16-byte chunk where the output's goes, the sum kept where the
    gate is above zero; rows past M and chunks past N skipped.  Returns C
    and how often each element was stored."""
    a = np.concatenate(pairs_a, axis=1)
    b = np.concatenate(pairs_b, axis=1)
    M, K = a.shape
    N = b.shape[0]
    bm, bn = tile
    rm, rn = bm // 64, bn // 64
    wm, wn = bm // 2, bn // 4
    c = np.full((M, N), np.nan, np.float32)
    count = np.zeros((M, N), np.int64)
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            rows = slice(m0, min(M, m0 + bm))
            cols = slice(n0, min(N, n0 + bn))
            acc = np.zeros((rows.stop - rows.start, cols.stop - cols.start),
                           np.float32)
            for k in range(K):
                acc = (acc.astype(np.float64)
                       + a[rows, k].astype(np.float64)[:, None]
                       * b[cols, k].astype(np.float64)[None, :]
                       ).astype(np.float32)
            for t in range(THREADS):
                warp, lane = t // 32, t % 32
                am = (warp // 4) * wm + (lane % 8) * 4
                bnn = (warp % 4) * wn + (lane // 8) * 4
                for j in range(rn):
                    n = n0 + bnn + 16 * j
                    if n >= N:
                        continue
                    for i in range(rm):
                        for u in range(4):
                            m = m0 + am + 32 * i + u
                            if m >= M:
                                continue
                            g = gate[m, n:n + 4]
                            v = acc[m - m0, n - n0:n - n0 + 4]
                            c[m, n:n + 4] = np.where(g > 0, v, 0.0)
                            count[m, n:n + 4] += 1
    return c, count


def _operands(op, batch, n, m, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(1 if op == "matmul_nt_mask" else 2):
        out += [rng.standard_normal((batch, n)),
                rng.standard_normal((m, n)) / n ** 0.5]
    gate = rng.standard_normal((batch, m))
    gate[:, ::7] = 0.0                   # zeros are gated off, as negatives
    return [np.asarray(t, np.float32) for t in out + [gate]]


def _walk(op, arrays, tile):
    if op == "matmul_nt_mask":
        a, w, gate = arrays
        return _gated_walk([a], [w], gate, tile)
    a1, w1, a2, w2, gate = arrays
    return _gated_walk([a1, a2], [w1, w2], gate, tile)


@pytest.mark.parametrize("tile", [(128, 128), (128, 64), (64, 64)], ids=str)
@pytest.mark.parametrize("op", OPS)
def test_the_emulated_fp32_walk_matches_plain_and_jax(op, tile):
    """Batch 100, n 24, m 40 (one tile row and column at 128, two tile
    rows at 64, the last ragged): every output stored once, against the
    plain version and the JAX kernel in interpret mode."""
    arrays = _operands(op, 100, 24, 40, seed=len(op) + tile[1])
    got, count = _walk(op, arrays, tile)
    assert (count == 1).all()
    plain = getattr(mlp, f"{op}_ref")(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)
    jax_out = getattr(jmlp, op)(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=ATOL, rtol=0)
    gate = arrays[-1]
    assert not got[gate <= 0].any()


def _ulp_bf16(v):
    """One bf16 ulp at each |v| (8 significant bits), the smallest normal's
    below it."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("op", OPS)
def test_one_bf16_rounding_of_the_fp32_sum(op):
    """bf16 operands: the fp32 sum of the same walk, rounded once to bf16,
    is within one bf16 ulp of the plain version and of the JAX kernel."""
    arrays = [torch.from_numpy(t).to(BF16).to(F32).numpy()
              for t in _operands(op, 100, 24, 40, seed=3)]
    got, _ = _walk(op, arrays, (128, 128))
    got = torch.from_numpy(got).to(BF16).to(F32).numpy()
    ts = [torch.from_numpy(t).to(BF16) for t in arrays]
    plain = getattr(mlp, f"{op}_ref")(*ts).to(F32).numpy()
    assert (np.abs(got - plain) <= _ulp_bf16(plain)).all()
    jax_out = np.asarray(getattr(jmlp, op)(
        *[jnp.asarray(t).astype(jnp.bfloat16) for t in arrays]
    ).astype(jnp.float32))
    assert (np.abs(got - jax_out) <= _ulp_bf16(jax_out)).all()

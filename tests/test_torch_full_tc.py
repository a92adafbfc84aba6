"""Rows 11 and 12, the ``high`` tier's full backward chains ``enc_bwd_full``
and ``dec_bwd_full``, on their tensor-core forms: fp32 operands split once
by the split pass (csrc/split.cuh) into bf16 halves and every product
taken as three bf16 passes in three fp32 accumulators added ``(hh + hl) +
lh`` (csrc/full.cu on csrc/wgmma.cuh's 3-pass mode); bf16 operands the
split backward's tensor-core launches.  Here, without a card: the dispatch
(``mlp.resolve_full``), the plans (``tensor_cores.full_plan``), what
reaches the C entry points and the scratch they get, and the 3-pass walk
modelled in numpy (the split, three accumulators over k-steps of 64, the
joined k of dh, the batch cut into slices added in order, the fp32 gate
after the three sums are added, the split pass's column sums in their
order) at small widths, against the plain versions and the JAX kernels in
interpret mode under ``jax.default_matmul_precision("high")``.  The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3d).

Tolerances: the model against the plain versions and the JAX kernels
``atol = rtol = 1e-5`` (the same split and the same bf16 x bf16 products,
exact in fp32, added in another order: ~1e-7 of values of order 1); on
operands built so that every sum has one non-zero term
(chip_smoke.py ``exact_split_case``) the model equals the plain version
bit for bit outside the two dense bias gradients; the split bit for bit.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
CUDA_CORES, TENSOR_CORES = 0, tensor_cores.TENSOR_CORES
SMS = 132                          # an H100's SMs
SEG, UNITS, LATENT = 64, 128, 32   # small widths, every one a multiple of 8
ATOL = RTOL = 1e-5
OPS = ("enc_bwd_full", "dec_bwd_full")
ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py`` of the repository root, as a module (its
    ``exact_split_case``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- the dispatch

# (dtype, batch, seg, units, latent, aligned) → the code "auto" takes: the
# tensor cores in both dtypes with every width a multiple of 8, a row and
# aligned pointers; the first version otherwise
TABLE = [(F32, 4096, 1024, 2048, 256, True, TENSOR_CORES),
         (BF16, 4096, 1024, 2048, 256, True, TENSOR_CORES),
         (F32, 4097, 1024, 2048, 256, True, TENSOR_CORES),
         (F32, 1, 64, 128, 32, True, TENSOR_CORES),
         (BF16, 33, 64, 128, 32, True, TENSOR_CORES),
         (F32, 37, 70, 130, 18, True, CUDA_CORES),
         (BF16, 37, 70, 130, 18, True, CUDA_CORES),
         (F32, 4096, 1024, 2048, 36, True, CUDA_CORES),
         (BF16, 4096, 1020, 2048, 256, True, CUDA_CORES),
         (F32, 4096, 1024, 2044, 256, True, CUDA_CORES),
         (F32, 4096, 1024, 2048, 256, False, CUDA_CORES),
         (BF16, 4096, 1024, 2048, 256, False, CUDA_CORES),
         (F32, 0, 1024, 2048, 256, True, CUDA_CORES)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype,batch,seg,units,latent,aligned,code", TABLE)
def test_the_dispatch_table(op, dtype, batch, seg, units, latent, aligned,
                            code):
    assert mlp.resolve_full(op, "auto", dtype, batch, seg, units, latent,
                            aligned) == code
    assert mlp.resolve_full(op, "cuda_cores", dtype, batch, seg, units,
                            latent, aligned) == CUDA_CORES
    if code == TENSOR_CORES:
        assert mlp.resolve_full(op, "tensor_cores", dtype, batch, seg,
                                units, latent, aligned) == TENSOR_CORES
    else:
        # naming the new form for a shape it cannot take raises
        with pytest.raises(ValueError, match="takes fp32 or bf16"):
            mlp.resolve_full(op, "tensor_cores", dtype, batch, seg, units,
                             latent, aligned)


@pytest.mark.parametrize("op", OPS)
def test_names_the_chains_have_not_raise(op):
    # three passes (the default for fp32) have no sgemm.cuh form
    with pytest.raises(ValueError, match="kernel 'sgemm' takes fp32 "
                       "operands in one pass"):
        mlp.resolve_full(op, "sgemm", F32, 4096, 1024, 2048, 256)
    with pytest.raises(ValueError, match="unknown kernel"):
        mlp.resolve_full(op, "wgmma", F32, 4096, 1024, 2048, 256)
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="unknown kernel"):
        getattr(mlp, op)(*([x] * (6 if op == "enc_bwd_full" else 5)),
                         kernel="wgmma")


# ---- the plans

@pytest.mark.parametrize("batch", [4096, 8192, 4097, 1])
def test_the_plans_take_the_3_pass_widths_in_fp32(monkeypatch, batch):
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    dev = torch.device("meta")
    enc = tensor_cores.full_plan(TENSOR_CORES, F32, dev, "enc", batch, 1024,
                                 2048, 256)
    dec = tensor_cores.full_plan(TENSOR_CORES, F32, dev, "dec", batch, 1024,
                                 2048, 256)
    assert len(enc) == 5 and len(dec) == 6
    for tile in (enc[0], enc[1], enc[3], dec[0], dec[1], dec[2], dec[4]):
        assert tile in tensor_cores.SPLIT_WIDTHS
    steps = -(-batch // 64)
    for split in (enc[2], enc[4], dec[3], dec[5]):
        assert 1 <= split <= steps
    # the rule's own: tile_n / wgrad_plan over the 3-pass widths
    tiles_m = -(-batch // 128)
    assert enc[0] == tensor_cores.tile_n(tiles_m, 2048, SMS,
                                         tensor_cores.SPLIT_WIDTHS)
    assert enc[3:] == tensor_cores.wgrad_plan(2048, 256, batch, SMS, 2,
                                              tensor_cores.SPLIT_WIDTHS)
    assert dec[4:] == tensor_cores.wgrad_plan(2048, 1024, batch, SMS, 1,
                                              tensor_cores.SPLIT_WIDTHS)
    # the first version takes none
    assert tensor_cores.full_plan(CUDA_CORES, F32, dev, "enc", batch, 1024,
                                  2048, 256) == (0,) * 5
    assert tensor_cores.full_plan(CUDA_CORES, F32, dev, "dec", batch, 1024,
                                  2048, 256) == (0,) * 6


@pytest.mark.parametrize("batch", [8192, 4096, 1000])
def test_the_bf16_plans_are_the_split_backwards(monkeypatch, batch):
    """bf16 chains run the split backward's launches, with the tiles and
    slices those launches take on their own."""
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    dev = torch.device("meta")
    seg, units, latent = 1024, 2048, 256
    enc = tensor_cores.full_plan(TENSOR_CORES, BF16, dev, "enc", batch, seg,
                                 units, latent)
    dec = tensor_cores.full_plan(TENSOR_CORES, BF16, dev, "dec", batch, seg,
                                 units, latent)
    tile = tensor_cores.tile
    wgrad = tensor_cores.wgrad
    assert enc == (tile(TENSOR_CORES, dev, batch, units),
                   *wgrad(TENSOR_CORES, dev, seg, units, batch),
                   *wgrad(TENSOR_CORES, dev, units, latent, batch, 2))
    assert dec == (tile(TENSOR_CORES, dev, batch, units),
                   tile(TENSOR_CORES, dev, batch, latent),
                   *wgrad(TENSOR_CORES, dev, latent, units, batch),
                   *wgrad(TENSOR_CORES, dev, units, seg, batch))


# ---- what reaches the C entry points

def _stand_in(monkeypatch, aligned=True):
    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned",
                        lambda *t: aligned)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    monkeypatch.setattr(
        mlp._build, "launch",
        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _meta(op, batch, seg, units, latent, dtype):
    def t(*shape):
        return torch.empty(shape, device="meta", dtype=dtype)
    if op == "enc_bwd_full":
        return (t(batch, seg), t(batch, units), t(batch, latent),
                t(batch, latent), t(units, latent), t(units, latent))
    return (t(batch, seg), t(batch, units), t(batch, latent),
            t(units, seg), t(latent, units))


def _halves(op, b, seg, units, latent):
    """The elements of the fp32 matrices the tensor-core chain splits, in
    csrc/full.cu's order."""
    if op == "enc_bwd_full":   # x, h, dmu, dlv, w21, w22, dh
        return (b * seg + b * units + 2 * b * latent + 2 * units * latent
                + b * units)
    # da, h3, z, w4, w3, dh3
    return (b * seg + b * units + b * latent + units * seg + latent * units
            + b * units)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [4096, 8192, 4097, 1])
def test_the_entry_points_get_scratch_plan_and_kernel(monkeypatch, op, dtype,
                                                      batch):
    launched = _stand_in(monkeypatch)
    seg, units, latent = 1024, 2048, 256
    wrapper = getattr(mlp, op)
    before = (wrapper.launches, wrapper.tensor_core_launches)
    out = wrapper(*_meta(op, batch, seg, units, latent, dtype))
    assert (wrapper.launches, wrapper.tensor_core_launches) == \
        (before[0] + 1, before[1] + 1)
    [(name, args)] = launched
    assert name == "rvk_" + op
    # every argument but the stream, which _build.launch adds
    assert len(args) == len(_build._SIGNATURES[name]) - 1
    enc = op == "enc_bwd_full"
    chain = "enc" if enc else "dec"
    n_plan = 5 if enc else 6
    plan = tuple(args[-1 - n_plan:-1])
    assert args[-1] == TENSOR_CORES
    assert plan == tensor_cores.full_plan(TENSOR_CORES, dtype, None, chain,
                                          batch, seg, units, latent)
    # the pass count after the dtype: the default, full_passes
    assert args[-2 - n_plan - 5:-1 - n_plan] == (
        batch, seg, units, latent, mlp.DTYPE_CODES[dtype],
        mlp.full_passes(dtype))
    splits, workspace = args[-2 - n_plan - 7:-2 - n_plan - 5]
    if dtype == F32:
        assert splits.dtype == BF16
        assert splits.numel() == 2 * _halves(op, batch, seg, units, latent)
    else:
        assert splits is None
    # room for every weight gradient's slices and every column sum's
    # partials (fp32 only) of the chain
    slices = ([(plan[2], seg, units, 1), (plan[4], units, latent, 2)] if enc
              else [(plan[3], latent, units, 1), (plan[5], units, seg, 1)])
    need = [o * s * (m * n + n) for s, m, n, o in slices if s > 1]
    blocks = -(-batch // mlp.SPLIT_ROWS)
    if dtype == F32 and blocks > 1:
        need.append(blocks * (units if enc else max(units, seg)))
    if need:
        assert workspace.dtype == F32 and workspace.numel() == max(need)
    else:
        assert workspace is None
    assert len(out) == (6 if enc else 5)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_odd_widths_and_unaligned_views_keep_the_first_version(monkeypatch,
                                                               op, dtype):
    for widths, aligned in (((70, 130, 18), True), ((1024, 2048, 256),
                                                    False)):
        launched = _stand_in(monkeypatch, aligned)
        wrapper = getattr(mlp, op)
        before = wrapper.tensor_core_launches
        wrapper(*_meta(op, 37, *widths, dtype))
        [(name, args)] = launched
        assert args[-1] == CUDA_CORES
        assert set(args[-6 if op == "enc_bwd_full" else -7:-1]) == {0}
        assert wrapper.tensor_core_launches == before
        with pytest.raises(ValueError, match="takes fp32 or bf16"):
            wrapper(*_meta(op, 37, *widths, dtype), kernel="tensor_cores")


def _exported(name):
    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(rf"^int {name}\(([^)]*)\)\s*\{{", text, re.M)
    return [a.strip() for a in m.group(1).split(",")]


def test_the_signatures_name_scratch_plans_and_kernel():
    enc, dec = _exported("rvk_enc_bwd_full"), _exported("rvk_dec_bwd_full")
    assert enc[13:15] == ["void* splits", "float* workspace"]
    assert dec[11:13] == ["void* splits", "float* workspace"]
    assert enc[-7:] == ["int tile_dh", "int tile_dw1", "int split_dw1",
                        "int tile_dw2", "int split_dw2", "int kernel",
                        "void* stream"]
    assert dec[-8:] == ["int tile_dh3", "int tile_dz", "int tile_dw3",
                        "int split_dw3", "int tile_dw4", "int split_dw4",
                        "int kernel", "void* stream"]
    assert _exported("rvk_split_hi_lo")[-4:] == [
        "int rows", "int cols", "int sums", "void* stream"]
    # the split pass's rows a block, as the wrapper sizes its partials
    text = (_build.CSRC / "split.cuh").read_text()
    assert re.search(r"kSplitRows = (\d+);", text).group(1) == \
        str(mlp.SPLIT_ROWS)
    # the chains are built from the shared mainloop and the split pass
    full = (_build.CSRC / "full.cu").read_text()
    assert '#include "wgmma.cuh"' in full and '#include "split.cuh"' in full


# ---- the split pass

def _bits_values(seed, shape):
    """fp32 values made from their bits (chip_smoke.py
    ``split_probe_values``): a quarter of them on the split's rounding tie
    or beside it."""
    return _smoke().split_probe_values(torch.Generator().manual_seed(seed),
                                       shape, torch.device("cpu"))


def test_the_split_pass_plain_version_is_the_jax_split_bit_for_bit():
    v = _bits_values(0, (100, 64))
    hi, lo, colsum = mlp.split_pass(v, sums=True)
    assert hi.dtype == lo.dtype == BF16 and colsum.dtype == F32
    jhi, jlo = jmlp._split_hi_lo(jnp.asarray(v.numpy()))
    # the probe values are normal numbers of exponent -3 .. 3: no flush
    for got, want in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(
            got.float().numpy().view(np.uint32),
            np.asarray(want.astype(jnp.float32)).view(np.uint32))
    # the column sums are those of the unsplit values, not of hi + lo
    assert torch.equal(colsum, v.sum(0))
    assert not torch.equal(colsum, (hi.float() + lo.float()).sum(0))
    assert mlp.split_pass(v)[2] is None


def _bf16_rne(x):
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def split_np(v):
    """The split pass's arithmetic in numpy: hi the top 16 bits of (u +
    0x8000), lo = bf16_rn(v - hi); both as fp32 values."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    hi = ((u + 0x8000) & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return hi, _bf16_rne(v.astype(np.float32) - hi)


def colsum_np(v, rows=64, lanes=4):
    """The split pass's column sums in its order: each block of ``rows``
    rows as ``lanes`` row lanes (rows r, r + lanes, ... in order), the
    lanes added in order, then the blocks in order; all fp32."""
    v = v.astype(np.float32)
    total = None
    for b0 in range(0, v.shape[0], rows):
        block = v[b0:b0 + rows]
        part = None
        for ty in range(lanes):
            lane = np.zeros(v.shape[1], np.float32)
            for r in range(ty, block.shape[0], lanes):
                lane = lane + block[r]
            part = lane if part is None else part + lane
        total = part if total is None else total + part
    return total


def test_the_split_model_is_the_plain_split():
    v = _bits_values(1, (70, 40)).numpy()
    hi, lo = split_np(v)
    want_hi, want_lo, want_sum = mlp.split_pass_ref(torch.from_numpy(v))
    np.testing.assert_array_equal(hi.view(np.uint32),
                                  want_hi.float().numpy().view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32),
                                  want_lo.float().numpy().view(np.uint32))
    np.testing.assert_allclose(colsum_np(v), want_sum.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---- the 3-pass walk, modelled

def rows_np(pairs, gate=None, k_step=64):
    """A 3-pass product's rows (csrc/wgmma.cuh SplitRows): C = sum over the
    pairs (a (M, K), b (N, K)) of a · bᵀ, the pairs joined along k (the
    first's k-steps, then the second's), each k-step of 64 adding A_hi·B_hi,
    A_hi·B_lo and A_lo·B_hi into three fp32 accumulators; then (hh + hl) +
    lh, then the fp32 gate."""
    m, n = pairs[0][0].shape[0], pairs[0][1].shape[0]
    hh, hl, lh = (np.zeros((m, n), np.float32) for _ in range(3))
    for a, b in pairs:
        (ah, al), (bh, bl) = split_np(a), split_np(b)
        for k0 in range(0, a.shape[1], k_step):
            ks = slice(k0, k0 + k_step)
            hh = hh + ah[:, ks] @ bh[:, ks].T
            hl = hl + ah[:, ks] @ bl[:, ks].T
            lh = lh + al[:, ks] @ bh[:, ks].T
    out = (hh + hl) + lh
    return out if gate is None else np.where(gate > 0, out, np.float32(0))


def wgrad_np(a, b, slices, k_step=64):
    """A 3-pass weight gradient aᵀ · b (csrc/wgmma.cuh SplitWgradOut over
    WgradTiles): the batch cut into ``slices`` runs of ceil(ceil(K / 64) /
    slices) k-steps, each run's three accumulators added (hh + hl) + lh,
    the runs added in order (slices.cuh sum_slices)."""
    (ah, al), (bh, bl) = split_np(a), split_np(b)
    steps = -(-a.shape[0] // k_step)
    per = -(-steps // slices)
    total = None
    for s in range(slices):
        shape = (a.shape[1], b.shape[1])
        hh, hl, lh = (np.zeros(shape, np.float32) for _ in range(3))
        for k0 in range(s * per * k_step, min((s + 1) * per * k_step,
                                              a.shape[0]), k_step):
            ks = slice(k0, k0 + k_step)
            hh = hh + ah[ks].T @ bh[ks]
            hl = hl + ah[ks].T @ bl[ks]
            lh = lh + al[ks].T @ bh[ks]
        part = (hh + hl) + lh
        total = part if total is None else total + part
    return total


def enc_model(x, h, dmu, dlv, w21, w22, slices=(1, 1)):
    """csrc/full.cu enc_bwd_split, modelled: dh joined and gated, dW1 and
    the heads' weight gradients, the bias gradients from the split pass's
    column sums of the unsplit dh, dmu, dlv."""
    dh = rows_np([(dmu, w21), (dlv, w22)], h)
    return (wgrad_np(x, dh, slices[0]), colsum_np(dh),
            wgrad_np(h, dmu, slices[1]), colsum_np(dmu),
            wgrad_np(h, dlv, slices[1]), colsum_np(dlv))


def dec_model(da, h3, z, w4, w3, slices=(1, 1)):
    """csrc/full.cu dec_bwd_split, modelled: dh3 gated, dz, dW3 and dW4,
    db3 and db4 from the split pass's column sums of dh3 and da."""
    dh3 = rows_np([(da, w4)], h3)
    return (rows_np([(dh3, w3)]), wgrad_np(z, dh3, slices[0]),
            colsum_np(dh3), wgrad_np(h3, da, slices[1]), colsum_np(da))


MODELS = {"enc_bwd_full": enc_model, "dec_bwd_full": dec_model}


def _operands(op, batch, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, relu=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.maximum(a, 0) if relu else a
    # audio-like x, activations of order 1, cotangents and weights smaller:
    # every output of order 1 or below, where atol 1e-5 is ~1e-5 of it
    if op == "enc_bwd_full":
        return (rnd(batch, SEG, scale=0.3), rnd(batch, UNITS, relu=True),
                rnd(batch, LATENT, scale=0.1), rnd(batch, LATENT, scale=0.1),
                rnd(UNITS, LATENT, scale=0.2), rnd(UNITS, LATENT, scale=0.2))
    return (rnd(batch, SEG, scale=0.05), rnd(batch, UNITS, relu=True),
            rnd(batch, LATENT), rnd(UNITS, SEG, scale=0.1),
            rnd(LATENT, UNITS, scale=0.1))


def _slices(op, batch):
    """The slices full_plan gives the chain's weight gradients."""
    w = tensor_cores.SPLIT_WIDTHS
    if op == "enc_bwd_full":
        return (tensor_cores.wgrad_plan(SEG, UNITS, batch, SMS, 1, w)[1],
                tensor_cores.wgrad_plan(UNITS, LATENT, batch, SMS, 2, w)[1])
    return (tensor_cores.wgrad_plan(LATENT, UNITS, batch, SMS, 1, w)[1],
            tensor_cores.wgrad_plan(UNITS, SEG, batch, SMS, 1, w)[1])


def _close(got, want):
    for g, w in zip(got, want):
        g = np.asarray(g.float() if isinstance(g, torch.Tensor) else g,
                       np.float32)
        w = np.asarray(w.float() if isinstance(w, torch.Tensor)
                       else jnp.asarray(w).astype(jnp.float32), np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("batch", [48, 1, 33])
def test_the_modelled_walk_matches_plain_and_jax(op, batch):
    arrays = _operands(op, batch, batch)
    got = MODELS[op](*arrays, slices=_slices(op, batch))
    plain = getattr(mlp, op + "_ref")(*map(torch.from_numpy, arrays), 3)
    _close(got, plain)
    with jax.default_matmul_precision("high"):
        want = getattr(jmlp, op)(*map(jnp.asarray, arrays))
    _close(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("slices", [(2, 3), (5, 2)])
def test_the_modelled_slices_add_up_to_the_whole_batch(op, slices):
    """A batch of 300 rows (five k-steps) cut into slices as a plan may
    cut it: the ordered sum of the slices' (hh + hl) + lh is the plain
    version's product to the tolerance."""
    arrays = _operands(op, 300, 7)
    got = MODELS[op](*arrays, slices=slices)
    plain = getattr(mlp, op + "_ref")(*map(torch.from_numpy, arrays), 3)
    _close(got, plain)


@pytest.mark.parametrize("op", OPS)
def test_the_modelled_walk_is_the_plain_version_bit_for_bit_on_built_operands(
        op):
    """chip_smoke.py's exact_split_case at small widths: every sum has one
    non-zero term, so three accumulators each hold one exact product and
    the two IEEE adds are the plain version's.  Outside the dense bias
    gradient the model gives the 3-pass plain version's bits, and they are
    not one pass's."""
    smoke = _smoke()
    cases = dict(zip(OPS, smoke.exact_split_case(torch.device("cpu"), 0,
                                                 SEG, UNITS, LATENT)))
    case = cases[op]
    got = MODELS[op](*(t.numpy() for t in case))
    want = getattr(mlp, op + "_ref")(*case, 3)
    once = getattr(mlp, op + "_ref")(*case, 1)
    moved = total = 0
    for i, (g, w, o) in enumerate(zip(got, want, once)):
        w, o = w.numpy(), o.numpy()
        if i in smoke.DENSE_SUMS[op]:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=smoke.EXACT_DB_REL * np.abs(w).max())
            continue
        np.testing.assert_array_equal(g, w)
        moved, total = moved + int((w != o).sum()), total + w.size
    assert moved > total // 10


def test_one_accumulator_for_the_three_passes_is_another_function():
    """Why three accumulators: adding hl and lh into hh's accumulator
    (one sum for all three products) rounds in another order than (hh +
    hl) + lh, and moves values that the built operands' check holds bit
    for bit."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((96, 256)).astype(np.float32)
    (ah, al), (bh, bl) = split_np(a), split_np(b)
    three = rows_np([(a, b)])
    one = np.zeros((64, 96), np.float32)
    for k0 in range(0, 256, 64):
        ks = slice(k0, k0 + 64)
        one = one + ah[:, ks] @ bh[:, ks].T
        one = one + ah[:, ks] @ bl[:, ks].T
        one = one + al[:, ks] @ bh[:, ks].T
    assert (one != three).any()
    np.testing.assert_allclose(one, three, rtol=RTOL, atol=ATOL)

"""fp32 ``encoder_fwd`` and ``decoder_fwd`` on the CUDA cores' mainloop
(rawaudiovae_kelsey_tpu_torch/csrc/sgemm.cuh ``launch_fwd``), modelled in
Python: both heads of the encoder in one grid whose tile columns run over
mu's then logvar's (``sgemm_heads_kernel``), a product's contraction cut
into slices whose sums are added in order, the bias and the activation
after the sum (``slices_epilogue``, csrc/slices.cuh), the plan rule
(``tensor_cores.sgemm_fwd_plan``), the dispatch (``mlp.resolve_encoder`` /
``resolve_decoder``) and what reaches the C entry points.  The launches are
emulated at a small width against the plain versions and the JAX kernels
in interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).

Tolerance: atol 1e-5.  The emulations form the plain version's fp32
products (each product exact in fp64, added in k order and rounded once,
as an FFMA adds it) and add the slices in another order than one fp32 dot
of at most 320 terms of order 1: their results move by ~1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp
from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
SGEMM = tensor_cores.SGEMM
SLICE_ROWS = 64                   # csrc/sgemm.cuh kSliceRows
ATOL = 1e-5
SMS = 132                         # an H100's SMs
DENSE = (1024, 2048, 256)         # configs/default.ini: seg, units, latent


def _slices(k, split):
    """k of each slice as launch_fwd cuts the contraction: runs of
    ceil(ceil(k / 64) / split) steps of 64."""
    steps = -(-k // SLICE_ROWS)
    per = -(-steps // split)
    return [range(z * per * SLICE_ROWS, min(k, (z + 1) * per * SLICE_ROWS))
            for z in range(split)]


# ---- the plan rule

# the server's four products at batch 256 and the microbatch's, (k, n,
# outputs) → (tile of SGEMM_TILES, slices) on 132 SMs: at 256 h is 32
# tiles of 128 x 128 cut into 4 slices (one wave of 128 blocks), the heads
# 8 tiles into 16, y 16 tiles into 8, and h3 (k = 256, 4 steps) takes 128
# tiles of 64 x 64 whole; at 8192 every product is more than a wave of 128
# x 128 tiles, unsplit
@pytest.mark.parametrize("rows,k,n,outputs,plan", [
    (256, 1024, 2048, 1, ((128, 128), 4)),
    (256, 2048, 256, 2, ((128, 128), 16)),
    (256, 256, 2048, 1, ((64, 64), 1)),
    (256, 2048, 1024, 1, ((128, 128), 8)),
    (8192, 1024, 2048, 1, ((128, 128), 1)),
    (8192, 2048, 256, 2, ((128, 128), 1)),
    (8192, 256, 2048, 1, ((128, 128), 1)),
    (8192, 2048, 1024, 1, ((128, 128), 1))],
    ids=["h@256", "heads@256", "h3@256", "y@256", "h@8192", "heads@8192",
         "h3@8192", "y@8192"])
def test_the_forward_plan_at_the_main_path(rows, k, n, outputs, plan):
    index, split = tensor_cores.sgemm_fwd_plan(rows, k, n, SMS, outputs)
    assert (tensor_cores.SGEMM_TILES[index], split) == plan


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 20000), k=st.integers(1, 1200).map(lambda v: 4 * v),
       n=st.integers(1, 1200).map(lambda v: 4 * v),
       outputs=st.sampled_from([1, 2]), sms=st.sampled_from([8, 66, 132]))
def test_the_forward_plan_cuts_only_to_fill_a_wave(rows, k, n, outputs, sms):
    """No slice is empty, every k is in one slice, and a cut contraction's
    blocks fit one wave of one block an SM."""
    index, split = tensor_cores.sgemm_fwd_plan(rows, k, n, sms, outputs)
    bm, bn = tensor_cores.SGEMM_TILES[index]
    runs = _slices(k, split)
    assert all(len(r) for r in runs)
    assert [i for r in runs for i in r] == list(range(k))
    if split > 1:
        assert outputs * -(-rows // bm) * -(-n // bn) * split <= sms


def test_the_first_version_and_the_tensor_cores_take_one_slice(
        monkeypatch):
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    dev = torch.device("meta")
    assert tensor_cores.fwd(0, dev, 256, 1024, 2048) == (0, 0)
    assert tensor_cores.fwd(1, dev, 256, 2048, 256, 2) == (
        tensor_cores.tile(1, dev, 256, 256, 2), 1)
    assert tensor_cores.fwd(SGEMM, dev, 256, 2048, 256, 2) == \
        tensor_cores.sgemm_fwd_plan(256, 2048, 256, SMS, 2)


# ---- the dispatch

@pytest.mark.parametrize("batch", [8192, 1000, 256, 1])
def test_fp32_dense_widths_take_the_fp32_kernel(batch):
    seg, units, latent = DENSE
    assert mlp.resolve_encoder("auto", F32, batch, *DENSE) == SGEMM
    assert mlp.resolve_encoder("sgemm", F32, batch, *DENSE) == SGEMM
    assert mlp.resolve_decoder("auto", F32, batch, latent, units, seg) \
        == SGEMM
    assert mlp.resolve_decoder("sgemm", F32, batch, latent, units, seg) \
        == SGEMM
    # bf16 keeps the tensor cores; the first version by name
    assert mlp.resolve_encoder("auto", BF16, batch, *DENSE) == 1
    assert mlp.resolve_decoder("auto", BF16, batch, latent, units, seg) == 1
    assert mlp.resolve_encoder("cuda_cores", F32, batch, *DENSE) == 0


@pytest.mark.parametrize("widths", [(1024, 2048, 38), (1024, 2046, 256),
                                    (1022, 2048, 256), (70, 130, 18)],
                         ids=["latent%4", "units%4", "seg%4", "odd"])
def test_odd_fp32_widths_keep_the_first_version(widths):
    seg, units, latent = widths
    assert mlp.resolve_encoder("auto", F32, 1000, *widths) == 0
    assert mlp.resolve_decoder("auto", F32, 1000, latent, units, seg) == 0
    with pytest.raises(ValueError, match="encoder_fwd: kernel 'sgemm' "
                       "takes fp32 operands"):
        mlp.resolve_encoder("sgemm", F32, 1000, *widths)
    with pytest.raises(ValueError, match="decoder_fwd: kernel 'sgemm' "
                       "takes fp32 operands"):
        mlp.resolve_decoder("sgemm", F32, 1000, latent, units, seg)


def test_unaligned_and_bf16_operands_never_take_the_fp32_kernel():
    seg, units, latent = DENSE
    assert mlp.resolve_encoder("auto", F32, 256, *DENSE, False) == 0
    assert mlp.resolve_decoder("auto", F32, 256, latent, units, seg,
                               False) == 0
    for dtype in (F32, BF16):
        aligned = dtype == BF16
        with pytest.raises(ValueError, match="'sgemm' takes fp32"):
            mlp.resolve_encoder("sgemm", dtype, 256, *DENSE, aligned)
    assert tensor_cores.SGEMM_OPS >= {"encoder_fwd", "decoder_fwd"}


# ---- what reaches the C entry points

def _stand_in(monkeypatch):
    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    monkeypatch.setattr(mlp._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _operands(kind, batch, seg, units, latent, dtype=F32):
    shapes = (((seg, units), (units,), (units, latent), (latent,),
               (units, latent), (latent,), (batch, seg)) if kind == "encoder"
              else ((latent, units), (units,), (units, seg), (seg,),
                    (batch, latent)))
    return [torch.empty(s, device="meta", dtype=dtype) for s in shapes]


def test_the_encoder_passes_the_plans_and_a_shared_workspace(monkeypatch):
    """rvk_encoder_fwd gets each product's slices and tile and one fp32
    workspace of the larger split product's partial sums (h: 4 slices of
    256 x 2048; the heads: 16 slices of two 256 x 256 outputs); none at
    the microbatch, where nothing is cut."""
    launched = _stand_in(monkeypatch)
    before = mlp.encoder_fwd.sgemm_launches
    mlp.encoder_fwd(*_operands("encoder", 256, *DENSE))
    name, args = launched.pop()
    assert name == "rvk_encoder_fwd" and len(args) == 21
    assert args[11:] == (256, *DENSE, 0, 4, 16, 0, 0, SGEMM)
    ws = args[10]
    assert ws.dtype == F32 and ws.shape == (max(4 * 256 * 2048,
                                                16 * 2 * 256 * 256),)
    mlp.encoder_fwd(*_operands("encoder", 8192, *DENSE))
    name, args = launched.pop()
    assert args[10] is None and args[15:] == (0, 1, 1, 0, 0, SGEMM)
    assert mlp.encoder_fwd.sgemm_launches - before == 2


def test_the_decoder_passes_the_plans_and_a_shared_workspace(monkeypatch):
    """rvk_decoder_fwd: h3 (k = 256) whole on 64 x 64 tiles, y in 8
    slices of 256 x 1024 on 128 x 128 at the server's batch."""
    launched = _stand_in(monkeypatch)
    seg, units, latent = DENSE
    before = mlp.decoder_fwd.sgemm_launches
    mlp.decoder_fwd(*_operands("decoder", 256, *DENSE))
    name, args = launched.pop()
    assert name == "rvk_decoder_fwd" and len(args) == 18
    assert args[8:] == (256, latent, units, seg, 0, 1, 8, 2, 0, SGEMM)
    assert args[7].shape == (8 * 256 * 1024,)
    mlp.decoder_fwd(*_operands("decoder", 8192, *DENSE))
    assert launched.pop()[1][7] is None
    assert mlp.decoder_fwd.sgemm_launches - before == 2


def test_the_signatures_of_the_forward_entry_points():
    p, i = _build._P, _build._I
    # x, w1, b1, w21, b21, w22, b22, mu, logvar, h, workspace | batch, seg,
    # units, latent, dtype, split_hidden, split_heads, tile_hidden,
    # tile_heads, kernel | stream
    assert _build._SIGNATURES["rvk_encoder_fwd"] == [p] * 11 + [i] * 10 + [p]
    # z, w3, b3, w4, b4, y, h3, workspace | batch, latent, units, seg,
    # dtype, split_hidden, split_out, tile_hidden, tile_out, kernel | stream
    assert _build._SIGNATURES["rvk_decoder_fwd"] == [p] * 8 + [i] * 10 + [p]


def test_the_entry_points_take_a_workspace_then_the_splits_then_tiles():
    import re

    text = (_build.CSRC / "mlp.cu").read_text()
    for name, splits in (("rvk_encoder_fwd", "split_heads"),
                         ("rvk_decoder_fwd", "split_out")):
        params = [a.strip() for a in re.search(
            rf"^int {name}\(([^)]*)\)", text, re.M).group(1).split(",")]
        assert "float* workspace" in params
        at = params.index("int split_hidden")
        assert params[at + 1] == f"int {splits}"
        assert params[at + 2] == "int tile_hidden"
    assert '#include "sgemm.cuh"' in text


# ---- the two-output column walk (sgemm_heads_kernel)

def _heads_walk(latent, bn):
    """Each tile column of the heads' grid, as sgemm_heads_kernel takes
    it: (output, first column of that output) for blockIdx.x in 0 .. 2 ·
    ceil(latent / BN) - 1."""
    cols = -(-latent // bn)
    return [(x // cols, (x - x // cols * cols) * bn) for x in range(2 * cols)]


@settings(max_examples=300, deadline=None)
@given(latent=st.integers(1, 200).map(lambda v: 4 * v),
       bn=st.sampled_from([bn for _, bn in tensor_cores.SGEMM_TILES]))
def test_the_heads_walk_writes_every_column_once_by_its_own_head(latent,
                                                                 bn):
    """Every column of mu and of logvar is written by one tile column of
    the grid, whose output (the W, bias and C it picks) is that head; the
    16-byte chunks past the latent width are skipped."""
    written = np.zeros((2, latent), dtype=np.int64)
    for o, n0 in _heads_walk(latent, bn):
        assert o in (0, 1)
        for n in range(n0, n0 + bn, 4):          # the epilogue's chunks
            if n < latent:
                written[o, n:n + 4] += 1
    assert (written == 1).all()
    walk = _heads_walk(latent, bn)
    assert [o for o, _ in walk] == [0] * (len(walk) // 2) \
        + [1] * (len(walk) // 2)


# ---- the launches, emulated

def _act(v, act):
    return torch.relu(v) if act == "relu" else torch.tanh(v) \
        if act == "tanh" else v


def _product(a, bs, biases, act, tile, split):
    """launch_fwd<len(bs), act>: each output C_o = act(A · B_o + bias_o),
    tile by tile (the heads' tile columns over both outputs, as
    _heads_walk takes them), slice by slice, each tile's outputs one
    accumulator adding A[m, k] · B[k, n] in k order (exact in fp64,
    rounded once: an FFMA); one slice: bias and activation in the epilogue;
    more: each slice's sums into the workspace at (o · split + s) · M·N,
    then the epilogue adds the slices in order, adds the bias and applies
    the activation (slices_epilogue)."""
    m, k = a.shape
    n = bs[0].shape[1]
    bm, bn = tile
    runs = _slices(k, split)
    work = torch.full((len(bs) * split, m, n), float("nan"))
    walk = _heads_walk(n, bn) if len(bs) == 2 else \
        [(0, c) for c in range(0, n, bn)]
    for o, n0 in walk:
        for m0 in range(0, m, bm):
            rows, cols = slice(m0, m0 + bm), slice(n0, n0 + bn)
            for z, ks in enumerate(runs):
                acc = torch.zeros(a[rows].shape[0], bs[o][:, cols].shape[1])
                for kk in ks:
                    acc = (acc.double() + a[rows, kk].double()[:, None]
                           * bs[o][kk, cols].double()[None, :]).float()
                work[o * split + z, rows, cols] = acc
    assert not torch.isnan(work).any()        # every value written once
    out = []
    for o in range(len(bs)):
        total = work[o * split].clone()
        for z in range(1, split):
            total = total + work[o * split + z]
        out.append(_act(total + biases[o], act))
    return out


def _encoder(w1, b1, w21, b21, w22, b22, x, plans):
    (t_h, s_h), (t_o, s_o) = plans
    (h,) = _product(x, [w1], [b1], "relu", t_h, s_h)
    mu, logvar = _product(h, [w21, w22], [b21, b22], "none", t_o, s_o)
    return mu, logvar, h


def _decoder(w3, b3, w4, b4, z, plans):
    (t_h, s_h), (t_o, s_o) = plans
    (h3,) = _product(z, [w3], [b3], "relu", t_h, s_h)
    (y,) = _product(h3, [w4], [b4], "tanh", t_o, s_o)
    return y, h3


def _fp32(arrays):
    return [torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in arrays]


def _encoder_operands(batch, seg, units, latent, seed=0):
    rng = np.random.default_rng(seed)
    return _fp32([rng.standard_normal((seg, units)) / seg ** 0.5,
                  rng.standard_normal(units) * 0.1,
                  rng.standard_normal((units, latent)) / units ** 0.5,
                  rng.standard_normal(latent) * 0.1,
                  rng.standard_normal((units, latent)) / units ** 0.5,
                  rng.standard_normal(latent) * 0.1,
                  rng.uniform(-1, 1, (batch, seg))])


def _decoder_operands(batch, latent, units, seg, seed=0):
    rng = np.random.default_rng(seed)
    return _fp32([rng.standard_normal((latent, units)) / latent ** 0.5,
                  rng.standard_normal(units) * 0.1,
                  rng.standard_normal((units, seg)) / units ** 0.5,
                  rng.standard_normal(seg) * 0.1,
                  rng.standard_normal((batch, latent))])


def _close(got, want):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w)) if not isinstance(w, torch.Tensor) \
            else w
        assert g.dtype == F32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= ATOL


# widths (seg, units): the dense model cut to 64/128 (one k-step of 64 for
# h, two for the heads and y), and 320/200 (h in five steps, the heads and
# y in four, the last ragged); plans (tile, slices) of each product
WIDTHS = [(64, 128), (320, 200)]
PLANS = [(((128, 128), 1), ((128, 128), 1)), (((128, 64), 1), ((64, 64), 2)),
         (((64, 64), 5), ((128, 64), 3)), (((64, 64), 2), ((128, 128), 4))]


def _fit(plans, ks):
    """The plans with each split cut to the most slices its contraction
    takes without an empty one (launch_fwd refuses those)."""
    out = []
    for (tile, split), k in zip(plans, ks):
        steps = -(-k // SLICE_ROWS)
        while split > 1 and -(-steps // -(-steps // split)) != split:
            split -= 1
        out.append((tile, min(split, steps)))
    return out


@pytest.mark.parametrize("latent", [8, 72])
@pytest.mark.parametrize("seg,units", WIDTHS, ids=str)
@pytest.mark.parametrize("plans", PLANS, ids=str)
def test_the_emulated_encoder_matches_plain_and_jax(latent, seg, units,
                                                    plans):
    """Batch 300 (three tile rows of 128, five of 64, the last ragged);
    latent 8 or 72 (one or two tile columns a head, the last ragged):
    mu, logvar and h against the plain version and the JAX kernel in
    interpret mode."""
    ops = _encoder_operands(300, seg, units, latent, seed=latent + seg)
    got = _encoder(*ops, _fit(plans, (seg, units)))
    _close(got, mlp.encoder_fwd_ref(*ops))
    _close(got, jmlp.encoder_fwd(*[jnp.asarray(t.numpy()) for t in ops]))


@pytest.mark.parametrize("latent", [8, 72])
@pytest.mark.parametrize("seg,units", WIDTHS, ids=str)
@pytest.mark.parametrize("plans", PLANS, ids=str)
def test_the_emulated_decoder_matches_plain_and_jax(latent, seg, units,
                                                    plans):
    """Batch 300: y and h3 against the plain version and the JAX kernel in
    interpret mode; y reads h3 as written (fp32: no rounding between the
    layers)."""
    ops = _decoder_operands(300, latent, units, seg, seed=latent + units)
    got = _decoder(*ops, _fit(plans, (latent, units)))
    _close(got, mlp.decoder_fwd_ref(*ops))
    _close(got, jmlp.decoder_fwd(*[jnp.asarray(t.numpy()) for t in ops]))

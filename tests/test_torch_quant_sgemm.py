"""The int8 decoder ``quantized_decoder_fwd`` on the CUDA cores' fp32
mainloop (rawaudiovae_kelsey_tpu_torch/csrc/sgemm.cuh ``launch_fwd`` with an
int8 B, csrc/quant.cu), modelled in Python: the dispatch
(``quant.resolve_quantized_decoder``), the plan it passes to the C entry
point (the fp32 decoder's ``tensor_cores.sgemm_fwd_plan``, a shared
workspace) and the int8 walk itself — each slab of q copied as it lies,
dequantized as ``q · s`` with one fp32 multiply as it is read back, the
contraction cut into slices added in order, the bias and the activation
after the sum — against the plain version, the JAX package's XLA
reference ``quantized_decode_xla`` and its Pallas kernel in interpret
mode.  The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).

Tolerance: atol 1e-5 against every reference.  The model forms the plain
version's fp32 products of the same dequantized weights (each rounded once,
as an FFMA adds it unrounded: within the tolerance) and adds them in slice
order, another order than one fp32 dot of at most 128 terms of order 1:
results of order 1 move by ~1e-7.  The dequantized weights themselves are
held bit for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.ops import quant as jquant
from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp, quant, tensor_cores

BF16, F32 = torch.bfloat16, torch.float32
SGEMM = tensor_cores.SGEMM
SLICE_ROWS = 64                       # csrc/sgemm.cuh kSliceRows
SMS = 132                             # an H100's SMs
ATOL = 1e-5
DENSE = (256, 2048, 1024)             # configs/default.ini: latent, units, seg
SMALL = (32, 128, 64)                 # the model's widths here
BATCHES = (48, 33, 1)
# csrc/sgemm.cuh kTiles and each tile's slab depth (kSlabDepth)
SLAB_DEPTH = {(128, 128): 16, (128, 64): 32, (64, 64): 32}


# ---- the dispatch

@pytest.mark.parametrize("batch", [8192, 256, 33, 1])
@pytest.mark.parametrize("widths", [DENSE, SMALL], ids=["dense", "small"])
def test_fp32_dense_widths_take_the_fp32_kernel(batch, widths):
    assert quant.resolve_quantized_decoder("auto", F32, batch,
                                           *widths) == SGEMM
    assert quant.resolve_quantized_decoder("sgemm", F32, batch,
                                           *widths) == SGEMM
    assert quant.resolve_quantized_decoder("cuda_cores", F32, batch,
                                           *widths) == 0
    assert "quantized_decoder_fwd" in tensor_cores.SGEMM_OPS


@pytest.mark.parametrize("widths", [(38, 2048, 1024), (256, 2046, 1024),
                                    (256, 2048, 1022), (18, 130, 70)],
                         ids=["latent%4", "units%4", "seg%4", "odd"])
def test_widths_no_multiple_of_4_keep_the_first_version(widths):
    assert quant.resolve_quantized_decoder("auto", F32, 256, *widths) == 0
    with pytest.raises(ValueError, match="quantized_decoder_fwd: kernel "
                       "'sgemm' takes fp32 operands"):
        quant.resolve_quantized_decoder("sgemm", F32, 256, *widths)


def test_unaligned_views_bf16_and_no_rows_keep_the_first_version():
    assert quant.resolve_quantized_decoder("auto", F32, 256, *DENSE,
                                           False) == 0
    assert quant.resolve_quantized_decoder("auto", BF16, 256, *DENSE) == 0
    assert quant.resolve_quantized_decoder("auto", F32, 0, *DENSE) == 0
    for dtype, aligned in ((F32, False), (BF16, True)):
        with pytest.raises(ValueError, match="'sgemm' takes fp32"):
            quant.resolve_quantized_decoder("sgemm", dtype, 256, *DENSE,
                                            aligned)


def test_no_tensor_core_form_and_no_unknown_kernel():
    with pytest.raises(ValueError, match="no tensor-core form"):
        quant.resolve_quantized_decoder("tensor_cores", F32, 256, *DENSE)
    with pytest.raises(ValueError, match="unknown kernel"):
        quant.resolve_quantized_decoder("wgmma", F32, 256, *DENSE)


# ---- what reaches the C entry point

def _stand_in(monkeypatch):
    launched = []
    for module in (mlp, quant):
        monkeypatch.setattr(module, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: SMS)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _qparams(latent, units, seg, device="meta"):
    def layer(k, n):
        return {"q": torch.empty((k, n), device=device, dtype=torch.int8),
                "scale": torch.empty((1, n), device=device),
                "b": torch.empty((n,), device=device)}
    return {"fc3": layer(latent, units), "fc4": layer(units, seg)}


@pytest.mark.parametrize("batch", [256, 33, 1, 8192])
def test_the_fp32_decoders_plans_reach_the_entry_point(monkeypatch, batch):
    """rvk_quantized_decoder_fwd gets each product's (tile, slices) from
    ``tensor_cores.sgemm_fwd_plan`` at the decoder's shapes — exactly what
    ``decoder_fwd`` passes for fp32 operands of the same widths — and the
    same fp32 workspace of the larger split product's slices (none where
    nothing is cut)."""
    launched = _stand_in(monkeypatch)
    latent, units, seg = DENSE
    z = torch.empty((batch, latent), device="meta")
    before = (quant.quantized_decoder_fwd.launches,
              quant.quantized_decoder_fwd.sgemm_launches)
    y = quant.quantized_decoder_fwd(_qparams(*DENSE), z)
    assert y.shape == (batch, seg) and y.dtype == F32
    name, args = launched.pop()
    # z, q3, s3, b3, q4, s4, b4, y, h3, workspace | batch, latent, units,
    # seg, split_hidden, split_out, tile_hidden, tile_out, kernel
    assert name == "rvk_quantized_decoder_fwd" and len(args) == 19
    assert args[0] is z and args[7] is y
    assert args[8].shape == (batch, units) and args[8].dtype == F32
    (tile_h, split_h), (tile_o, split_o) = (
        tensor_cores.sgemm_fwd_plan(batch, latent, units, SMS),
        tensor_cores.sgemm_fwd_plan(batch, units, seg, SMS))
    assert args[10:] == (batch, *DENSE, split_h, split_o, tile_h, tile_o,
                         SGEMM)
    size = max([s * batch * n for s, n in ((split_h, units), (split_o, seg))
                if s > 1], default=0)
    assert (args[9] is None) if not size else (
        args[9].shape == (size,) and args[9].dtype == F32)
    # the fp32 decoder's launch at the same widths takes the same plans
    mlp.decoder_fwd(torch.empty((latent, units), device="meta"),
                    torch.empty((units,), device="meta"),
                    torch.empty((units, seg), device="meta"),
                    torch.empty((seg,), device="meta"), z)
    dec = launched.pop()[1]
    assert dec[13:] == args[14:]
    assert (dec[7] is None) == (args[9] is None)
    assert (quant.quantized_decoder_fwd.launches - before[0],
            quant.quantized_decoder_fwd.sgemm_launches - before[1]) == (1, 1)


def test_the_first_version_gets_no_plan(monkeypatch):
    launched = _stand_in(monkeypatch)
    before = (quant.quantized_decoder_fwd.launches,
              quant.quantized_decoder_fwd.sgemm_launches)
    quant.quantized_decoder_fwd(_qparams(*DENSE),
                                torch.empty((256, 256), device="meta"),
                                kernel="cuda_cores")
    args = launched.pop()[1]
    assert args[9] is None and args[14:] == (0, 0, 0, 0, 0)
    quant.quantized_decoder_fwd(_qparams(38, 2048, 1024),
                                torch.empty((100, 38), device="meta"))
    assert launched.pop()[1][14:] == (0, 0, 0, 0, 0)      # latent % 4
    with pytest.raises(ValueError, match="'sgemm' takes fp32"):
        quant.quantized_decoder_fwd(_qparams(38, 2048, 1024),
                                    torch.empty((100, 38), device="meta"),
                                    kernel="sgemm")
    quant.quantized_decoder_fwd(_qparams(*DENSE),
                                torch.empty((0, 256), device="meta"))
    assert launched == []
    assert (quant.quantized_decoder_fwd.launches - before[0],
            quant.quantized_decoder_fwd.sgemm_launches - before[1]) == (2, 0)


def test_a_cpu_tensor_takes_the_plain_version_whatever_the_kernel():
    rng = np.random.default_rng(5)
    w3, w4 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((32, 128), (128, 64)))
    qp = quant.quantize_decoder({"fc3": {"w": w3, "b": torch.zeros(128)},
                                 "fc4": {"w": w4, "b": torch.zeros(64)}})
    z = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    before = (quant.quantized_decoder_fwd.launches,
              quant.quantized_decoder_fwd.sgemm_launches)
    want = quant.quantized_decode_ref(qp, z)
    for kernel in ("auto", "cuda_cores", "sgemm", "tensor_cores"):
        assert torch.equal(quant.quantized_decoder_fwd(qp, z, kernel), want)
    with pytest.raises(ValueError, match="unknown kernel"):
        quant.quantized_decoder_fwd(qp, z, "wgmma")
    assert before == (quant.quantized_decoder_fwd.launches,
                      quant.quantized_decoder_fwd.sgemm_launches)


def test_the_entry_points_signature():
    p, i = _build._P, _build._I
    assert _build._SIGNATURES["rvk_quantized_decoder_fwd"] == \
        [p] * 10 + [i] * 9 + [p]
    text = (_build.CSRC / "quant.cu").read_text()
    params = [a.strip() for a in re.search(
        r"^int rvk_quantized_decoder_fwd\(([^)]*)\)", text,
        re.M).group(1).split(",")]
    assert params[9] == "float* workspace"
    assert params[10:19] == [f"int {n}" for n in (
        "batch", "latent", "units", "seg", "split_hidden", "split_out",
        "tile_hidden", "tile_out", "kernel")]
    assert params[19] == "void* stream"
    assert '#include "sgemm.cuh"' in text
    assert text.count("rvk::sgemm::launch_fwd<1, rvk::kActRelu, int8_t>") \
        == 1
    assert text.count("rvk::sgemm::launch_fwd<1, rvk::kActTanh, int8_t>") \
        == 1


# ---- the int8 walk, modelled

def _slices(k, split):
    """k of each slice as launch_fwd cuts the contraction: runs of
    ceil(ceil(k / 64) / split) steps of 64."""
    steps = -(-k // SLICE_ROWS)
    per = -(-steps // split)
    return [range(z * per * SLICE_ROWS, min(k, (z + 1) * per * SLICE_ROWS))
            for z in range(split)]


def _staged_b(q, s, tile, slice_k, n0):
    """The fp32 compute buffers of one tile column's walk over one slice,
    slab by slab: each slab of kBK k-rows by BN columns copied as it lies
    (zeros past K and N), each value dequantized as q · s[column], one
    fp32 multiply (rounded to nearest), as Operand::transpose does for an
    int8 B.  Returns {k: the dequantized row of the tile's columns}."""
    k_total, n = q.shape
    bk = SLAB_DEPTH[tile]
    bn = tile[1]
    cols = np.zeros(bn, dtype=np.float32)
    width = max(0, min(n, n0 + bn) - n0)
    cols[:width] = s[0, n0:n0 + width]
    rows = {}
    first, end = slice_k.start, slice_k.stop
    for k0 in range(first - first % bk, end, bk):
        slab = np.zeros((bk, bn), dtype=np.int8)
        for r in range(bk):
            k = k0 + r
            if first <= k < end:
                slab[r, :width] = q[k, n0:n0 + width]
        dequantized = slab.astype(np.float32) * cols     # fp32 multiply
        assert dequantized.dtype == np.float32
        for r in range(bk):
            if first <= k0 + r < end:
                rows[k0 + r] = dequantized[r]
    return rows


def _product(a, q, s, bias, act, tile, split):
    """launch_fwd<1, act, int8_t>: C = act(A · (q·s) + bias) tile column
    by tile column and slice by slice, each output one accumulator adding
    A[m, k] · B[k, n] in k order (exact in fp64, rounded once: an FFMA);
    one slice: the bias and the activation in the epilogue; more: the
    slices' sums added in order, then the bias and the activation
    (slices_epilogue).  Also returns the dequantized B the walk staged."""
    m, k = a.shape
    n = q.shape[1]
    bn = tile[1]
    staged = np.full((k, n), np.nan, dtype=np.float32)
    work = np.zeros((split, m, n), dtype=np.float32)
    for z, ks in enumerate(_slices(k, split)):
        for n0 in range(0, n, bn):
            rows = _staged_b(q, s, tile, ks, n0)
            width = min(n, n0 + bn) - n0
            acc = np.zeros((m, bn), dtype=np.float32)
            for kk in ks:
                acc = (acc.astype(np.float64) + a[:, kk, None].astype(
                    np.float64) * rows[kk][None, :]).astype(np.float32)
                staged[kk, n0:n0 + width] = rows[kk][:width]
            work[z, :, n0:n0 + width] = acc[:, :width]
    total = work[0].copy()
    for z in range(1, split):
        total = total + work[z]
    pre = total + bias
    out = np.maximum(pre, np.float32(0)) if act == "relu" else np.tanh(pre)
    return out.astype(np.float32), staged


def _decoder(qp, z, plans):
    (t_h, s_h), (t_o, s_o) = plans
    np_ = {n: {k: v.numpy() for k, v in layer.items()}
           for n, layer in qp.items()}
    h3, b3 = _product(z, np_["fc3"]["q"], np_["fc3"]["scale"],
                      np_["fc3"]["b"], "relu", t_h, s_h)
    y, b4 = _product(h3, np_["fc4"]["q"], np_["fc4"]["scale"],
                     np_["fc4"]["b"], "tanh", t_o, s_o)
    return y, (b3, b4)


def _weights(latent, units, seg, seed):
    rng = np.random.default_rng(seed)
    w3 = rng.standard_normal((latent, units)) / latent ** 0.5
    w4 = rng.standard_normal((units, seg)) / units ** 0.5
    w4[:, 3] = 0.0                       # an all-zero column: scale 1.0
    params = {"fc3": {"w": w3, "b": rng.standard_normal(units) * 0.1},
              "fc4": {"w": w4, "b": rng.standard_normal(seg) * 0.1}}
    return {n: {k: torch.from_numpy(v.astype(np.float32))
                for k, v in layer.items()} for n, layer in params.items()}


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


# (tile, slices) of h3 and y: the rule's pick at these widths on 132 SMs,
# then forced ones that cut y's 128 k into 2 slices and walk the three tiles
PLANS = ["rule", (((64, 64), 1), ((128, 128), 2)),
         (((128, 64), 1), ((64, 64), 2)), (((128, 128), 1), ((128, 64), 1))]


def _plans(plan, batch, latent, units, seg):
    if plan == "rule":
        return [(tensor_cores.SGEMM_TILES[i], s) for i, s in (
            tensor_cores.sgemm_fwd_plan(batch, latent, units, SMS),
            tensor_cores.sgemm_fwd_plan(batch, units, seg, SMS))]
    return _fit(plan, (latent, units))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_the_modelled_walk_matches_plain_xla_and_the_jax_kernel(batch, plan):
    """Latent 32, units 128, seg 64 (h3 one slab, y two k-steps of 64),
    batches 48, 33 and 1: y against quantized_decode_ref, the JAX
    package's quantized_decode_xla and its Pallas kernel in interpret mode,
    atol 1e-5."""
    latent, units, seg = SMALL
    params = _weights(*SMALL, seed=batch)
    qp = quant.quantize_decoder(params)
    z = np.random.default_rng(batch + 1).standard_normal(
        (batch, latent)).astype(np.float32)
    got, _ = _decoder(qp, z, _plans(plan, batch, *SMALL))
    assert got.shape == (batch, seg) and got.dtype == np.float32
    want = quant.quantized_decode_ref(qp, torch.from_numpy(z)).numpy()
    assert float(np.abs(got - want).max()) <= ATOL
    jq = jquant.quantize_decoder(
        {n: {k: jnp.asarray(v.numpy()) for k, v in layer.items()}
         for n, layer in params.items()})
    for ref in (jquant.quantized_decode_xla(jq, jnp.asarray(z)),
                jquant.quantized_decoder_fwd(jq, jnp.asarray(z))):
        ref = np.asarray(jax.device_get(ref))
        assert ref.shape == got.shape
        assert float(np.abs(got - ref).max()) <= ATOL


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_the_staged_weights_are_dequantize_weight_bit_for_bit(plan):
    """Every value the walk stages for the k-steps, slab by slab and tile
    column by tile column, is ``dequantize_weight(q, s)``'s: one fp32
    multiply, the same bits (so the kernel's products are the fp32
    decoder's on the dequantized weights)."""
    qp = quant.quantize_decoder(_weights(*SMALL, seed=11))
    z = np.random.default_rng(12).standard_normal((33, 32)).astype(
        np.float32)
    _, (b3, b4) = _decoder(qp, z, _plans(plan, 33, *SMALL))
    for staged, layer in ((b3, "fc3"), (b4, "fc4")):
        want = quant.dequantize_weight(qp[layer]["q"],
                                       qp[layer]["scale"]).numpy()
        assert not np.isnan(staged).any()
        assert np.array_equal(staged.view(np.uint32), want.view(np.uint32))

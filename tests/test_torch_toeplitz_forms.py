"""The two newer forms of the port's block-Toeplitz product
(rawaudiovae_kelsey_tpu_torch/ops/toeplitz.py): the narrow-channel kernel
(csrc/narrow.cuh, kernel code 3) and the fp32 kernel with an implicit
Toeplitz A (csrc/sgemm.cuh's mainloop, code 2), checked here on the CPU.

* Which form ``kernel="auto"`` picks at every layer of configs/conv1d.ini,
  forward and ``dx``, in both dtypes, and what reaches ``rvk_toeplitz_fwd``
  (the contraction window, the tile, the code), on ``meta`` tensors with
  the launch recorded; a form named for operands it cannot take raises.
* numpy models of the two walks: the narrow block's staged window (16-byte
  loads on x's own grid, the zero fill, the swizzle) and its k order; the
  fp32 kernel's row and offset addressing of A, 16 bytes a copy, over the
  contraction window.  Each is held against the plain version and the JAX
  kernel (``rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py``, which runs in
  interpret mode on the CPU) at tolerances of tests/test_torch_toeplitz.py
  (atol 2e-5, rtol 1e-4: fp32 sums in another order).
* That skipping the tap stack's zero rows leaves each emulated FMA chain's
  bits unchanged, and that a 16-byte copy of the implicit A lies wholly
  inside or wholly outside its batch row (hypothesis).

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3e), where each new form gives the first version's
bits."""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rawaudiovae_kelsey_tpu_torch.config import load_config
from rawaudiovae_kelsey_tpu_torch.ops import conv, tensor_cores, toeplitz

jtoep = importlib.import_module("rawaudiovae_kelsey_tpu.ops.pallas_toeplitz")

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "rawaudiovae_kelsey_tpu_torch" / "csrc"
BF16, F32 = torch.bfloat16, torch.float32
FWD = dict(atol=2e-5, rtol=1e-4)
CODES = tensor_cores.KERNEL_CODES
FIRST, TC, SGEMM, NARROW = (CODES[k] for k in ("cuda_cores", "tensor_cores",
                                               "sgemm", "narrow"))
BATCH = 4096


# ----------------------------------------------------------------- dispatch

def _stand_in(monkeypatch):
    """The device checks stood in for and the launch recorded, so that a
    ``meta`` tensor passes the checks a CUDA tensor passes (an H100's 132
    SMs for the tiles)."""
    launched = []
    monkeypatch.setattr(toeplitz, "kernel_device", lambda x: x.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: 132)
    monkeypatch.setattr(toeplitz._build, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    return launched


def _conv1d_layers():
    """configs/conv1d.ini's eight layers as ``(direction, length, cin,
    cout)``, the encoder's convolutions then the decoder's transposed ones."""
    cfg = load_config(ROOT / "configs" / "conv1d.ini")
    ch = [int(c) for c in cfg.vae.conv_channels.split(",")]
    seg, s = cfg.audio.segment_length, cfg.vae.conv_stride
    assert (cfg.vae.conv_kernel, s, seg) == (9, 4, 1024)
    enc = [("conv", seg // s ** i, c_in, c_out)
           for i, (c_in, c_out) in enumerate(zip([1, *ch], ch))]
    rev = [*reversed(ch), 1]
    dec = [("convT", seg // s ** (len(ch) - i), c_in, c_out)
           for i, (c_in, c_out) in enumerate(zip(rev, rev[1:]))]
    return enc + dec


def _layer_launches(monkeypatch, direction, length, cin, cout, dtype,
                    passes=1, batch=BATCH):
    """The two launches (forward, then dx) of one conv1d layer's forward
    and backward through ``ops/conv.py`` on ``meta`` tensors, as ``(args,
    code)``: ``args`` what reached ``rvk_toeplitz_fwd`` after the five
    pointers (x, w, b, y and the workspace)."""
    launched = _stand_in(monkeypatch)
    op = conv.conv1d_pallas if direction == "conv" \
        else conv.conv1d_transpose_pallas
    x = torch.empty((batch, length, cin), device="meta", dtype=dtype,
                    requires_grad=True)
    w = torch.empty((9, cin, cout), device="meta", dtype=dtype,
                    requires_grad=True)
    b = torch.empty((cout,), device="meta", dtype=dtype, requires_grad=True)
    op(x, w, b, 4, "relu", passes).sum().backward()
    assert [name for name, _ in launched] == ["rvk_toeplitz_fwd"] * 2
    return [(args[5:], args[-1]) for _, args in launched]


# (layer) → the forms of its forward and dx launches, by dtype
EXPECTED = {
    "fp32": [(NARROW, NARROW)] + [(SGEMM, SGEMM)] * 6 + [(NARROW, NARROW)],
    "bf16": [(NARROW, NARROW)] + [(TC, TC)] * 6 + [(NARROW, NARROW)],
    "fp32, 4 passes": [(NARROW, NARROW)] + [(TC, TC)] * 6
    + [(NARROW, NARROW)],
}


@pytest.mark.parametrize("kind", list(EXPECTED))
@pytest.mark.parametrize("layer", range(8))
def test_auto_picks_a_new_form_at_every_conv1d_layer(monkeypatch, kind,
                                                     layer):
    """fp32: the first and last layers and their dx narrow (G or N of 4),
    layers 1-6 on the fp32 kernel; bf16: the same narrow ones, 1-6 on the
    tensor cores; passes = 4 takes the tensor cores at the wide layers too,
    on the operands' bf16 halves."""
    dtype = BF16 if kind == "bf16" else F32
    passes = 4 if "4 passes" in kind else 1
    launches = _layer_launches(monkeypatch, *_conv1d_layers()[layer], dtype,
                               passes)
    assert tuple(code for _, code in launches) == EXPECTED[kind][layer]
    for args, _ in launches:
        B, nb, G, kb, N, t_out = args[:6]
        narrow = toeplitz.takes_narrow(dtype, B, nb, t_out, G, N, kb, passes)
        assert narrow == (min(G, N) < 8)


# what reaches rvk_toeplitz_fwd at each layer's forward in fp32 (after the
# pointers): B, nb, G, KB, N, t_out, shift, act, passes, dtype | k0, k_len
# | t_half, b_half, tile, kernel.  The strided convolutions (layers 1-3)
# pass their weight's rows of the packed tap stack: 288 of 384, 576 of 768,
# 1152 of 1536; the tile is sgemm_whole_tile's (128 x 64 where N is 64:
# index 1); the narrow form's tile is its column chunk, its t_half the
# positions a thread sums (one in fp32, two in bf16).
FP32_FORWARD = [
    (4096, 256, 4, 3, 32, 256, 1, 1, 1, 0, 2, 9, 1, 0, 32, NARROW),
    (4096, 64, 128, 3, 64, 64, 1, 1, 1, 0, 64, 288, 0, 0, 1, SGEMM),
    (4096, 16, 256, 3, 128, 16, 1, 1, 1, 0, 128, 576, 0, 0, 0, SGEMM),
    (4096, 4, 512, 3, 256, 4, 1, 1, 1, 0, 256, 1152, 0, 0, 0, SGEMM),
    (4096, 4, 256, 3, 512, 4, 1, 1, 1, 0, 0, 768, 0, 0, 0, SGEMM),
    (4096, 16, 128, 3, 256, 16, 1, 1, 1, 0, 0, 384, 0, 0, 0, SGEMM),
    (4096, 64, 64, 3, 128, 64, 1, 1, 1, 0, 0, 192, 0, 0, 0, SGEMM),
    (4096, 256, 32, 3, 4, 256, 1, 1, 1, 0, 0, 96, 1, 0, 4, NARROW),
]


@pytest.mark.parametrize("layer", range(8))
def test_what_reaches_the_entry_point_at_each_fp32_layer(monkeypatch, layer):
    (fwd, _), (dx, code_dx) = _layer_launches(
        monkeypatch, *_conv1d_layers()[layer], F32)
    assert fwd == FP32_FORWARD[layer]
    # dx: the reversed taps over the whole stack, zero bias, no activation
    B, nb, G, kb, N, t_out, shift = FP32_FORWARD[layer][:7]
    assert dx[:10] == (B, t_out, N, kb, G, nb, kb - 1 - shift, 0, 1, 0)
    assert dx[10:12] == (0, kb * N)
    assert code_dx == (NARROW if min(G, N) < 8 else SGEMM)
    if code_dx == NARROW:
        assert dx[12:16] == (1, 0, toeplitz.narrow_chunk(G), NARROW)


def test_the_bf16_layers_keep_the_tensor_core_plan(monkeypatch):
    """bf16 layer 2 (t_out 16): the tensor-core kernel's half tile and
    width as before, the window passed and not read."""
    (fwd, code), _ = _layer_launches(monkeypatch, *_conv1d_layers()[2], BF16)
    assert code == TC
    assert fwd[10:] == (128, 576, 16, 4, 128, TC)


@pytest.mark.parametrize("dtype,passes,rows", [(BF16, 1, 2), (F32, 1, 1),
                                               (F32, 4, 1)])
def test_the_narrow_form_sums_two_positions_a_thread_in_bf16(
        monkeypatch, dtype, passes, rows):
    launched = _stand_in(monkeypatch)
    x, w, b = (torch.empty(sh, device="meta", dtype=dtype)
               for sh in ((8, 256, 4), (3, 4, 32), (32,)))
    toeplitz.toeplitz_fwd(x, w, b, "relu", 256, 1, passes)
    args = launched.pop()[1]
    assert args[13:] == (passes, int(dtype == BF16), 0, 12, rows, 0, 32,
                         NARROW)
    assert toeplitz.narrow_rows(dtype) == rows


def test_launch_counts_follow_the_form(monkeypatch):
    launched = _stand_in(monkeypatch)
    counts = ("launches", "tensor_core_launches", "sgemm_launches",
              "narrow_launches")
    before = [getattr(toeplitz.toeplitz_fwd, c) for c in counts]
    for shapes, dtype, kernel in (
            (((8, 64, 128), (3, 128, 64), (64,)), F32, "auto"),
            (((8, 64, 4), (3, 4, 32), (32,)), BF16, "auto"),
            (((8, 64, 4), (3, 4, 32), (32,)), F32, "sgemm"),
            (((8, 64, 4), (3, 4, 32), (32,)), F32, "cuda_cores")):
        x, w, b = (torch.empty(sh, device="meta", dtype=dtype)
                   for sh in shapes)
        toeplitz.toeplitz_fwd(x, w, b, "tanh", 64, 1, kernel=kernel)
    assert [getattr(toeplitz.toeplitz_fwd, c) - n
            for c, n in zip(counts, before)] == [4, 0, 2, 1]
    assert [args[-1] for _, args in launched] == [SGEMM, NARROW, SGEMM,
                                                  FIRST]


@pytest.mark.parametrize("shapes,dtype,passes,window,kernel,match", [
    # the narrow form: both widths 8 or more; bf16 with 4 passes is refused
    # before any form
    (((8, 64, 8), (3, 8, 8), (8,)), F32, 1, None, "narrow",
     "'narrow' takes fp32 or bf16 operands with G or N below 8"),
    (((8, 64, 128), (3, 128, 64), (64,)), BF16, 1, None, "narrow",
     "'narrow' takes"),
    # too much shared memory: a window of 130 x 128 floats, N = 4
    (((8, 64, 128), (3, 128, 4), (4,)), F32, 1, None, "narrow",
     "within 65536 bytes"),
    # the fp32 kernel: bf16, 4 passes, G or N or the window no multiple of 4
    (((8, 64, 128), (3, 128, 64), (64,)), BF16, 1, None, "sgemm",
     "'sgemm' takes fp32 operands with one pass"),
    (((8, 64, 128), (3, 128, 64), (64,)), F32, 4, None, "sgemm",
     "'sgemm' takes fp32"),
    (((8, 64, 126), (3, 126, 64), (64,)), F32, 1, None, "sgemm",
     "window"),
    (((8, 64, 128), (3, 128, 62), (62,)), F32, 1, None, "sgemm",
     "'sgemm' takes fp32"),
    (((8, 64, 128), (3, 128, 64), (64,)), F32, 1, (2, 290), "sgemm",
     r"window \(2, 290\)"),
    (((8, 64, 128), (3, 128, 64), (64,)), F32, 1, (64, 350), "sgemm",
     r"window \(64, 350\)"),
    # the tensor cores: fp32
    (((8, 64, 4), (3, 4, 32), (32,)), F32, 1, None, "tensor_cores",
     "takes bf16 operands"),
], ids=["narrow-wide", "narrow-wide-bf16", "narrow-smem", "sgemm-bf16",
        "sgemm-4-pass", "sgemm-G", "sgemm-N", "sgemm-k0", "sgemm-k_len",
        "tc-fp32"])
def test_a_named_form_raises_where_it_cannot_run(monkeypatch, shapes, dtype,
                                                 passes, window, kernel,
                                                 match):
    launched = _stand_in(monkeypatch)
    x, w, b = (torch.empty(sh, device="meta", dtype=dtype) for sh in shapes)
    with pytest.raises(ValueError, match=match):
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, passes, kernel=kernel,
                              window=window)
    assert launched == []
    # "auto" runs a form that takes them
    toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, passes, window=window)
    assert len(launched) == 1


def test_unaligned_views_keep_the_first_version(monkeypatch):
    launched = _stand_in(monkeypatch)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    for shapes in (((8, 64, 4), (3, 4, 32), (32,)),
                   ((8, 64, 128), (3, 128, 64), (64,))):
        x, w, b = (torch.empty(sh, device="meta") for sh in shapes)
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1)
        assert launched.pop()[1][-1] == FIRST
        for kernel in ("narrow", "sgemm"):
            if kernel == "narrow" and shapes[0][2] == 128:
                continue
            with pytest.raises(ValueError, match="aligned = False"):
                toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, kernel=kernel)


@pytest.mark.parametrize("window", [(-4, 8), (0, 0), (8, 4), (0, 400)])
def test_a_window_outside_the_tap_stack_raises(monkeypatch, window):
    _stand_in(monkeypatch)
    x, w, b = (torch.empty(sh, device="meta")
               for sh in ((8, 64, 128), (3, 128, 64), (64,)))
    with pytest.raises(ValueError, match="window"):
        toeplitz.toeplitz_fwd(x, w, b, "relu", 64, 1, window=window)


def test_only_the_toeplitz_product_has_the_narrow_form():
    assert tensor_cores.NARROW_OPS == {"toeplitz_fwd"}
    assert "toeplitz_fwd" in tensor_cores.SGEMM_OPS
    with pytest.raises(ValueError, match="no kernel 'narrow'"):
        tensor_cores.resolve_kernel("linear_fwd", "narrow", F32, 64, 64, 64)


def test_the_narrow_rule_and_the_kernel_agree_on_their_constants():
    """NARROW_POSITIONS, NARROW_SMEM_BYTES and the chunks are the ones
    csrc/narrow.cuh is built with, and narrow_smem its smem_bytes."""
    text = (CSRC / "narrow.cuh").read_text()
    assert re.search(r"kPositions = (\d+);", text).group(1) == \
        str(toeplitz.NARROW_POSITIONS)
    assert re.search(r"kSmemLimit = (\d+) \* 1024;", text).group(1) == \
        str(toeplitz.NARROW_SMEM_BYTES // 1024)
    assert "case 4:" in text and "case 8:" in text and "case 16:" in text
    assert "return 2 * window_chunks(G, kb, esize) * 16 +" in text
    assert "kPositions * (chunk * esize + 16);" in text
    assert [toeplitz.narrow_chunk(n) for n in (1, 4, 5, 8, 9, 16, 17, 32, 33,
                                               512)] == \
        [4, 4, 8, 8, 16, 16, 32, 32, 32, 32]
    # the conv1d model's narrow launches, bf16 and fp32: 14-40 KB a block.
    # Layer 0 (G = 4, N = 32): windows of 520 elements, 66 chunks (72, whole
    # groups); layer 7 (G = 32, N = 4): 4160 elements
    assert toeplitz.narrow_smem(4, 3, 32, 1, 2) == \
        2 * 72 * 16 + (384 + 32) * 4 + 128 * (64 + 16)
    assert toeplitz.narrow_smem(32, 3, 4, 1, 2) == \
        2 * 528 * 16 + (384 + 4) * 4 + 128 * (8 + 16)
    assert toeplitz.narrow_smem(4, 3, 32) == \
        2 * 136 * 16 + (384 + 32) * 4 + 128 * (128 + 16)
    assert toeplitz.narrow_smem(32, 3, 4, 4) == \
        2 * 1048 * 16 + (2 * 384 + 4) * 4 + 128 * (16 + 16)


# ------------------------------------------------------ the walks in numpy

def _fma_chain(a, w, k_order):
    """fp32 sums acc = fma(a[..., k], w[k], acc) over ``k_order`` from +0,
    each step rounded once to fp32 (the product of two fp32 values is exact
    in fp64)."""
    acc = np.zeros(a.shape[:-1] + w.shape[1:], np.float32)
    for k in k_order:
        acc = (acc.astype(np.float64) + a[..., k, None].astype(np.float64)
               * w[k].astype(np.float64)).astype(np.float32)
    return acc


def _split(v):
    """The bf16 hi / lo split of fp32 values (csrc/gemm.cuh split_hi_lo):
    hi the top 16 bits after adding half an ulp of bf16, lo v - hi rounded
    to bf16."""
    u = v.astype(np.float32).view(np.uint32)
    hi = ((u + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(np.float32)
    lo = torch.from_numpy((v - hi).astype(np.float32)).to(BF16).float()
    return hi, lo.numpy()


def _epilogue(acc, b, act):
    v = (acc + b.astype(np.float32)).astype(np.float32)
    if act == "relu":
        return np.maximum(v, np.float32(0))
    if act == "tanh":
        return np.tanh(v).astype(np.float32)
    return v


def narrow_walk(x, w, b, act, t_out, shift, passes=1, esize=4):
    """csrc/narrow.cuh narrow_kernel on numpy fp32 arrays whose elements
    the kernel stores in ``esize`` bytes: for each item (batch row, 128
    positions) and chunk of columns, the window of x copied as it lies in
    16-byte chunks on x's own grid into a buffer it starts ``d`` elements
    into, chunks wholly outside the batch row zero-filled, the elements
    outside it in the two that straddle its ends zeroed, the chunks placed
    by the swizzle; each position read from element ``d + p·G`` of the
    buffer; the block's columns of the taps; each position's chains in
    ascending k, four chains (hh, ll, hl, lh) for passes = 4."""
    B, nb, G = x.shape
    kb, _, N = w.shape
    K, P, length = kb * G, toeplitz.NARROW_POSITIONS, nb * G
    NC, per = toeplitz.narrow_chunk(N), 16 // esize
    span = (P + kb - 1) * G
    chunks = -(-(-(-span // per) + 1) // 8) * 8
    swz = np.arange(chunks) ^ ((np.arange(chunks) >> 3) & 7)
    assert sorted(swz) == list(range(chunks))
    # what a copy past the end of x reads: anything (here NaN), trimmed
    flat = np.concatenate([x.reshape(-1), np.full(per, np.nan, np.float32)])
    taps = w.reshape(K, N)
    y = np.zeros((B, t_out, N), np.float32)
    for bb in range(B):
        for t0 in range(0, t_out, P):
            fs = (t0 - shift) * G
            origin = bb * length + fs
            cb, d = divmod(origin, per)
            vs = max(fs, 0) - fs
            ve = max(min(fs + span, length) - fs, vs)
            buf = np.full((chunks, per), np.nan, np.float32)
            for q in range(chunks):
                lo = q * per - d
                if max(lo, vs) < min(lo + per, ve):       # meets the row
                    buf[swz[q]] = flat[(cb + q) * per:(cb + q + 1) * per]
                    for j in range(per):
                        if not vs <= lo + j < ve:
                            buf[swz[q], j] = 0
                else:
                    buf[swz[q]] = 0
            s = np.arange(d, d + span)
            window = buf[swz[s // per], s % per]
            rows = np.stack([window[p * G:p * G + K]
                             for p in range(min(P, t_out - t0))])
            assert not np.isnan(rows).any()
            for n0 in range(0, N, NC):
                wc = np.zeros((K, NC), np.float32)
                wc[:, :min(NC, N - n0)] = taps[:, n0:n0 + NC]
                if passes == 1:
                    acc = _fma_chain(rows, wc, range(K))
                else:
                    (xh, xl), (wh, wl) = _split(rows), _split(wc)
                    chains = [_fma_chain(a, c, range(K))
                              for a, c in ((xh, wh), (xl, wl), (xh, wl),
                                           (xl, wh))]
                    acc = ((chains[0] + chains[1]).astype(np.float32)
                           + (chains[2] + chains[3]).astype(np.float32))
                out = _epilogue(acc.astype(np.float32),
                                np.pad(b[n0:n0 + NC], (0, max(0, n0 + NC - N))),
                                act)
                y[bb, t0:t0 + len(rows), n0:n0 + NC] = out[:, :N - n0]
    return y


def toeplitz_rows(x, t_out, shift, window):
    """The implicit A of csrc/sgemm.cuh's Toeplitz operand, (B·t_out, k1 -
    k0), built copy by copy as the kernel stages it: row m = (b, t) starts
    at flat element f = (t - shift)·G + k0 of batch row b; the copy of k ..
    k + 3 takes elements f + k .. f + k + 3 where f + k lies in [0, nb·G)
    (unsigned compare, as the kernel does), and zeros otherwise."""
    B, nb, G = x.shape
    k0, k1 = window
    K, length = k1 - k0, nb * G
    flat = x.reshape(B, length)
    a = np.zeros((B * t_out, K), np.float32)
    for m in range(B * t_out):
        bb, t = divmod(m, t_out)
        f = (t - shift) * G + k0
        for k in range(0, K, 4):
            e = f + k
            if 0 <= e < length:        # (unsigned) e < nb·G
                a[m, k:k + 4] = flat[bb, e:e + 4]
    return a


def sgemm_walk(x, w, b, act, t_out, shift, window):
    """The fp32 kernel's product: the implicit A over the window, one FMA
    chain an output in k order (the slabs and tiles walk k in order), then
    bias and activation."""
    B, nb, G = x.shape
    kb, _, N = w.shape
    k0, k1 = window
    a = toeplitz_rows(x, t_out, shift, window)
    acc = _fma_chain(a, w.reshape(kb * G, N)[k0:k1], range(k1 - k0))
    return _epilogue(acc, b, act).reshape(B, t_out, N)


def _operands(seed, B, nb, G, kb, N, window=None):
    """Seeded fp32 operands; with ``window``, w zero outside its rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nb, G)).astype(np.float32)
    w = (rng.standard_normal((kb, G, N)) * 0.2).astype(np.float32)
    if window is not None:
        flat = w.reshape(kb * G, N)
        flat[:window[0]] = 0
        flat[window[1]:] = 0
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, w, b


def _jax(x, w, b, act, t_out, shift, passes=1):
    return np.asarray(jtoep.toeplitz_fwd(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), act, t_out, shift,
                                         passes))


def _ref(x, w, b, act, t_out, shift, passes=1):
    return toeplitz.toeplitz_fwd_ref(
        *(torch.from_numpy(a) for a in (x, w, b)), act, t_out, shift,
        passes).numpy()


# t_out below, equal to and above nb (nb = 9), at shift 0 and KB - 1
SHIFT_T = [(0, 5), (2, 9), (0, 13), (2, 13)]
WIDTHS = [4, 8, 24]


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("shift,t_out", SHIFT_T)
@pytest.mark.parametrize("G", WIDTHS)
@pytest.mark.parametrize("N", WIDTHS)
def test_the_two_walks_match_plain_and_the_jax_kernel(B, shift, t_out, G, N):
    kb, nb = 3, 9
    window = (4, kb * G - 4)
    x, w, b = _operands(B * 1000 + G * 10 + N, B, nb, G, kb, N, window)
    want = _jax(x, w, b, "tanh", t_out, shift)
    ref = _ref(x, w, b, "tanh", t_out, shift)
    np.testing.assert_allclose(ref, want, **FWD)
    if min(G, N) < toeplitz.NARROW_BELOW:
        got = narrow_walk(x, w, b, "tanh", t_out, shift)
        np.testing.assert_allclose(got, want, **FWD)
        np.testing.assert_allclose(got, ref, **FWD)
    for win in (window, (0, kb * G)):
        got = sgemm_walk(x, w, b, "tanh", t_out, shift, win)
        np.testing.assert_allclose(got, want, **FWD)
        np.testing.assert_allclose(got, ref, **FWD)


@pytest.mark.parametrize("G,N,esize", [(4, 24, 4), (4, 24, 2), (3, 8, 4),
                                       (24, 4, 2), (6, 5, 4), (5, 6, 2)])
def test_the_narrow_walk_in_four_passes_and_bf16_chunks(G, N, esize):
    """passes = 4 (fp32), and chunks of 8 values (bf16's 16 bytes) whose
    grid cuts the batch rows elsewhere; G no multiple of 4."""
    x, w, b = _operands(G * 7 + N, 5, 11, G, 3, N)
    for passes in (1, 4):
        got = narrow_walk(x, w, b, "relu", 12, 1, passes, esize)
        np.testing.assert_allclose(got, _ref(x, w, b, "relu", 12, 1, passes),
                                   **FWD)
        np.testing.assert_allclose(got, _jax(x, w, b, "relu", 12, 1, passes),
                                   **FWD)


@pytest.mark.parametrize("esize", [4, 2])
def test_an_item_past_the_batch_row_reads_zeros(esize):
    """t_out = 150 past nb = 20: the second item of each batch row (t0 =
    128) lies wholly past it, and in bf16 its window starts half a chunk
    into one (d = 4) that holds none of the row: a zero fill, not a copy."""
    x, w, b = _operands(7, 3, 20, 4, 3, 8)
    got = narrow_walk(x, w, b, "tanh", 150, 1, 1, esize)
    np.testing.assert_allclose(got, _ref(x, w, b, "tanh", 150, 1), **FWD)
    np.testing.assert_allclose(got[:, 22:], np.broadcast_to(
        np.tanh(b), (3, 128, 8)), **FWD)


def test_the_narrow_walk_covers_several_blocks_and_chunks():
    """t_out = 300 over three blocks of 128 positions, N = 40 over two
    column chunks of 32 (G = 4)."""
    x, w, b = _operands(5, 2, 299, 4, 3, 40)
    got = narrow_walk(x, w, b, "none", 300, 1)
    np.testing.assert_allclose(got, _ref(x, w, b, "none", 300, 1), **FWD)


def test_skipping_the_zero_rows_leaves_every_chain_unchanged():
    """The fp32 kernel's chain over the window [k0, k1) and the first
    version's over the whole packed stack, whose rows outside the window
    are zero, give equal bits (fma(x, 0, s) == s, and s is never -0): at
    conv1d.ini's encoder layer 1 geometry, narrowed (G = 128 → the window
    of conv1d_window), and on operands built to cancel."""
    L, K, cin, cout, stride = 64, 9, 8, 12, 4
    rng = np.random.default_rng(3)
    xt = torch.from_numpy(rng.standard_normal((3, L, cin)).astype(np.float32))
    wt = torch.from_numpy(
        rng.standard_normal((K, cin, cout)).astype(np.float32))
    xf, wpad, t_out, shift = conv.pack_conv1d(xt, wt, stride)
    window = conv.conv1d_window(L, K, cin, stride)
    assert window == (16, 88) and wpad.shape == (3, 32, cout)
    flat = wpad.reshape(-1, cout).numpy()
    assert not flat[:window[0]].any() and not flat[window[1]:].any()
    a_full = toeplitz_rows(xf.numpy(), t_out, shift, (0, flat.shape[0]))
    a_win = toeplitz_rows(xf.numpy(), t_out, shift, window)
    assert np.array_equal(a_full[:, window[0]:window[1]], a_win)
    full = _fma_chain(a_full, flat, range(flat.shape[0]))
    part = _fma_chain(a_win, flat[window[0]:window[1]],
                      range(window[1] - window[0]))
    assert np.array_equal(full.view(np.uint32), part.view(np.uint32))
    # sums that cancel to zero stay +0 through the zero rows
    a = np.array([[1.5, -1.5, 0.0, 7.0]], np.float32)
    taps = np.array([[2.0], [2.0], [0.0], [0.0]], np.float32)
    out = _fma_chain(a, taps, range(4))
    assert out[0, 0] == 0 and not np.signbit(out[0, 0])
    np.testing.assert_allclose(
        sgemm_walk(xf.numpy(), wpad.numpy(), np.zeros(cout, np.float32),
                   "none", t_out, shift, window),
        conv.conv1d_pallas(xt, wt, torch.zeros(cout), stride).numpy(), **FWD)


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 6), nb=st.integers(1, 40), g4=st.integers(1, 64),
       t_out=st.integers(1, 60), kb=st.integers(1, 5), data=st.data())
def test_a_copy_of_the_implicit_a_lies_wholly_in_or_out_of_its_row(
        B, nb, g4, t_out, kb, data):
    """With G and the window's origin multiples of 4, every 16-byte copy
    the fp32 kernel stages (four k from a multiple of 4, at flat element e
    = (t - shift)·G + k0 + k) has all four elements inside the batch row
    [0, nb·G) or none: the zero fill is then exactly the rows outside."""
    G = 4 * g4
    shift = data.draw(st.integers(0, kb - 1))
    k0 = 4 * data.draw(st.integers(0, (kb * G - 4) // 4))
    k_len = 4 * data.draw(st.integers(1, (kb * G - k0) // 4))
    t = data.draw(st.integers(0, t_out - 1))
    k = 4 * data.draw(st.integers(0, k_len // 4 - 1))
    e = (t - shift) * G + k0 + k
    inside = [0 <= e + j < nb * G for j in range(4)]
    assert all(inside) or not any(inside)
    assert toeplitz.takes_sgemm(F32, B, nb, t_out, G, 8, (k0, k0 + k_len))


def test_a_tap_width_no_multiple_of_4_may_straddle_the_batch_row():
    """Why the fp32 kernel takes G % 4 == 0 only: G = 6 puts a copy across
    the row's end."""
    nb, G, shift = 3, 6, 0
    starts = [(t - shift) * G + k for t in range(4) for k in range(0, 12, 4)]
    assert any(0 <= e < nb * G <= e + 3 for e in starts)
    assert not toeplitz.takes_sgemm(F32, 2, nb, 4, G, 8, (0, 12))

"""The block-Toeplitz product, the convolution primitive of the conv1d VAE:
the CUDA counterpart of the JAX package's ``ops/pallas_toeplitz.py``.

    toeplitz_fwd(x, w, b, act, t_out, shift)[b, t]
        = act( Σ_j  x[b, t + j - shift] @ w[j] + b )      (rows outside ≡ 0)

``x`` is a flat-stream view of the signal, ``(B, nb, G)``; ``w`` is a stack
of ``KB`` taps ``(KB, G, N)``; the output is ``(B, t_out, N)`` in x's
dtype.  Each output row reads ``KB`` consecutive G-blocks of its batch row,
and blocks outside ``[0, nb)`` read as zero, which is how SAME padding is
expressed: through ``shift``, with no padded copy.  Both convolution
directions map onto it (``ops/conv.py``).

Two hand-written kernels run the whole op as one implicit GEMM of
``B·t_out`` rows against ``w`` viewed as ``(KB·G, N)``:

* bf16 operands with ``passes = 1`` that TMA can address (``G`` and ``N``
  multiples of 8, 16-byte aligned pointers: :func:`takes_tensor_cores`)
  take the tensor-core kernel (``csrc/wgmma.cuh``, its Toeplitz tile walk):
  each consumer warpgroup's 64 output rows are one box of ``b_half`` batch
  rows by ``t_half`` positions (:func:`tile_plan`), and tap ``j``'s rows
  of A are the same box of x shifted by ``j - shift`` positions, loaded by
  TMA with the rows outside ``[0, nb)`` and past the batch zero-filled;
* everything else the first version on the CUDA cores
  (``csrc/toeplitz.cu``).  Operand modes: bf16 with fp32 accumulation; fp32
  with ``passes = 1``, IEEE fp32; fp32 with ``passes = 4``, every product
  formed from the bf16 hi/lo split of both operands as ``(hh + ll) + (hl +
  lh)``.

``passes`` is an explicit argument here: the JAX package reads it from the
ambient ``jax.default_matmul_precision``, and this package has no ambient
tier.  The two kernels add the same fp32 products in another order, so the
output's bits follow the choice (as in ``ops/tensor_cores.py``).

:func:`toeplitz_matmul` is the differentiable op.  It is closed under
differentiation: ``dx`` is the same kernel on the cotangent with the taps
reversed and the channels transposed (``shift = KB - 1 - shift``, ``t_out =
nb``, zero bias); ``dW[j]`` is one plain product per tap on the static row
ranges of :func:`tap_ranges`, and ``db`` a plain sum — both outside the
kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores
from rawaudiovae_kelsey_tpu_torch.ops.linear import (
    ACT_CODES,
    act_backward,
    apply_act,
)
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    _f,
    operand_dtype,
    require,
    split_hi_lo,
)

Tensor = torch.Tensor
_INT_MAX = 2 ** 31 - 1


def tap_ranges(kb: int, shift: int, t: int, nb: int
               ) -> List[Tuple[int, int, int, int]]:
    """Static ``(tap j, offset o, a, e)``: output rows ``[a, e)`` read input
    rows ``[a + o, e + o)`` through tap ``j``; rows outside read zeros.
    Taps wholly out of range are left out."""
    out = []
    for j in range(kb):
        o = j - shift
        a = max(0, -o)
        e = min(t, nb - o)
        if e > a:
            out.append((j, o, a, e))
    return out


def tile_plan(t_out: int) -> Tuple[int, int]:
    """The tensor-core kernel's half tile for ``t_out`` output positions a
    batch row → ``(t_half, b_half)``: each consumer warpgroup's 64 rows are
    ``b_half`` whole batch rows of ``t_half = t_out`` positions where
    ``t_out < 64`` (the conv1d model's 16 and 4: every row used), else 64
    positions of one batch row.  A box never runs from one batch row into
    the next, and its dims (64 channels, ``t_half``, ``b_half``) stay
    within TMA's 256."""
    if t_out >= 64:
        return 64, 1
    return t_out, 64 // t_out


def tile_halves(B: int, t_out: int, t_half: int, b_half: int) -> int:
    """How many half tiles (warpgroup boxes) cover the ``(B, t_out)``
    output: ``ceil(t_out / t_half)`` along a batch row times ``ceil(B /
    b_half)``; tile row ``h // 2`` holds halves ``h`` and ``h + 1``."""
    return -(-t_out // t_half) * -(-B // b_half)


def half_origin(h: int, t_out: int, t_half: int, b_half: int
                ) -> Tuple[int, int]:
    """Half tile ``h`` → its first batch row and position ``(b0, t0)``: the
    halves of one group of ``b_half`` batch rows are consecutive
    (``csrc/wgmma.cuh`` ToeplitzTiles)."""
    n_t = -(-t_out // t_half)
    return (h // n_t) * b_half, (h % n_t) * t_half


def k_step(kb: int, G: int) -> Tuple[int, int]:
    """k-step ``kb`` of the tensor-core kernel → ``(tap j, channel g0)``:
    the A box at ``(g0, t0 - shift + j, b0)`` meets the rows ``j·G + g0``
    onwards of w viewed as ``(KB·G, N)``.  A tap takes ``ceil(G / 64)``
    steps of 64 channels."""
    steps = -(-G // 64)
    return kb // steps, (kb % steps) * 64


def takes_tensor_cores(dtype: torch.dtype, B: int, nb: int, t_out: int,
                       G: int, N: int, passes: int = 1,
                       aligned: bool = True) -> bool:
    """Whether a Toeplitz product runs on the tensor-core kernel:
    ``tensor_cores.takes_tensor_cores`` with the contraction ``G`` a tap
    and output width ``N`` (row pitches of x, w and y of 16 bytes), one
    pass, and an input with rows (``nb >= 1``)."""
    return (passes == 1 and nb >= 1 and tensor_cores.takes_tensor_cores(
        dtype, B * t_out, G, N, aligned))


def check_passes(dtype: torch.dtype, passes: int) -> None:
    """Raise unless ``passes`` is 1, or 4 with fp32 operands."""
    if passes not in (1, 4) or (passes == 4 and dtype != torch.float32):
        raise ValueError(f"passes = {passes} with {dtype} operands: the "
                         "product takes 1 pass, or 4 with fp32 operands")


def _t_out(x, w, t_out: Optional[int]) -> int:
    return x.shape[1] - w.shape[0] + 1 if t_out is None else t_out


def toeplitz_fwd_ref(x, w, b, act: str = "none", t_out: Optional[int] = None,
                     shift: int = 0, passes: int = 1) -> Tensor:
    """Plain version of :func:`toeplitz_fwd`: one product per tap over its
    valid rows, accumulated in fp32 in tap order."""
    check_passes(x.dtype, passes)
    B, nb, _ = x.shape
    kb, _, N = w.shape
    t = _t_out(x, w, t_out)
    acc = torch.zeros((B, t, N), dtype=torch.float32, device=x.device)
    for j, o, a, e in tap_ranges(kb, shift, t, nb):
        xs, wj = _f(x[:, a + o:e + o]), _f(w[j])
        if passes == 4:
            xh, xl = split_hi_lo(xs)
            wh, wl = split_hi_lo(wj)
            p = (xh @ wh + xl @ wl) + (xh @ wl + xl @ wh)
        else:
            p = xs @ wj
        acc[:, a:e] += p
    return apply_act(act, acc + _f(b)).to(x.dtype)


def kernel_device(x: Tensor) -> torch.device:
    """The device a launch for ``x`` runs on; raises for anything but a
    CUDA tensor (CPU tensors never reach here)."""
    if x.device.type != "cuda":
        raise ValueError("toeplitz_fwd: the kernel runs on CUDA tensors, "
                         f"got {x.device}")
    return x.device


def toeplitz_fwd(x, w, b, act: str = "none", t_out: Optional[int] = None,
                 shift: int = 0, passes: int = 1,
                 kernel: str = "auto") -> Tensor:
    """``act(Σ_j x[:, t+j-shift, :] @ w[j] + b)``: x ``(B, nb, G)``, w
    ``(KB, G, N)``, b ``(N,)`` → ``(B, t_out, N)``; input rows out of range
    contribute zero.  ``t_out`` defaults to ``nb - KB + 1``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py``
    ``toeplitz_fwd``.  CUDA: one launch of one of two hand-written
    kernels, chosen by :func:`takes_tensor_cores`: the tensor-core kernel
    (``csrc/wgmma.cuh``) or the first version (``csrc/toeplitz.cu``).
    ``kernel`` names one instead (``tensor_cores.KERNEL_CODES``); the
    tensor-core kernel on operands it cannot take raises.  One call counts
    once in ``launches`` and in ``tensor_core_launches`` too when that
    kernel ran."""
    tensor_cores.check_name("toeplitz_fwd", kernel)
    if x.device.type == "cpu":
        return toeplitz_fwd_ref(x, w, b, act, t_out, shift, passes)
    dev = kernel_device(x)
    if act not in ACT_CODES:
        raise ValueError(f"toeplitz_fwd: unknown activation {act!r}")
    dt = operand_dtype(x, "toeplitz_fwd: x")
    check_passes(dt, passes)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"toeplitz_fwd: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}: expected (B, nb, G) and "
                         "(KB, G, N)")
    B, nb, G = x.shape
    kb, _, N = w.shape
    t = _t_out(x, w, t_out)
    if t < 0 or kb < 1 or G < 1 or not 0 <= shift < kb:
        raise ValueError(f"toeplitz_fwd: t_out {t}, KB {kb}, G {G}, shift "
                         f"{shift}: expected t_out >= 0, KB, G >= 1 and "
                         "0 <= shift < KB")
    if max(B * t, nb * G, (kb + max(t, nb)) * G) > _INT_MAX:
        raise ValueError("toeplitz_fwd: B·t_out, nb·G and (KB + t_out)·G "
                         "must fit a 32-bit int")
    require(x, "x", (B, nb, G), dev, dt)
    require(w, "w", (kb, G, N), dev, dt)
    require(b, "b", (N,), dev, dt)
    aligned = tensor_cores.pointers_aligned(x, w, b)
    code = tensor_cores.resolve(
        "toeplitz_fwd", kernel,
        takes_tensor_cores(dt, B, nb, t, G, N, passes, aligned),
        lambda: f"{dt}, passes = {passes}, x {tuple(x.shape)}, w "
                f"{tuple(w.shape)}, t_out = {t}, aligned = {aligned}")
    y = torch.empty((B, t, N), device=dev, dtype=dt)
    if y.numel():
        t_half = b_half = tile = 0
        if code:
            t_half, b_half = tile_plan(t)
            halves = tile_halves(B, t, t_half, b_half)
            # two halves of TILE_M / 2 rows a tile
            tile = tensor_cores.tile(code, dev,
                                     halves * (tensor_cores.TILE_M // 2), N)
        _build.launch("rvk_toeplitz_fwd", dev, x, w, b, y, B, nb, G, kb, N,
                      t, shift, ACT_CODES[act], passes, DTYPE_CODES[dt],
                      t_half, b_half, tile, code)
        toeplitz_fwd.launches += 1
        toeplitz_fwd.tensor_core_launches += bool(code)
    return y


toeplitz_fwd.launches = 0
toeplitz_fwd.tensor_core_launches = 0


class ToeplitzMatmul(torch.autograd.Function):
    """``(x, w, b, act, t_out, shift, passes) → toeplitz_fwd(...)``; saves
    ``(x, w, y)``.  Backward: ``dx`` through :func:`toeplitz_fwd` again,
    ``dw`` and ``db`` plain (``pallas_toeplitz.py`` ``_tm_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, b, act, t_out, shift, passes):
        y = toeplitz_fwd(x, w, b, act, t_out, shift, passes)
        ctx.save_for_backward(x, w, y)
        ctx.act, ctx.shift, ctx.passes = act, shift, passes
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        kb, nb, t = w.shape[0], x.shape[1], y.shape[1]
        da = act_backward(ctx.act, y, dy).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            # dx[u] = Σ_j da[u - (j - shift)] @ w[j]ᵀ: with the taps
            # reversed (j' = kb-1-j) a shifted Toeplitz product over da
            wrev = w.flip(0).transpose(1, 2).contiguous()     # (KB, N, G)
            zero = torch.zeros((w.shape[1],), dtype=da.dtype,
                               device=da.device)
            dx = toeplitz_fwd(da, wrev, zero, "none", nb,
                              kb - 1 - ctx.shift, ctx.passes).to(x.dtype)
        # dW[j] = Σ_t x[t + j - shift]ᵀ da[t] over the valid rows: one
        # plain product per tap, accumulated in fp32
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for j, o, a, e in tap_ranges(kb, ctx.shift, t, nb):
            dw[j] = torch.einsum("btg,btn->gn", _f(x[:, a + o:e + o]),
                                 _f(da[:, a:e]))
        db = _f(da).sum((0, 1))
        return dx, dw.to(w.dtype), db.to(w.dtype), None, None, None, None


def toeplitz_matmul(x, w, b, act: str = "none", t_out: Optional[int] = None,
                    shift: int = 0, passes: int = 1) -> Tensor:
    """Differentiable fused block-Toeplitz product (relu | tanh | none)."""
    return ToeplitzMatmul.apply(x, w, b, act, t_out, shift, passes)

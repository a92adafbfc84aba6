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

Four hand-written kernels run it, one launch a call (and the split pass
before the 4-pass tensor-core form), chosen in this order:

* bf16 operands with ``passes = 1`` that TMA can address (``G`` and ``N``
  multiples of 8, 16-byte aligned pointers: :func:`takes_tensor_cores`)
  take the tensor-core kernel (``csrc/wgmma.cuh``, its Toeplitz tile walk):
  the op as one implicit GEMM of ``B·t_out`` rows against ``w`` viewed as
  ``(KB·G, N)``, each consumer warpgroup's 64 output rows one box of
  ``b_half`` batch rows by ``t_half`` positions (:func:`tile_plan`), tap
  ``j``'s rows of A the same box of x shifted by ``j - shift`` positions,
  loaded by TMA with the rows outside ``[0, nb)`` and past the batch
  zero-filled; fp32 operands with ``passes = 4`` and the same widths and
  alignment take the same walk on their bf16 halves: the split pass
  (``csrc/split.cuh``) writes x's and w's hi and lo halves to a workspace
  allocated here, and each stage is multiplied four ways into four fp32
  accumulators added ``(hh + ll) + (hl + lh)`` before the bias and the
  activation (``FourPassRows``, 128 x 64 tiles, fp32 out);
* a tap width ``G`` or an output width ``N`` below 8 (:func:`takes_narrow`:
  the conv1d model's first and last layers and the last one's ``dx``), in
  either dtype and pass count, the narrow-channel kernel
  (``csrc/narrow.cuh``): a block walks items of 128 output positions,
  copying the window of x the next one reads while each thread computes
  one position's row of this one;
* fp32 operands with ``passes = 1``, ``G``, ``N`` and the contraction
  window's origin and length multiples of 4 and 16-byte aligned pointers
  (:func:`takes_sgemm`), the register-tiled fp32 kernel
  (``csrc/sgemm.cuh``) with the implicit A copied 16 bytes at a time;
* everything else the first version on the CUDA cores
  (``csrc/toeplitz.cu``).  Operand modes: bf16 with fp32 accumulation; fp32
  with ``passes = 1``, IEEE fp32; fp32 with ``passes = 4``, every product
  formed from the bf16 hi/lo split of both operands as ``(hh + ll) + (hl +
  lh)``.

The narrow and fp32 kernels compute each output as the first version does,
one fp32 FMA chain over the contraction in order, so the three give equal
bits; the tensor-core kernel adds the same products in another order (in
four passes each pass's sum over all taps, where the first version and the
plain version add the four passes of each tap).

``window = (k0, k1)``: the rows of ``w`` viewed as ``(KB·G, N)`` outside
``[k0, k1)`` are zero, a promise of the caller (``ops/conv.py``: the
convolution's weight placed in a zero tap stack).  The fp32 kernel then
contracts only the window; the function, and so every other kernel and the
plain version, is the same.

``passes`` is an argument here: the JAX package reads it from the ambient
``jax.default_matmul_precision``, and upgrades one pass on fp32 operands to
four under ``high`` (``pallas_toeplitz.py:177-182``).  This package carries
the tier as an argument instead: a train or eval step under ``high`` binds
``passes =`` :data:`HIGH_PASSES` to the op-level model functions of
``ops/conv.py``, which declare it (``models/registry.py`` ``under_tier``)
and pass it down to here and to ``dx``; a call outside a step keeps the
pass count it names, one by default.

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

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores
from rawaudiovae_kelsey_tpu_torch.ops.linear import (
    ACT_CODES,
    act_backward,
    apply_act,
)
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    SPLIT_ROWS,
    _f,
    operand_dtype,
    require,
    split_hi_lo,
)

Tensor = torch.Tensor
_INT_MAX = 2 ** 31 - 1
# the pass count a train or eval step under ``high`` binds to the op-level
# convolutions (fp32 operands: JAX's upgrade, ``pallas_toeplitz.py:177``)
HIGH_PASSES = 4
# the 4-pass tensor-core form: its tile width (four accumulators of 128 x
# 64 take 128 registers a thread, csrc/wgmma.cuh), and the most rows of x
# viewed as (B·nb, G) or of w as (KB·G, N) the split pass takes (its grid's
# y of 65535 blocks of SPLIT_ROWS rows)
FOUR_PASS_WIDTH = 64
SPLIT_MAX_ROWS = 65535 * SPLIT_ROWS


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
                       G: int, N: int, passes: int = 1, aligned: bool = True,
                       kb: int = 1) -> bool:
    """Whether a Toeplitz product runs on the tensor-core kernel:
    ``tensor_cores.takes_tensor_cores`` with the contraction ``G`` a tap
    and output width ``N`` (row pitches of x, w and y of 16 bytes) and an
    input with rows (``nb >= 1``), for bf16 operands in one pass or fp32
    ones in four, whose bf16 halves it multiplies; in four passes also at
    most :data:`SPLIT_MAX_ROWS` rows of x viewed as ``(B·nb, G)`` and of
    the ``kb`` taps viewed as ``(KB·G, N)``."""
    halves = passes == 4 and dtype == torch.float32
    if halves and max(B * nb, kb * G) > SPLIT_MAX_ROWS:
        return False
    return ((passes == 1 or halves) and nb >= 1
            and tensor_cores.takes_tensor_cores(
                torch.bfloat16 if halves else dtype, B * t_out, G, N,
                aligned))


# the narrow-channel kernel (csrc/narrow.cuh): the widths it takes (G or N
# below this), the output positions of a work item, the output columns a
# thread takes (the chunk: the least of these that holds N, else the
# largest, the grid walking N in chunks), and the shared memory the rule
# allows a block (narrow_smem)
NARROW_BELOW = 8
NARROW_POSITIONS = 128
NARROW_CHUNKS = (4, 8, 16, 32)
NARROW_SMEM_BYTES = 64 * 1024
# the fp32 kernel's grid holds the tile rows in its y (at most 65535): rows
# of the smallest tile, 64, times that
SGEMM_MAX_ROWS = 65535 * 64


def narrow_rows(dtype: torch.dtype) -> int:
    """The narrow kernel's output positions a thread sums (its ``t_half``
    argument): two for bf16, each tap read once for both (a block of 64
    threads), one for fp32 (and its four passes, whose sixteen chains a
    position fill the registers).  On an H100, at the conv1d model's
    narrow launches, two a thread made bf16 layer 7 faster and left layer 0
    as it was, and made fp32 layer 7 slower (``chip_smoke.py`` phase 3e's
    narrow sweep; PERF.md section 6)."""
    return 2 if dtype == torch.bfloat16 else 1


def narrow_chunk(N: int) -> int:
    """The narrow kernel's output columns a thread for output width ``N``:
    the least of :data:`NARROW_CHUNKS` that holds ``N``, else the largest
    (the grid's y then walks ``N`` in chunks)."""
    return next((c for c in NARROW_CHUNKS if c >= N), NARROW_CHUNKS[-1])


def narrow_smem(G: int, kb: int, N: int, passes: int = 1,
                esize: int = 4) -> int:
    """Bytes of shared memory a narrow block takes (``csrc/narrow.cuh``
    ``smem_bytes``) for elements of ``esize`` bytes: two buffers for the
    window of x an item's :data:`NARROW_POSITIONS` positions read, ``(128 +
    KB - 1)·G`` elements copied as they lie in 16-byte chunks (one more for
    the window's offset, whole groups of 8); the block's chunk of every tap,
    ``KB·G·chunk`` fp32 values, twice (hi and lo) for ``passes = 4``; the
    chunk of the bias; the output rows at a pitch of the chunk + 16
    bytes."""
    chunk = narrow_chunk(N)
    per = 16 // esize
    chunks = -(-(-(-(NARROW_POSITIONS + kb - 1) * G // per) + 1) // 8) * 8
    return (2 * chunks * 16
            + ((2 if passes == 4 else 1) * kb * G * chunk + chunk) * 4
            + NARROW_POSITIONS * (chunk * esize + 16))


def takes_narrow(dtype: torch.dtype, B: int, nb: int, t_out: int, G: int,
                 N: int, kb: int, passes: int = 1,
                 aligned: bool = True) -> bool:
    """Whether a Toeplitz product runs on the narrow-channel kernel: fp32
    or bf16 (``passes = 4`` with fp32 only), something to compute, an
    input with rows, a tap width ``G`` or output width ``N`` below
    :data:`NARROW_BELOW`, 16-byte aligned pointers (x is copied 16 bytes
    at a time), and a block's window buffers, taps and output rows within
    :data:`NARROW_SMEM_BYTES` (:func:`narrow_smem`).  At batch 4096 on an
    H100 it beat the first version and the fp32 kernel at the conv1d
    model's first and last layers and their ``dx`` (``chip_smoke.py``
    phase 3e sweeps the forms there; PERF.md section 6)."""
    return (dtype in (torch.float32, torch.bfloat16)
            and (passes == 1 or dtype == torch.float32)
            and B * t_out > 0 and nb >= 1 and N >= 1
            and min(G, N) < NARROW_BELOW and aligned
            and narrow_smem(G, kb, N, passes, dtype.itemsize)
            <= NARROW_SMEM_BYTES)


def takes_sgemm(dtype: torch.dtype, B: int, nb: int, t_out: int, G: int,
                N: int, window: Tuple[int, int], passes: int = 1,
                aligned: bool = True) -> bool:
    """Whether a Toeplitz product runs on the fp32 kernel: one pass, an
    input with rows, ``tensor_cores.takes_sgemm`` on the ``B·t_out`` rows,
    the contraction window ``(k0, k1)`` and ``N``, the tap width ``G`` and
    the window's origin multiples of 4 too (a 16-byte copy of the implicit
    A then lies wholly inside its batch row or wholly outside it), and at
    most :data:`SGEMM_MAX_ROWS` rows."""
    k0, k1 = window
    return (passes == 1 and nb >= 1 and G % tensor_cores.SGEMM_ALIGN_F32 == 0
            and k0 % tensor_cores.SGEMM_ALIGN_F32 == 0
            and B * t_out <= SGEMM_MAX_ROWS
            and tensor_cores.takes_sgemm(dtype, B * t_out, k1 - k0, N,
                                         aligned))


# what the tensor-core kernel takes, in tensor_cores.resolve's error
TAKES_TENSOR_CORES = (f"bf16 operands with one pass or fp32 ones with four, "
                      f"G and N multiples of {tensor_cores.TMA_ALIGN_BF16} "
                      f"and 16-byte aligned pointers")
# and the two newer forms
TAKES_NARROW = (f"fp32 or bf16 operands with G or N below {NARROW_BELOW}, "
                f"16-byte aligned pointers and a block's window and taps "
                f"within {NARROW_SMEM_BYTES} bytes")
TAKES_SGEMM = ("fp32 operands with one pass, G, N and the window's origin "
               "and length multiples of 4 and 16-byte aligned pointers")


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


@spanned("rvk.row17.toeplitz_fwd")
def toeplitz_fwd(x, w, b, act: str = "none", t_out: Optional[int] = None,
                 shift: int = 0, passes: int = 1, kernel: str = "auto",
                 window: Optional[Tuple[int, int]] = None) -> Tensor:
    """``act(Σ_j x[:, t+j-shift, :] @ w[j] + b)``: x ``(B, nb, G)``, w
    ``(KB, G, N)``, b ``(N,)`` → ``(B, t_out, N)``; input rows out of range
    contribute zero.  ``t_out`` defaults to ``nb - KB + 1``.  ``window``:
    ``(k0, k1)``, the rows of ``w`` viewed as ``(KB·G, N)`` outside which it
    is zero (the module docstring).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py``
    ``toeplitz_fwd``.  CUDA: one launch of one of four hand-written
    kernels, the first that takes the operands of the tensor-core kernel
    (:func:`takes_tensor_cores`), the narrow-channel one
    (:func:`takes_narrow`), the fp32 one (:func:`takes_sgemm`) and the
    first version.  ``kernel`` names one instead
    (``tensor_cores.KERNEL_CODES``); a kernel named for operands it cannot
    take raises.  fp32 operands in four passes on the tensor cores are
    split first into a bf16 workspace allocated here.  One call counts once
    in ``launches``, and in ``tensor_core_launches`` (one pass),
    ``split_launches`` (four passes on the tensor cores),
    ``narrow_launches`` or ``sgemm_launches`` too when that kernel ran."""
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
    k0, k1 = (0, kb * G) if window is None else window
    if not 0 <= k0 < k1 <= kb * G:
        raise ValueError(f"toeplitz_fwd: window {window} against KB·G = "
                         f"{kb * G}: expected 0 <= k0 < k1 <= KB·G")
    require(x, "x", (B, nb, G), dev, dt)
    require(w, "w", (kb, G, N), dev, dt)
    require(b, "b", (N,), dev, dt)
    aligned = tensor_cores.pointers_aligned(x, w, b)
    code = tensor_cores.resolve(
        "toeplitz_fwd", kernel,
        takes_tensor_cores(dt, B, nb, t, G, N, passes, aligned, kb),
        lambda: f"{dt}, passes = {passes}, x {tuple(x.shape)}, w "
                f"{tuple(w.shape)}, t_out = {t}, window ({k0}, {k1}), "
                f"aligned = {aligned}",
        takes_sgemm(dt, B, nb, t, G, N, (k0, k1), passes, aligned),
        takes=TAKES_TENSOR_CORES,
        fits_narrow=takes_narrow(dt, B, nb, t, G, N, kb, passes, aligned),
        takes_sgemm=TAKES_SGEMM, takes_narrow=TAKES_NARROW)
    y = torch.empty((B, t, N), device=dev, dtype=dt)
    if y.numel():
        t_half = b_half = tile = 0
        workspace = None
        split = code == tensor_cores.TENSOR_CORES and passes == 4
        if split:
            t_half, b_half = tile_plan(t)
            tile = FOUR_PASS_WIDTH
            # x's hi and lo halves, then w's
            workspace = torch.empty((2 * (B * nb * G + kb * G * N),),
                                    device=dev, dtype=torch.bfloat16)
        elif code == tensor_cores.TENSOR_CORES:
            t_half, b_half = tile_plan(t)
            halves = tile_halves(B, t, t_half, b_half)
            # two halves of TILE_M / 2 rows a tile
            tile = tensor_cores.tile(code, dev,
                                     halves * (tensor_cores.TILE_M // 2), N)
        elif code == tensor_cores.SGEMM:
            tile = tensor_cores.SGEMM_TILES.index(
                tensor_cores.sgemm_whole_tile(B * t, N,
                                              tensor_cores.sm_count(dev)))
        elif code == tensor_cores.NARROW:
            t_half, tile = narrow_rows(dt), narrow_chunk(N)
        _build.launch("rvk_toeplitz_fwd", dev, x, w, b, y, workspace, B, nb,
                      G, kb, N, t, shift, ACT_CODES[act], passes,
                      DTYPE_CODES[dt], k0, k1 - k0, t_half, b_half, tile,
                      code)
        toeplitz_fwd.launches += 1
        toeplitz_fwd.tensor_core_launches += (
            code == tensor_cores.TENSOR_CORES and not split)
        toeplitz_fwd.split_launches += split
        toeplitz_fwd.sgemm_launches += code == tensor_cores.SGEMM
        toeplitz_fwd.narrow_launches += code == tensor_cores.NARROW
    return y


toeplitz_fwd.launches = 0
toeplitz_fwd.tensor_core_launches = 0
toeplitz_fwd.split_launches = 0
toeplitz_fwd.sgemm_launches = 0
toeplitz_fwd.narrow_launches = 0


class ToeplitzMatmul(torch.autograd.Function):
    """``(x, w, b, act, t_out, shift, passes, window) → toeplitz_fwd(...)``;
    saves ``(x, w, y)``.  Backward: ``dx`` through :func:`toeplitz_fwd`
    again (no window: the reversed taps spread w's zero rows over the
    output), ``dw`` and ``db`` plain (``pallas_toeplitz.py``
    ``_tm_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, b, act, t_out, shift, passes, window=None):
        y = toeplitz_fwd(x, w, b, act, t_out, shift, passes, window=window)
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
        return (dx, dw.to(w.dtype), db.to(w.dtype), None, None, None, None,
                None)


def toeplitz_matmul(x, w, b, act: str = "none", t_out: Optional[int] = None,
                    shift: int = 0, passes: int = 1,
                    window: Optional[Tuple[int, int]] = None) -> Tensor:
    """Differentiable fused block-Toeplitz product (relu | tanh | none);
    ``window`` as for :func:`toeplitz_fwd`."""
    return ToeplitzMatmul.apply(x, w, b, act, t_out, shift, passes, window)

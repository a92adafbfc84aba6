"""Which hand-written kernel a product takes: the first version on the CUDA
cores, the bf16 tensor-core form (``csrc/wgmma.cuh``) or the fp32
register-tiled form (``csrc/sgemm.cuh``); and the tile of the latter two.

Sixteen ops have a tensor-core form: :func:`~rawaudiovae_kelsey_tpu_torch.
ops.linear.linear_fwd`, :func:`~rawaudiovae_kelsey_tpu_torch.ops.linear.
linear_ksplit_fwd`, :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.matmul_nt`
and its gated forms :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.
matmul_nt_mask` and :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.
matmul_nt2_mask` (two products joined along k, the contraction ``n`` a
pair's), :func:`~rawaudiovae_kelsey_tpu_torch.ops.toeplitz.toeplitz_fwd`
(whose contraction is ``G`` a tap and output width ``N``),
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.encoder_fwd`,
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.decoder_fwd` (two products
each, every one of which must fit),
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.dec_bwd_fused` (dh3 and dz must
fit), :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.enc_bwd_dw1` (dh, two
products joined along k, must fit, and ``seg`` be a multiple of 8) and
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.grad_accum` and
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.grad_accum2` (their rows of 16
bytes; ``grad_accum2`` 's two weight gradients in one launch); the last
four contract the batch in a weight gradient, split into slices by
:func:`wgrad_plan`; and the fused linear backward's
:func:`~rawaudiovae_kelsey_tpu_torch.ops.linear_bwd.dx_fused` (tile width
:func:`cotangent_tile_n`) and
:func:`~rawaudiovae_kelsey_tpu_torch.ops.linear_bwd.dw_fused` (a weight
gradient walked as its transpose, :func:`cotangent_wgrad_plan`), whose A is
the cotangent formed in registers; and the full chains
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.enc_bwd_full` and
:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.dec_bwd_full`, in both dtypes
(:func:`takes_full_chain`, :func:`full_plan`).  Fourteen of them,
``linear_fwd``, ``linear_ksplit_fwd``, ``matmul_nt``, ``matmul_nt_mask``,
``matmul_nt2_mask``, ``grad_accum``, ``grad_accum2``, ``enc_bwd_dw1``,
``dec_bwd_fused``, ``encoder_fwd``, ``decoder_fwd``, ``dx_fused``,
``dw_fused`` and ``toeplitz_fwd`` (its rule in ``ops/toeplitz.py``), the
full chains in one fp32 pass (the split kernels' fp32 launches in turn,
:func:`full_plan`), and the int8 decoder
:func:`~rawaudiovae_kelsey_tpu_torch.ops.quant.quantized_decoder_fwd`,
which has no tensor-core form (:data:`SGEMM_OPS`), have an fp32 form,
the weight gradients of ``grad_accum``, ``grad_accum2``, ``enc_bwd_dw1``,
``dec_bwd_fused`` and ``dw_fused`` split into slices by
:func:`sgemm_wgrad_plan`, each product of ``encoder_fwd``,
``decoder_fwd`` and ``quantized_decoder_fwd`` planned by
:func:`sgemm_fwd_plan`.  The choice is a
function of dtype, shape and pointer alignment alone
(:func:`takes_tensor_cores`, :func:`takes_sgemm`), made in the wrapper
before the launch:

* bf16 operands take the tensor-core kernel when TMA can address them: the
  contraction ``k`` and the output width ``n`` multiples of 8 (row pitches
  of 16 bytes; the epilogue stores adjacent column pairs) and base pointers
  on 16-byte boundaries; every other bf16 shape keeps the CUDA-core kernel;
* fp32 operands take the tensor cores only in the ``high`` tier's full
  chains (:func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.enc_bwd_full`,
  :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.dec_bwd_full`;
  :func:`takes_full_chain`) and its forward and input gradient (the
  ``passes = 3`` forms of ``encoder_fwd``, ``decoder_fwd``,
  ``matmul_nt2_mask``, ``matmul_nt`` and the row-parallel forms;
  :func:`split_tile`) and, with the backward-fusion switch forced, its
  other backward kernels (the ``passes = 3`` forms of ``matmul_nt_mask``,
  ``grad_accum``, ``grad_accum2``, ``enc_bwd_dw1`` and ``dec_bwd_fused``;
  :func:`split_wgrad`), whose product is three bf16 passes on the
  operands' hi and lo halves, the TPU kernels' own, and in the Toeplitz
  product's ``passes = 4`` (four bf16 passes, the ``high`` tier's
  op-level conv1d layers; its rule in ``ops/toeplitz.py``); the ``float32`` and
  ``highest`` tiers promise IEEE fp32 products, and the tensor cores offer
  fp32 data only TF32 or bf16 splits, which is another result.  Where an
  op has an fp32 form they take it when ``k`` and ``n`` are multiples of 4
  (16-byte rows) and every base pointer is on a 16-byte boundary; every
  other fp32 product keeps the first version.

Nothing falls back at run time: a launch that fails raises, and asking for
``kernel="tensor_cores"`` or ``kernel="sgemm"`` on operands that kernel
cannot take raises.

``toeplitz_fwd`` also has a narrow-channel form (:data:`NARROW_OPS`, code
3: a tap or output width below 8), which ``"auto"`` takes before the fp32
one (``ops/toeplitz.py`` ``takes_narrow``).

A wrapper's ``kernel`` keyword is ``"auto"`` (the rules above) or a key of
:data:`KERNEL_CODES`: the checks on the card hold and time the kernels on
one shape by naming them.  The tensor-core kernel's tiles are 128 rows by
:func:`tile_n` columns, the fp32 kernel's one of :data:`SGEMM_TILES`
(:func:`sgemm_tile`); the wrapper passes the choice down (:func:`tile`).

The kernels round differently (one fp32 accumulator across all of k
against an ordered sum of per-slice partial sums; fp32 sums in another
order), so the output's bits follow the choice, and through it the
pointers' alignment: the same values in a contiguous view that starts 2
bytes off a 16-byte boundary take the CUDA-core kernel and may differ from
the aligned tensor's result by a bf16 ulp (an fp32 one by a few ulps).  No
tensor that ``torch`` allocates itself is such a view.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

# kernel name → the code the C entry points take (csrc/wgmma.cuh Kernel)
KERNEL_CODES = {"cuda_cores": 0, "tensor_cores": 1, "sgemm": 2, "narrow": 3}
TENSOR_CORES, SGEMM = KERNEL_CODES["tensor_cores"], KERNEL_CODES["sgemm"]
NARROW = KERNEL_CODES["narrow"]
# the ops whose C entry points have the fp32 form (code 2)
SGEMM_OPS = frozenset({"linear_fwd", "linear_ksplit_fwd", "matmul_nt",
                       "matmul_nt_mask", "matmul_nt2_mask", "grad_accum",
                       "grad_accum2", "enc_bwd_dw1", "dec_bwd_fused",
                       "encoder_fwd", "decoder_fwd", "quantized_decoder_fwd",
                       "dw_fused", "dx_fused", "toeplitz_fwd",
                       "enc_bwd_full", "dec_bwd_full"})
# the ops whose C entry points have the narrow-channel form (code 3)
NARROW_OPS = frozenset({"toeplitz_fwd"})

# TMA's unit: base pointers and row pitches are multiples of 16 bytes
TMA_ALIGN_BYTES = 16
TMA_ALIGN_BF16 = TMA_ALIGN_BYTES // 2

# the tensor-core kernel's tile: 128 rows (two consumer warpgroups of 64),
# one of these widths (csrc/wgmma.cuh, widest first)
TILE_M = 128
TILE_WIDTHS = (256, 128, 64)
# the widths of the 3-pass mode: three accumulators of 128 x 256 would take
# 384 registers a thread (csrc/wgmma.cuh, "the 3-pass product")
SPLIT_WIDTHS = (128, 64)
# the fp32 kernel's tiles (rows, columns), largest first; the C entry
# points take the index (csrc/sgemm.cuh kTiles)
SGEMM_TILES = ((128, 128), (128, 64), (64, 64))
# its unit: k and n multiples of 4 floats (16-byte rows and chunks)
SGEMM_ALIGN_F32 = TMA_ALIGN_BYTES // 4
# the fewest k-steps of 64 batch rows a slice of a weight gradient takes
# (wgrad_plan).  Shorter slices cost more than their extra blocks gain: each
# fills its ring from nothing and writes, and the reduction reads back, a
# whole fp32 dW.  On an H100, dW3 at microbatch 8192 ran faster as 4 slices
# of 32 k-steps in 128 x 128 tiles than as 8 of 16 in 128 x 256, the same
# single wave (chip_smoke.py phase 3b sweeps the plans; PERF.md section 6).
WGRAD_MIN_STEPS = 32
# the same for the fp32 weight gradient (sgemm_wgrad_plan): a k-step of 64
# rows takes the CUDA cores about fifteen times as long as the tensor
# cores, so a slice of 8 (512 rows) is still long beside what it writes
SGEMM_WGRAD_MIN_STEPS = 8
# fp32 forward products (sgemm_fwd_plan): the time a unit of tile area takes
# a k-step of 64 on each tile of SGEMM_TILES, one block an SM, relative to
# 128 x 128 (a lane of a 64 x 64 tile does 16 FFMAs for the 8 floats it
# reads from shared memory a k-step, one of a 128 x 128 tile 64 for 16).  On
# an H100 such a k-step took 6.4, 3.6 and 2.1 us on the three tiles
# (chip_smoke.py phase 3's plan sweep at 256 x 2048 -> 1024; PERF.md
# section 6)
SGEMM_TILE_RATE = (1.0, 1.125, 1.31)
# and what cutting the contraction into slices adds, in the same units
# (tile area times k-steps): about half a k-step of a 128 x 128 tile, the
# slices' epilogue (3-6 us there)
SGEMM_SPLIT_COST = 8192

_sm_counts = {}


def takes_tensor_cores(dtype: torch.dtype, rows: int, k: int, n: int,
                       aligned: bool = True) -> bool:
    """Whether a product of ``rows`` rows, contraction ``k`` and output
    width ``n`` runs on the tensor-core kernel: bf16, something to compute,
    ``k`` and ``n`` multiples of 8, and (``aligned``) every operand's base
    pointer on a 16-byte boundary."""
    return (dtype == torch.bfloat16 and rows > 0 and k > 0 and n > 0
            and k % TMA_ALIGN_BF16 == 0 and n % TMA_ALIGN_BF16 == 0
            and aligned)


def takes_sgemm(dtype: torch.dtype, rows: int, k: int, n: int,
                aligned: bool = True) -> bool:
    """Whether a product of ``rows`` rows, contraction ``k`` and output
    width ``n`` runs on the fp32 kernel of an op in :data:`SGEMM_OPS`:
    fp32, something to compute, ``k`` and ``n`` multiples of 4, and
    (``aligned``) every operand's base pointer on a 16-byte boundary."""
    return (dtype == torch.float32 and rows > 0 and k > 0 and n > 0
            and k % SGEMM_ALIGN_F32 == 0 and n % SGEMM_ALIGN_F32 == 0
            and aligned)


@functools.lru_cache(maxsize=1024)
def tile_n(tiles_m: int, n: int, sms: int,
           widths: tuple = TILE_WIDTHS) -> int:
    """The tile width of the tensor-core kernel for ``tiles_m`` tile rows
    and output width ``n`` on a card of ``sms`` SMs: the width of
    :data:`TILE_WIDTHS` whose grid takes the fewest waves times that width
    (each block walks its tiles one after another, a tile's time grows with
    its width), the wider on a tie (it reads A fewer times).  So a grid
    that fills the card in one wave of wide tiles keeps them, and a small
    one (the deep model's 4096 x 512 -> 256, the server's batch of 256)
    takes 64-wide tiles that give more SMs work.  ``widths``: the widths to
    choose from (:data:`SPLIT_WIDTHS` for a 3-pass product)."""
    best = None
    for width in widths:
        tiles = tiles_m * -(-n // width)
        cost = -(-tiles // sms) * width
        if best is None or cost < best[0]:
            best = (cost, width)
    return best[1]


@functools.lru_cache(maxsize=1024)
def sgemm_tile(rows: int, n: int, sms: int) -> tuple:
    """The tile ``(rows, columns)`` of the fp32 kernel for a product of
    ``rows`` rows and output width ``n`` on a card of ``sms`` SMs: the tile
    of :data:`SGEMM_TILES` whose grid takes the fewest waves (one tile an
    SM) times its area (a tile's time grows with it), the larger on a tie
    (it reads the operands fewer times a product).  So 4096 x 4096 -> 4096
    and the backward's 8192-row products keep 128 x 128, and the server's
    256 rows take 128 x 64 or 64 x 64 tiles that give more SMs work."""
    best = None
    for bm, bn in SGEMM_TILES:
        tiles = -(-rows // bm) * -(-n // bn)
        cost = -(-tiles // sms) * bm * bn
        if best is None or cost < best[0]:
            best = (cost, (bm, bn))
    return best[1]


@functools.lru_cache(maxsize=1024)
def sgemm_whole_tile(rows: int, n: int, sms: int) -> tuple:
    """The tile ``(rows, columns)`` of the fp32 kernel for a product of
    ``rows`` rows and output width ``n`` whose contraction is one slice
    (the Toeplitz product's, ``ops/toeplitz.py``): the tile of
    :data:`SGEMM_TILES` whose grid takes the fewest waves of one block an
    SM times its area times its :data:`SGEMM_TILE_RATE` (a 64 x 64 tile's
    lane does 16 FFMAs for the 8 floats it reads a k-step, a 128 x 128
    tile's 64 for 16), the larger on a tie: :func:`sgemm_fwd_plan` 's cost
    with one slice.  So the conv1d model's fp32 layers take 128 x 128, and
    128 x 64 where ``n`` is 64 (``chip_smoke.py`` phase 3e sweeps the
    tiles)."""
    best = None
    for index, (bm, bn) in enumerate(SGEMM_TILES):
        tiles = -(-rows // bm) * -(-n // bn)
        cost = -(-tiles // sms) * bm * bn * SGEMM_TILE_RATE[index]
        if best is None or cost < best[0]:
            best = (cost, (bm, bn))
    return best[1]


def _slice_plan(tiles: int, steps: int, slots: int, least: int) -> tuple:
    """``(waves, k-steps a slice, slices)`` of a weight gradient of
    ``tiles`` output tiles over ``steps`` k-steps of 64 rows on ``slots``
    blocks a wave: as many slices as fill one wave, each at least ``least``
    k-steps, and the fewest that keep that many k-steps a slice (no slice
    is empty)."""
    split = max(1, min(slots // tiles, steps // least))
    per = -(-steps // split)
    split = -(-steps // per)
    return -(-tiles * split // slots), per, split


@functools.lru_cache(maxsize=1024)
def wgrad_plan(m: int, n: int, k: int, sms: int, outputs: int = 1,
               widths: tuple = TILE_WIDTHS) -> tuple:
    """``(tile width, slices)`` of the tensor-core weight gradient ``dW (m,
    n) = aᵀ b`` over a contraction of ``k`` rows (the batch) on a card of
    ``sms`` SMs (``csrc/wgmma.cuh`` ``launch_wgrad_outs``), for ``outputs``
    weight gradients of one ``a`` side by side in one launch (each ``(m,
    n)``: ``grad_accum2`` 's two heads).  Its grid is small (dW3 at 256 x
    2048 is 16 tiles of 128 x 256), so the batch is cut into slices, each a
    whole dW's tiles, added in order afterwards: for each width of
    :data:`TILE_WIDTHS`, as many slices as fill one wave, at least
    :data:`WGRAD_MIN_STEPS` k-steps of 64 rows each, and the fewest that
    keep that many k-steps a slice (no slice is empty).  The width whose
    grid takes the fewest waves times width times k-steps a slice wins; on
    a tie, 128 wide (its ring has five stages where 256 has three, and a
    64-wide tile reads A from L2 twice as often a product), then a plan of
    one slice (it writes dW once and needs no reduction), then the wider
    (it reads the operands fewer times, each slice reading all of A and
    B's rows once).  On an H100, at microbatch 8192, dW4 and dW1 (2048 x
    1024, 1024 x 2048) ran 5.8 % and 3.9 % faster as one slice of 128 x
    128 tiles than as 2 slices of 128 x 256, the same single wave, and
    grad_accum2's two 2048 x 256 outputs faster as 2 slices of 128 x 128
    than as one of 128 x 64 or 4 of 128 x 256, which tie with it on the
    cost (chip_smoke.py phase 3b; PERF.md section 6).  ``widths``: the
    widths to choose from (:data:`SPLIT_WIDTHS` for a 3-pass product)."""
    steps = -(-k // 64)
    best = None
    for width in widths:
        tiles = outputs * -(-m // TILE_M) * -(-n // width)
        waves, per, split = _slice_plan(tiles, steps, sms, WGRAD_MIN_STEPS)
        cost = (waves * width * per, width != 128, split > 1)
        if best is None or cost < best[0]:
            best = (cost, width, split)
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def sgemm_wgrad_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """``(tile index, slices)`` of the fp32 weight gradient ``dW (m, n) =
    aᵀ b`` over a contraction of ``k`` rows (the batch) on a card of
    ``sms`` SMs (``csrc/sgemm.cuh`` ``launch_wgrad``; the index into
    :data:`SGEMM_TILES`), in the spirit of :func:`wgrad_plan`: for each
    tile, as many slices as fill one wave of two blocks an SM (the
    kernel's launch bounds), at least :data:`SGEMM_WGRAD_MIN_STEPS` k-steps
    of 64 rows each, no slice empty.  The tile whose grid takes the fewest
    waves times tile area times k-steps a slice wins; on a tie, the larger
    tile: a lane of a 128 x 128 tile does 64 FFMAs for the 16 floats it
    reads from shared memory a k-step, one of a 64 x 64 tile 16 for 8,
    which leaves the FFMAs waiting on shared memory.  dW4 and dW1 at
    microbatch 8192 (128 tiles of 128 x 128) take two slices; dW21, dW22
    (2048 x 256) and dW3 (256 x 2048), 32 such tiles, eight.  On an H100
    those ran faster than one wave of one block an SM (one slice, four)
    (chip_smoke.py phase 3c; PERF.md section 6)."""
    steps = -(-k // 64)
    best = None
    for index, (bm, bn) in enumerate(SGEMM_TILES):
        tiles = -(-m // bm) * -(-n // bn)
        waves, per, split = _slice_plan(tiles, steps, 2 * sms,
                                        SGEMM_WGRAD_MIN_STEPS)
        cost = waves * bm * bn * per
        if best is None or cost < best[0]:
            best = (cost, index, split)
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def sgemm_fwd_plan(rows: int, k: int, n: int, sms: int,
                   outputs: int = 1) -> tuple:
    """``(tile index, slices)`` of one forward product of the fp32
    encoder or decoder, ``rows`` rows, contraction ``k`` and output width
    ``n`` (``outputs`` outputs of that width side by side in one grid: the
    encoder's two heads), on a card of ``sms`` SMs (``csrc/sgemm.cuh``
    ``launch_fwd``; the index into :data:`SGEMM_TILES`).  A contraction is
    cut only to fill the card: for each tile, one slice, and each power of
    two of slices whose blocks still fit one wave of one block an SM and
    leave no slice empty.  The cost of each is the waves of blocks times
    tile area times k-steps of 64 a slice times the tile's
    :data:`SGEMM_TILE_RATE`, plus :data:`SGEMM_SPLIT_COST` where there is
    more than one slice; the least wins, and on a tie fewer slices, then
    the larger tile.  A wave is one block an SM, not the two the launch
    bounds allow: on an H100 two blocks an SM took longer than one block
    doing both blocks' k-steps.  At the server's 256 rows h takes 128 x
    128 tiles over 4 slices, the heads 16 and y 8, h3 (k = 256) 64 x 64
    tiles whole; at the training microbatch (8192 rows) every product is
    more than a wave of 128 x 128 tiles, so none is cut (chip_smoke.py
    phase 3 sweeps the plans; PERF.md section 6)."""
    steps = -(-k // 64)
    best = None
    for index, (bm, bn) in enumerate(SGEMM_TILES):
        tiles = outputs * -(-rows // bm) * -(-n // bn)
        split = 1
        while split == 1 or (tiles * split <= sms and split <= steps):
            per = -(-steps // split)
            if -(-steps // per) == split:
                work = -(-tiles * split // sms) * bm * bn * per
                cost = (work * SGEMM_TILE_RATE[index]
                        + (split > 1) * SGEMM_SPLIT_COST, split, index)
                if best is None or cost < best[0]:
                    best = (cost, index, split)
            split *= 2
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def cotangent_tile_n(tiles_m: int, n: int, sms: int) -> int:
    """The tile width of the tensor-core ``dx_fused`` (``dx = da · wᵀ``,
    ``da`` formed in registers) for ``tiles_m`` tile rows and output width
    ``n``: :func:`tile_n`."""
    return tile_n(tiles_m, n, sms)


@functools.lru_cache(maxsize=1024)
def cotangent_wgrad_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """``(tile width, slices)`` of the tensor-core ``dw_fused``, whose walk
    is the transpose ``dWᵀ (m, n) = daᵀ · x`` (``m`` the layer's output
    width, ``n`` its input width) over a batch of ``k`` rows: the slices
    and the cost of :func:`wgrad_plan`, a tie going to the wider tile, then
    to fewer slices.  The formed A turns wgrad_plan's reasons around: each
    tile forms its rows of ``da`` again (``n / width`` times a row of
    tiles), and the ring at 128 x 256 has three stages to 128 x 128's four,
    not to five."""
    steps = -(-k // 64)
    best = None
    for width in TILE_WIDTHS:
        tiles = -(-m // TILE_M) * -(-n // width)
        waves, per, split = _slice_plan(tiles, steps, sms, WGRAD_MIN_STEPS)
        cost = (waves * width * per, -width, split)
        if best is None or cost < best[0]:
            best = (cost, width, split)
    return best[1], best[2]


def cotangent_tile(code: int, device: torch.device, batch: int, k: int,
                   n: int) -> int:
    """The ``tile`` argument of ``rvk_dx_fused`` (``dx (batch, k) = da ·
    wᵀ``, contraction ``n``): :func:`cotangent_tile_n` for the tensor-core
    form (``code`` 1), the index of :func:`sgemm_tile` for the fp32 one
    (``code`` 2), 0 for the first version."""
    if code == TENSOR_CORES:
        return cotangent_tile_n(-(-batch // TILE_M), k, sm_count(device))
    return tile(code, device, batch, k)


def cotangent_wgrad(code: int, device: torch.device, k: int, n: int,
                    batch: int) -> tuple:
    """The ``(tile, split)`` arguments of ``rvk_dw_fused`` (``dW (k, n) =
    xᵀ · da`` over ``batch`` rows): :func:`cotangent_wgrad_plan` of the
    transpose for the tensor-core form (``code`` 1), :func:`sgemm_wgrad_plan`
    for the fp32 one (``code`` 2), ``(0, 0)`` for the first version."""
    if code == TENSOR_CORES:
        return cotangent_wgrad_plan(n, k, batch, sm_count(device))
    return wgrad(code, device, k, n, batch)


def fwd(code: int, device: torch.device, rows: int, k: int, n: int,
        outputs: int = 1) -> tuple:
    """The ``(tile, split)`` arguments of a C entry point's forward
    product of ``rows`` rows, contraction ``k`` and output width ``n``:
    :func:`sgemm_fwd_plan` for the fp32 kernel (``code`` 2), else
    :func:`tile` and one slice for the tensor-core kernel (``code`` 1) and
    ``(0, 0)`` for the first version."""
    if code == SGEMM:
        return sgemm_fwd_plan(rows, k, n, sm_count(device), outputs)
    return tile(code, device, rows, n, outputs), int(code == TENSOR_CORES)


def wgrad(code: int, device: torch.device, m: int, n: int, k: int,
          outputs: int = 1) -> tuple:
    """The ``(tile_dw, split)`` arguments of a C entry point's weight
    gradient: :func:`wgrad_plan` for the tensor-core kernel (``code`` 1,
    ``outputs`` weight gradients in one launch), :func:`sgemm_wgrad_plan`
    for the fp32 one (``code`` 2), ``(0, 0)`` for the first version."""
    if code == TENSOR_CORES:
        return wgrad_plan(m, n, k, sm_count(device), outputs)
    if code == SGEMM:
        return sgemm_wgrad_plan(m, n, k, sm_count(device))
    return 0, 0


def tile(code: int, device: torch.device, rows: int, n: int,
         outputs: int = 1) -> int:
    """The ``tile_n`` argument of a C entry point for a product of ``rows``
    rows and output width ``n``: :func:`tile_n` for the tensor-core kernel
    (``code`` 1, tiles of :data:`TILE_M` rows; ``outputs`` outputs of width
    ``n`` side by side in one launch, as the encoder's two heads, give as
    many tiles as that many times the tile rows), the index of
    :func:`sgemm_tile` in :data:`SGEMM_TILES` for the fp32 kernel (``code``
    2), 0 for the first version."""
    if code == TENSOR_CORES:
        return tile_n(outputs * -(-rows // TILE_M), n, sm_count(device))
    if code == SGEMM:
        return SGEMM_TILES.index(sgemm_tile(rows, n, sm_count(device)))
    return 0


def split_tile(code: int, device: torch.device, rows: int, n: int,
               outputs: int = 1) -> int:
    """The ``tile_n`` argument of a 3-pass product of ``rows`` rows and
    output width ``n`` (the ``high`` tier's forward and input gradient,
    ``ops/mlp.py`` ``encoder_fwd3``): :func:`tile_n` over
    :data:`SPLIT_WIDTHS` on the tensor cores (``code`` 1; ``outputs``
    outputs side by side in one walk, as the heads), 0 for the first
    version."""
    if code != TENSOR_CORES:
        return 0
    return tile_n(outputs * -(-rows // TILE_M), n, sm_count(device),
                  SPLIT_WIDTHS)


def split_wgrad(code: int, device: torch.device, m: int, n: int, k: int,
                outputs: int = 1) -> tuple:
    """The ``(tile_dw, split)`` arguments of a 3-pass weight gradient (the
    ``high`` tier's ``grad_accum``, ``grad_accum2``, ``enc_bwd_dw1`` and
    ``dec_bwd_fused``, ``ops/mlp.py``): :func:`wgrad_plan` over
    :data:`SPLIT_WIDTHS` on the tensor cores (``code`` 1), ``(0, 0)`` for
    the first version."""
    if code != TENSOR_CORES:
        return 0, 0
    return wgrad_plan(m, n, k, sm_count(device), outputs, SPLIT_WIDTHS)


def takes_full_chain(dtype: torch.dtype, batch: int, *widths: int,
                     aligned: bool = True) -> bool:
    """Whether a full chain (``enc_bwd_full`` or ``dec_bwd_full``, widths
    seg, units and latent) runs on the tensor cores: fp32 operands (three
    bf16 passes, the ``high`` tier's product) or bf16 ones (one pass), at
    least one row, every width a positive multiple of 8 (the TMA rows of
    every product and weight gradient of the chain) and (``aligned``) every
    base pointer on a 16-byte boundary."""
    return (dtype in (torch.float32, torch.bfloat16) and batch > 0
            and all(w > 0 and w % TMA_ALIGN_BF16 == 0 for w in widths)
            and aligned)


def full_plan(code: int, dtype: torch.dtype, device: torch.device,
              chain: str, batch: int, seg: int, units: int,
              latent: int) -> tuple:
    """The tile and slice arguments of ``rvk_enc_bwd_full`` (``chain``
    "enc": ``tile_dh, tile_dw1, split_dw1, tile_dw2, split_dw2``) or
    ``rvk_dec_bwd_full`` ("dec": ``tile_dh3, tile_dz, tile_dw3, split_dw3,
    tile_dw4, split_dw4``).  On the tensor cores (``code`` 1) each product
    takes :func:`tile_n` and each weight gradient :func:`wgrad_plan` (dW21
    and dW22 as two outputs of one launch), from :data:`SPLIT_WIDTHS` for
    fp32 operands (the 3-pass mode) and from :data:`TILE_WIDTHS` for bf16
    (the split backward's launches, with the plans those take); on the
    fp32 kernel (``code`` 2, the chains' one-pass fp32 form) the tile index
    of each product and :func:`sgemm_wgrad_plan` of each weight gradient,
    dW21 and dW22 one after the other; zeros for the first version."""
    if code == SGEMM:
        if chain == "enc":
            return (tile(code, device, batch, units),
                    *wgrad(code, device, seg, units, batch),
                    *wgrad(code, device, units, latent, batch))
        return (tile(code, device, batch, units),
                tile(code, device, batch, latent),
                *wgrad(code, device, latent, units, batch),
                *wgrad(code, device, units, seg, batch))
    if code != TENSOR_CORES:
        return (0,) * (5 if chain == "enc" else 6)
    widths = SPLIT_WIDTHS if dtype == torch.float32 else TILE_WIDTHS
    sms = sm_count(device)
    tiles_m = -(-batch // TILE_M)

    def rows(n):
        return tile_n(tiles_m, n, sms, widths)

    def weights(m, n, outputs=1):
        return wgrad_plan(m, n, batch, sms, outputs, widths)

    if chain == "enc":
        return (rows(units), *weights(seg, units), *weights(units, latent, 2))
    return (rows(units), rows(latent), *weights(latent, units),
            *weights(units, seg))


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device``, read once."""
    index = device.index
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[index]


def pointers_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (a contiguous view
    into a larger buffer may not)."""
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    return bits % TMA_ALIGN_BYTES == 0


def check_name(op: str, kernel: str) -> None:
    """Raise unless ``kernel`` is ``"auto"`` or a key of
    :data:`KERNEL_CODES`."""
    if kernel != "auto" and kernel not in KERNEL_CODES:
        raise ValueError(f"{op}: unknown kernel {kernel!r} (auto, "
                         f"{', '.join(KERNEL_CODES)})")


def resolve_kernel(op: str, kernel: str, dtype: torch.dtype, rows: int,
                   k: int, n: int, aligned: bool = True) -> int:
    """``kernel`` (``"auto"`` or a key of :data:`KERNEL_CODES`) → the code
    to launch ``op`` with.  ``"auto"`` follows :func:`takes_tensor_cores`,
    then, for an op of :data:`SGEMM_OPS`, :func:`takes_sgemm`; a kernel
    asked for by name on operands it cannot take raises instead of
    switching."""
    return resolve(op, kernel, takes_tensor_cores(dtype, rows, k, n, aligned),
                   lambda: f"{dtype}, {rows} rows, k = {k}, n = {n}, "
                           f"aligned = {aligned}",
                   op in SGEMM_OPS
                   and takes_sgemm(dtype, rows, k, n, aligned))


# what the tensor-core kernel of an op takes, in resolve's error
TAKES_TENSOR_CORES = (f"bf16 operands with the contraction and the output "
                      f"width multiples of {TMA_ALIGN_BF16} and 16-byte "
                      f"aligned pointers")
# and the fp32 kernel
TAKES_SGEMM = (f"fp32 operands with the contraction and the output width "
               f"multiples of {SGEMM_ALIGN_F32} and 16-byte aligned pointers")


def resolve(op: str, kernel: str, fits: bool, got: Callable[[], str],
            fits_sgemm: bool = False, takes: str = TAKES_TENSOR_CORES,
            fits_narrow: bool = False, takes_sgemm: str = TAKES_SGEMM,
            takes_narrow: str = "") -> int:
    """:func:`resolve_kernel` on what the rules found: ``fits`` the
    tensor-core kernel, ``fits_narrow`` the narrow-channel one (an op of
    :data:`NARROW_OPS`), ``fits_sgemm`` the fp32 one, taken in that order
    by ``"auto"``; ``got()`` describes the operands in the error (built
    only then: a call's host time matters), ``takes``, ``takes_sgemm`` and
    ``takes_narrow`` what each kernel takes."""
    check_name(op, kernel)
    if kernel == "auto":
        return KERNEL_CODES["tensor_cores" if fits else
                            "narrow" if fits_narrow else
                            "sgemm" if fits_sgemm else "cuda_cores"]
    if kernel == "tensor_cores" and not fits:
        raise ValueError(f"{op}: kernel {kernel!r} takes {takes}; got "
                         f"{got()}")
    for name, ops, fits_it, text in (
            ("sgemm", SGEMM_OPS, fits_sgemm, takes_sgemm),
            ("narrow", NARROW_OPS, fits_narrow, takes_narrow)):
        if kernel == name and op not in ops:
            raise ValueError(f"{op}: no kernel {kernel!r} (only "
                             f"{', '.join(sorted(ops))} have one)")
        if kernel == name and not fits_it:
            raise ValueError(f"{op}: kernel {kernel!r} takes {text}; got "
                             f"{got()}")
    return KERNEL_CODES[kernel]

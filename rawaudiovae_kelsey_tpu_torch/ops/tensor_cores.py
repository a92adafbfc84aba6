"""Which hand-written kernel a product takes: the first version on the CUDA
cores, or the bf16 tensor-core form (``csrc/wgmma.cuh``); and the tile
width of the latter.

Four ops have both: :func:`~rawaudiovae_kelsey_tpu_torch.ops.linear.
linear_fwd`, :func:`~rawaudiovae_kelsey_tpu_torch.ops.linear.
linear_ksplit_fwd`, :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.matmul_nt`
and :func:`~rawaudiovae_kelsey_tpu_torch.ops.toeplitz.toeplitz_fwd` (whose
contraction is ``G`` a tap and output width ``N``).  The choice is a
function of dtype, shape and pointer alignment alone
(:func:`takes_tensor_cores`), made in the wrapper before the launch:

* fp32 operands keep the CUDA-core kernels: the ``float32`` and ``highest``
  tiers promise IEEE fp32 products, and the tensor cores offer fp32 data
  only TF32 or bf16 splits, which is another result;
* bf16 operands take the tensor-core kernel when TMA can address them: the
  contraction ``k`` and the output width ``n`` multiples of 8 (row pitches
  of 16 bytes; the epilogue stores adjacent column pairs) and base pointers
  on 16-byte boundaries; every other bf16 shape keeps the CUDA-core kernel.

Nothing falls back at run time: a tensor-core launch that fails raises, and
asking for ``kernel="tensor_cores"`` on operands it cannot take raises.

A wrapper's ``kernel`` keyword is ``"auto"`` (the rule above),
``"cuda_cores"`` or ``"tensor_cores"``: the checks on the card hold and time
both kernels on one shape by naming them.  The tensor-core kernel's tiles
are 128 rows by :func:`tile_n` columns, which the wrapper passes down.

The two kernels round differently (one fp32 accumulator across all of k
against an ordered sum of per-slice partial sums), so the output's bits
follow the choice, and through it the pointers' alignment: the same values
in a contiguous view that starts 2 bytes off a 16-byte boundary take the
CUDA-core kernel and may differ from the aligned tensor's result by a bf16
ulp.  No tensor that ``torch`` allocates itself is such a view.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

# kernel name → the code the C entry points take (csrc/wgmma.cuh Kernel)
KERNEL_CODES = {"cuda_cores": 0, "tensor_cores": 1}

# TMA's unit: base pointers and row pitches are multiples of 16 bytes
TMA_ALIGN_BYTES = 16
TMA_ALIGN_BF16 = TMA_ALIGN_BYTES // 2

# the tensor-core kernel's tile: 128 rows (two consumer warpgroups of 64),
# one of these widths (csrc/wgmma.cuh, widest first)
TILE_M = 128
TILE_WIDTHS = (256, 128, 64)

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


@functools.lru_cache(maxsize=1024)
def tile_n(tiles_m: int, n: int, sms: int) -> int:
    """The tile width of the tensor-core kernel for ``tiles_m`` tile rows
    and output width ``n`` on a card of ``sms`` SMs: the width of
    :data:`TILE_WIDTHS` whose grid takes the fewest waves times that width
    (each block walks its tiles one after another, a tile's time grows with
    its width), the wider on a tie (it reads A fewer times).  So a grid
    that fills the card in one wave of wide tiles keeps them, and a small
    one (the deep model's 4096 x 512 -> 256, the server's batch of 256)
    takes 64-wide tiles that give more SMs work."""
    best = None
    for width in TILE_WIDTHS:
        tiles = tiles_m * -(-n // width)
        cost = -(-tiles // sms) * width
        if best is None or cost < best[0]:
            best = (cost, width)
    return best[1]


def width(code: int, device: torch.device, tiles_m: int, n: int) -> int:
    """The ``tile_n`` argument of a C entry point: :func:`tile_n` for the
    tensor-core kernel (``code`` 1), 0 for the first version."""
    return tile_n(tiles_m, n, sm_count(device)) if code else 0


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
    to launch ``op`` with.  ``"auto"`` follows :func:`takes_tensor_cores`;
    a tensor-core kernel asked for by name on operands it cannot take
    raises instead of switching."""
    return resolve(op, kernel, takes_tensor_cores(dtype, rows, k, n, aligned),
                   lambda: f"{dtype}, {rows} rows, k = {k}, n = {n}, "
                           f"aligned = {aligned}")


def resolve(op: str, kernel: str, fits: bool,
            got: Callable[[], str]) -> int:
    """:func:`resolve_kernel` on what the rule found, ``fits``; ``got()``
    describes the operands in the error (built only then: a call's host
    time matters)."""
    check_name(op, kernel)
    if kernel == "auto":
        return KERNEL_CODES["tensor_cores" if fits else "cuda_cores"]
    if kernel == "tensor_cores" and not fits:
        raise ValueError(
            f"{op}: kernel {kernel!r} takes bf16 operands with the "
            f"contraction and the output width multiples of "
            f"{TMA_ALIGN_BF16} and 16-byte aligned pointers; got "
            f"{got()}")
    return KERNEL_CODES[kernel]

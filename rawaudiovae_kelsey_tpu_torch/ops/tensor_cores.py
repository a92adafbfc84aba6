"""Which hand-written kernel a product takes: the first version on the CUDA
cores, or the bf16 tensor-core form (``csrc/wgmma.cuh``).

Two ops have both: :func:`~rawaudiovae_kelsey_tpu_torch.ops.linear.
linear_ksplit_fwd` and :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.
matmul_nt`.  The choice is a function of dtype, shape and pointer alignment
alone (:func:`takes_tensor_cores`), made in the wrapper before the launch:

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
both kernels on one shape by naming them.  The tensor-core kernel picks its
tile width by shape itself (``launch_wgmma``).

The two kernels round differently (one fp32 accumulator across all of k
against an ordered sum of per-slice partial sums), so the output's bits
follow the choice, and through it the pointers' alignment: the same values
in a contiguous view that starts 2 bytes off a 16-byte boundary take the
CUDA-core kernel and may differ from the aligned tensor's result by a bf16
ulp.  No tensor that ``torch`` allocates itself is such a view.
"""

from __future__ import annotations

import torch

# kernel name → the code the C entry points take (csrc/wgmma.cuh Kernel)
KERNEL_CODES = {"cuda_cores": 0, "tensor_cores": 1}

# TMA's unit: base pointers and row pitches are multiples of 16 bytes
TMA_ALIGN_BYTES = 16
TMA_ALIGN_BF16 = TMA_ALIGN_BYTES // 2


def takes_tensor_cores(dtype: torch.dtype, rows: int, k: int, n: int,
                       aligned: bool = True) -> bool:
    """Whether a product of ``rows`` rows, contraction ``k`` and output
    width ``n`` runs on the tensor-core kernel: bf16, something to compute,
    ``k`` and ``n`` multiples of 8, and (``aligned``) every operand's base
    pointer on a 16-byte boundary."""
    return (dtype == torch.bfloat16 and rows > 0 and k > 0 and n > 0
            and k % TMA_ALIGN_BF16 == 0 and n % TMA_ALIGN_BF16 == 0
            and aligned)


def pointers_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (a contiguous view
    into a larger buffer may not)."""
    return all(t.data_ptr() % TMA_ALIGN_BYTES == 0 for t in tensors)


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
    check_name(op, kernel)
    fits = takes_tensor_cores(dtype, rows, k, n, aligned)
    if kernel == "auto":
        return KERNEL_CODES["tensor_cores" if fits else "cuda_cores"]
    if kernel == "tensor_cores" and not fits:
        raise ValueError(
            f"{op}: kernel {kernel!r} takes bf16 operands with the "
            f"contraction and the output width multiples of "
            f"{TMA_ALIGN_BF16} and 16-byte aligned pointers; got {dtype}, "
            f"{rows} rows, k = {k}, n = {n}, aligned = {aligned}")
    return KERNEL_CODES[kernel]

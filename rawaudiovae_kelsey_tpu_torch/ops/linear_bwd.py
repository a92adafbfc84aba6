"""The fused backward of one linear layer ``y = act(x @ w + b)``: the CUDA
counterparts of ``dw_fused`` and ``dx_fused`` of the JAX repository's
``benchmarks/deep_bwd_probe.py``.

The plain backward (``ops/linear.py`` ``PallasLinear.backward``) writes the
cotangent ``da = act'(y) · dy`` — a ``(B, n)`` tensor as large as the
layer's output — to device memory and reads it back for ``dx``, ``dW`` and
``db``.  The two kernels here (``csrc/linear_bwd.cu``) form ``da`` inside
each product from ``y`` and ``dy`` instead:

* :func:`dw_fused`: ``dW = xᵀ · da`` and ``db = Σ_rows da``, both fp32;
* :func:`dx_fused`: ``dx = da · wᵀ`` in the operand dtype.

``da`` follows the probe's ``_da``: ``y`` and ``dy`` are brought to fp32;
relu gives ``dy`` where ``y > 0`` and 0 elsewhere, tanh ``dy · (1 − y·y)``,
none ``dy``; the result is rounded once to the operand dtype before it
enters a product or the bias sum.  That differs from
``ops/linear.py`` ``act_backward``, which evaluates the tanh branch in
``dy``'s dtype (for bf16: three roundings, not one); for relu and none, and
for fp32 operands, the two agree bit for bit.

As everywhere in ``ops/``, each kernel stands beside its plain PyTorch
version (``<op>_ref``); the wrapper runs the plain version for a CPU tensor
only, and for a CUDA tensor checks device, dtype, shape and contiguity,
launches the kernel and counts the launch in ``<op>.launches``, or raises.

Each op has three hand-written kernels, chosen by dtype, shape and pointer
alignment (``ops/tensor_cores.py``) or named by ``kernel``: bf16 operands
with k and n multiples of 8 and 16-byte aligned pointers take the
tensor-core forms (``csrc/wgmma.cuh``: ``da`` formed in registers from the
TMA-staged ``y`` and ``dy`` and multiplied from there; ``dW`` computed as
its transpose, the batch cut into :func:`~rawaudiovae_kelsey_tpu_torch.ops.
tensor_cores.wgrad_plan` 's slices); fp32 operands with k and n multiples
of 4 and 16-byte aligned pointers the register-tiled IEEE fp32 forms
(``csrc/sgemm.cuh``: ``da`` formed as the staged slabs are read back);
every other shape the first version.  A call counts once in ``launches``,
and in ``tensor_core_launches`` or ``sgemm_launches`` too when that form
ran it.
:func:`fused_bwd` is the pair as one backward, :func:`plain_bwd` the
backward the deep model takes today, with the same return contract; neither
is wired into ``PallasLinear``: ``probes/deep_bwd.py`` measures one against
the other.

Shapes: x ``(B, k)``, y and dy ``(B, n)``, w ``(k, n)``, all of one dtype
(fp32 or bf16) → dx ``(B, k)`` in that dtype, dW ``(k, n)`` and db ``(n,)``
fp32.  Ragged B, k and n are masked in the kernels; nothing is padded.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores
from rawaudiovae_kelsey_tpu_torch.ops.linear import ACT_CODES, act_backward
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    _f,
    _grads,
    _workspace,
    cuda_device,
    operand_dtype,
    require,
)

Tensor = torch.Tensor


def _known(name: str, act: str) -> None:
    if act not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {act!r}")


# ----------------------------------------------------------- plain versions

def cotangent(act: str, y: Tensor, dy: Tensor) -> Tensor:
    """``da = act'(y) · dy`` as the kernels form it (the probe's ``_da``):
    fp32 arithmetic on ``y`` and ``dy``, one rounding to ``y``'s dtype."""
    _known("cotangent", act)
    yf, g = _f(y), _f(dy)
    if act == "relu":
        da = torch.where(yf > 0, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))
    elif act == "tanh":
        da = g * (1.0 - yf * yf)
    else:
        da = g
    return da.to(y.dtype)


def dw_fused_ref(x, y, dy, act: str = "relu") -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`dw_fused`."""
    da = _f(cotangent(act, y, dy))
    return _f(x).t() @ da, da.sum(0)


def dx_fused_ref(y, dy, w, act: str = "relu") -> Tensor:
    """Plain version of :func:`dx_fused`."""
    return (_f(cotangent(act, y, dy)) @ _f(w).t()).to(y.dtype)


# ----------------------------------------------------------------- wrappers

@spanned("rvk.row18.dw_fused")
def dw_fused(x, y, dy, act: str = "relu", kernel: str = "auto"
             ) -> Tuple[Tensor, Tensor]:
    """``(dW, db) = (xᵀ · da, Σ_rows da)``, fp32, with ``da`` formed inside
    the kernel from ``y`` and ``dy``.

    Replaces ``benchmarks/deep_bwd_probe.py`` ``dw_fused``.  CUDA: one
    launch (``csrc/linear_bwd.cu``; two where the plan cuts the batch into
    slices, which ``sum_slices`` adds in order) of the kernel
    :func:`resolve_dw_fused` picks; every kernel gives equal bits on a
    second launch."""
    _known("dw_fused", act)
    tensor_cores.check_name("dw_fused", kernel)
    if x.device.type == "cpu":
        return dw_fused_ref(x, y, dy, act)
    dev = cuda_device(x, "dw_fused: x")
    dt = operand_dtype(x, "dw_fused: x")
    batch, k = x.shape
    if y.dim() != 2:
        raise ValueError(f"dw_fused: y has shape {tuple(y.shape)}")
    n = y.shape[1]
    if k < 1 or n < 1:
        raise ValueError(f"dw_fused: an empty layer, k = {k}, n = {n}")
    require(x, "x", (batch, k), dev, dt)
    require(y, "y", (batch, n), dev, dt)
    require(dy, "dy", (batch, n), dev, dt)
    code = resolve_dw_fused(kernel, dt, batch, k, n,
                            tensor_cores.pointers_aligned(x, y, dy))
    dw, db = _grads(dev, (k, n), (n,))
    tile, split = tensor_cores.cotangent_wgrad(code, dev, k, n, batch)
    _build.launch("rvk_dw_fused", dev, x, y, dy, dw, db,
                  _workspace(dev, split, k, n), batch, k, n, ACT_CODES[act],
                  DTYPE_CODES[dt], tile, split, code)
    dw_fused.launches += 1
    dw_fused.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    dw_fused.sgemm_launches += code == tensor_cores.SGEMM
    return dw, db


dw_fused.launches = 0
dw_fused.tensor_core_launches = 0
dw_fused.sgemm_launches = 0


def resolve_dw_fused(kernel: str, dtype: torch.dtype, batch: int, k: int,
                     n: int, aligned: bool = True) -> int:
    """The kernel code :func:`dw_fused` launches with: the tensor cores
    where ``tensor_cores.takes_tensor_cores`` holds for ``batch`` rows and
    widths ``k`` and ``n`` (the rows of ``x``, ``y`` and ``dy`` are TMA's
    16-byte rows; the contraction is the batch, of any length), the fp32
    kernel where ``tensor_cores.takes_sgemm`` does, else the first version;
    ``kernel`` names one instead (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "dw_fused", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, k, n, aligned),
        lambda: f"{dtype}, batch {batch}, k {k}, n {n}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, k, n, aligned))


@spanned("rvk.row19.dx_fused")
def dx_fused(y, dy, w, act: str = "relu", kernel: str = "auto") -> Tensor:
    """``dx = da · wᵀ`` in the operand dtype, with ``da`` formed inside the
    kernel from ``y`` and ``dy``; fp32 accumulation over all of n, one
    rounding.

    Replaces ``benchmarks/deep_bwd_probe.py`` ``dx_fused``.  CUDA: one
    launch (``csrc/linear_bwd.cu``) of the kernel
    ``tensor_cores.resolve_kernel`` picks (the contraction n, the output
    width k)."""
    _known("dx_fused", act)
    tensor_cores.check_name("dx_fused", kernel)
    if y.device.type == "cpu":
        return dx_fused_ref(y, dy, w, act)
    dev = cuda_device(y, "dx_fused: y")
    dt = operand_dtype(y, "dx_fused: y")
    batch, n = y.shape
    if w.dim() != 2:
        raise ValueError(f"dx_fused: w has shape {tuple(w.shape)}")
    k = w.shape[0]
    if k < 1 or n < 1:
        raise ValueError(f"dx_fused: an empty layer, k = {k}, n = {n}")
    require(y, "y", (batch, n), dev, dt)
    require(dy, "dy", (batch, n), dev, dt)
    require(w, "w", (k, n), dev, dt)
    code = tensor_cores.resolve_kernel(
        "dx_fused", kernel, dt, batch, n, k,
        tensor_cores.pointers_aligned(y, dy, w))
    dx = torch.empty((batch, k), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_dx_fused", dev, y, dy, w, dx, batch, k, n,
                      ACT_CODES[act], DTYPE_CODES[dt],
                      tensor_cores.cotangent_tile(code, dev, batch, k, n),
                      code)
        dx_fused.launches += 1
        dx_fused.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        dx_fused.sgemm_launches += code == tensor_cores.SGEMM
    return dx


dx_fused.launches = 0
dx_fused.tensor_core_launches = 0
dx_fused.sgemm_launches = 0


# ------------------------------------------------------ one layer's backward

def fused_bwd(x, y, dy, w, act: str = "relu", kernel: str = "auto"
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dx, dW, db)`` of one layer through the two fused kernels (the
    probe's ``fused_bwd``): one call each, no ``da`` in device memory."""
    dw, db = dw_fused(x, y, dy, act, kernel)
    return dx_fused(y, dy, w, act, kernel), dw, db


def plain_bwd(x, y, dy, w, act: str = "relu"
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dx, dW, db)`` of one layer as the deep model computes it today
    (the probe's ``xla_bwd``): ``da`` written out in ``dy``'s dtype
    (``act_backward``), three plain products in the operand dtype as in
    ``PallasLinear.backward``, then ``dW`` and ``db`` brought to fp32 as
    the train step does with every gradient."""
    da = act_backward(act, y, dy)
    dx = (da @ w.t()).to(x.dtype)
    return dx, (x.t() @ da).float(), da.sum(0).float()

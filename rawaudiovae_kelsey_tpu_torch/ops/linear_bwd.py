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

from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.ops.linear import ACT_CODES, act_backward
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    _f,
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

def dw_fused(x, y, dy, act: str = "relu") -> Tuple[Tensor, Tensor]:
    """``(dW, db) = (xᵀ · da, Σ_rows da)``, fp32, with ``da`` formed inside
    the kernel from ``y`` and ``dy``.

    Replaces ``benchmarks/deep_bwd_probe.py`` ``dw_fused``.  CUDA: one
    launch (``csrc/linear_bwd.cu``); a block owns a tile of ``dW`` over the
    whole batch, so two launches give equal bits."""
    _known("dw_fused", act)
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
    dw = torch.empty((k, n), device=dev, dtype=torch.float32)
    db = torch.empty((n,), device=dev, dtype=torch.float32)
    _build.launch("rvk_dw_fused", dev, x, y, dy, dw, db, batch, k, n,
                  ACT_CODES[act], DTYPE_CODES[dt])
    dw_fused.launches += 1
    return dw, db


dw_fused.launches = 0


def dx_fused(y, dy, w, act: str = "relu") -> Tensor:
    """``dx = da · wᵀ`` in the operand dtype, with ``da`` formed inside the
    kernel from ``y`` and ``dy``; fp32 accumulation over all of n, one
    rounding.

    Replaces ``benchmarks/deep_bwd_probe.py`` ``dx_fused``.  CUDA: one
    launch (``csrc/linear_bwd.cu``)."""
    _known("dx_fused", act)
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
    dx = torch.empty((batch, k), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_dx_fused", dev, y, dy, w, dx, batch, k, n,
                      ACT_CODES[act], DTYPE_CODES[dt])
        dx_fused.launches += 1
    return dx


dx_fused.launches = 0


# ------------------------------------------------------ one layer's backward

def fused_bwd(x, y, dy, w, act: str = "relu"
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dx, dW, db)`` of one layer through the two fused kernels (the
    probe's ``fused_bwd``): one launch each, no ``da`` in device memory."""
    dw, db = dw_fused(x, y, dy, act)
    return dx_fused(y, dy, w, act), dw, db


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

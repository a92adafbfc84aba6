"""The fused linear layer ``act(x @ w + b)`` of the deep/wide MLP VAE: the
CUDA counterparts of the JAX package's ``ops/pallas_linear.py``.

Two kernels compute the same function (``csrc/linear.cu``):

* :func:`linear_fwd`: an output tile owns the whole contraction, one
  launch;
* :func:`linear_ksplit_fwd`: the contraction is walked slice by slice in
  order.

fp32 operands with k and n multiples of 4 and 16-byte aligned pointers take
the register-tiled fp32 kernel (``csrc/sgemm.cuh``) in both: a block owns an
output tile and carries one fp32 accumulator per output across all of k
(IEEE FFMAs, in k order), no workspace; the two ops then launch the same
kernel and give the same bits.  bf16 operands that TMA can address
(``ops/tensor_cores.py``) take the tensor-core kernel (``csrc/wgmma.cuh``)
in both: one launch, a block owns an output tile and carries one fp32
accumulator across all of k, bias, activation and the one rounding in its
epilogue, no workspace.  The other fp32 operands, and bf16 ones TMA cannot
take, keep the first versions on the CUDA cores: for :func:`linear_fwd` one
tiled GEMM; for :func:`linear_ksplit_fwd` slices of ``KSPLIT_BLOCK_K`` over
a grid dimension, every block writes the fp32 partial sum of its slice to a
workspace and a second stage adds the slices in order, adds the bias,
applies the activation and rounds once.  None uses atomics, so two launches
give equal bits.

:func:`dispatch_fwd` picks between them by the JAX package's rule
(``_dispatch_fwd``): a layer with batch ≥ ``KSPLIT_BLOCK_B``, k ≥ 2 ·
``KSPLIT_BLOCK_K`` and n ≥ ``KSPLIT_BLOCK`` takes the k-split kernel, every
other the whole-k one.  The three constants keep the JAX package's names
and values because they decide which kernel a layer takes.

As in ``ops/mlp.py`` each kernel stands beside its plain PyTorch version
(``<op>_ref``) and its wrapper runs the plain version for a CPU tensor
only; for a CUDA tensor it checks device, dtype, shape and contiguity,
launches the kernel and counts the launch in ``<op>.launches``, or raises.

:func:`pallas_linear` is the differentiable layer (the role of the JAX
``pallas_linear``).  Its backward is what the JAX custom VJP does outside
any kernel: ``da`` from the saved output (ReLU: ``y > 0``; tanh: ``1 -
y²``) in the cotangent's dtype, then ``da @ wᵀ``, ``xᵀ @ da`` and
``da.sum(0)`` as plain products.  :func:`deep_encode_pallas` /
:func:`deep_decode_pallas` run the deep model on it.

Shapes: x ``(B, k)``, w ``(k, n)``, b ``(n,)`` → ``(B, n)`` in x's dtype;
fp32 or bf16 operands, all of one dtype; fp32 accumulation.  Ragged B, k
and n are masked in the kernels; nothing is padded.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import span, spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    _f,
    cuda_device,
    operand_dtype,
    require,
)

Tensor = torch.Tensor

# activation name → the code the C entry points take (csrc/gemm.cuh Act)
ACT_CODES = {"none": 0, "relu": 1, "tanh": 2}

# the dispatch rule's constants (pallas_linear.py): the k-split kernel's
# batch tile, its output tile and its contraction slice there; here the
# first two only gate the dispatch and the third is also the slice depth
KSPLIT_BLOCK_B = 1024
KSPLIT_BLOCK = 512
KSPLIT_BLOCK_K = 512


def apply_act(act: str, v: Tensor) -> Tensor:
    """``relu`` | ``tanh`` | ``none`` on ``v``; anything else raises."""
    if act == "relu":
        return torch.relu(v)
    if act == "tanh":
        return torch.tanh(v)
    if act == "none":
        return v
    raise ValueError(f"unknown activation {act!r}")


def ksplit_slices(k: int) -> int:
    """The k-split kernel's slice count for a contraction of ``k``: a
    function of the shape alone."""
    return -(-k // KSPLIT_BLOCK_K)


# ----------------------------------------------------------- plain versions

def linear_fwd_ref(x, w, b, act: str = "none") -> Tensor:
    """Plain version of :func:`linear_fwd`."""
    return apply_act(act, _f(x) @ _f(w) + _f(b)).to(x.dtype)


def linear_ksplit_fwd_ref(x, w, b, act: str = "none") -> Tensor:
    """Plain version of :func:`linear_ksplit_fwd`: the partial product of
    each ``KSPLIT_BLOCK_K`` slice of the contraction, added in slice order
    in fp32, then bias, activation and one rounding."""
    xf, wf = _f(x), _f(w)
    acc = None
    for k0 in range(0, x.shape[1], KSPLIT_BLOCK_K):
        part = xf[:, k0:k0 + KSPLIT_BLOCK_K] @ wf[k0:k0 + KSPLIT_BLOCK_K]
        acc = part if acc is None else acc + part
    return apply_act(act, acc + _f(b)).to(x.dtype)


def linear_partial_ref(x, w, ksplit: bool = False) -> Tensor:
    """Plain version of :func:`linear_partial`: ``x @ w`` in fp32, the
    k-split's slices added in slice order."""
    if not ksplit:
        return _f(x) @ _f(w)
    xf, wf = _f(x), _f(w)
    acc = None
    for k0 in range(0, x.shape[1], KSPLIT_BLOCK_K):
        part = xf[:, k0:k0 + KSPLIT_BLOCK_K] @ wf[k0:k0 + KSPLIT_BLOCK_K]
        acc = part if acc is None else acc + part
    return acc


# ----------------------------------------------------------------- wrappers

def _check(name: str, x, w, b, act: str):
    if act not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {act!r}")
    dev = cuda_device(x, f"{name}: x")
    dt = operand_dtype(x, f"{name}: x")
    batch, k = x.shape
    if w.dim() != 2 or k < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    require(x, "x", (batch, k), dev, dt)
    require(w, "w", (k, n), dev, dt)
    require(b, "b", (n,), dev, dt)
    return dev, dt, batch, k, n


@spanned("rvk.row16.linear_fwd")
def linear_fwd(x, w, b, act: str = "none", kernel: str = "auto") -> Tensor:
    """``act(x @ w + b)``, the whole contraction in one pass per output
    tile.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_linear.py`` ``linear_fwd``.
    CUDA, one launch of one of three hand-written kernels
    (``ops/tensor_cores.py``): bf16 operands TMA can address take the
    tensor-core kernel (``csrc/wgmma.cuh``), fp32 operands with k and n
    multiples of 4 and 16-byte aligned pointers the register-tiled fp32
    kernel (``csrc/sgemm.cuh``), everything else the tiled GEMM on the CUDA
    cores (``csrc/linear.cu``).  ``kernel`` names one instead; a kernel
    named on operands it cannot take raises.  One call counts once in
    ``launches``, and in ``tensor_core_launches`` or ``sgemm_launches`` too
    when that kernel ran."""
    tensor_cores.check_name("linear_fwd", kernel)
    if x.device.type == "cpu":
        return linear_fwd_ref(x, w, b, act)
    dev, dt, batch, k, n, code, tile = _prepare("linear_fwd", x, w, b, act,
                                                kernel)
    y = torch.empty((batch, n), device=dev, dtype=dt)
    if batch and n:
        _build.launch("rvk_linear_fwd", dev, x, w, b, y, batch, k, n,
                      ACT_CODES[act], DTYPE_CODES[dt], tile, code)
        linear_fwd.launches += 1
        linear_fwd.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        linear_fwd.sgemm_launches += code == tensor_cores.SGEMM
    return y


linear_fwd.launches = 0
linear_fwd.tensor_core_launches = 0
linear_fwd.sgemm_launches = 0


def _prepare(name: str, x, w, b, act: str, kernel: str):
    """The checks and the kernel choice of :func:`linear_fwd` and
    :func:`linear_ksplit_fwd` on CUDA tensors → ``(device, dtype, batch, k,
    n, kernel code, tile width)``."""
    dev, dt, batch, k, n = _check(name, x, w, b, act)
    code = tensor_cores.resolve_kernel(
        name, kernel, dt, batch, k, n, tensor_cores.pointers_aligned(x, w, b))
    tile = tensor_cores.tile(code, dev, batch, n) if batch and n else 0
    return dev, dt, batch, k, n, code, tile


@spanned("rvk.row15.linear_ksplit_fwd")
def linear_ksplit_fwd(x, w, b, act: str = "none",
                      kernel: str = "auto") -> Tensor:
    """``act(x @ w + b)`` with the contraction walked in
    :func:`ksplit_slices` slices, in order: the large-layer path.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_linear.py``
    ``linear_ksplit_fwd``.  CUDA, one of three hand-written kernels, chosen
    by ``tensor_cores.resolve_kernel``: bf16 operands with k and n multiples
    of 8 and 16-byte aligned pointers take the tensor-core kernel
    (``csrc/wgmma.cuh``), fp32 operands with k and n multiples of 4 and
    16-byte aligned pointers the register-tiled fp32 kernel
    (``csrc/sgemm.cuh``; the same launch as :func:`linear_fwd`'s, equal
    bits), both one launch with one fp32 accumulator across all of k and
    no workspace; everything else the first version (``csrc/linear.cu``;
    the per-slice partial products into an fp32 workspace ``(slices, B,
    n)``, then their ordered sum with the bias and the activation).
    ``kernel`` names one instead (``tensor_cores.KERNEL_CODES``); a kernel
    named on operands it cannot take raises.  The kernels round
    differently, so the output's bits depend on the choice and hence on
    the pointers' alignment (an unaligned contiguous view may differ from
    the aligned tensor by a bf16 ulp, an fp32 one by a few ulps).  One call
    counts once in ``launches``, whichever ran, and in
    ``tensor_core_launches`` or ``sgemm_launches`` too when that one
    ran."""
    tensor_cores.check_name("linear_ksplit_fwd", kernel)
    if x.device.type == "cpu":
        return linear_ksplit_fwd_ref(x, w, b, act)
    dev, dt, batch, k, n, code, tile = _prepare("linear_ksplit_fwd", x, w, b,
                                                act, kernel)
    y = torch.empty((batch, n), device=dev, dtype=dt)
    if batch and n:
        slices = ksplit_slices(k)
        ws = None if code else torch.empty((slices, batch, n), device=dev,
                                           dtype=torch.float32)
        _build.launch("rvk_linear_ksplit_fwd", dev, x, w, b, y, ws, batch, k,
                      n, slices, KSPLIT_BLOCK_K, ACT_CODES[act],
                      DTYPE_CODES[dt], tile, code)
        linear_ksplit_fwd.launches += 1
        linear_ksplit_fwd.tensor_core_launches += \
            code == tensor_cores.TENSOR_CORES
        linear_ksplit_fwd.sgemm_launches += code == tensor_cores.SGEMM
    return y


linear_ksplit_fwd.launches = 0
linear_ksplit_fwd.tensor_core_launches = 0
linear_ksplit_fwd.sgemm_launches = 0


def linear_partial(x, w, ksplit: bool = False,
                   kernel: str = "auto") -> Tensor:
    """The row-parallel form of :func:`linear_fwd` (``ksplit`` False) or
    :func:`linear_ksplit_fwd` (True): ``x @ w`` as fp32 partial sums, no
    bias, no activation — a rank's column slice of the layer's input times
    its row shard of the weight (``parallel/tensor_parallel.py``).  The
    model group adds the sums; the bias, the activation and the one
    rounding follow.

    CUDA, one launch of ``csrc/linear.cu`` ``rvk_linear_partial``, of the
    kernel ``tensor_cores.resolve_kernel`` picks for that row: bf16
    operands TMA can address on the tensor cores (``csrc/wgmma.cuh``
    ``PartialRows``: the accumulators stored as fp32), fp32 operands with k
    and n multiples of 4 on ``csrc/sgemm.cuh`` (no bias, no activation),
    everything else the row's first version with an fp32 output (the
    whole-k GEMM, or the k-split's two stages).  Counts one launch of the
    row's wrapper (``launches`` and ``partial_launches``, and the kernel's
    own counter), in the row's span."""
    wrapper = linear_ksplit_fwd if ksplit else linear_fwd
    with span(wrapper.span_name):
        return _linear_partial(wrapper, x, w, ksplit, kernel)


def _linear_partial(wrapper, x, w, ksplit: bool, kernel: str) -> Tensor:
    name = wrapper.__name__
    tensor_cores.check_name(name, kernel)
    if x.device.type == "cpu":
        return linear_partial_ref(x, w, ksplit)
    dev = cuda_device(x, f"{name}: x")
    dt = operand_dtype(x, f"{name}: x")
    batch, k = x.shape
    if w.dim() != 2 or k < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    require(x, "x", (batch, k), dev, dt)
    require(w, "w", (k, n), dev, dt)
    code = tensor_cores.resolve_kernel(
        name, kernel, dt, batch, k, n, tensor_cores.pointers_aligned(x, w))
    y = torch.empty((batch, n), device=dev, dtype=torch.float32)
    if batch and n:
        tile = tensor_cores.tile(code, dev, batch, n)
        slices = ksplit_slices(k) if ksplit else 0
        ws = (torch.empty((slices, batch, n), device=dev,
                          dtype=torch.float32)
              if slices and code == tensor_cores.KERNEL_CODES["cuda_cores"]
              else None)
        _build.launch("rvk_linear_partial", dev, x, w, y, ws, batch, k, n,
                      slices, KSPLIT_BLOCK_K, DTYPE_CODES[dt], tile, code)
        wrapper.launches += 1
        wrapper.partial_launches += 1
        wrapper.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        wrapper.sgemm_launches += code == tensor_cores.SGEMM
    return y


linear_fwd.partial_launches = 0
linear_ksplit_fwd.partial_launches = 0


def takes_ksplit(batch: int, k: int, n: int) -> bool:
    """The dispatch rule (``pallas_linear.py`` ``_dispatch_fwd``): large
    layers, where both operands stream, take the k-split kernel."""
    return (batch >= KSPLIT_BLOCK_B and k >= 2 * KSPLIT_BLOCK_K
            and n >= KSPLIT_BLOCK)


def dispatch_fwd(x, w, b, act: str = "none") -> Tensor:
    if takes_ksplit(x.shape[0], w.shape[0], w.shape[1]):
        return linear_ksplit_fwd(x, w, b, act)
    return linear_fwd(x, w, b, act)


# ------------------------------------------------------- autograd Function

def act_backward(act: str, y: Tensor, dy: Tensor) -> Tensor:
    """The cotangent before the activation, from the saved output, in
    ``dy``'s dtype (``pallas_linear.py`` ``_bwd``)."""
    if act == "relu":
        da = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                device=dy.device))
    elif act == "tanh":
        da = dy * (1.0 - y * y)
    else:
        da = dy
    return da.to(dy.dtype)


def linear_grads(act: str, x, w, y, dy, need_dx: bool):
    """``(dx, dw, db)`` of ``y = act(x @ w + b)`` from the saved ``(x, w,
    y)``, plain PyTorch; ``dx`` None unless ``need_dx``."""
    da = act_backward(act, y, dy)
    dx = (da @ w.t()).to(x.dtype) if need_dx else None
    return dx, (x.t() @ da).to(w.dtype), da.sum(0).to(w.dtype)


class PallasLinear(torch.autograd.Function):
    """``(x, w, b, act) → act(x @ w + b)`` through :func:`dispatch_fwd`;
    saves ``(x, w, y)``.  The backward is plain PyTorch, as the JAX
    package's is plain XLA."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        y = dispatch_fwd(x, w, b, act)
        ctx.save_for_backward(x, w, y)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        return (*linear_grads(ctx.act, x, w, y, dy, ctx.needs_input_grad[0]),
                None)


def pallas_linear(x, w, b, act: str = "none") -> Tensor:
    """Differentiable fused linear + activation (relu | tanh | none)."""
    return PallasLinear.apply(x, w, b, act)


def deep_encode_pallas(params, x) -> Tuple[Tensor, Tensor]:
    """The deep model's encoder (``models/variants.py`` layout) on the
    fused kernels."""
    h = x
    for layer in params["enc"]:
        h = pallas_linear(h, layer["w"], layer["b"], "relu")
    mu = pallas_linear(h, params["mu_head"]["w"], params["mu_head"]["b"],
                       "none")
    logvar = pallas_linear(h, params["logvar_head"]["w"],
                           params["logvar_head"]["b"], "none")
    return mu, logvar


def deep_decode_pallas(params, z) -> Tensor:
    h = z
    for layer in params["dec"][:-1]:
        h = pallas_linear(h, layer["w"], layer["b"], "relu")
    last = params["dec"][-1]
    return pallas_linear(h, last["w"], last["b"], "tanh")

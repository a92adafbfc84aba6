"""SnakeBeta, the Oobleck VAE's activation (``models/variants.py``), fused:

    y = x + 1 / (e^beta + 1e-9) · sin²(e^alpha · x)

with ``x`` of shape ``(B, C, L)`` and ``alpha``, ``beta`` one value a
channel, in log scale (BigVGAN's ``SnakeBeta`` with ``alpha_logscale``).
No TPU kernel of the JAX package computes it: row 21 of PERF.md's table is
a port-only kernel.  Plain PyTorch runs the forward as five elementwise
passes and autograd saves three more tensors of ``x``'s size for the
backward; :func:`snake_fwd` is one launch that reads ``x`` and writes
``y``, and :func:`snake_bwd` one launch that reads ``x`` and ``dy``, writes
``dx`` and reduces both parameters' gradients per channel
(``csrc/snake.cu``).  :class:`Snake`, the autograd Function, saves ``x``
alone.

Beside each, as for every kernel of the package: the plain version
(:func:`snake_ref`, :func:`snake_bwd_ref`), which the wrapper runs for CPU
tensors only, and a launch counter.  The arithmetic is fp32 (float64 for
float64 tensors in the plain versions), each output rounded once to its
input's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.ops.mlp import DTYPE_CODES, require

Tensor = torch.Tensor

EPS = 1e-9
# the forward's grid: elementwise, so any grid gives the same bits
_FWD_BLOCKS = 132 * 16
# the backward's blocks: about this many in all, split over the channels;
# a function of the shape alone, and with it the order of the parameters'
# sums
_BWD_TARGET_BLOCKS = 132 * 8
_THREADS, _CHUNK = 256, 8
# a device's channel counters (csrc/snake.cu): zero between launches
_counters: Dict[torch.device, Tensor] = {}


def _math_dtype(t: Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def snake_ref(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """Plain version of :func:`snake_fwd`."""
    md = _math_dtype(x)
    a = torch.exp(alpha.to(md))[:, None]
    inv = 1.0 / (torch.exp(beta.to(md))[:, None] + EPS)
    xf = x.to(md)
    return (xf + inv * torch.square(torch.sin(a * xf))).to(x.dtype)


def snake_bwd_ref(x: Tensor, alpha: Tensor, beta: Tensor, dy: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`snake_bwd`: the closed-form gradients."""
    md = _math_dtype(x)
    a = torch.exp(alpha.to(md))[:, None]
    eb = torch.exp(beta.to(md))
    inv = 1.0 / (eb + EPS)
    t = a * x.to(md)
    g = dy.to(md)
    s = torch.sin(t)
    s2t = torch.sin(2.0 * t)
    dx = g * (1.0 + inv[:, None] * a * s2t)
    d_alpha = inv * (g * s2t * t).sum(dim=(0, 2))
    d_beta = -inv * inv * eb * (g * s * s).sum(dim=(0, 2))
    return dx.to(x.dtype), d_alpha.to(alpha.dtype), d_beta.to(beta.dtype)


def _operands(name: str, x: Tensor, alpha: Tensor, beta: Tensor):
    if x.device.type != "cuda" or x.dim() != 3:
        raise ValueError(f"{name}: the kernel takes a (B, C, L) CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    if x.dtype not in DTYPE_CODES or alpha.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtypes {x.dtype} / {alpha.dtype}, the "
                        "kernel takes float32 or bfloat16")
    rows, channels, length = x.shape
    require(x, "x", (rows, channels, length), x.device, x.dtype)
    require(alpha, "alpha", (channels,), x.device, alpha.dtype)
    require(beta, "beta", (channels,), x.device, alpha.dtype)
    return x.device, (rows, channels, length)


def bwd_splits(rows: int, channels: int, length: int) -> int:
    """The backward's blocks a channel: about ``_BWD_TARGET_BLOCKS`` in all,
    none with fewer units (chunks of 8, or elements) than threads."""
    width = _CHUNK if length % _CHUNK == 0 else 1
    units = rows * (length // width)
    most = max(1, -(-units // _THREADS))
    return max(1, min(most, -(-_BWD_TARGET_BLOCKS // channels)))


@spanned("rvk.row21.snake_fwd")
def snake_fwd(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """SnakeBeta of ``x`` ``(B, C, L)`` with ``alpha``, ``beta`` ``(C,)``,
    in ``x``'s dtype.  CUDA: one launch (``csrc/snake.cu``), x and y fp32
    or bf16, the parameters fp32 or bf16 (of one dtype), fp32 arithmetic;
    16-byte vectors where L is a multiple of 8 and the pointers aligned."""
    if x.device.type == "cpu":
        return snake_ref(x, alpha, beta)
    dev, (rows, channels, length) = _operands("snake_fwd", x, alpha, beta)
    y = torch.empty_like(x)
    _build.launch("rvk_snake_fwd", dev, x, alpha, beta, y, rows, channels,
                  length, _FWD_BLOCKS, DTYPE_CODES[x.dtype],
                  DTYPE_CODES[alpha.dtype])
    snake_fwd.launches += 1
    return y


snake_fwd.launches = 0


def _channel_counters(device: torch.device, channels: int) -> Tensor:
    have = _counters.get(device)
    if have is None or have.numel() < channels:
        have = torch.zeros(max(channels, 4096), dtype=torch.int32,
                           device=device)
        _counters[device] = have
    return have


@spanned("rvk.row21.snake_bwd")
def snake_bwd(x: Tensor, alpha: Tensor, beta: Tensor, dy: Tensor
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dx, d alpha, d beta)`` of SnakeBeta under the cotangent ``dy``
    (``x``'s shape and dtype), each in its input's dtype.  CUDA: one launch
    (``csrc/snake.cu``): dx elementwise, the parameters' gradients summed
    per channel over :func:`bwd_splits` blocks a channel in an order that
    is a function of the shape alone, the last block of a channel adding
    the blocks' partials."""
    if x.device.type == "cpu":
        return snake_bwd_ref(x, alpha, beta, dy)
    dev, (rows, channels, length) = _operands("snake_bwd", x, alpha, beta)
    dy = dy.contiguous()
    require(dy, "dy", tuple(x.shape), dev, x.dtype)
    splits = bwd_splits(rows, channels, length)
    dx = torch.empty_like(x)
    d_alpha = torch.empty_like(alpha)
    d_beta = torch.empty_like(beta)
    partials = torch.empty((channels * splits * 2 if splits > 1 else 1,),
                           dtype=torch.float32, device=dev)
    _build.launch("rvk_snake_bwd", dev, x, alpha, beta, dy, dx, d_alpha,
                  d_beta, partials, _channel_counters(dev, channels), rows,
                  channels, length, splits, DTYPE_CODES[x.dtype],
                  DTYPE_CODES[alpha.dtype])
    snake_bwd.launches += 1
    return dx, d_alpha, d_beta


snake_bwd.launches = 0


class Snake(torch.autograd.Function):
    """``(x, alpha, beta) → y`` through :func:`snake_fwd`, its backward
    :func:`snake_bwd`; the tensors saved are ``x`` and the two ``(C,)``
    parameters."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return snake_fwd(x, alpha, beta)

    @staticmethod
    def backward(ctx, dy):
        return snake_bwd(*ctx.saved_tensors, dy)


def snake(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """SnakeBeta of ``x`` ``(B, C, L)``, differentiable in all three."""
    return Snake.apply(x.contiguous(), alpha.contiguous(),
                       beta.contiguous())

"""Fused VAE loss reduction: the CUDA counterpart of the JAX package's
``ops/pallas_loss.py``.

``MSE + β·KL`` needs two sums, ``Σ(recon−x)²`` and ``Σ(1+logvar−mu²−
e^logvar)``.  :func:`loss_sums` takes both in one pass over the four
tensors with a hand-written kernel (``csrc/loss.cu``): neither the squared
error nor the KL integrand reaches device memory.  Beside it, as for every
kernel of the package: the plain version :func:`loss_sums_ref`, which the
wrapper runs for CPU tensors only, and a launch counter.

:func:`fused_loss` and :func:`fused_loss_components` are the
``pallas_loss`` / ``pallas_loss_components`` of the JAX package:
``torch.autograd.Function`` s over :func:`loss_sums` whose backward is the
closed-form elementwise gradient, left to PyTorch's elementwise ops as the
JAX package leaves it to XLA:

    d recon  = 2 (recon − x) / N_x · g      (d x = −d recon)
    d mu     = β mu / N_l · g
    d logvar = β (e^logvar − 1) / (2 N_l) · g

The numbers are those of ``models/vae.py`` ``loss_components`` in fp32.
The train step does not dispatch these ops: like the JAX step
(``parallel/step.py``), it keeps the loss on plain ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    DTYPE_CODES,
    cuda_device,
    operand_dtype,
    require,
)

Tensor = torch.Tensor

# stage-1 grid of the kernel: one block per _BLOCK_ELEMS elements of recon,
# at most _MAX_BLOCKS.  A function of the shape alone, so the order of the
# additions, and with it every bit of the sums, repeats from run to run.
_BLOCK_ELEMS = 256 * 16
_MAX_BLOCKS = 1024


def _f(t: Tensor) -> Tensor:
    return t.to(torch.float32)


def loss_sums_ref(recon, x, mu, logvar) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`loss_sums`: two fp32 sums."""
    sq = torch.square(_f(recon) - _f(x)).sum()
    kl = (1.0 + _f(logvar) - torch.square(_f(mu))
          - torch.exp(_f(logvar))).sum()
    return sq, kl


def _same_dtype(*tensors: Tensor) -> Tuple[Tensor, ...]:
    """The tensors in one dtype: fp32 as soon as any two differ."""
    if len({t.dtype for t in tensors}) == 1:
        return tensors
    return tuple(_f(t) for t in tensors)


@spanned("rvk.row14.loss_sums")
def loss_sums(recon, x, mu, logvar) -> Tuple[Tensor, Tensor]:
    """``(Σ(recon−x)², Σ(1+logvar−mu²−e^logvar))`` as two 0-d fp32 tensors,
    from one pass.  ``recon``/``x`` are ``(batch, seg)``, ``mu``/``logvar``
    ``(batch, latent)``, fp32 or bf16 (mixed dtypes are brought to fp32
    first); the arithmetic is fp32.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_loss.py`` ``_loss_sums``.
    CUDA: two launches (``csrc/loss.cu``), per-block partial sums and a
    one-block sum of the partials in a fixed order — no atomics, equal bits
    on every run.  The ragged tail is masked; nothing is padded."""
    if recon.device.type == "cpu":
        return loss_sums_ref(recon, x, mu, logvar)
    dev = cuda_device(recon, "loss_sums: recon")
    recon, x, mu, logvar = _same_dtype(recon, x, mu, logvar)
    dt = operand_dtype(recon, "loss_sums: recon")
    batch, seg = recon.shape
    latent = mu.shape[-1]
    require(recon, "recon", (batch, seg), dev, dt)
    require(x, "x", (batch, seg), dev, dt)
    require(mu, "mu", (batch, latent), dev, dt)
    require(logvar, "logvar", (batch, latent), dev, dt)
    n_x, n_l = batch * seg, batch * latent
    blocks = max(1, min(_MAX_BLOCKS, -(-n_x // _BLOCK_ELEMS)))
    partials = torch.empty((blocks, 2), device=dev, dtype=torch.float32)
    out = torch.empty((2,), device=dev, dtype=torch.float32)
    _build.launch("rvk_loss_sums", dev, recon, x, mu, logvar, partials, out,
                  n_x, n_l, blocks, DTYPE_CODES[dt])
    loss_sums.launches += 1
    return out[0], out[1]


loss_sums.launches = 0


def _check_reduction(reduction: str) -> None:
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction {reduction!r}: expected 'mean' or 'sum'")


def _components(recon, x, mu, logvar, kl_beta: float, reduction: str
                ) -> Tuple[Tensor, Tensor, Tensor]:
    sq, kl = loss_sums(recon, x, mu, logvar)
    if reduction == "mean":
        mse = sq / recon.numel()
        kld = -0.5 * kl / mu.numel()
    else:
        mse, kld = sq, -0.5 * kl
    return mse + kl_beta * kld, mse, kld


def _input_grads(ctx, recon, x, mu, logvar, g_m, g_k):
    """Closed-form gradients for cotangents ``g_m`` of the MSE term and
    ``g_k`` of the KLD term (``pallas_loss.py:145-159``), each in its
    input's dtype; ``None`` for inputs that need none."""
    n_x, n_l = (recon.numel(), mu.numel()) if ctx.reduction == "mean" \
        else (1, 1)
    need = ctx.needs_input_grad
    d_recon = d_x = d_mu = d_logvar = None
    if need[0] or need[1]:
        d = (2.0 / n_x) * (_f(recon) - _f(x)) * g_m
        d_recon = d.to(recon.dtype) if need[0] else None
        d_x = (-d).to(x.dtype) if need[1] else None
    if need[2]:
        d_mu = ((1.0 / n_l) * _f(mu) * g_k).to(mu.dtype)
    if need[3]:
        d_logvar = ((1.0 / (2.0 * n_l)) * (torch.exp(_f(logvar)) - 1.0)
                    * g_k).to(logvar.dtype)
    return d_recon, d_x, d_mu, d_logvar


class FusedLoss(torch.autograd.Function):
    """``(recon, x, mu, logvar, kl_beta, reduction) → loss`` through
    :func:`loss_sums`; the JAX package's ``pallas_loss``."""

    @staticmethod
    def forward(ctx, recon, x, mu, logvar, kl_beta, reduction):
        ctx.save_for_backward(recon, x, mu, logvar)
        ctx.kl_beta, ctx.reduction = kl_beta, reduction
        return _components(recon, x, mu, logvar, kl_beta, reduction)[0]

    @staticmethod
    def backward(ctx, g):
        grads = _input_grads(ctx, *ctx.saved_tensors, g, ctx.kl_beta * g)
        return (*grads, None, None)


class FusedLossComponents(torch.autograd.Function):
    """``(recon, x, mu, logvar, kl_beta, reduction) → (loss, mse, kld)``
    through :func:`loss_sums`; the JAX package's
    ``pallas_loss_components``."""

    @staticmethod
    def forward(ctx, recon, x, mu, logvar, kl_beta, reduction):
        ctx.save_for_backward(recon, x, mu, logvar)
        ctx.kl_beta, ctx.reduction = kl_beta, reduction
        return _components(recon, x, mu, logvar, kl_beta, reduction)

    @staticmethod
    def backward(ctx, g_loss, g_mse, g_kld):
        # loss = mse + beta * kld, so the cotangents combine linearly
        grads = _input_grads(ctx, *ctx.saved_tensors, g_loss + g_mse,
                             ctx.kl_beta * g_loss + g_kld)
        return (*grads, None, None)


def fused_loss(recon, x, mu, logvar, kl_beta: float,
               reduction: str = "mean") -> Tensor:
    """``mse + kl_beta · kld`` with the numbers of ``models/vae.py``
    ``loss_fn``, the sums from one kernel pass."""
    _check_reduction(reduction)
    return FusedLoss.apply(recon, x, mu, logvar, float(kl_beta), reduction)


def fused_loss_components(recon, x, mu, logvar, kl_beta: float,
                          reduction: str = "mean"
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(loss, mse, kld)``: the ``models/vae.py`` ``loss_components``
    contract, the sums from one kernel pass."""
    _check_reduction(reduction)
    return FusedLossComponents.apply(recon, x, mu, logvar, float(kl_beta),
                                     reduction)

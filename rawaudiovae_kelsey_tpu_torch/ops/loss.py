"""Fused VAE loss: the CUDA counterpart of the JAX package's
``ops/pallas_loss.py``, and the train step's loss on the card.

``MSE + β·KL`` needs two sums, ``Σ(recon−x)²`` and ``Σ(1+logvar−mu²−
e^logvar)``.  :func:`loss_sums` takes both in one pass over the four
tensors with a hand-written kernel (``csrc/loss.cu``): neither the squared
error nor the KL integrand reaches device memory.  :func:`loss_grads` is
the closed-form gradient in one more pass, a second kernel of the same
file:

    d recon  = 2 (recon − x) / N_x · g_m      (d x = −d recon)
    d mu     = mu / N_l · g_k
    d logvar = (e^logvar − 1) / (2 N_l) · g_k

``g_m`` the cotangent of the MSE term, ``g_k`` of the KLD term (β times
the loss's), N = 1 under ``sum``.  Both kernels read ``recon`` / ``x`` and
``mu`` / ``logvar`` in their own dtypes (fp32 or bf16 each pair) and
compute in fp32 registers.  Beside each, as for every kernel of the
package: the plain version (:func:`loss_sums_ref`, :func:`loss_grads_ref`),
which the wrapper runs for CPU tensors only, and a launch counter.

:func:`fused_loss` and :func:`fused_loss_components` are the
``pallas_loss`` / ``pallas_loss_components`` of the JAX package:
``torch.autograd.Function`` s over :func:`loss_sums` whose backward is
:func:`loss_grads`.  The numbers are those of ``models/vae.py``
``loss_components`` in fp32, the sums' additions in another order.

The train step's loss is its model's (``models/registry.py``): under
``backend = pallas`` it runs through :func:`fused_loss_components` where
:func:`takes_fused_loss` says the kernels take the tensors (CUDA, the
shapes and dtypes above).  The JAX step leaves its loss to XLA;
everywhere else the port's step keeps the plain ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

# the kernels' grid: one block per _BLOCK_ELEMS elements of recon (256
# threads, two chunks of 8 elements each a loop turn), at most
# _MAX_BLOCKS.  A function of the shape alone, so the order of the sums'
# additions, and with it every bit of the sums, repeats from run to run
# and does not depend on the dtypes.
_BLOCK_ELEMS = 256 * 16
_MAX_BLOCKS = 1024
# the gradient kernel's grid, by the reconstruction's dtype: elementwise,
# so any grid gives the same bits; at most these many blocks read fastest
# at the benchmark's shapes on an H100 (fp32 with two blocks an SM, bf16
# with a block for every 4096 elements up to 64 an SM)
_GRAD_BLOCKS = {torch.float32: 264, torch.bfloat16: 8448}


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


def _operands(name, recon, x, mu, logvar):
    """The kernels' operands, checked: each pair (``recon``, ``x``) and
    (``mu``, ``logvar``) in one dtype, fp32 if its two differ, and bf16
    ``mu`` / ``logvar`` beside an fp32 ``recon`` brought to fp32 too (the
    kernels are built for fp32 / fp32, bf16 / fp32 and bf16 / bf16); → the
    device, the four tensors and the pairs' dtypes."""
    dev = cuda_device(recon, f"{name}: recon")
    recon, x = _same_dtype(recon, x)
    mu, logvar = _same_dtype(mu, logvar)
    if recon.dtype == torch.float32 and mu.dtype == torch.bfloat16:
        mu, logvar = _f(mu), _f(logvar)
    dx = operand_dtype(recon, f"{name}: recon")
    dl = operand_dtype(mu, f"{name}: mu")
    batch, seg = recon.shape
    latent = mu.shape[-1]
    require(recon, "recon", (batch, seg), dev, dx)
    require(x, "x", (batch, seg), dev, dx)
    require(mu, "mu", (batch, latent), dev, dl)
    require(logvar, "logvar", (batch, latent), dev, dl)
    return dev, (recon, x, mu, logvar), (dx, dl)


def _blocks(n_x: int, most: int = _MAX_BLOCKS) -> int:
    return max(1, min(most, -(-n_x // _BLOCK_ELEMS)))


@spanned("rvk.row14.loss_sums")
def loss_sums(recon, x, mu, logvar) -> Tuple[Tensor, Tensor]:
    """``(Σ(recon−x)², Σ(1+logvar−mu²−e^logvar))`` as two 0-d fp32 tensors,
    from one pass.  ``recon``/``x`` are ``(batch, seg)``, ``mu``/``logvar``
    ``(batch, latent)``, each pair fp32 or bf16 (a pair of two dtypes is
    brought to fp32 first); the arithmetic is fp32.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_loss.py`` ``_loss_sums``.
    CUDA: two launches (``csrc/loss.cu``), per-block partial sums and a
    one-block sum of the partials in a fixed order, a function of the
    shapes alone — no atomics, equal bits on every run and for bf16
    operands and their fp32 copies.  The ragged tail is masked; nothing is
    padded."""
    if recon.device.type == "cpu":
        return loss_sums_ref(recon, x, mu, logvar)
    dev, four, (dx, dl) = _operands("loss_sums", recon, x, mu, logvar)
    n_x, n_l = recon.numel(), mu.numel()
    blocks = _blocks(n_x)
    partials = torch.empty((blocks, 2), device=dev, dtype=torch.float32)
    out = torch.empty((2,), device=dev, dtype=torch.float32)
    _build.launch("rvk_loss_sums", dev, *four, partials, out, n_x, n_l,
                  blocks, DTYPE_CODES[dx], DTYPE_CODES[dl])
    loss_sums.launches += 1
    return out[0], out[1]


loss_sums.launches = 0


def loss_grads_ref(recon, x, mu, logvar, g_m, g_k, n_x, n_l
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`loss_grads`, in fp32, each gradient rounded
    once to its input's dtype (``pallas_loss.py:145-159``)."""
    d_recon = (2.0 / n_x) * (_f(recon) - _f(x)) * g_m
    d_mu = (1.0 / n_l) * _f(mu) * g_k
    d_logvar = (1.0 / (2.0 * n_l)) * (torch.exp(_f(logvar)) - 1.0) * g_k
    return (d_recon.to(recon.dtype), d_mu.to(mu.dtype),
            d_logvar.to(logvar.dtype))


@spanned("rvk.row14.loss_grads")
def loss_grads(recon, x, mu, logvar, g_m, g_k, n_x: int, n_l: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(d recon, d mu, d logvar)`` of ``Σ(recon−x)² / n_x`` under the
    cotangent ``g_m`` and of ``−½ Σ(1+logvar−mu²−e^logvar) / n_l`` under
    ``g_k`` (``n_x``, ``n_l`` the mean's element counts, 1 under a sum),
    each in its input's dtype.  ``g_m`` and ``g_k`` are 0-d fp32 tensors on
    the operands' device, read by the kernel: no host sync.

    Replaces the elementwise backward that ``pallas_loss.py``'s
    ``custom_vjp`` leaves to XLA.  CUDA: one launch (``csrc/loss.cu``),
    fp32 arithmetic (the precise ``expf``) with the plain version's
    roundings, 16-byte loads and stores; a pair of two dtypes is brought
    to fp32 first and its gradient rounded to ``recon``'s dtype after."""
    if recon.device.type == "cpu":
        return loss_grads_ref(recon, x, mu, logvar, g_m, g_k, n_x, n_l)
    dev, four, (dx, dl) = _operands("loss_grads", recon, x, mu, logvar)
    for g, name in ((g_m, "g_m"), (g_k, "g_k")):
        require(g, name, (), dev)
    d_recon = torch.empty_like(four[0])
    d_mu = torch.empty_like(four[2])
    d_logvar = torch.empty_like(four[3])
    blocks = _blocks(recon.numel(), _GRAD_BLOCKS[dx])
    _build.launch("rvk_loss_grads", dev, *four, g_m, g_k, d_recon, d_mu,
                  d_logvar, recon.numel(), mu.numel(), 2.0 / n_x, 1.0 / n_l,
                  1.0 / (2.0 * n_l), blocks, DTYPE_CODES[dx],
                  DTYPE_CODES[dl])
    loss_grads.launches += 1
    return (d_recon.to(recon.dtype), d_mu.to(mu.dtype),
            d_logvar.to(logvar.dtype))


loss_grads.launches = 0


def on_card(t: Tensor) -> bool:
    """Whether ``t`` lies where the kernels run: a CUDA device."""
    return t.device.type == "cuda"


def takes_fused_loss(recon, x, mu, logvar) -> bool:
    """Whether the kernels take the train step's loss on these tensors:
    on one CUDA device, a ``recon`` and an ``x`` of one 2-D shape and a
    ``mu`` and a ``logvar`` of one 2-D shape with as many rows, each fp32
    or bf16, contiguous and not empty.  ``models/registry.py``
    ``kernel_loss``, the loss a ``backend = pallas`` model binds, asks it
    on every call and keeps the plain ops where it says no."""
    four = (recon, x, mu, logvar)
    return (on_card(recon)
            and all(t.device == recon.device and t.dtype in DTYPE_CODES
                    and t.is_contiguous() for t in four)
            and recon.dim() == 2 and x.shape == recon.shape
            and mu.dim() == 2 and logvar.shape == mu.shape
            and mu.shape[0] == recon.shape[0]
            and recon.numel() > 0 and mu.numel() > 0)


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
    ``g_k`` of the KLD term, each in its input's dtype, from
    :func:`loss_grads`; ``d x`` (which no train step asks for) from plain
    ops; ``None`` for inputs that need none."""
    n_x, n_l = (recon.numel(), mu.numel()) if ctx.reduction == "mean" \
        else (1, 1)
    need = ctx.needs_input_grad
    d_recon = d_x = d_mu = d_logvar = None
    if need[0] or need[2] or need[3]:
        d_recon, d_mu, d_logvar = loss_grads(recon, x, mu, logvar, g_m, g_k,
                                             n_x, n_l)
    if need[1]:
        d_x = (-((2.0 / n_x) * (_f(recon) - _f(x)) * g_m)).to(x.dtype)
    return (d_recon if need[0] else None, d_x, d_mu if need[2] else None,
            d_logvar if need[3] else None)


def _sum(a: Optional[Tensor], b: Optional[Tensor],
         device: torch.device) -> Tensor:
    """``a + b`` where a cotangent that was not asked for is ``None``: a
    0-d fp32 zero on ``device`` if both are."""
    if a is None and b is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    if a is None or b is None:
        return b if a is None else a
    return a + b


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
        # an output nobody differentiates brings None, not a filled zero
        ctx.set_materialize_grads(False)
        return _components(recon, x, mu, logvar, kl_beta, reduction)

    @staticmethod
    def backward(ctx, g_loss, g_mse, g_kld):
        # loss = mse + beta * kld, so the cotangents combine linearly
        saved = ctx.saved_tensors
        g_m = _sum(g_loss, g_mse, saved[0].device)
        g_k = _sum(None if g_loss is None else ctx.kl_beta * g_loss, g_kld,
                   saved[0].device)
        return (*_input_grads(ctx, *saved, g_m, g_k), None, None)


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

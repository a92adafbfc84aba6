"""Optimizer: Adam with the reference's defaults.

The reference used ``optim.Adam(model.parameters(), lr)`` with every
default — betas (0.9, 0.999), eps 1e-8, no schedule, no clipping, no weight
decay (train.py:163); the JAX package runs ``optax.adam`` with the same
hyperparameters (bias-corrected moments, eps outside the sqrt).

The update here is written out rather than ``torch.optim.Adam``: it
follows ``optax.adam``'s order of operations (``(1-b1)·g + b1·mu``, the
bias corrections ``1 - b**count`` in fp32, ``mu_hat / (sqrt(nu_hat) +
eps)``, then ``p + (-lr)·u``), so the port and the JAX package stay within
fp32 rounding over coupled steps, and its moments are the tensors of
:class:`TrainState`, which map one to one onto the JAX checkpoint's leaves.
It runs in place on the state's tensors, and queues no host-to-device
copy: the two bias corrections reach the device as filled scalars, so the
host never waits for the step it has just queued (a copied scalar blocks
until the stream drains, which idles the device between the small steps of
a device-resident epoch).  The JAX update is XLA's, not a Pallas kernel, so
there is no kernel to port here.

On the card, a tree of more leaves than one launch of row 20's whole-tree
kernel takes (``ops/adam.py`` ``K_MAX_LEAVES``, 48; the Oobleck model's 365)
is updated through that kernel (``fused_adam_apply``): the same bits, in
``ceil(leaves / 48)`` launches where the update below takes 16 a leaf, so
the host no longer paces the step.  The MLP models' trees (10 and 22
leaves) keep the update below.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.train.state import Params, TrainState
from rawaudiovae_kelsey_tpu_torch.tree import leaves


# the fewest leaves updated through row 20's kernel: one more than a launch
# of it takes (ops/adam.py K_MAX_LEAVES)
FUSED_MIN_LEAVES = 49


@dataclass(frozen=True)
class Adam:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @torch.no_grad()
    def update(self, state: TrainState, grads: Params) -> None:
        """One Adam update of ``state`` (params, moments, count) from fp32
        ``grads``, in place: row 20's kernel for a tree of more than
        ``FUSED_MIN_LEAVES - 1`` leaves on the card, else
        :meth:`update_leafwise`; the same bits either way."""
        params = leaves(state.params)
        if len(params) >= FUSED_MIN_LEAVES and params[0].is_cuda:
            from rawaudiovae_kelsey_tpu_torch.ops.adam import (
                fused_adam_apply,
            )
            fused_adam_apply(self, state, grads)
            return
        self.update_leafwise(state, grads)

    @torch.no_grad()
    def update_leafwise(self, state: TrainState, grads: Params) -> None:
        """:meth:`update` in eager elementwise ops, one leaf at a time."""
        state.count += 1
        f32 = torch.float32
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=f32) ** state.count)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=f32) ** state.count)
        on_device = {}   # device → the two corrections as 0-d fp32 tensors
        for p, g, mu, nu in zip(leaves(state.params), leaves(grads),
                                leaves(state.mu), leaves(state.nu)):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            if p.device not in on_device:
                on_device[p.device] = tuple(
                    torch.full((), v, dtype=f32, device=p.device)
                    for v in (bc1, bc2))
            bc1_, bc2_ = on_device[p.device]
            u = (mu / bc1_) / (torch.sqrt(nu / bc2_) + self.eps)
            p.add_(-self.learning_rate * u)


def build_optimizer(cfg: Config) -> Adam:
    return Adam(learning_rate=cfg.training.learning_rate)

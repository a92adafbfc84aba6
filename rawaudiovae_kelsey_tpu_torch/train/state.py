"""Train state: everything one optimizer update reads and writes.

The counterpart of the JAX package's ``train/state.py``.  There the params,
the optax Adam state, the threefry key and the step counter travel as one
donated pytree; here the same quantities are plain fields: fp32 master
params and the two Adam moments as trees of tensors on the training device
(the JAX params layout: ``{"fc1": {"w": (in, out), "b": (out,)}, ...}`` for
the dense model, lists of layers under ``enc`` / ``dec`` for the variants;
``tree.py`` walks them), and the Adam count, the noise seed and the step as
host integers.  The update works in place on the tensors.
``train/checkpoint.py`` maps the state onto the JAX package's checkpoint
layout (3n+3 leaves for n param leaves) and back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from rawaudiovae_kelsey_tpu_torch.tree import tree_map

Params = Any   # a params tree (tree.py): nested dicts / lists of tensors


def zeros_like(params: Params) -> Params:
    return tree_map(torch.zeros_like, params)


def clone(params: Params) -> Params:
    return tree_map(lambda t: t.detach().clone(), params)


@dataclass
class TrainState:
    params: Params      # fp32 master weights
    mu: Params          # Adam first moment (optax ScaleByAdamState.mu)
    nu: Params          # Adam second moment (.nu)
    count: int          # Adam update count (.count)
    seed: int           # noise seed (the JAX state's threefry key)
    step: int           # optimizer updates taken

    @classmethod
    def create(cls, params: Params, seed: int) -> "TrainState":
        return cls(params=params, mu=zeros_like(params),
                   nu=zeros_like(params), count=0, seed=int(seed), step=0)

    def clone(self) -> "TrainState":
        """An independent copy (the update mutates its tensors in place)."""
        return TrainState(params=clone(self.params), mu=clone(self.mu),
                          nu=clone(self.nu), count=self.count,
                          seed=self.seed, step=self.step)

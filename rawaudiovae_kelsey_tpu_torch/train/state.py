"""Train state: everything one optimizer update reads and writes.

The counterpart of the JAX package's ``train/state.py``.  There the params,
the optax Adam state, the threefry key and the step counter travel as one
donated pytree; here the same quantities are plain fields: fp32 master
params and the two Adam moments as dicts of tensors on the training device
(the JAX params layout, ``{"fc1": {"w": (in, out), "b": (out,)}, ...}``),
and the Adam count, the noise seed and the step as host integers.  The
update works in place on the tensors.  ``train/checkpoint.py`` maps the
state onto the JAX package's 33-leaf checkpoint layout and back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def zeros_like(params: Params) -> Params:
    return {n: {k: torch.zeros_like(t) for k, t in p.items()}
            for n, p in params.items()}


def clone(params: Params) -> Params:
    return {n: {k: t.detach().clone() for k, t in p.items()}
            for n, p in params.items()}


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

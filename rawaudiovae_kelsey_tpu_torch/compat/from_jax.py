"""Carry weights and train states between the JAX package and the port.

Both packages keep a model's params as the same tree (the dense VAE's
``{"fc1": {"w": (in, out), "b": (out,)}, ...}``; lists of layers under
``enc`` / ``dec`` for the deep and conv1d models, conv weights ``(kernel,
in, out)``), so the conversion is a copy of every leaf, with no transpose: the JAX side hands over NumPy arrays
(``jax.device_get`` of its tree), the port holds tensors.  A round trip is
exact.

A train state crosses as the JAX ``TrainState``'s leaves, in
``jax.tree_util`` flatten order — params, optax Adam's count, mu and nu,
the threefry key, the step — the layout of the checkpoint files
(``train/checkpoint.py``).  :func:`params_to_shards` carries a JAX params
tree onto a tensor-parallel rank (whole leaves, then the rank's shards).  The JAX side takes them back with
``jax.tree_util.tree_unflatten(treedef, leaves)``.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.parallel.sharding import shard_params
from rawaudiovae_kelsey_tpu_torch.train.checkpoint import (
    state_from_leaves,
    state_leaves,
)
from rawaudiovae_kelsey_tpu_torch.train.state import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import tree_map


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Tree of NumPy arrays (a JAX params tree after ``jax.device_get``:
    dicts, and lists of layers for the variants) → the same structure of
    tensors on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_shards(tree: Any, mesh, specs: Any,
                     device: torch.device | str = "cpu") -> Any:
    """A JAX params tree (NumPy) → the whole leaves as tensors → this
    rank's shards under ``specs`` on ``mesh`` (``parallel/sharding.py``
    ``shard_params``): the route that puts both packages' weights onto a
    tensor-parallel rank."""
    return shard_params(params_from_jax(tree, device), mesh, specs)


def params_to_jax(params: Any) -> Any:
    """Tree of tensors → the same structure of NumPy arrays, which
    ``jax.numpy.asarray`` (or any JAX function) takes as a params tree."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def train_state_from_jax(leaves: List[Any], template: TrainState
                         ) -> TrainState:
    """``jax.tree_util.tree_leaves`` of a JAX ``TrainState`` (host arrays)
    → the port's :class:`TrainState`, shaped and placed like
    ``template``."""
    return state_from_leaves(leaves, template)


def train_state_to_jax(state: TrainState) -> List[np.ndarray]:
    """The port's :class:`TrainState` → the JAX ``TrainState``'s leaves
    (NumPy), in its flatten order."""
    return state_leaves(state)

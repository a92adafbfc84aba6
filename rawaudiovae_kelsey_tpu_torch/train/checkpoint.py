"""Params-only checkpoints (``best_model.npz`` / ``last_model.npz``) in the
JAX package's npz layout, so a file written by either package loads in the
other.

The layout (JAX ``train/checkpoint.py`` ``save_params``): one array per
leaf, named ``leaf_00000`` … in ``jax.tree_util`` flatten order — dict keys
sorted at every level, so for the dense model ``fc1.b, fc1.w, fc21.b,
fc21.w, fc22.b, fc22.w, fc3.b, fc3.w, fc4.b, fc4.w`` — with ``w`` stored
``(in, out)``.  The full train-state checkpoints (Adam moments, resume)
come with the training port.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, List, Tuple

import numpy as np
import torch


def flatten(tree: Any) -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a nested dict, in JAX's flatten order
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [(f"{k}.{path}" if path else str(k), leaf)
                for k in sorted(tree)
                for path, leaf in flatten(tree[k])]
    return [("", tree)]


def unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild ``template``'s nested-dict structure from ``leaves`` (given
    in :func:`flatten` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def _unique_tmp(path: Path) -> Path:
    """Writer-private tmp name for the atomic write-then-rename."""
    return path.with_name(
        f"{path.name}.tmp{os.getpid()}-{threading.get_ident()}")


def save_params(path: Path, params: Any) -> Path:
    """Write ``params`` (nested dict of tensors or arrays) atomically: best/
    last are overwritten while a server may be reading them."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        f"leaf_{i:05d}": (leaf.detach().cpu().numpy()
                          if isinstance(leaf, torch.Tensor)
                          else np.asarray(leaf))
        for i, (_, leaf) in enumerate(flatten(params))
    }
    tmp = _unique_tmp(path)
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    tmp.rename(path)
    return path


def load_params(path: Path, template: Any) -> Any:
    """Load an npz into ``template``'s structure; each leaf becomes a tensor
    on the template leaf's device.  A wrong-architecture file fails here,
    with the leaf count or shape that differs."""
    with np.load(Path(path)) as npz:
        leaves = [npz[k] for k in sorted(npz.files)]
    want = flatten(template)
    if len(leaves) != len(want):
        raise ValueError(
            f"{path}: {len(leaves)} leaves but template has {len(want)}")
    out = []
    for got, (name, t) in zip(leaves, want):
        if tuple(got.shape) != tuple(t.shape):
            raise ValueError(
                f"{path}: leaf {name} shape {got.shape} != template "
                f"{tuple(t.shape)}")
        device = t.device if isinstance(t, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(np.ascontiguousarray(got)).to(device))
    return unflatten(template, out)

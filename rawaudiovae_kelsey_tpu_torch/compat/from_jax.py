"""Carry weights between the JAX package and the port.

Both packages keep the dense VAE's params as the same nested dict
(``{"fc1": {"w": (in, out), "b": (out,)}, ...}``), so the conversion is a
copy of every leaf, with no transpose: the JAX side hands over NumPy arrays
(``jax.device_get`` of its tree), the port holds tensors.  A round trip is
exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Nested dict of NumPy arrays (a JAX params tree after
    ``jax.device_get``) → the same structure of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_jax(params: Any) -> Any:
    """Nested dict of tensors → the same structure of NumPy arrays, which
    ``jax.numpy.asarray`` (or any JAX function) takes as a params tree."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy().copy()

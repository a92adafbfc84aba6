"""The reference implementation's PyTorch checkpoints — the JAX package's
``compat/torch_import.py``, ported.

The reference checkpoints are ``torch.save`` dicts
``{'epoch'|'batch_id', 'state_dict', 'optimizer'}`` (train.py:206-239) whose
``state_dict`` carries ``fc{1,21,22,3,4}.{weight,bias}`` tensors with
``nn.Linear`` layout ``weight: (out, in)`` computing ``x @ W.T + b``.  The
port's params dict stores ``w: (in, out)`` computing ``x @ W + b`` (the
layout ``compat/from_jax.py`` documents), so import transposes each weight
and places the result on a given device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.models.vae import LAYERS, Params


def state_dict_to_params(state_dict: Mapping[str, Any],
                         device: torch.device | str = "cpu") -> Params:
    """A reference VAE ``state_dict`` (tensors or ndarrays) → the port's
    params dict of fp32 tensors on ``device``."""
    params: Params = {}
    for name in LAYERS:
        wkey, bkey = f"{name}.weight", f"{name}.bias"
        if wkey not in state_dict or bkey not in state_dict:
            raise KeyError(f"state_dict missing {wkey}/{bkey}")
        w = _to_tensor(state_dict[wkey])
        b = _to_tensor(state_dict[bkey])
        params[name] = {"w": w.t().contiguous().to(device),
                        "b": b.to(device)}
    return params


def params_to_state_dict(params: Params) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_dict_to_params` (numpy arrays, torch
    layout)."""
    out: Dict[str, np.ndarray] = {}
    for name in LAYERS:
        out[f"{name}.weight"] = np.ascontiguousarray(
            _to_numpy(params[name]["w"]).T
        )
        out[f"{name}.bias"] = _to_numpy(params[name]["b"])
    return out


def _install_rawvae_stub() -> None:
    """Make the reference's whole-module pickles loadable without the
    reference package: ``best_model.pt``/``last_model.pt`` were saved with
    ``torch.save(model)`` (train.py:243-244), so unpickling needs an
    importable ``rawvae.model.VAE`` class.  A minimal stand-in does
    (unpickling restores state via ``__dict__``, so an empty nn.Module
    subclass suffices)."""
    import sys
    import types

    if "rawvae.model" in sys.modules:
        return

    class VAE(torch.nn.Module):  # matches the pickled class path
        pass

    pkg = types.ModuleType("rawvae")
    mod = types.ModuleType("rawvae.model")
    mod.VAE = VAE
    pkg.model = mod
    sys.modules.setdefault("rawvae", pkg)
    sys.modules["rawvae.model"] = mod


def load_torch_checkpoint(path: Union[str, Path],
                          device: torch.device | str = "cpu") -> Params:
    """Load a reference ``ckpt_NNNNN`` file, a bare state_dict file, or a
    whole-module pickle (``best_model.pt``) into a params dict on
    ``device``."""
    try:
        obj = torch.load(Path(path), map_location="cpu", weights_only=False)
    except ModuleNotFoundError:
        # whole-module pickle referencing the (absent) reference package
        _install_rawvae_stub()
        obj = torch.load(Path(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        # whole-module pickle (best_model.pt / last_model.pt, train.py:243-244)
        obj = obj.state_dict()
    return state_dict_to_params(obj, device)


def _to_tensor(t) -> torch.Tensor:
    # always a copy: a view of a live tensor would let later in-place
    # updates of the caller's module (an optimizer step) change the params
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(t, dtype=np.float32, copy=True))


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)

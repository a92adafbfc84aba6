"""Checkpoints in the JAX package's npz layout, so a file written by
either package loads in the other — resume included.

The layout (JAX ``train/checkpoint.py``): one array per leaf, named
``leaf_00000`` … in ``jax.tree_util`` flatten order (``tree.py``) — dict
keys sorted at every level, lists by index, so for the dense model's params
``fc1.b, fc1.w, fc21.b, fc21.w, fc22.b, fc22.w, fc3.b, fc3.w, fc4.b,
fc4.w``, for the deep model's ``dec.0.b, dec.0.w, …, enc.0.b, …,
logvar_head.b, logvar_head.w, mu_head.b, mu_head.w`` and for the conv1d
model's ``dec, dec_in, enc, logvar_head, mu_head`` — with a linear ``w``
stored ``(in, out)`` and a conv ``w`` ``(kernel, in, out)``.

* ``best_model.npz`` / ``last_model.npz`` (:func:`save_params`): the params.
* ``model/checkpoints/ckpt_{label:05d}.npz`` (:func:`save_checkpoint`): the
  whole train state, 3n+3 leaves for a model of n param leaves: the 33
  leaves of the JAX ``TrainState`` for the dense model — the 10 params; optax Adam's ``count`` (int32); its 10 ``mu``; its
  10 ``nu``; the threefry key ``rng`` (uint32[2], ``PRNGKey(seed)`` =
  ``[seed >> 32, seed & 0xffffffff]``); ``step`` (int32) — plus a json
  sidecar of loop metadata (epoch, best_loss, step).

The JAX package's orbax checkpoints (``[tpu] checkpoint_format = orbax``)
are not ported: asking for one raises.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.train.state import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import flatten, unflatten

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
_ORBAX_RE = re.compile(r"orbax_(\d+)$")
ORBAX_NOT_PORTED = (
    "orbax checkpoints are not ported to the PyTorch package (ROADMAP.md "
    "queue A); use [tpu] checkpoint_format = npz")


def _unique_tmp(path: Path) -> Path:
    """Writer-private tmp name for the atomic write-then-rename."""
    return path.with_name(
        f"{path.name}.tmp{os.getpid()}-{threading.get_ident()}")


def save_params(path: Path, params: Any) -> Path:
    """Write ``params`` (a tree of tensors or arrays) atomically: best/
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


# --------------------------------------------------------- the train state

def _numpy(t: Any) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def state_leaves(state: TrainState) -> List[np.ndarray]:
    """The train state as the JAX ``TrainState``'s leaves, in its flatten
    order (params, Adam count, mu, nu, rng, step)."""
    seed = state.seed & 0xFFFFFFFFFFFFFFFF
    return [
        *(_numpy(t) for _, t in flatten(state.params)),
        np.asarray(state.count, np.int32),
        *(_numpy(t) for _, t in flatten(state.mu)),
        *(_numpy(t) for _, t in flatten(state.nu)),
        np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32),
        np.asarray(state.step, np.int32),
    ]


def state_from_leaves(leaves: List[Any], template: TrainState
                      ) -> TrainState:
    """Inverse of :func:`state_leaves`: tensors on the template params'
    device, shapes checked against the template."""
    want = flatten(template.params)
    n = len(want)
    if len(leaves) != 3 * n + 3:
        raise ValueError(f"{len(leaves)} leaves but a train state of this "
                         f"model has {3 * n + 3}")
    leaves = [np.asarray(a) for a in leaves]

    def tree(part: List[np.ndarray]) -> Any:
        out = []
        for got, (name, t) in zip(part, want):
            if tuple(got.shape) != tuple(t.shape):
                raise ValueError(f"leaf {name} shape {got.shape} != "
                                 f"template {tuple(t.shape)}")
            out.append(torch.from_numpy(np.array(got, np.float32))
                       .to(t.device))
        return unflatten(template.params, out)

    hi, lo = (int(v) for v in leaves[3 * n + 1].reshape(-1)[-2:])
    return TrainState(
        params=tree(leaves[:n]),
        mu=tree(leaves[n + 1: 2 * n + 1]),
        nu=tree(leaves[2 * n + 1: 3 * n + 1]),
        count=int(leaves[n]),
        seed=(hi << 32) | lo,
        step=int(leaves[3 * n + 2]),
    )


def _write_meta(meta_path: Path, extra: Optional[Dict[str, Any]],
                step: int) -> None:
    meta = dict(extra or {})
    meta["step"] = step
    tmp = _unique_tmp(meta_path)
    tmp.write_text(json.dumps(meta))
    tmp.rename(meta_path)


def _read_meta(meta_path: Path) -> Dict[str, Any]:
    """Sidecar read that tolerates a missing or torn file (resume must not
    brick on metadata)."""
    try:
        return json.loads(meta_path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def save_checkpoint(ckpt_dir: Path, state: TrainState,
                    extra: Optional[Dict[str, Any]] = None,
                    label: Optional[int] = None) -> Path:
    """Write ``ckpt_{label:05d}.npz`` (+ a json sidecar of loop metadata
    such as epoch and best_loss) atomically.  ``label`` defaults to the
    optimizer step count."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    label = state.step if label is None else label
    path = ckpt_dir / f"ckpt_{label:05d}.npz"
    arrays = {f"leaf_{i:05d}": a
              for i, a in enumerate(state_leaves(state))}
    tmp = _unique_tmp(path)
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    tmp.rename(path)
    _write_meta(path.with_suffix(".json"), extra, state.step)
    return path


def restore_checkpoint(path: Path, template: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint (written by either package) into the structure
    of ``template``; returns the state and the sidecar metadata."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(f"{path}: {ORBAX_NOT_PORTED}")
    with np.load(path) as npz:
        leaves = [npz[k] for k in sorted(npz.files)]
    try:
        state = state_from_leaves(leaves, template)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return state, _read_meta(path.with_suffix(".json"))


def _scan_checkpoints(ckpt_dir: Path) -> list:
    """Every periodic checkpoint in a dir as sorted (label, path): npz files
    and the JAX package's committed orbax dirs (which restore refuses)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    found = []
    for p in ckpt_dir.iterdir():
        m = _CKPT_RE.search(p.name)
        if m is None and p.is_dir():
            m = _ORBAX_RE.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    found.sort()
    return found


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    """The newest checkpoint in a dir, or None."""
    found = _scan_checkpoints(ckpt_dir)
    return found[-1][1] if found else None


def prune_checkpoints(ckpt_dir: Path, keep: int) -> list:
    """Delete all but the newest ``keep`` periodic npz checkpoints (with
    their sidecars) — ``[training] keep_checkpoints``; ``keep <= 0`` keeps
    everything.  best/last models live elsewhere.  Returns what went."""
    if keep <= 0:
        return []
    found = [p for _, p in _scan_checkpoints(ckpt_dir) if p.is_file()]
    removed = []
    for p in found[:-keep] if len(found) > keep else []:
        try:
            p.unlink()
            p.with_suffix(".json").unlink(missing_ok=True)
            removed.append(p)
        except OSError:
            pass  # retention is best-effort; never fail a run over cleanup
    return removed

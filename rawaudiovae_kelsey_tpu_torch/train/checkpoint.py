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

Under several ranks only rank 0 writes (:func:`save_checkpoint`, its
sidecar, :func:`prune_checkpoints`; JAX ``:41-110``): the replicas are
equal bit for bit, so rank 0's state is the run's.  Every rank restores
the same file on ``--resume``.  Under tensor parallelism the trainer
gathers the shards first (``train/loop.py``), so the file holds whole
leaves in the JAX layout and loads in either package; restoring into a
sharded template (``mesh`` and ``specs``) slices each leaf into the
template's spec (JAX ``:111-135`` re-places the leaves in the template's
shardings).

``[tpu] checkpoint_format = orbax`` is the port's own sharded format under
JAX's name — a declared divergence: orbax is not a dependency of the port,
and these are not orbax's bytes.  It keeps JAX's names, so the scan, the
resume and the retention treat both formats alike: ``orbax_{label:05d}/``
holds

* ``index.json``: the format's name and version, the mesh it was written
  on (``data``, ``model``), the step, Adam's count, the seed, and for
  every leaf of params, mu and nu its name, whole shape and spec;
* ``shard_{m:05d}-of-{M:05d}.npz``: model rank ``m``'s shards of those
  leaves (written by the ranks of data index 0; the other data indices
  hold equal copies);
* ``meta.json``: the loop's sidecar, as beside an npz.

Everything is written into ``orbax_{label:05d}.tmp`` (which no scan
matches) and renamed into place once every writer is done (a barrier over
the ranks where there are several writers): a torn directory is never
listed.  :func:`restore_checkpoint` puts each leaf back together and
slices it into a template's spec on any mesh (written at model 2, read
at 1 or 4).  ``[tpu] async_checkpoint`` keeps JAX's semantics: the save
returns after the device→host copy, the files are written on a thread,
and :func:`wait_for_orbax` (every rank, at the same point: the next
save, the end of the run) commits the directory and its sidecar.  A
directory without the port's index (one JAX's orbax wrote) raises
``ValueError``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    is_coordinator,
    world_size,
)
from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
    REPLICATED,
    global_shape,
    local_slice,
    spec_axis,
)
from rawaudiovae_kelsey_tpu_torch.train.state import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import flatten, tree_map, unflatten

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
_ORBAX_RE = re.compile(r"orbax_(\d+)$")
SHARDED_FORMAT = "rawaudiovae_kelsey_tpu_torch sharded train state"
SHARDED_VERSION = 1
INDEX = "index.json"


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
    """Atomic sidecar write (tmp + rename), rank 0 only."""
    if not is_coordinator():
        return
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
    optimizer step count.  Only rank 0 writes (the others return the
    path it writes): concurrent writers on shared storage would interleave
    into a corrupt file."""
    ckpt_dir = Path(ckpt_dir)
    label = state.step if label is None else label
    path = ckpt_dir / f"ckpt_{label:05d}.npz"
    if not is_coordinator():
        return path
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i:05d}": a
              for i, a in enumerate(state_leaves(state))}
    tmp = _unique_tmp(path)
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    tmp.rename(path)
    _write_meta(path.with_suffix(".json"), extra, state.step)
    return path


def _slice(a: np.ndarray, spec: str, mesh: Optional[Mesh]) -> np.ndarray:
    """This rank's slice of a whole leaf under ``spec`` (``sharding``
    ``local_slice``; the leaf itself without a mesh)."""
    if mesh is None:
        return a
    return local_slice(torch.from_numpy(np.asarray(a)), spec, mesh).numpy()


def restore_checkpoint(path: Path, template: TrainState,
                       mesh: Optional[Mesh] = None, specs: Any = None
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint (an npz written by either package, or a
    sharded directory) into the structure of ``template``; returns the
    state and the sidecar metadata.  ``mesh`` and ``specs`` (a spec a
    param leaf) make ``template`` a rank's shards: each leaf is sliced
    into its spec."""
    path = Path(path)
    if path.is_dir():
        return (restore_sharded(path, template, mesh, specs),
                _read_meta(path / "meta.json"))
    with np.load(path) as npz:
        leaves = [npz[k] for k in sorted(npz.files)]
    if specs is not None:
        n = len(flatten(template.params))
        spec_list = [s_ for _, s_ in flatten(specs)]
        for part in (0, n + 1, 2 * n + 1):
            for i, spec in enumerate(spec_list):
                if part + i < len(leaves):
                    leaves[part + i] = _slice(leaves[part + i], spec, mesh)
    try:
        state = state_from_leaves(leaves, template)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return state, _read_meta(path.with_suffix(".json"))


# ------------------------------------------- the sharded format ("orbax")

def _shard_file(m: int, model: int) -> str:
    return f"shard_{m:05d}-of-{model:05d}.npz"


def _named(state: TrainState, specs: Any):
    """``(name, tensor, spec)`` of every leaf of params, mu and nu."""
    spec_list = [s_ for _, s_ in flatten(specs)]
    for part in ("params", "mu", "nu"):
        for (name, t), spec in zip(flatten(getattr(state, part)), spec_list):
            yield f"{part}.{name}", t, spec


class _Pending:
    """A save whose files are written (or being written, ``thread``) into
    ``tmp``; :func:`wait_for_orbax` commits it.  ``collective``: several
    writers, so the commit is a barrier every rank enters."""

    def __init__(self, tmp: Path, path: Path, extra, step: int,
                 collective: bool, write) -> None:
        self.tmp, self.path, self.extra, self.step = tmp, path, extra, step
        self.collective = collective
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        if write is not None:
            def run() -> None:
                try:
                    write()
                except BaseException as e:   # re-raised at the commit
                    self.error = e
            self.thread = threading.Thread(target=run, name="orbax-write",
                                           daemon=True)
            self.thread.start()


_PENDING: List[_Pending] = []


def _barrier(collective: bool) -> None:
    if collective and world_size() > 1:
        dist.barrier()


def _commit(p: _Pending) -> None:
    if p.thread is not None:
        p.thread.join()
    if p.error is not None:
        raise RuntimeError(f"{p.path}: writing the checkpoint failed"
                           ) from p.error
    _barrier(p.collective)           # every writer's files are in tmp
    if is_coordinator():
        if p.path.exists():
            shutil.rmtree(p.path)    # a save of the same label again
        p.tmp.rename(p.path)
        _write_meta(p.path / "meta.json", p.extra, p.step)
    _barrier(p.collective)           # every rank sees the directory


def wait_for_orbax() -> None:
    """Commit every pending save: join its writer thread, then (several
    writers) a barrier, the rename into place and the sidecar.  Every rank
    calls it at the same point where a save had several writers; the
    trainers call it before the next save and at the end of the run."""
    while _PENDING:
        _commit(_PENDING.pop(0))


def save_checkpoint_sharded(ckpt_dir: Path, state: TrainState,
                            extra: Optional[Dict[str, Any]] = None,
                            label: Optional[int] = None,
                            mesh: Optional[Mesh] = None, specs: Any = None,
                            wait: bool = True) -> Path:
    """Write ``orbax_{label:05d}/`` (the module's docstring) from
    ``state`` — a rank's shards where ``mesh`` has a model axis, ``specs``
    a spec a param leaf (all replicated if None).  Every rank calls it;
    the ranks of data index 0 write their shards, rank 0 the index.
    ``wait=False`` (``[tpu] async_checkpoint``) returns after the
    device→host copy and leaves the commit to :func:`wait_for_orbax`."""
    wait_for_orbax()                 # the previous save commits first
    label = state.step if label is None else label
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"orbax_{label:05d}"
    tmp = path.with_name(path.name + ".tmp")
    model = mesh.model if mesh is not None else 1
    index = mesh.model_index if mesh is not None else 0
    writes = mesh is None or mesh.data_index == 0
    collective = model > 1
    if specs is None:
        specs = tree_map(lambda _: REPLICATED, state.params)
    if is_coordinator():
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)   # a torn earlier attempt
        tmp.mkdir()
    _barrier(collective)             # tmp exists before a rank writes
    named = list(_named(state, specs))
    # the device→host copy (a copy on the CPU too): the caller's state may
    # change once we return
    arrays = ({name: t.detach().to("cpu", copy=True).numpy()
               for name, t, _ in named} if writes else {})
    meta = None
    if is_coordinator():
        meta = {
            "format": SHARDED_FORMAT, "version": SHARDED_VERSION,
            "mesh": {"data": mesh.data if mesh is not None else 1,
                     "model": model},
            "step": int(state.step), "count": int(state.count),
            "seed": int(state.seed),
            "leaves": [{"name": name, "shape": list(global_shape(t, spec,
                                                                  model)),
                        "spec": spec} for name, t, spec in named]}

    def write() -> None:
        if writes:
            with open(tmp / _shard_file(index, model), "wb") as fh:
                np.savez(fh, **arrays)
        if meta is not None:
            (tmp / INDEX).write_text(json.dumps(meta))

    if wait:
        write()
        _commit(_Pending(tmp, path, extra, state.step, collective, None))
    else:
        _PENDING.append(_Pending(tmp, path, extra, state.step, collective,
                                 write))
    return path


def _read_index(path: Path) -> Dict[str, Any]:
    try:
        index = json.loads((path / INDEX).read_text())
    except (OSError, json.JSONDecodeError):
        index = None
    if not isinstance(index, dict) or index.get("format") != SHARDED_FORMAT:
        raise ValueError(
            f"{path}: not a sharded checkpoint of this package (no "
            f"{INDEX} of format {SHARDED_FORMAT!r}; a directory JAX's orbax "
            "wrote does not load here: convert it to npz with the JAX "
            "package)")
    if index.get("version") != SHARDED_VERSION:
        raise ValueError(f"{path}: sharded format version "
                         f"{index.get('version')}, this package reads "
                         f"{SHARDED_VERSION}")
    return index


def restore_sharded(path: Path, template: TrainState,
                    mesh: Optional[Mesh] = None, specs: Any = None
                    ) -> TrainState:
    """A sharded directory → ``template``'s structure on this rank's mesh
    (``mesh`` and ``specs``; whole leaves without them), whatever the mesh
    it was written on: each leaf's saved shards put back together, then
    this rank's slice."""
    if not any(p.collective for p in _PENDING):
        wait_for_orbax()             # a same-process restore sees its saves
    path = Path(path)
    index = _read_index(path)
    saved_model = int(index["mesh"]["model"])
    if specs is None:
        specs = tree_map(lambda _: REPLICATED, template.params)
    files: Dict[int, Any] = {}

    def shard(m: int, name: str) -> np.ndarray:
        if m not in files:
            files[m] = np.load(path / _shard_file(m, saved_model))
        return files[m][name]

    want = {name: (t, spec) for name, t, spec in _named(template, specs)}
    got = {}
    try:
        for leaf in index["leaves"]:
            name = leaf["name"]
            if name not in want:
                raise ValueError(f"{path}: leaf {name} is not in this "
                                 "model's train state")
            t, spec = want[name]
            shape = tuple(leaf["shape"])
            d_saved = spec_axis(len(shape), leaf["spec"])
            whole = shard(0, name) if d_saved is None else np.concatenate(
                [shard(m, name) for m in range(saved_model)], axis=d_saved)
            a = _slice(whole, spec, mesh)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{path}: leaf {name} of shape {shape} "
                                 f"gives {tuple(a.shape)} here, the template "
                                 f"holds {tuple(t.shape)}")
            got[name] = torch.from_numpy(np.array(a, np.float32)).to(
                t.device)
    finally:
        for f in files.values():
            f.close()
    missing = set(want) - set(got)
    if missing:
        raise ValueError(f"{path}: no leaves {sorted(missing)}")

    def tree(part: str) -> Any:
        return unflatten(template.params,
                         [got[f"{part}.{name}"] for name, _
                          in flatten(template.params)])

    return TrainState(params=tree("params"), mu=tree("mu"), nu=tree("nu"),
                      count=int(index["count"]), seed=int(index["seed"]),
                      step=int(index["step"]))


def _scan_checkpoints(ckpt_dir: Path) -> list:
    """Every periodic checkpoint in a dir as sorted (label, path): npz files
    and committed ``orbax_*`` directories (``*.tmp`` ones never match)."""
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
    """The newest checkpoint in a dir, or None.  A same-process scan sees
    the pending saves of one writer (it commits them); a commit with
    several writers is every rank's, and the trainers make it."""
    if _PENDING and not any(p.collective for p in _PENDING):
        wait_for_orbax()
    found = _scan_checkpoints(ckpt_dir)
    return found[-1][1] if found else None


def prune_checkpoints(ckpt_dir: Path, keep: int) -> list:
    """Delete all but the newest ``keep`` periodic checkpoints — npz
    files (with their sidecars) and committed ``orbax_*`` directories count
    toward one budget, ``[training] keep_checkpoints``; ``keep <= 0`` keeps
    everything.  Pending saves are not committed yet and are never touched;
    best/last models live elsewhere.  Returns what went; only rank 0
    removes."""
    if keep <= 0 or not is_coordinator():
        return []
    found = [p for _, p in _scan_checkpoints(ckpt_dir)]
    removed = []
    for p in found[:-keep] if len(found) > keep else []:
        try:
            if p.is_dir():
                shutil.rmtree(p)
            else:
                p.unlink()
                p.with_suffix(".json").unlink(missing_ok=True)
            removed.append(p)
        except OSError:
            pass  # retention is best-effort; never fail a run over cleanup
    return removed

"""Process groups and the data-parallel mesh — the JAX package's
``parallel/mesh.py`` on ``torch.distributed``.

The process model.  JAX runs one process per host, and that process drives
all of the host's devices; a mesh is a grid of devices.  PyTorch runs one
process per card.  The JAX names are kept so that a reader finds each
counterpart, and here they mean:

* a JAX "process" or "host" is a **rank**, one process driving one card
  (or one CPU process under ``gloo``).  :func:`host_shard_info` returns
  ``(rank, world_size)``, so ``data/corpus.py`` ``shard_files`` shards the
  wav list per rank; JAX's ``data_axis_process_contiguous`` always holds
  (a rank's rows are one block by construction), so no gate asks it;
  ``parallel/resident.py``
  ``align_local_rows`` pads to a multiple of one device a process; the
  multihost batch rule "divisible by the per-host device count" becomes
  "divisible by the world size";
* a :class:`Mesh` is the ``data × model`` grid of the group's ranks: rank
  ``r`` at data index ``r // model`` and model index ``r % model``.  Under
  ``model_parallel > 1`` (tensor parallelism, ``parallel/sharding.py``) the
  ranks of one data index hold the shards of one replica of the params and
  see the same rows; each mesh carries two families of sub-groups (made by
  :func:`make_mesh` in the same order on every rank): the **model group**,
  the ranks of this rank's data index, over which the activations' partial
  sums and the sharded params travel, and the **data group**, the ranks of
  this rank's model index, over which the gradients and the metrics are
  reduced (a reduction over the world would count each data index
  ``model`` times).  A group of every rank is the default group
  (``None``); a group of one rank has no collective at all;
* ``batch_sharding`` becomes a row-block helper: rank ``r`` of ``n``
  holds rows ``[r·B/n, (r+1)·B/n)`` of a global batch of ``B`` rows, one
  block per global microbatch when the step accumulates microbatches
  (:func:`local_rows`).  JAX's ``global_batch_from_local`` stitches each
  host's rows into one global array; here a rank's local rows ARE its
  block, fed to its own device as they stand, and the step reduces
  across the blocks, so nothing is stitched.

How ranks start:

* :func:`maybe_initialize_distributed` ``(coordinator_address,
  num_processes, process_id, backend=None)`` is idempotent: its guard is
  ``torch.distributed.is_initialized()``, so a group the caller
  initialised is used as it stands (as JAX's guard is
  ``jax.distributed.is_initialized()``).  The tests and ``chip_smoke.py``
  bring their own ``gloo`` group this way.  With empty arguments it reads
  torchrun's environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``.  The backend is NCCL for CUDA devices
  and gloo for the CPU.  ``[tpu] multihost`` and ``coordinator_address``
  call it as JAX's trainers do (``train/loop.py:79-85``,
  ``train/epoch.py:43-61``), and so does torchrun's ``WORLD_SIZE`` in the
  environment (``train/loop.py`` ``setup``): across hosts, start one
  process a card with ``torchrun --nnodes H --nproc-per-node G``, or give
  ``coordinator_address = host:port`` beside ``RANK`` and ``WORLD_SIZE``.
* On one host, when the process is not yet part of a group, the ``train``
  and ``stream`` commands start their own ranks (``train/cli.py``
  :func:`plan_ranks`): ``data_parallel`` of them, or one a visible card
  under ``data_parallel = 0``, each a process of its own started by
  ``torch.multiprocessing`` (start method ``spawn``); the command joins
  them and exits non-zero if any fails.

Nothing falls back: asking for more ranks than there are visible cards
raises (as JAX's ``make_mesh`` raises ``mesh AxB != N devices``), and an
init or collective failure propagates — a rank that trained its own copy
into the shared workspace would be worse than a crash (the JAX docstring
of ``maybe_initialize_distributed``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# what a group waits for a peer before a collective fails
DEFAULT_TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class Mesh:
    """The ``data × model`` grid of a group's ranks, seen from one rank:
    rank ``r`` sits at data index ``r // model`` and model index ``r %
    model``; ``device`` is the card (or the CPU) this rank computes on.
    ``model_group`` / ``data_group`` are the sub-groups of this rank's data
    index and of its model index (``None``: the default group, or no
    collective where the axis has one rank)."""
    data: int
    model: int
    rank: int
    device: torch.device
    model_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(data_parallel: int = 0, model_parallel: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over the current group (one rank when there is none).
    ``data_parallel = 0`` means "every rank divided by model_parallel";
    a product other than the world size raises ``ValueError`` as JAX's
    ``make_mesh`` does.  With both axes above one, every rank makes the
    model groups (one a data index) and then the data groups (one a model
    index), in that order: ``dist.new_group`` is a collective of the whole
    group.  ``device`` defaults to the current CUDA device under NCCL, else
    the CPU."""
    if model_parallel <= 0:
        model_parallel = 1
    n = world_size()
    if data_parallel <= 0:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} != {n} devices")
    if device is None:
        device = _collective_device()
    r = rank()
    model_group = data_group = None
    if data_parallel > 1 and model_parallel > 1:
        for d in range(data_parallel):
            g = dist.new_group([d * model_parallel + m
                                for m in range(model_parallel)])
            if d == r // model_parallel:
                model_group = g
        for m in range(model_parallel):
            g = dist.new_group([d * model_parallel + m
                                for d in range(data_parallel)])
            if m == r % model_parallel:
                data_group = g
    return Mesh(data_parallel, model_parallel, r, torch.device(device),
                model_group, data_group)


def default_backend(device: torch.device | str | None) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return ("nccl" if device is not None
            and torch.device(device).type == "cuda" else "gloo")


def maybe_initialize_distributed(coordinator_address: str = "",
                                 num_processes: int = 0,
                                 process_id: int = -1,
                                 backend: Optional[str] = None,
                                 device: torch.device | str | None = None,
                                 timeout: timedelta = DEFAULT_TIMEOUT
                                 ) -> bool:
    """Join (or start) the process group.  Idempotent: a group that
    already exists is used as it stands.  ``coordinator_address``
    (``host:port``) is rank 0's store; without it torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` are read.  ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.  ``backend =
    None`` takes :func:`default_backend` of ``device`` (``cuda:LOCAL_RANK``
    when ``device`` is a bare ``cuda``).  Failures propagate."""
    if dist.is_initialized():
        return True
    env = os.environ
    world = num_processes if num_processes > 0 else int(env["WORLD_SIZE"])
    rank_ = process_id if process_id >= 0 else int(env["RANK"])
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    device = local_device(device)
    backend = backend or default_backend(device)
    kwargs = {}
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world, timeout=timeout, **kwargs)
    return True


def local_device(device: torch.device | str | None
                 ) -> Optional[torch.device]:
    """A bare ``cuda`` names ``cuda:LOCAL_RANK`` where torchrun set it (or
    the command started the ranks); any other device is kept."""
    if device is None:
        return None
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def host_shard_info(mesh: Optional[Mesh] = None) -> tuple[int, int]:
    """``(rank, world_size)`` for per-rank ingest sharding; on a
    ``mesh``, ``(data index, data)``: the model ranks of a data index read
    the same shard, as they hold one replica."""
    if mesh is not None:
        return mesh.data_index, mesh.data
    return rank(), world_size()


def is_coordinator() -> bool:
    """True on the rank that owns writing (checkpoints, TB, wavs)."""
    return rank() == 0


# ------------------------------------------------------------- row blocks

def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """The rows ``[r·rows/n, (r+1)·rows/n)`` this rank holds of a global
    batch of ``rows`` rows; raises when ``rows`` does not divide the data
    axis (pad it first: ``data/loader.py`` ``pad_batches_for_mesh``)."""
    n = mesh.data
    if rows % n:
        raise ValueError(
            f"a batch of {rows} rows does not divide the {n} ranks of the "
            "data axis (pad it to a multiple first)")
    per = rows // n
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def local_rows(mesh: Mesh, total: int, micro: int = 0) -> np.ndarray:
    """Indices of this rank's rows in a global batch of ``total`` rows
    that the step cuts into microbatches of ``micro`` (0: none): block
    ``r`` of each microbatch, then block ``r`` of the ragged tail — the
    order in which the mesh step consumes them."""
    if not micro or micro >= total:
        s = batch_sharding(mesh, total)
        return np.arange(s.start, s.stop)
    n_micro, rem = divmod(total, micro)
    parts = [i * micro + np.arange(total)[batch_sharding(mesh, micro)]
             for i in range(n_micro)]
    if rem:
        s = batch_sharding(mesh, rem)
        parts.append(n_micro * micro + np.arange(s.start, s.stop))
    return np.concatenate(parts)


# ------------------------------------------------------------ collectives

def _collective_device() -> torch.device:
    """The device of this rank's collective buffers: its CUDA device under
    NCCL (which takes only CUDA tensors), else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_ints(values: Sequence[int]) -> np.ndarray:
    """Every rank's ``values`` as a ``(world, len(values))`` int64 array
    (JAX ``multihost_utils.process_allgather`` of small host arrays).
    One rank: its own values."""
    mine = torch.as_tensor(list(values), dtype=torch.int64,
                           device=_collective_device())
    if world_size() == 1:
        return mine.cpu().numpy()[None]
    out = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def any_rank(flag: bool) -> bool:
    """True when ``flag`` is true on any rank (an all-reduce of the flag;
    every rank must call it at the same point)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_text(text: Optional[str], limit: int = 4096) -> str:
    """Rank 0's ``text`` on every rank, through a length-prefixed buffer of
    ``4 + limit`` bytes: an over-long text fails on EVERY rank (raising on
    rank 0 alone would leave the others blocked in the broadcast)."""
    if world_size() == 1:
        return text
    buf = torch.zeros(4 + limit, dtype=torch.uint8,
                      device=_collective_device())
    if rank() == 0:
        raw = text.encode()
        n = len(raw) if len(raw) <= limit else 0xFFFFFFFF
        head = np.frombuffer(np.uint32(n).tobytes(), np.uint8)
        host = np.zeros(4 + limit, np.uint8)
        host[:4] = head
        host[4: 4 + min(len(raw), limit)] = np.frombuffer(raw[:limit],
                                                          np.uint8)
        buf.copy_(torch.from_numpy(host))
    dist.broadcast(buf, 0)
    shared = buf.cpu().numpy()
    n = int(np.frombuffer(shared[:4].tobytes(), np.uint32)[0])
    if n == 0xFFFFFFFF:
        raise ValueError(f"text exceeds the {limit}-byte broadcast limit")
    return shared[4: 4 + n].tobytes().decode()


def broadcast_tensors(tensors: List[torch.Tensor]) -> None:
    """Overwrite every rank's ``tensors`` with rank 0's, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, 0)


def _axis(mesh: Optional[Mesh], axis: str):
    """``(group, size)`` of ``mesh``'s ``axis`` (``"data"`` or
    ``"model"``); without a mesh, the world."""
    if mesh is None:
        return None, world_size()
    if axis == DATA_AXIS:
        return mesh.data_group, mesh.data
    return mesh.model_group, mesh.model


def all_reduce_flat(tensors: List[torch.Tensor], mean: bool,
                    mesh: Optional[Mesh] = None
                    ) -> List[torch.Tensor]:
    """One all-reduce of ``tensors`` (fp32) as ONE flat bucket: the sum over
    the ranks of ``mesh``'s data axis (the world without a mesh), divided
    by their count for ``mean``.  Every rank gets the same bits.  Returns
    new tensors shaped as the inputs."""
    group, size = _axis(mesh, DATA_AXIS)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if size > 1:
        dist.all_reduce(flat, group=group)
    if mean:
        flat = flat / size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal counts) over ``mesh``'s data
    axis (the world without a mesh), concatenated in rank order."""
    group, size = _axis(mesh, DATA_AXIS)
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


# the model axis (tensor parallelism): activations and sharded params

def model_all_reduce(tensors: List[torch.Tensor], mesh: Mesh
                     ) -> List[torch.Tensor]:
    """The sum of ``tensors`` over ``mesh``'s model group, in fp32, as ONE
    flat bucket (the row-parallel products' partial sums); new fp32
    tensors shaped as the inputs.  Every rank of the group gets the same
    bits."""
    if mesh.model == 1:
        return [t.float() for t in tensors]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.model_group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def model_all_gather(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model group's slices of ``t`` along ``dim``, concatenated in
    model-index order (a column-parallel output made whole, a sharded
    leaf gathered)."""
    if mesh.model == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def model_slice(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (``t.shape[dim]
    / model`` wide, at its model index): a copy, never a view."""
    if mesh.model == 1:
        return t
    width = t.shape[dim] // mesh.model
    # clone: a slice of the first axis is contiguous already, and a view
    # would keep the whole leaf alive (and share its storage)
    return t.narrow(dim, mesh.model_index * width, width).clone(
        memory_format=torch.contiguous_format)

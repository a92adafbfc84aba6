"""Device-resident corpus training: whole epochs on the device — the
single-device half of the JAX package's ``parallel/resident.py``.

The host-fed loop gathers every shuffled batch on the host and copies it to
the device inside the hot loop.  Raw audio is small, so when it fits:

  1. the training data is uploaded ONCE, in one of two layouts:
       * ``frames`` — the materialised overlapping-frame matrix
         (``seg/hop ×`` the corpus, 8× at 1024/128), cut on the device from
         the uploaded samples.  An epoch is one whole-matrix gather by the
         epoch's permutation, then contiguous batch slices;
       * ``corpus`` — the raw 1-D sample array (1×).  A batch is gathered
         from a strided window view of it, ``seg``-sample runs at
         ``start · hop``;
  2. an epoch runs with no host feed: a permutation drawn on the device,
     batch assembly on the device, one optimizer step per batch;
  3. the per-batch losses stay on the device; the caller fetches them in
     bursts.

The last partial batch is dropped (``drop_last``; the host-fed path keeps
it — DIVERGENCES.md).

What differs from the JAX module, and why:

* no fixed ``group_k`` graph with a masked NaN tail: that is how one jitted
  call covers a variable number of epochs.  Eager PyTorch compiles nothing,
  so ``run_epochs`` loops ``k`` epochs and returns ``k`` loss rows, with no
  host synchronisation inside;
* the permutations come from ``torch.randperm`` on a device generator
  seeded by a hash of ``(seed, 0x5EED, epoch)`` — a function of those
  alone, so a resumed run replays the order — not from threefry
  (``fold_in(fold_in(rng, 0x5EED), epoch)``): the same kind of declared
  divergence as the noise source.  ``perm`` injects other orders (the tests
  feed both packages JAX's);
* the step is the host-fed trainer's own (``parallel/step.py``
  ``build_train_step``), one full-batch gradient per batch; it updates the
  state in place.

The mesh-sharded engine (JAX ``:235-453``): the frame matrix is sharded
over the ranks — each rank uploads only its own block, cast on the host
(:func:`put_frames_sharded`), so no card holds the whole matrix; a rank's
rows are its file shard's frames wrap-padded to the ranks' largest count
(:func:`align_local_rows`) or its block of a padded global matrix
(:func:`pad_frames_for_mesh`).  :func:`build_resident_epoch_sharded` runs
an epoch as one whole-shard gather by the rank's permutation, then the
step loop of ``parallel/spmd.py`` (per-rank noise, one gradient all-reduce
a step).  ``resident_shuffle`` ``global`` and ``block`` shuffle in two
passes (:func:`_two_pass_shuffle`: a per-rank ``randperm``, then an
``all_to_all`` of the head blocks), ``local`` within each shard.  The
permutation seeds are :func:`perm_seed` with the rank folded in (JAX folds
``shard`` into the epoch key, ``:325-335``); ``randperm`` plus
``all_to_all`` stand in for threefry's permutation (a declared
divergence, as on one device).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.data.framing import (
    overlapping_frame_count,
    pad_to_multiple,
)
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.observe.spans import span
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_ints,
    world_size,
)
from rawaudiovae_kelsey_tpu_torch.parallel.spmd import per_rank_step
from rawaudiovae_kelsey_tpu_torch.parallel.step import (
    NoiseFn,
    build_train_step,
    fold_rank,
    mix64,
)
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam
from rawaudiovae_kelsey_tpu_torch.train.state import TrainState

Tensor = torch.Tensor
# (epoch, n_shuffle) → a permutation of range(n_shuffle), int64
PermFn = Callable[[int, int], Tensor]


def choose_layout(n_samples: int, seg: int, hop: int, dtype_bytes: int,
                  budget_bytes: int) -> Optional[str]:
    """"frames" if TWICE the frame matrix fits the budget (the per-epoch
    whole-matrix shuffle keeps one transient permuted copy next to the
    original), else "corpus" if the raw samples fit, else None (host-fed
    batches)."""
    n_frames = max(0, overlapping_frame_count(n_samples, seg, hop))
    if 2 * n_frames * seg * dtype_bytes <= budget_bytes:
        return "frames"
    if n_samples * dtype_bytes <= budget_bytes:
        return "corpus"
    return None


def put_resident(corpus: np.ndarray, cfg: Config, layout: str,
                 device: torch.device | str) -> Tensor:
    """One-time upload in the chosen layout: bf16 when the compute
    precision is bf16 (half the device memory), else fp32.  The samples are
    zero-padded to a hop multiple as the host framer pads them, uploaded
    once, and for ``frames`` cut into the ``(n_frames, seg)`` matrix on
    the device."""
    dtype = (torch.bfloat16 if cfg.tpu.precision == "bfloat16"
             else torch.float32)
    seg, hop = cfg.audio.segment_length, cfg.audio.hop_length
    if seg % hop != 0:
        raise ValueError(
            f"segment_length {seg} is not a multiple of hop_size {hop}")
    padded = pad_to_multiple(np.ascontiguousarray(corpus, np.float32), hop)
    samples = torch.from_numpy(padded).to(device).to(dtype)
    if layout != "frames":
        return samples
    if samples.numel() < seg:
        return samples.new_zeros((0, seg))
    return samples.unfold(0, seg, hop).contiguous()


def pick_block_rows(n_frames: int, n_batches: int, batch: int) -> int:
    """Block height for the block-granular resident shuffle: the SMALLEST
    power-of-two divisor of ``batch`` (≥ 32) that leaves enough whole blocks
    to fill every batch; smaller blocks shuffle finer.  Returns 1 (row
    granularity) when none fits."""
    for blk in (32, 64, 128, 256, 512):
        if batch % blk == 0 and (n_frames // blk) * blk >= n_batches * batch:
            return blk
    return 1


def perm_seed(seed: int, epoch: int) -> int:
    """The generator seed of epoch ``epoch``'s permutation: a hash of
    ``(seed, 0x5EED, epoch)``, 63 bits."""
    mask = (1 << 64) - 1
    return mix64(mix64(mix64(seed & mask) ^ 0x5EED) ^ (epoch & mask)) >> 1


def build_resident_epoch(
    model: ModelDef,
    cfg: Config,
    optimizer: Optional[Adam],
    n_samples: int,
    layout: str = "frames",
    noise: Optional[NoiseFn] = None,
    perm: Optional[PermFn] = None,
) -> Tuple[Callable, int]:
    """Returns ``(run_epochs, n_batches)`` where ``run_epochs(state, data,
    epoch0, k=1) → (state, losses[k, n_batches])`` trains ``k`` consecutive
    full epochs from epoch ``epoch0``; the fp32 losses stay on the device
    and nothing inside synchronises with the host.  ``state`` is updated in
    place.  ``data`` is the tensor from :func:`put_resident` in the
    matching layout.

    ``cfg.tpu.resident_shuffle = "block"`` (frames layout only) trades
    exact row-uniform shuffling for block-granular shuffling: frames move
    in contiguous :func:`pick_block_rows`-row blocks, so the per-epoch
    gather copies long runs.  Consecutive overlapping frames then stay
    together within a block, and the last ``n_frames mod block`` frames
    never train (DIVERGENCES.md).

    ``noise`` and ``perm`` replace the seeded noise and permutations."""
    seg = model.segment_length
    hop = cfg.audio.hop_length
    batch = cfg.training.batch_size
    micro = cfg.tpu.microbatch_size
    if micro and batch > micro:
        raise ValueError(
            "the resident epoch takes one full-batch gradient per step and "
            f"cannot accumulate microbatches (microbatch_size {micro} < "
            f"batch_size {batch})")
    n_frames = max(0, overlapping_frame_count(n_samples, seg, hop))
    n_batches = n_frames // batch
    if n_batches == 0:
        raise ValueError(
            f"corpus has {n_frames} frames < one batch of {batch}")
    block_rows = 1
    if cfg.tpu.resident_shuffle == "block" and layout == "frames":
        block_rows = pick_block_rows(n_frames, n_batches, batch)
    n_shuffle = n_frames // block_rows    # shuffle units per epoch
    used = n_batches * batch // block_rows  # units consumed per epoch
    step = build_train_step(model, cfg, optimizer, noise)

    def selection(state: TrainState, epoch: int, device) -> Tensor:
        if perm is not None:
            return perm(epoch, n_shuffle).to(device)[:used]
        g = torch.Generator(device=device)
        g.manual_seed(perm_seed(state.seed, epoch))
        return torch.randperm(n_shuffle, generator=g, device=device)[:used]

    def epoch_batches(data: Tensor, sel: Tensor):
        if layout == "frames":
            if block_rows > 1:
                # gather whole contiguous blocks of block_rows frames
                blocks = data[: n_shuffle * block_rows].view(
                    n_shuffle, block_rows, seg)
                shuffled = blocks[sel]
            else:
                # ONE whole-matrix gather per epoch; the steps then take
                # contiguous slices: data[sel][a:b] == data[sel[a:b]]
                shuffled = data[sel]
            return shuffled.view(n_batches, batch, seg).unbind(0)
        # corpus layout: seg-sample runs at start * hop — indexing the
        # window view with a batch's starts gathers only those rows
        windows = data.unfold(0, seg, hop)
        return (_gather(windows, starts)
                for starts in sel.view(n_batches, batch).unbind(0))

    def run_epochs(state: TrainState, data: Tensor, epoch0: int, k: int = 1):
        rows = []
        for epoch in range(epoch0, epoch0 + k):
            losses = []
            with span("rvk.epoch"):
                batches = epoch_batches(
                    data, selection(state, epoch, data.device))
            for xb in batches:
                state, metrics = step(state, xb)
                losses.append(metrics["loss"].float())
            rows.append(torch.stack(losses))
        return state, torch.stack(rows)

    return run_epochs, n_batches


def _gather(windows: Tensor, starts: Tensor) -> Tensor:
    """A batch's rows of the ``corpus`` layout's window view."""
    with span("rvk.gather"):
        return windows[starts]


# ------------------------------------------------- the mesh-sharded engine

def pad_frames_for_mesh(frames: np.ndarray, n_shards: int) -> np.ndarray:
    """Wrap-pad the frame matrix so rows divide evenly across shards."""
    return _wrap_pad_to(frames, -(-len(frames) // n_shards) * n_shards)


def _wrap_pad_to(frames: np.ndarray, target: int) -> np.ndarray:
    """Wrap-pad ``frames`` to exactly ``target`` rows."""
    if len(frames) >= target:
        return frames[:target]
    if len(frames) == 0:
        # silently returning short rows would desync this rank from its
        # peers and deadlock their next collective — fail loudly instead
        raise ValueError(
            "cannot wrap-pad an empty frame matrix: this rank's file shard "
            "yielded no frames (more ranks than audio files?)")
    extra = target - len(frames)
    reps = -(-extra // len(frames))
    fill = np.concatenate([frames] * reps, axis=0)[:extra]
    return np.concatenate([frames, fill], axis=0)


def align_local_rows(frames: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Wrap-pad this rank's frame rows to the largest count over the ranks
    (an all-gather of the counts; one device a process, so no further
    rounding), so every rank contributes an equal block.  Wrap-padding
    repeats local frames — the epoch semantics of
    :func:`pad_frames_for_mesh` (duplicated rows train again)."""
    if world_size() <= 1:
        return frames
    counts = all_gather_ints([len(frames)])
    return _wrap_pad_to(frames, int(counts.max()))


def put_frames_sharded(frames: np.ndarray, cfg: Config, mesh: Mesh
                       ) -> Tensor:
    """Upload this rank's block of the frame matrix onto its device, cast
    on the HOST (bf16 under ``precision = bfloat16``, else fp32) so that
    only the block crosses the link.  ``frames`` is the rank's own rows:
    its file shard's, aligned by :func:`align_local_rows`, or its block
    ``[r·N/n, (r+1)·N/n)`` of a global matrix padded by
    :func:`pad_frames_for_mesh` (``parallel/mesh.py`` ``batch_sharding``
    names it)."""
    dtype = (torch.bfloat16 if cfg.tpu.precision == "bfloat16"
             else torch.float32)
    host = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    return host.to(dtype).to(mesh.device)


def _two_pass_shuffle(frames_local: Tensor, seed: int, mesh: Mesh
                      ) -> Tensor:
    """A global-ish shuffle of a sharded frame matrix on the devices: pass
    1 permutes the local rows (``randperm`` seeded by ``seed``), pass 2 is
    an ``all_to_all`` block transpose — each rank keeps 1/n of its rows and
    sends 1/n to every other rank, so a shard then holds an equal random
    slice of every original shard.  The rows past the largest multiple of
    n stay local (random rows after pass 1).  One collective an epoch."""
    n_local = frames_local.shape[0]
    g = torch.Generator(device=frames_local.device)
    g.manual_seed(seed)
    pre = torch.randperm(n_local, generator=g, device=frames_local.device)
    frames_local = frames_local[pre]
    n = mesh.data
    blk = n_local // n
    if n == 1 or blk == 0:
        return frames_local
    head = frames_local[: blk * n].contiguous()
    out = torch.empty_like(head)
    dist.all_to_all_single(out, head)
    if blk * n == n_local:
        return out
    return torch.cat([out, frames_local[blk * n:]])


def build_resident_epoch_sharded(
    model: ModelDef,
    cfg: Config,
    optimizer: Optional[Adam],
    n_frames_padded: int,
    mesh: Mesh,
    noise: Optional[NoiseFn] = None,
    perm: Optional[PermFn] = None,
) -> Tuple[Callable, int]:
    """Multi-rank resident epochs: the frame matrix (``n_frames_padded``
    rows over all ranks) is sharded over the data axis; every rank draws
    its epoch's permutation, gathers its whole shard once by it, and runs
    ``batch/n`` of its rows a step through the per-rank step of
    ``parallel/spmd.py`` — whose one gradient all-reduce is the only
    collective of a step.  Returns ``(run_epochs, n_batches)`` with
    :func:`build_resident_epoch`'s signature; ``data`` is the rank's block
    from :func:`put_frames_sharded`, and the losses are the reduced global
    ones, equal on every rank.

    ``resident_shuffle`` ``global`` (and ``block``, a one-device form that
    keeps the exact two-pass shuffle on a mesh, as in JAX) runs
    :func:`_two_pass_shuffle` each epoch; ``local`` permutes within each
    shard.  ``noise`` replaces the rank's draws, ``perm(epoch, n_local)``
    its final permutation (the callers' functions know the rank)."""
    batch = cfg.training.batch_size
    n_shards = mesh.data
    if batch % n_shards:
        raise ValueError(
            f"batch_size {batch} not divisible by data shards {n_shards}")
    micro = cfg.tpu.microbatch_size
    if micro and batch > micro:
        raise ValueError(
            "the resident epoch takes one full-batch gradient per step and "
            f"cannot accumulate microbatches (microbatch_size {micro} < "
            f"batch_size {batch})")
    local_bs = batch // n_shards
    n_local = n_frames_padded // n_shards
    n_batches = n_local // local_bs
    if n_batches == 0:
        raise ValueError(
            f"{n_local} frames/shard < one local batch of {local_bs}")
    used = n_batches * local_bs
    seg = model.segment_length
    index = mesh.data_index
    global_shuffle = cfg.tpu.resident_shuffle in ("global", "block")
    step = per_rank_step(model, cfg, optimizer, mesh, noise)

    def shuffled_shard(data: Tensor, epoch: int, seed: int) -> Tensor:
        epoch_seed = perm_seed(seed, epoch)
        local = data
        if global_shuffle and n_shards > 1:
            local = _two_pass_shuffle(
                data, fold_rank(mix64(epoch_seed ^ 0xA110) >> 1, index),
                mesh)
        if perm is not None:
            sel = perm(epoch, n_local).to(data.device)[:used]
        else:
            g = torch.Generator(device=data.device)
            g.manual_seed(fold_rank(epoch_seed, index))
            sel = torch.randperm(n_local, generator=g,
                                 device=data.device)[:used]
        # one whole-shard gather an epoch, then contiguous slices
        return local[sel].view(n_batches, local_bs, seg)

    def run_epochs(state: TrainState, data: Tensor, epoch0: int, k: int = 1):
        rows = []
        for epoch in range(epoch0, epoch0 + k):
            with span("rvk.epoch"):
                shuffled = shuffled_shard(data, epoch, state.seed)
            losses = []
            for xb in shuffled.unbind(0):
                state, metrics = step(state, xb)
                losses.append(metrics["loss"].float())
            rows.append(torch.stack(losses))
        return state, torch.stack(rows)

    return run_epochs, n_batches

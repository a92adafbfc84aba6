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

The mesh-sharded engine (``build_resident_epoch_sharded``,
``_two_pass_shuffle``, ``put_frames_sharded``, ``align_local_rows``,
``pad_frames_for_mesh``) waits for multi-GPU training.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.data.framing import (
    overlapping_frame_count,
    pad_to_multiple,
)
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.parallel.step import (
    NoiseFn,
    build_train_step,
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
            yield from shuffled.view(n_batches, batch, seg).unbind(0)
            return
        # corpus layout: seg-sample runs at start * hop — indexing the
        # window view with a batch's starts gathers only those rows
        windows = data.unfold(0, seg, hop)
        for starts in sel.view(n_batches, batch).unbind(0):
            yield windows[starts]

    def run_epochs(state: TrainState, data: Tensor, epoch0: int, k: int = 1):
        rows = []
        for epoch in range(epoch0, epoch0 + k):
            losses = []
            for xb in epoch_batches(data, selection(state, epoch,
                                                    data.device)):
                state, metrics = step(state, xb)
                losses.append(metrics["loss"].float())
            rows.append(torch.stack(losses))
        return state, torch.stack(rows)

    return run_epochs, n_batches

"""Streaming trainer — the ``python train_iterable.py --config x.ini`` flow
(train_iterable.py:114-329), the JAX package's ``train/stream.py`` ported to
one device: an epoch-less loop over a bounded stream of batches pulled from
a cycling, per-pass-shuffled wav-folder dataset.

Contract points kept:
  * ``total_num_batches = total_num_frames // batch_size``
    (train_iterable.py:74) bounds the run;
  * checkpoints keyed on ``batch_id`` (train_iterable.py:220), in the
    layout both packages read, so a run interrupted in one resumes in the
    other;
  * stdout teed to ``<workdir>/console_log`` (train_iterable.py:117-133);
  * per-batch parameter histograms (train_iterable.py:216-217) — throttled by
    ``[tpu] histogram_interval`` (quirk #10: every batch was pathological).
Fixed, as in the JAX package: the hard-coded segment_length 1024
(dataset.py:66, quirk #2) and the degenerate best-model gate (quirk #7).

Two engines share all bookkeeping, chosen by ``[tpu] device_resident``
through one gate, :func:`resident_plan`:
  * host-fed (``_run``): a background prefetcher decodes, frames and copies
    batches to the device ahead of the step, the per-batch losses stay on
    the device and drain in bursts;
  * device-resident (``_run_resident``, the JAX package's engine of the
    same name on one device): the folder is uploaded once in the layout the
    gate sized — ``samples`` (the hop-padded audio plus an int32 start per
    frame) or ``frames`` (the window matrix) — and the EXACT stream order
    (per-pass file shuffle, batches crossing files, bit for bit the host
    loader's) replays on the device from staged int32 index chunks; the
    host never builds an audio batch.
``auto`` takes the resident engine where the plan fits and otherwise prints
the plan and trains host-fed; ``always`` raises where it does not fit.

Under several ranks (``parallel/mesh.py``; the ``stream`` command starts
them on one host) each rank streams its own file shard (the JAX multihost
branch: the dataset seeded ``seed + rank``), ``batch_size / world`` rows a
step through the mesh step; the host-fed engine checks ``batch_size %
world`` up front (JAX ``:178-190``: "divisible by the per-host device
count").  The resident engine keeps the ``frames`` layout (JAX's
``resident_layout = auto`` rule: the mesh paths address frame rows), each
rank's frames on its own card and its own index plan, so its rows are the
host-fed engine's and the two engines' losses are equal bit for bit; an
indivisible ``batch_size`` there pads the ranks' index batches to one size
with rows of weight 0 (the row-weighted loss).  The gate's decision comes
from all-gathered sizes, the same on every rank, and a stop flag acts only
by agreement, at the JAX cadences (every ``sync_every`` batches host-fed;
at histogram and checkpoint crossings and every 8th chunk resident).
Under ``model_parallel > 1`` the ranks of one data index stream the same
shard (seeded ``seed + data index``) into the sharded step, host-fed: the
resident engine refuses the model axis as JAX's does.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.data.datasets import StreamingFrameDataset
from rawaudiovae_kelsey_tpu_torch.data.loader import (
    feed_dtype,
    prefetch_to_device,
)
from rawaudiovae_kelsey_tpu_torch.data.validate import check_before_training
from rawaudiovae_kelsey_tpu_torch.io import wav_info
from rawaudiovae_kelsey_tpu_torch.observe.logging import tee_stdout
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_ints,
    host_shard_info,
    is_coordinator,
)
from rawaudiovae_kelsey_tpu_torch.train import loop as L
from rawaudiovae_kelsey_tpu_torch.train.epoch import (
    _sync_stop,
    check_supported,
)
from rawaudiovae_kelsey_tpu_torch.train.interrupt import GracefulInterrupt

# the device memory the resident stream needs beside the corpus: the train
# state, the step's activations and gradients, the pregathered chunk of
# rows (up to PREGATHER_BYTES), a checkpoint boundary's snapshot of the
# state.  On a card the gate caps the corpus at the free memory less this.
# Measured: 1,436 and 1,569 MB of peak allocation beside the corpus in two
# runs of configs/default_iterable.ini (dense 1024/2048/256, batch 4096,
# bf16, chunks of 64 pregathered; chip_smoke.py phase 12, NVIDIA H100 80GB
# HBM3, 700.00 W: the snapshot and the next chunk overlap as timing has
# it), kept with headroom
RESIDENT_STEP_BYTES = 2 << 30
# the largest chunk of rows gathered at once (JAX train/stream.py:508-510)
PREGATHER_BYTES = 1 << 30
# the most steps a chunk issues (JAX train/stream.py:480)
MAX_CHUNK = 64


def train(cfg: Config, verbose: bool = True,
          device: torch.device | str = "cuda") -> L.TrainContext:
    datapath = cfg.dataset.datapath_path
    if not datapath.exists():
        raise FileNotFoundError(datapath.resolve())
    check_supported(cfg, device)
    ctx = L.setup(cfg, device)
    # one console log: rank 0's
    tee = (tee_stdout(ctx.workspace.console_log_path) if is_coordinator()
           else contextlib.nullcontext())
    try:
        with tee, GracefulInterrupt() as stop:
            return _run(ctx, cfg, verbose, stop)
    finally:
        L.finish(ctx)


class ResidentPlan(NamedTuple):
    """What the resident stream would hold on the device."""
    layout: str          # "samples" | "frames"
    frames: int          # streaming frames across the folder
    need_bytes: int      # device bytes of the corpus in that layout
    budget_bytes: int    # what the device may give it
    fits: bool


def resident_plan(dataset: StreamingFrameDataset, cfg: Config,
                  device: torch.device, mesh: Optional[Mesh] = None
                  ) -> Optional[ResidentPlan]:
    """Size the device-resident stream in the layout it will take —
    ``samples`` (the hop-padded audio plus an int32 start per frame) when
    ``[tpu] resident_layout`` says so or is ``auto`` with overlapping
    windows, else the ``frames`` matrix; always ``frames`` on a mesh —
    against ``[tpu] resident_budget_gb``, on a card also capped by its free
    memory (``torch.cuda.mem_get_info``) less :data:`RESIDENT_STEP_BYTES`.
    A config that asks for microbatch accumulation never fits: the
    resident step takes one full-batch gradient.  ``None`` when a wav
    header cannot be read.  On a mesh the plan is the ranks' worst case,
    the same on every rank (a rank entering the resident engine's
    collectives while a peer trains host-fed would hang them): any
    unreadable header gives ``None``; the largest corpus against the
    smallest budget."""
    est = _estimate_stream_frames(dataset, cfg)
    seg, hop = cfg.audio.segment_length, cfg.audio.hop_length
    dtype_bytes = 2 if cfg.tpu.precision == "bfloat16" else 4
    want = cfg.tpu.resident_layout
    frames = samples = -1
    if est is not None:
        frames, samples = est
    if mesh is None and (want == "samples" or (want == "auto"
                                               and hop < seg)):
        layout, need = "samples", samples * dtype_bytes + 4 * frames
    else:
        layout, need = "frames", frames * seg * dtype_bytes
    budget = int(cfg.tpu.resident_budget_gb * (1 << 30))
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        budget = min(budget, free - RESIDENT_STEP_BYTES)
    if mesh is not None:
        sizes = all_gather_ints([frames, need, budget])
        if int(sizes[:, 0].min()) < 0:
            est = None
        frames = int(sizes[:, 0].min())
        need, budget = int(sizes[:, 1].max()), int(sizes[:, 2].min())
    if est is None:
        return None
    micro = cfg.tpu.microbatch_size
    micro_ok = not (micro and cfg.training.batch_size > micro)
    return ResidentPlan(layout, frames, need, budget,
                        micro_ok and frames > 0 and need <= budget)


def describe_plan(plan: Optional[ResidentPlan], cfg: Config) -> str:
    if plan is None:
        return "wav headers unreadable"
    micro = cfg.tpu.microbatch_size
    extra = ("; microbatch_size is set (the resident step takes one "
             "full-batch gradient)"
             if micro and cfg.training.batch_size > micro else "")
    return (f"{plan.frames:,} frames, {plan.layout} layout, "
            f"{plan.need_bytes / 1e6:,.0f} MB of a "
            f"{plan.budget_bytes / 1e6:,.0f} MB budget: "
            f"{'fits' if plan.fits else 'does not fit'}{extra}")


def _run(ctx: L.TrainContext, cfg: Config, verbose: bool,
         stop=None) -> L.TrainContext:
    batch_size = cfg.training.batch_size
    total_num_batches = cfg.training.total_num_frames // batch_size
    if total_num_batches <= 0:
        raise ValueError(
            "total_num_frames must be >= batch_size for the streaming trainer"
        )
    print(f"Total number of batches: {total_num_batches}")

    audio_dir = cfg.dataset.datapath_path / "audio"
    check_before_training(
        audio_dir, cfg.audio.sampling_rate,
        cfg.dataset.check_dataset, cfg.dataset.check_audio,
    )
    # a rank streams its own file shard (JAX's per-host stream); the model
    # ranks of a data index stream the same one
    host_id, num_hosts = host_shard_info(ctx.mesh)
    dataset = StreamingFrameDataset(
        audio_dir,
        cfg.audio.sampling_rate,
        cfg.audio.hop_length,
        cfg.audio.segment_length,   # quirk #2 fix: honors config
        shuffle=True,
        mono=cfg.dataset.mono,
        seed=cfg.tpu.seed + host_id,
        host_id=host_id,
        num_hosts=num_hosts,
    )
    cfg.dataset.total_frames = str(cfg.training.total_num_frames)
    ctx.workspace.snapshot_config(cfg)
    device = ctx.model.device
    mesh = ctx.mesh

    # the resident gate: size the layout the resident stream would take
    # against the budget, then run the engine it chooses.  The resident
    # engine refuses the model axis, as JAX's does (stream.py:102-103)
    if mesh is not None and mesh.model > 1 \
            and cfg.tpu.device_resident != "never":
        if cfg.tpu.device_resident == "always":
            raise ValueError(
                "device_resident=always but model_parallel = "
                f"{mesh.model}: the resident stream refuses the model axis; "
                "use device_resident=auto or never")
        print(f"device_resident=auto: model_parallel = {mesh.model} trains "
              "host-fed (the resident stream refuses the model axis)")
    elif cfg.tpu.device_resident != "never":
        plan = resident_plan(dataset, cfg, device, mesh)
        if plan is not None and plan.fits:
            return _run_resident(ctx, cfg, verbose, stop, dataset,
                                 total_num_batches, plan.layout)
        if cfg.tpu.device_resident == "always":
            # never degrade silently to host-fed training
            raise ValueError(
                "device_resident=always but the stream does not fit on the "
                f"device ({describe_plan(plan, cfg)}); raise "
                "resident_budget_gb, drop microbatch_size or use "
                "device_resident=auto")
        print(f"device_resident=auto: {describe_plan(plan, cfg)}; "
              "training host-fed")

    interval = cfg.training.checkpoint_interval
    hist_every = cfg.tpu.histogram_interval
    lr = cfg.training.learning_rate

    # resume support: skip already-trained batches
    start_batch = ctx.start_step
    remaining = total_num_batches - start_batch
    if remaining <= 0:
        print("Nothing to do: checkpoint already covers the frame budget.")
        return ctx
    if start_batch:
        print(f"Resuming at batch {start_batch}")

    rank_batch = batch_size
    if mesh is not None:
        # checked UP FRONT: an indivisible batch would leave the ranks
        # unequal blocks
        if batch_size % mesh.data:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the world "
                f"size ({mesh.data}) for host-fed mesh streaming")
        rank_batch = batch_size // mesh.data

    # islice(start, stop): regenerating and SKIPPING the first start_batch
    # batches keeps the stream order aligned on resume (taking the first
    # `remaining` would retrain already-seen data and drop the tail); each
    # rank prefetches only its own rows onto its own device
    feed = prefetch_to_device(
        itertools.islice(dataset.batches(rank_batch), start_batch,
                         start_batch + remaining),
        device, depth=cfg.tpu.prefetch, cast_dtype=feed_dtype(cfg),
    )

    pending = []  # (batch_id, device_loss) — drained off the hot path
    train_loss_accum = 0.0
    window_loss = 0.0       # since the last checkpoint — drives the best gate
    window_count = 0
    window_mark = start_batch  # first batch of the current rate window
    # progress cadence; interval=0 must NOT collapse it to every batch: the
    # drain's copy would block on the step queued one line up
    progress_every = max(1, interval // 10) if interval else 100
    ctx.timer.start()

    def drain():
        nonlocal train_loss_accum, window_loss, window_count
        if not pending:
            return
        # one transfer for all buffered scalars (a per-scalar fetch costs a
        # full host<->device round trip each)
        values = torch.stack([dl for _, dl in pending]).double().cpu()
        for (bid, _), loss in zip(pending, values.tolist()):
            train_loss_accum += loss
            window_loss += loss
            window_count += 1
            ctx.writer.add_scalar("Loss/Batch", loss, bid)
            ctx.writer.add_scalar("Learning Rate", lr, bid)
        pending.clear()

    # a signal is one rank's: under a mesh the flag is all-reduced at a
    # fixed batch cadence, the same on every rank, so the collective
    # always matches up (JAX :226-262)
    multihost = mesh is not None
    sync_every = progress_every

    try:
        for offset, batch in enumerate(feed):
            batch_id = start_batch + offset
            ctx.state, metrics = ctx.train_step(ctx.state, batch)
            pending.append((batch_id, metrics["loss"]))

            if (not multihost and stop) or (
                    multihost and batch_id % sync_every == 0
                    and _sync_stop(stop, True)):
                feed.close()
                drain()
                print(f"Interrupted at batch {batch_id}; checkpointing.")
                L.save_periodic_checkpoint(ctx, {"batch_id": batch_id},
                                           label=batch_id)
                return ctx

            if verbose and batch_id % progress_every == 0:
                drain()
                print(f"Batch {batch_id}/{total_num_batches} - "
                      f"Cumulative loss: {train_loss_accum:.6f}")

            if hist_every and batch_id % hist_every == 0:
                L.log_param_histograms(ctx, batch_id)

            if interval and batch_id % interval == 0 and batch_id != 0:
                drain()
                step_time = ctx.timer.stop()
                # batches actually trained this window (the first window
                # after a resume is shorter than a full interval)
                n_window = batch_id - window_mark
                window_mark = batch_id
                print(f"Checkpoint - Batch {batch_id} "
                      f"({n_window * batch_size / max(step_time, 1e-9):,.0f}"
                      " frames/s)")
                if cfg.dataset.generate_test:
                    L.reconstruct_test_set(ctx, batch_id)
                # best gate FIRST — on the mean loss of this checkpoint
                # interval (the reference compared a cumulative sum against
                # a constant — both degenerate; see DIVERGENCES.md) — so
                # the checkpoint meta records this boundary's gate
                interval_mean = window_loss / max(window_count, 1)
                # ONE state fetch shared by the best gate and the
                # checkpoint writer
                host, host_p = L.boundary_host_state(ctx)
                L.maybe_save_best(ctx, interval_mean, batch_id, after=0,
                                  host_params=host_p)
                L.save_periodic_checkpoint(ctx, {"batch_id": batch_id},
                                           label=batch_id, host_state=host)
                window_loss, window_count = 0.0, 0
                # restart AFTER checkpoint I/O so the reported frames/s
                # measures the training window, not eval/save traffic
                ctx.timer.start()
    finally:
        feed.close()

    drain()
    # final reconstruction + saves (train_iterable.py:271-319)
    print(f"Last Checkpoint - Batch {total_num_batches}")
    host, host_p = L.boundary_host_state(ctx)  # one fetch, whole tail
    if cfg.dataset.generate_test:
        L.reconstruct_test_set(ctx, total_num_batches)
    if window_count:  # an empty window (final batch == a checkpoint
        # boundary) must not feed the best gate a fake 0.0
        L.maybe_save_best(ctx, window_loss / window_count,
                          total_num_batches, after=0, host_params=host_p)
    L.save_periodic_checkpoint(ctx, {"batch_id": total_num_batches},
                               label=total_num_batches, host_state=host)
    L.save_last(ctx, host_params=host_p)
    return ctx


def _estimate_stream_frames(dataset: StreamingFrameDataset, cfg: Config
                            ) -> Optional[tuple]:
    """``(frames, samples)`` across the folder from wav headers only: the
    streaming frames, and the hop-padded samples of the files long enough
    to yield one.  ``None`` when a header cannot be read."""
    seg, hop, sr = (cfg.audio.segment_length, cfg.audio.hop_length,
                    cfg.audio.sampling_rate)
    frames = samples = 0
    try:
        for f in dataset.audio_file_list:
            n, _ch, native_sr, _bits = wav_info(f)
            if native_sr != sr:
                n = int(n * sr / native_sr)
            n += (-n) % hop
            if n >= seg:
                frames += (n - seg) // hop + 1
                samples += n
    except Exception:
        return None
    return frames, samples


def k_schedule(start_batch: int, total_num_batches: int, chunk: int,
               interval: int, hist_every: int) -> List[int]:
    """Steps of each chunk from ``start_batch`` to the end of the budget:
    at most ``chunk``, cut so that a chunk ends on every checkpoint and
    histogram boundary (JAX train/stream.py:621-634)."""
    bid, out = start_batch, []
    while bid < total_num_batches:
        k = min(chunk, total_num_batches - bid)
        if interval:
            k = min(k, interval - bid % interval)
        if hist_every:
            k = min(k, hist_every - bid % hist_every)
        out.append(k)
        bid += k
    return out


def upload_corpus(dataset: StreamingFrameDataset, cfg: Config, layout: str,
                  device: torch.device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """The stream's corpus on ``device`` → ``(data, starts, frames)``:
    in the ``samples`` layout the hop-padded samples and the int32 start
    of every frame, in the ``frames`` layout the window matrix and no
    starts.  bf16 under ``precision = bfloat16`` (cast on the host, as the
    host feed casts a ``feed_dtype = bfloat16`` batch), else fp32."""
    dtype = (torch.bfloat16 if cfg.tpu.precision == "bfloat16"
             else torch.float32)
    if layout == "samples":
        samples, starts = dataset.all_samples()
        data = torch.from_numpy(samples).to(dtype).to(device)
        return data, torch.from_numpy(starts).to(device), len(starts)
    frames = dataset.all_frames()
    return torch.from_numpy(frames).to(dtype).to(device), None, len(frames)


def rows_of(data: torch.Tensor, starts: Optional[torch.Tensor],
            idx: torch.Tensor, seg: int) -> torch.Tensor:
    """The ``(rows, seg)`` windows of frame indices ``idx``: a row gather
    of the frame matrix, or (samples layout) of the strided window view of
    the samples at ``starts[idx]`` — only the indexed rows are read (JAX
    train/stream.py:514-522)."""
    if starts is None:
        return data[idx.long()]
    return data.unfold(0, seg, 1)[starts[idx].long()]


def chunk_rows(data: torch.Tensor, starts: Optional[torch.Tensor],
               idx: torch.Tensor, seg: int, pregather: bool):
    """The batches of a chunk of index rows ``idx`` (k, rows), in order:
    one gather for the whole chunk, sliced, when ``pregather``, else a
    gather a batch.  The rows are equal: data[I][j] == data[I[j]]."""
    if pregather:
        k, rows = idx.shape
        return rows_of(data, starts, idx.reshape(-1), seg).view(
            k, rows, seg).unbind(0)
    return (rows_of(data, starts, row, seg) for row in idx.unbind(0))


def _run_resident(ctx: L.TrainContext, cfg: Config, verbose: bool, stop,
                  dataset: StreamingFrameDataset, total_num_batches: int,
                  layout: str) -> L.TrainContext:
    """The device-resident stream on one device: the corpus is uploaded
    once; each batch is gathered on the device by int32 frame indices
    (:func:`rows_of`) that the host stages ahead in chunks; the step is
    ``ctx.train_step``, the host-fed loop's own (the registry's
    ``resident_model`` is the model itself here), so a batch's noise seed
    is the host-fed one and the bits are the same.

    Declared divergence from JAX's ``run_chunk``: no fixed ``(chunk,
    rows)`` shape with a NaN-masked tail and an active count.  That shape
    lets one compiled executable serve every chunk; eager PyTorch compiles
    nothing, so a chunk of ``k`` steps issues ``k`` steps and returns ``k``
    device losses, with no host synchronisation inside (as
    ``parallel/resident.py`` does for epochs).

    Under a mesh (JAX ``:360-495``) each rank uploads its own file shard's
    frames to its own card and replays its own stream's index plan, so a
    rank's rows are those its host-fed engine would feed; JAX's
    ``idx_base`` (the offset of a host's block in the stitched global
    matrix) is 0 by construction, every rank indexing its own tensor.  A
    ``batch_size`` that does not divide the ranks gives ranks ``⌈B/n⌉`` or
    ``⌊B/n⌋`` real rows, padded to ``⌈B/n⌉`` with index 0 at weight 0
    (``pad_rows`` and the row-weighted loss, JAX ``:459-495``)."""
    device = ctx.model.device
    on_cuda = device.type == "cuda"
    mesh = ctx.mesh
    batch_size = cfg.training.batch_size
    interval = cfg.training.checkpoint_interval
    hist_every = cfg.tpu.histogram_interval
    lr = cfg.training.learning_rate
    seg = cfg.audio.segment_length

    start_batch = ctx.start_step
    if total_num_batches - start_batch <= 0:
        print("Nothing to do: checkpoint already covers the frame budget.")
        return ctx
    if start_batch:
        print(f"Resuming at batch {start_batch}")

    data, starts, n_frames = upload_corpus(dataset, cfg, layout, device)
    chunk = min(MAX_CHUNK, interval or MAX_CHUNK, total_num_batches) or 1
    rows, pad_rows, weights = batch_size, 0, None
    if mesh is not None:
        n, r = mesh.data, mesh.data_index
        rows = batch_size // n + (r < batch_size % n)
        pad_rows = -(-batch_size // n) - rows
        if batch_size % n:
            # every rank takes the weighted step (its n_real all-reduce)
            weights = torch.cat([torch.ones(rows), torch.zeros(pad_rows)]
                                ).to(device)
    # one gather per chunk (the rows of every step at once) where its
    # buffer is small; per-step gathers otherwise
    pregather = (chunk * (rows + pad_rows) * seg * data.element_size()
                 <= PREGATHER_BYTES)

    plan = dataset.index_batches(rows)
    # resume: consume the indices the finished batches already used
    for _ in range(start_batch):
        next(plan)
    # the decoded per-file cache served the upload and the plan's counts;
    # the data now lives on the device
    dataset.release_cache()
    nbytes = data.numel() * data.element_size() + (
        0 if starts is None else starts.numel() * starts.element_size())
    where = "on device"
    if mesh is not None:
        where = (f"rank {mesh.rank}'s shard on its device, sharded over "
                 f"{mesh.data} ranks")
    print(f"Device-resident stream: {n_frames:,} frames "
          f"({nbytes / 1e6:,.0f} MB {where}, {layout} layout), "
          f"{chunk} steps/dispatch")

    ks = k_schedule(start_batch, total_num_batches, chunk, interval,
                    hist_every)

    def chunk_plan():
        for k in ks:
            batches = list(itertools.islice(plan, k))
            if pad_rows:       # weight-0 rows; index 0 is always in range
                batches = [np.concatenate([bb, np.zeros(pad_rows, bb.dtype)])
                           for bb in batches]
            yield np.stack(batches)

    # index chunks staged onto the device ahead of use: the only host→device
    # traffic of the loop
    staged = prefetch_to_device(chunk_plan(), device, depth=3)

    def run_chunk(idx: torch.Tensor) -> torch.Tensor:
        losses = []
        extra = () if weights is None else (weights,)
        for xb in chunk_rows(data, starts, idx, seg, pregather):
            ctx.state, metrics = ctx.train_step(ctx.state, xb, *extra)
            losses.append(metrics["loss"])
        return torch.stack(losses)

    train_loss_accum = 0.0
    window_loss, window_count = 0.0, 0
    batch_id = start_batch
    # (first batch_id, device losses, done event) — drained off the hot path
    pending = []

    def drain():
        nonlocal train_loss_accum, window_loss, window_count
        if not pending:
            return
        # one transfer for every buffered loss
        values = torch.cat([dl for _, dl, _ in pending]).double().cpu()
        it = iter(values.tolist())
        for bid0, dl, _ in pending:
            for j in range(dl.shape[0]):
                loss = next(it)
                train_loss_accum += loss
                window_loss += loss
                window_count += 1
                ctx.writer.add_scalar("Loss/Batch", loss, bid0 + j)
                ctx.writer.add_scalar("Learning Rate", lr, bid0 + j)
        pending.clear()

    # resident histograms land on chunk boundaries; a fresh run's first log
    # fires at the FIRST boundary, so the series has the host-fed path's
    # sample count (its batch-0 log)
    hist_marker = (((start_batch // hist_every) if start_batch else -1)
                   if hist_every else 0)
    # checkpoint boundaries off the loop: the state is snapshotted on the
    # device (the step updates the live state in place) and the worker
    # fetches and writes while the loop issues the next chunks
    bwriter = L.AsyncBoundaryWriter() if cfg.tpu.async_checkpoint else None
    ctx.boundary_writer = bwriter  # finish() joins on exception paths

    ctx.timer.start()
    loop_t0 = time.perf_counter()

    def e2e_summary(bid: int) -> None:
        # whole-loop wall (after the upload, every checkpoint boundary in
        # it); the per-window "Checkpoint - Batch" rates leave boundary
        # I/O out by design
        done_b = bid - start_batch
        wall = time.perf_counter() - loop_t0
        if done_b > 0 and wall > 0:
            print(f"====> Resident stream e2e: {done_b} batches in "
                  f"{wall:.2f}s = {done_b * batch_size / wall:,.0f} "
                  f"frames/s wall-clock incl. checkpoints")

    window_mark = start_batch  # first batch of the current rate window
    try:
        for ci, idx in enumerate(staged):
            k = idx.shape[0]
            losses = run_chunk(idx)
            done = None
            if on_cuda:
                done = torch.cuda.Event()
                done.record()
            pending.append((batch_id, losses, done))  # no sync here
            batch_id += k
            if len(pending) >= 8 and pending[-8][2] is not None:
                # backpressure on the chunk issued 8 back (drains happen
                # only at boundaries): in-flight work and interrupt latency
                # stay bounded with the queue full
                pending[-8][2].synchronize()

            if verbose:
                print(f"Batch {batch_id}/{total_num_batches}")
            crossed_hist = bool(hist_every
                                and batch_id // hist_every != hist_marker)
            at_ckpt = bool(interval and batch_id % interval == 0
                           and batch_id != total_num_batches)
            if crossed_hist:
                hist_marker = batch_id // hist_every
                if not at_ckpt:
                    L.log_param_histograms(ctx, batch_id)
                # else: logged in the checkpoint block from its one fetch
            # under a mesh the flag is all-reduced where every rank is at
            # the same chunk: histogram and checkpoint crossings, else every
            # 8th chunk (the chunk schedule is the same on every rank)
            stop_now = (bool(stop) if mesh is None
                        else ((crossed_hist or at_ckpt or ci % 8 == 7)
                              and _sync_stop(stop, True)))
            if stop_now:
                staged.close()
                drain()
                if bwriter is not None:
                    bwriter.flush()  # settle the best gate's trail first
                e2e_summary(batch_id)
                print(f"Interrupted at batch {batch_id}; checkpointing.")
                L.save_periodic_checkpoint(ctx, {"batch_id": batch_id},
                                           label=batch_id)
                return ctx
            if not at_ckpt:
                continue
            drain()
            step_time = ctx.timer.stop()
            # the batches trained in this window (the first window after a
            # resume is shorter than a full interval)
            n_window = batch_id - window_mark
            window_mark = batch_id
            print(f"Checkpoint - Batch {batch_id} "
                  f"({n_window * batch_size / max(step_time, 1e-9):,.0f}"
                  " frames/s)")
            if cfg.dataset.generate_test:
                L.reconstruct_test_set(ctx, batch_id)
            wmean = window_loss / max(window_count, 1)
            if bwriter is not None:
                snap = ctx.state.clone()
                ready = None
                if on_cuda:
                    ready = torch.cuda.Event()
                    ready.record()

                def boundary_io(bs=snap, ready=ready, bid=batch_id,
                                wl=wmean, hist=crossed_hist):
                    h = L.fetch_host_state(bs, ready)
                    if hist:  # a coincident crossing shares this fetch
                        L.log_param_histograms(ctx, bid, params=h.params)
                    # best gate first: the meta records this boundary's
                    L.maybe_save_best(ctx, wl, bid, after=0,
                                      host_params=h.params)
                    L.save_periodic_checkpoint(ctx, {"batch_id": bid},
                                               label=bid, host_state=h)

                bwriter.submit(boundary_io)
            else:
                # ONE state fetch shared by the histograms, the best gate
                # and the checkpoint writer
                host, host_p = L.boundary_host_state(ctx)
                if crossed_hist:
                    L.log_param_histograms(ctx, batch_id, params=host_p)
                L.maybe_save_best(ctx, wmean, batch_id, after=0,
                                  host_params=host_p)
                L.save_periodic_checkpoint(ctx, {"batch_id": batch_id},
                                           label=batch_id, host_state=host)
            window_loss, window_count = 0.0, 0
            ctx.timer.start()  # leave checkpoint I/O out of the next window
    finally:
        staged.close()

    drain()
    if bwriter is not None:
        bwriter.flush()  # settle the last boundary before the tail reads
    e2e_summary(batch_id)
    print(f"Last Checkpoint - Batch {total_num_batches}")
    host, host_p = L.boundary_host_state(ctx)  # one fetch, whole tail
    if cfg.dataset.generate_test:
        L.reconstruct_test_set(ctx, total_num_batches)
    if window_count:
        L.maybe_save_best(ctx, window_loss / window_count,
                          total_num_batches, after=0, host_params=host_p)
    L.save_periodic_checkpoint(ctx, {"batch_id": total_num_batches},
                               label=total_num_batches, host_state=host)
    L.save_last(ctx, host_params=host_p)
    return ctx

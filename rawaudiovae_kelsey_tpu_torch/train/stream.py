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

The host-fed path is ported: a background prefetcher decodes, frames and
copies batches to the device ahead of the step, the per-batch losses stay
on the device and drain in bursts.  The device-resident replay of the
stream (the JAX package's ``_run_resident``) is not ported yet: the gate
below sizes it and says so, and never changes engine silently.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

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
from rawaudiovae_kelsey_tpu_torch.train import loop as L
from rawaudiovae_kelsey_tpu_torch.train.epoch import check_supported
from rawaudiovae_kelsey_tpu_torch.train.interrupt import GracefulInterrupt

RESIDENT_NOT_PORTED = (
    "the device-resident stream replay is not ported to the PyTorch package "
    "yet (ROADMAP.md queue A: _run_resident of train/stream.py)")
# share of the card's free memory the resident corpus may take: the rest
# is the step's activations, the train state and the allocator's slack.
# A placeholder: nothing has measured it, because the engine it sizes is
# not ported and the plan only feeds the gate's printed line.  It is to be
# set from the resident stream's measured peak memory when that lands
# (ROADMAP.md queue A).
RESIDENT_FREE_SHARE = 0.5


def train(cfg: Config, verbose: bool = True,
          device: torch.device | str = "cuda") -> L.TrainContext:
    datapath = cfg.dataset.datapath_path
    if not datapath.exists():
        raise FileNotFoundError(datapath.resolve())
    check_supported(cfg)
    ctx = L.setup(cfg, device)
    try:
        with tee_stdout(ctx.workspace.console_log_path), \
                GracefulInterrupt() as stop:
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
                  device: torch.device) -> Optional[ResidentPlan]:
    """Size the device-resident stream in the layout it would take —
    ``samples`` (the hop-padded audio plus an int32 start per frame) when
    ``[tpu] resident_layout`` says so or is ``auto`` with overlapping
    windows, else the ``frames`` matrix — against the device's free memory
    (``torch.cuda.mem_get_info``; on the CPU, ``resident_budget_gb``).
    ``None`` when a wav header cannot be read."""
    est = _estimate_stream_frames(dataset, cfg)
    if est is None:
        return None
    frames, samples = est
    seg, hop = cfg.audio.segment_length, cfg.audio.hop_length
    dtype_bytes = 2 if cfg.tpu.precision == "bfloat16" else 4
    want = cfg.tpu.resident_layout
    if want == "samples" or (want == "auto" and hop < seg):
        layout, need = "samples", samples * dtype_bytes + 4 * frames
    else:
        layout, need = "frames", frames * seg * dtype_bytes
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        budget = int(free * RESIDENT_FREE_SHARE)
    else:
        budget = int(cfg.tpu.resident_budget_gb * (1 << 30))
    # the resident step takes one full-batch gradient: it cannot honour
    # microbatch accumulation
    micro = cfg.tpu.microbatch_size
    micro_ok = not (micro and cfg.training.batch_size > micro)
    return ResidentPlan(layout, frames, need, budget,
                        micro_ok and frames > 0 and need <= budget)


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
    dataset = StreamingFrameDataset(
        audio_dir,
        cfg.audio.sampling_rate,
        cfg.audio.hop_length,
        cfg.audio.segment_length,   # quirk #2 fix: honors config
        shuffle=True,
        mono=cfg.dataset.mono,
        seed=cfg.tpu.seed,
    )
    cfg.dataset.total_frames = str(cfg.training.total_num_frames)
    ctx.workspace.snapshot_config(cfg)
    device = ctx.model.device

    # the resident gate: size the layout the resident stream would take
    # against the device's free memory, then say which engine runs
    if cfg.tpu.device_resident != "never":
        plan = resident_plan(dataset, cfg, device)
        verdict = ("wav headers unreadable" if plan is None else
                   f"{plan.frames:,} frames, {plan.layout} layout, "
                   f"{plan.need_bytes / 1e6:,.0f} MB of a "
                   f"{plan.budget_bytes / 1e6:,.0f} MB budget: "
                   f"{'fits' if plan.fits else 'does not fit'}")
        if cfg.tpu.device_resident == "always":
            raise NotImplementedError(
                f"device_resident=always: {RESIDENT_NOT_PORTED} "
                f"({verdict}); use device_resident=auto or never to train "
                "host-fed")
        print(f"device_resident=auto: {RESIDENT_NOT_PORTED} ({verdict}); "
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

    # islice(start, stop): regenerating and SKIPPING the first start_batch
    # batches keeps the stream order aligned on resume (taking the first
    # `remaining` would retrain already-seen data and drop the tail)
    feed = prefetch_to_device(
        itertools.islice(dataset.batches(batch_size), start_batch,
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

    try:
        for offset, batch in enumerate(feed):
            batch_id = start_batch + offset
            ctx.state, metrics = ctx.train_step(ctx.state, batch)
            pending.append((batch_id, metrics["loss"]))

            if stop:
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

"""Epoch trainer — the ``python train.py --config default.ini`` flow
(train.py:113-307), the JAX package's ``train/epoch.py`` host-fed loop
(``_run``) ported to one device.

Differences from the reference (each intentional, as in the JAX package):
  * the per-batch losses stay on the device during the epoch; the
    ``Loss/Batch`` and ``Learning Rate`` scalars are written from them at
    epoch end (same tags and steps, train.py:189,196; no sync per batch);
  * the best-model gate tracks the true best loss (quirk #7 fix);
  * checkpoint/resume actually restores (SURVEY.md §5.3).

What this slice does not carry raises, naming ROADMAP.md: the device-
resident epoch engine (``device_resident = always``; under ``auto`` the
port takes this host-fed loop, where the JAX package would take the
resident engine when no microbatch is set — ROADMAP.md queue C),
multihost, data or model parallelism over more than one device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
from rawaudiovae_kelsey_tpu_torch.data.loader import (
    feed_dtype,
    prefetch_to_device,
)
from rawaudiovae_kelsey_tpu_torch.data.validate import check_before_training
from rawaudiovae_kelsey_tpu_torch.observe.timing import trace_capture
from rawaudiovae_kelsey_tpu_torch.train import loop as L
from rawaudiovae_kelsey_tpu_torch.train.interrupt import GracefulInterrupt


def check_supported(cfg: Config) -> None:
    """Raise for every setting of the JAX trainer this port lacks."""
    t = cfg.tpu
    unported = {
        "device_resident = always (the device-resident epoch engine, "
        "parallel/resident.py)": t.device_resident == "always",
        "multihost": t.multihost,
        f"data_parallel = {t.data_parallel}": t.data_parallel > 1,
        f"model_parallel = {t.model_parallel}": t.model_parallel > 1,
        "checkpoint_format = orbax": t.checkpoint_format == "orbax",
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"[tpu] {what} is not ported to the PyTorch package yet "
                "(ROADMAP.md queue A); the JAX package rawaudiovae_kelsey_tpu "
                "runs it")


def train(cfg: Config, verbose: bool = True,
          device: torch.device | str = "cuda") -> L.TrainContext:
    # dataset path validation (train.py:52-63)
    datapath = cfg.dataset.datapath_path
    if not datapath.exists():
        raise FileNotFoundError(datapath.resolve())
    check_supported(cfg)
    ctx = L.setup(cfg, device)
    try:
        with GracefulInterrupt() as stop:
            return _run(ctx, cfg, verbose, stop)
    finally:
        L.finish(ctx)


def _run(ctx: L.TrainContext, cfg: Config, verbose: bool,
         stop=None) -> L.TrainContext:
    # eager ingest (train.py:113-130)
    if verbose:
        print("creating the dataset...")
    check_before_training(
        datapath_audio_dir(cfg), cfg.audio.sampling_rate,
        cfg.dataset.check_dataset, cfg.dataset.check_audio,
    )
    corpus, n_samples = build_corpus(
        datapath_audio_dir(cfg), cfg.audio.sampling_rate,
        mono=cfg.dataset.mono, verbose=verbose,
    )
    total_frames = n_samples // cfg.audio.segment_length
    print(f"Total number of audio frames: {total_frames}")
    cfg.dataset.total_frames = str(total_frames)
    ctx.workspace.snapshot_config(cfg)

    dataset = AudioFrameDataset(
        corpus, cfg.audio.segment_length, cfg.audio.hop_length,
        cfg.audio.sampling_rate,
    )
    batch_size = cfg.training.batch_size
    n_batches = dataset.num_batches(batch_size)
    device = ctx.model.device

    epochs = cfg.training.epochs
    interval = cfg.training.checkpoint_interval
    lr = cfg.training.learning_rate
    train_loss = float("inf")

    # resume: ctx.start_step counts optimizer updates; whole epochs only.
    # Round UP: a mid-epoch interrupt checkpoint resumes at the NEXT epoch
    # (see DIVERGENCES.md)
    start_epoch = min(-(-ctx.start_step // max(n_batches, 1)), epochs)
    if start_epoch:
        print(f"Resuming at epoch {start_epoch}")

    # optional profiler window over steps [start, start + steps)
    profile_window = None
    if cfg.tpu.profile_steps > 0:
        profile_window = (cfg.tpu.profile_start,
                          cfg.tpu.profile_start + cfg.tpu.profile_steps)
    profiler = None
    global_step = start_epoch * n_batches

    for epoch in range(start_epoch, epochs):
        if verbose:
            print(f"Epoch {epoch}/{epochs - 1}")
            print("-" * 10)
        feed = prefetch_to_device(
            dataset.batches(batch_size, shuffle=True,
                            seed=cfg.tpu.seed + epoch),
            device, depth=cfg.tpu.prefetch, cast_dtype=feed_dtype(cfg))
        batch_losses = []
        ctx.timer.start()
        try:
            for batch in feed:
                if profile_window is not None:
                    if global_step == profile_window[0] and profiler is None:
                        profiler = trace_capture(
                            ctx.workspace.log_dir / "profile").__enter__()
                    elif global_step == profile_window[1] and profiler:
                        profiler.__exit__(None, None, None)
                        profiler, profile_window = None, None
                ctx.state, metrics = ctx.train_step(ctx.state, batch)
                batch_losses.append(metrics["loss"])  # no sync
                global_step += 1
                if stop:
                    break
        finally:
            feed.close()
        epoch_s = ctx.timer.stop()
        if stop:
            print(f"Interrupted in epoch {epoch}; checkpointing.")
            L.save_periodic_checkpoint(ctx, {"epoch": epoch}, label=epoch)
            return ctx

        losses = (torch.stack(batch_losses).double().cpu().tolist()
                  if batch_losses else [])
        train_loss = float(np.sum(losses))
        for i, loss in enumerate(losses):
            gstep = epoch * n_batches + i
            ctx.writer.add_scalar("Loss/Batch", loss, gstep)
            ctx.writer.add_scalar("Learning Rate", lr, gstep)

        avg = train_loss / max(len(dataset), 1)
        print(
            f"====> Epoch: {epoch} - Total loss: {train_loss} - "
            f"Average loss: {avg:.9f} "
            f"({len(dataset) / max(epoch_s, 1e-9):,.0f} frames/s)"
        )
        ctx.writer.add_scalar("Loss/train_total", train_loss, epoch)
        ctx.writer.add_scalar("Loss/train_average", avg, epoch)
        if epoch % max(1, cfg.tpu.histogram_interval or 1) == 0:
            L.log_param_histograms(ctx, epoch)

        if interval and epoch % interval == 0 and epoch != 0:
            print(f"Checkpoint - Epoch {epoch}")
            if cfg.dataset.generate_test:
                L.reconstruct_test_set(ctx, epoch)
            # best gate FIRST so the checkpoint meta records this
            # boundary's gate
            L.maybe_save_best(ctx, train_loss, epoch,
                              cfg.training.save_best_model_after)
            L.save_periodic_checkpoint(ctx, {"epoch": epoch}, label=epoch)

    if profiler is not None:
        profiler.__exit__(None, None, None)
    # post-loop finalization (train.py:254-307)
    final_epoch = max(epochs - 1, 0)
    print(f"Last Checkpoint - Epoch {final_epoch}")
    if cfg.dataset.generate_test:
        L.reconstruct_test_set(ctx, epochs)
    if np.isfinite(train_loss):
        L.maybe_save_best(ctx, train_loss, epochs,
                          cfg.training.save_best_model_after)
    L.save_periodic_checkpoint(ctx, {"epoch": epochs}, label=epochs)
    L.save_last(ctx)
    return ctx


def datapath_audio_dir(cfg: Config) -> Path:
    return cfg.dataset.datapath_path / "audio"

"""Epoch trainer — the ``python train.py --config default.ini`` flow
(train.py:113-307), the JAX package's ``train/epoch.py`` ported to one
device: the host-fed loop (``_run``) and the device-resident engine
(``_run_resident`` over ``parallel/resident.py``), chosen by ``[tpu]
device_resident`` under the JAX package's rule — ``auto`` takes the
resident engine when the corpus fits ``resident_budget_gb`` and no
microbatch accumulation is asked for, ``always`` raises when it cannot.

Differences from the reference (each intentional, as in the JAX package):
  * the per-batch losses stay on the device during the epoch; the
    ``Loss/Batch`` and ``Learning Rate`` scalars are written from them at
    epoch end (same tags and steps, train.py:189,196; no sync per batch);
  * the best-model gate tracks the true best loss (quirk #7 fix);
  * checkpoint/resume actually restores (SURVEY.md §5.3).

Under several ranks (``parallel/mesh.py``; the ``train`` command starts
them on one host) every rank reads its own file shard and:
  * host-fed: feeds ``batch_size / world`` of its rows a step to the mesh
    step, ``batch_size % world`` checked up front, and every rank runs the
    smallest full-batch count of the ranks (all-gathered; a rank's last
    short batch is dropped, as JAX's multihost branch drops it);
  * resident (``frames`` layout only, ``batch_size % world == 0``): its
    frames wrap-padded to the largest rank's and uploaded to its own card
    (``parallel/resident.py`` sharded engine), the budget per card.
Every decision that selects a collective program is taken from
all-gathered sizes, so the ranks never diverge; a stop flag acts only by
agreement (:func:`_sync_stop`).  What the port does not carry raises,
naming ROADMAP.md: model parallelism and orbax checkpoints.
"""

from __future__ import annotations

import itertools
import os
import time
from pathlib import Path

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
from rawaudiovae_kelsey_tpu_torch.data.framing import overlapping_frames
from rawaudiovae_kelsey_tpu_torch.data.loader import (
    feed_dtype,
    prefetch_to_device,
)
from rawaudiovae_kelsey_tpu_torch.data.validate import check_before_training
from rawaudiovae_kelsey_tpu_torch.models.registry import resident_model
from rawaudiovae_kelsey_tpu_torch.observe.timing import trace_capture
from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    MODEL_PARALLEL_NOT_PORTED,
    all_gather_ints,
    any_rank,
    host_shard_info,
    world_size,
)
from rawaudiovae_kelsey_tpu_torch.train.checkpoint import ORBAX_NOT_PORTED
from rawaudiovae_kelsey_tpu_torch.train import loop as L
from rawaudiovae_kelsey_tpu_torch.train.interrupt import GracefulInterrupt
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves


def check_supported(cfg: Config,
                    device: torch.device | str = "cuda") -> None:
    """Raise for the settings of the JAX trainer this port lacks: model
    parallelism and orbax checkpoints (ROADMAP.md A.7b).  And say so when
    the trainer is called as a library on one of several visible cards
    outside a group of ranks: ``data_parallel = 0`` is "every device" in
    the JAX package; here the ``train`` and ``stream`` commands start one
    rank a card (``train/cli.py``), a library call trains where it is."""
    if cfg.tpu.model_parallel > 1:
        raise NotImplementedError(MODEL_PARALLEL_NOT_PORTED)
    if cfg.tpu.checkpoint_format == "orbax":
        raise NotImplementedError(f"[tpu] {ORBAX_NOT_PORTED}")
    device = torch.device(device)
    if (cfg.tpu.data_parallel == 0 and device.type == "cuda"
            and torch.cuda.device_count() > 1 and world_size() == 1
            and "RANK" not in os.environ and not cfg.tpu.multihost
            and not cfg.tpu.coordinator_address):
        print(f"[tpu] data_parallel = 0: {torch.cuda.device_count()} CUDA "
              f"devices are visible and one is used ({device}): this "
              "process is not a rank of a group; the train and stream "
              "commands start one rank a card (torchrun across hosts)")


def train(cfg: Config, verbose: bool = True,
          device: torch.device | str = "cuda") -> L.TrainContext:
    # dataset path validation (train.py:52-63)
    datapath = cfg.dataset.datapath_path
    if not datapath.exists():
        raise FileNotFoundError(datapath.resolve())
    check_supported(cfg, device)
    ctx = L.setup(cfg, device)
    try:
        with GracefulInterrupt() as stop:
            return _run(ctx, cfg, verbose, stop)
    finally:
        L.finish(ctx)


def _sync_stop(stop, multihost: bool) -> bool:
    """Act on an interrupt only by agreement of the ranks.  Signals are
    per-process: one rank taking its stop branch (drain, checkpoint,
    return) while the others issue the next collective would hang them all
    — and only rank 0 writes the interrupt checkpoint, which may not be the
    signalled rank.  All-reduce the flag at every decision point (every
    rank reaches these points in the same order); any rank's signal stops
    the run."""
    return any_rank(bool(stop)) if multihost else bool(stop)


def _run(ctx: L.TrainContext, cfg: Config, verbose: bool,
         stop=None) -> L.TrainContext:
    # eager ingest (train.py:113-130)
    if verbose:
        print("creating the dataset...")
    check_before_training(
        datapath_audio_dir(cfg), cfg.audio.sampling_rate,
        cfg.dataset.check_dataset, cfg.dataset.check_audio,
    )
    host_id, num_hosts = host_shard_info()
    corpus, n_samples = build_corpus(
        datapath_audio_dir(cfg), cfg.audio.sampling_rate,
        mono=cfg.dataset.mono, verbose=verbose,
        host_id=host_id, num_hosts=num_hosts,
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
    mesh = ctx.mesh

    # device-resident fast path: whole epochs on the device when the corpus
    # fits the budget.  Under a mesh the decisions must be IDENTICAL on
    # every rank, or the ranks diverge into different collective
    # programs: they come from all-gathered sizes (the largest corpus for
    # the budget, the smallest frame count for the batch gate; the average
    # loss divides by the global frame count)
    dtype_bytes = 2 if cfg.tpu.precision == "bfloat16" else 4
    budget = int(cfg.tpu.resident_budget_gb * (1 << 30))
    if mesh is not None:
        counts = all_gather_ints([n_samples, len(dataset)])
        n_samples_eff = int(counts[:, 0].max())
        min_frames = int(counts[:, 1].min())
        dataset_len = int(counts[:, 1].sum())
    else:
        n_samples_eff, min_frames = n_samples, len(dataset)
        dataset_len = len(dataset)
    # the budget is a card's: under a mesh each rank's block of the
    # (wrap-padded) frame matrix is at most the largest rank's corpus
    layout = R.choose_layout(n_samples_eff, cfg.audio.segment_length,
                             cfg.audio.hop_length, dtype_bytes, budget)
    mesh_ok = mesh is None or (layout == "frames"
                               and batch_size % mesh.data == 0)
    # the resident step takes one full-batch gradient: it cannot honour
    # microbatch accumulation, so configs that ask for it (giant batches)
    # keep the host-fed step that does
    micro = cfg.tpu.microbatch_size
    micro_ok = not (micro and batch_size > micro)
    use_resident = (cfg.tpu.device_resident != "never"
                    and layout is not None and mesh_ok and micro_ok)
    if use_resident and min_frames >= batch_size:
        return _run_resident(ctx, cfg, verbose, stop, corpus, n_samples,
                             dataset_len, layout)
    if cfg.tpu.device_resident == "always":
        raise ValueError(
            "device_resident=always but the corpus does not fit "
            f"resident_budget_gb={cfg.tpu.resident_budget_gb} (layout="
            f"{layout!r}), has fewer frames than one batch, the mesh/batch "
            "layout is incompatible, or microbatch_size is set (the "
            "resident step can't accumulate microbatches); adjust the "
            "config or use device_resident=auto")

    if mesh is not None:
        # every rank feeds batch_size / world of its own rows a step; an
        # indivisible batch_size would leave the ranks unequal blocks.
        # The ranks' corpora differ: every rank runs the SMALLEST
        # full-batch count, so every one enters each collective
        if batch_size % mesh.data:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the "
                f"{mesh.data} ranks for host-fed mesh training")
        rank_batch = batch_size // mesh.data
        local = dataset.num_batches(rank_batch, drop_last=True)
        n_batches = int(all_gather_ints([local]).min())
        if n_batches == 0:
            raise ValueError(
                "a rank has fewer frames than one batch of "
                f"{rank_batch} (batch_size {batch_size} over {mesh.data} "
                "ranks)")
    else:
        rank_batch = batch_size
        n_batches = dataset.num_batches(batch_size)
    multihost = mesh is not None
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
        # each rank prefetches only its own rows onto its own device
        feed = prefetch_to_device(
            itertools.islice(
                dataset.batches(rank_batch, shuffle=True,
                                seed=cfg.tpu.seed + epoch,
                                drop_last=multihost), n_batches),
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
                # a mid-epoch break is one rank's only: under a mesh the
                # others would keep issuing collectives (_sync_stop), so
                # there the interrupt lands at the epoch's end
                if stop and not multihost:
                    break
        finally:
            feed.close()
        epoch_s = ctx.timer.stop()
        if _sync_stop(stop, multihost):
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

        avg = train_loss / max(dataset_len, 1)
        frames = len(dataset) if mesh is None else n_batches * batch_size
        print(
            f"====> Epoch: {epoch} - Total loss: {train_loss} - "
            f"Average loss: {avg:.9f} "
            f"({frames / max(epoch_s, 1e-9):,.0f} frames/s)"
        )
        ctx.writer.add_scalar("Loss/train_total", train_loss, epoch)
        ctx.writer.add_scalar("Loss/train_average", avg, epoch)
        if epoch % max(1, cfg.tpu.histogram_interval or 1) == 0:
            L.log_param_histograms(ctx, epoch)

        if interval and epoch % interval == 0 and epoch != 0:
            print(f"Checkpoint - Epoch {epoch}")
            if cfg.dataset.generate_test:
                L.reconstruct_test_set(ctx, epoch)
            # ONE state fetch shared by the best gate and the checkpoint
            # writer; best gate FIRST so the checkpoint meta records this
            # boundary's gate
            host, host_p = L.boundary_host_state(ctx)
            L.maybe_save_best(ctx, train_loss, epoch,
                              cfg.training.save_best_model_after,
                              host_params=host_p)
            L.save_periodic_checkpoint(ctx, {"epoch": epoch}, label=epoch,
                                       host_state=host)

    if profiler is not None:
        profiler.__exit__(None, None, None)
    # post-loop finalization (train.py:254-307); one state fetch for the tail
    final_epoch = max(epochs - 1, 0)
    print(f"Last Checkpoint - Epoch {final_epoch}")
    host, host_p = L.boundary_host_state(ctx)
    if cfg.dataset.generate_test:
        L.reconstruct_test_set(ctx, epochs)
    if np.isfinite(train_loss):
        L.maybe_save_best(ctx, train_loss, epochs,
                          cfg.training.save_best_model_after,
                          host_params=host_p)
    L.save_periodic_checkpoint(ctx, {"epoch": epochs}, label=epochs,
                               host_state=host)
    L.save_last(ctx, host_params=host_p)
    return ctx


def _run_resident(ctx: L.TrainContext, cfg: Config, verbose: bool, stop,
                  corpus: np.ndarray, n_samples: int, dataset_len: int,
                  layout: str = "frames") -> L.TrainContext:
    """Device-resident epoch loop: the corpus is uploaded once, epochs run
    on the device in groups (``parallel/resident.py``), the per-batch
    losses drain in bursts at checkpoint / histogram / interrupt
    boundaries; checkpoints, TB and reconstructions between groups.

    The launches are asynchronous, but this thread issues every one of
    them, so a group "dispatched ahead" of a boundary overlaps only the
    boundary work that runs on the worker thread (the state fetch and the
    histogram / best / checkpoint writes), not this thread's own.

    Under a mesh the frame matrix is sharded over the ranks
    (``parallel/resident.py`` ``build_resident_epoch_sharded``): each rank
    frames its own file shard, wrap-pads it to the largest rank's count
    and uploads it to its own card; the losses are the reduced global
    ones, equal on every rank.  The boundary worker holds no collective
    (rank 0 alone writes; the reconstruction's all-gather runs on this
    thread), so it stays on under a mesh."""
    device = ctx.model.device
    on_cuda = device.type == "cuda"
    model = resident_model(cfg, ctx.model)
    mesh = ctx.mesh
    multihost = mesh is not None
    if mesh is not None:
        frames = R.align_local_rows(overlapping_frames(
            corpus, cfg.audio.segment_length, cfg.audio.hop_length), mesh)
        n_frames_padded = len(frames) * mesh.data
        dev_corpus = R.put_frames_sharded(frames, cfg, mesh)
        del frames
        run_epochs, n_batches = R.build_resident_epoch_sharded(
            model, cfg, None, n_frames_padded, mesh)
        mb = dev_corpus.numel() * dev_corpus.element_size() / 1e6
        print(f"Device-resident corpus (sharded over {mesh.data} devices): "
              f"{n_frames_padded:,} frames ({mb * mesh.data:,.0f} MB total, "
              f"{mb:,.0f} MB a card), {n_batches} batches/epoch with no "
              "host feed")
    else:
        run_epochs, n_batches = R.build_resident_epoch(
            model, cfg, None, n_samples, layout=layout)
        dev_corpus = R.put_resident(corpus, cfg, layout, device)
        mb = dev_corpus.numel() * dev_corpus.element_size() / 1e6
        print(f"Device-resident corpus ({layout} layout): {n_samples:,} "
              f"samples ({mb:,.0f} MB on device), "
              f"{n_batches} batches/epoch with no host feed")

    batch_size = cfg.training.batch_size
    epochs = cfg.training.epochs
    interval = cfg.training.checkpoint_interval
    lr = cfg.training.learning_rate
    hist_every = cfg.tpu.histogram_interval
    train_loss = float("inf")
    # resume rounds UP to whole epochs, with the resident n_batches
    start_epoch = min(-(-ctx.start_step // max(n_batches, 1)), epochs)
    if start_epoch:
        print(f"Resuming at epoch {start_epoch}")

    # groups of epochs per dispatch, capped at the checkpoint / histogram
    # cadence (groups break there anyway)
    group_k = min(64, max(1, epochs))
    if interval:
        group_k = min(group_k, interval + 1)
    if hist_every:
        group_k = min(group_k, hist_every + 1)

    # profiler window: trace the whole epoch containing profile_start (the
    # per-step window of the host-fed loop has no analog here)
    profile_epoch = (cfg.tpu.profile_start // max(n_batches, 1)
                     if cfg.tpu.profile_steps > 0 else -1)

    # Anything per-epoch on the host (a loss fetch, a histogram pull) stalls
    # the device between epochs.  Epochs therefore run in GROUPS that end at
    # checkpoint / histogram / profile boundaries (cap 64), and the
    # (k, n_batches) loss matrices drain in bursts — console lines and TB
    # scalars are identical, printed in epoch order, with the frames/s
    # figure averaged over the drained window.  histogram_interval = 0 logs
    # histograms at the checkpoint cadence here.
    # (first epoch, (k, n_batches) device losses, dispatch time, done event)
    pending = []

    def dispatch(e0: int, k: int):
        # timed from BEFORE the launches are issued: this thread issues
        # every one of them and runs only as far ahead as the device's
        # queue lets it, so issuing a group takes most of its run time
        t0 = time.perf_counter()
        ctx.state, dev_losses = run_epochs(ctx.state, dev_corpus, e0, k=k)
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
        return (e0, dev_losses, t0, done)

    def drain():
        nonlocal train_loss
        if not pending:
            return
        # fetch FIRST: the copy blocks until the queued epochs finish, so
        # the timed window includes the device's work
        t_first = pending[0][2]
        fetched = [(ep0, dl.double().cpu().numpy())
                   for ep0, dl, _, _ in pending]
        pending.clear()
        window_s = ctx.timer.stop()
        # a group dispatched ahead of a checkpoint boundary computes through
        # the (untimed) boundary I/O — time it from its DISPATCH
        window_s = max(window_s, time.perf_counter() - t_first)
        n_done = sum(arr.shape[0] for _, arr in fetched)
        rate = n_done * n_batches * batch_size / max(window_s, 1e-9)
        for ep0, arr in fetched:
            for j, row in enumerate(arr):
                ep = ep0 + j
                if verbose:
                    print(f"Epoch {ep}/{epochs - 1}")
                    print("-" * 10)
                train_loss = float(row.sum())
                for i, loss in enumerate(row):
                    gstep = ep * n_batches + i
                    ctx.writer.add_scalar("Loss/Batch", float(loss), gstep)
                    ctx.writer.add_scalar("Learning Rate", lr, gstep)
                avg = train_loss / max(dataset_len, 1)
                print(
                    f"====> Epoch: {ep} - Total loss: {train_loss} - "
                    f"Average loss: {avg:.9f} ({rate:,.0f} frames/s)"
                )
                ctx.writer.add_scalar("Loss/train_total", train_loss, ep)
                ctx.writer.add_scalar("Loss/train_average", avg, ep)
        # one machine-readable line per drain
        print(f"[drain] {n_done} epochs in {window_s:.3f}s = "
              f"{rate:,.0f} frames/s")
        ctx.timer.start()

    # Checkpoint-boundary pipelining: snapshot the boundary state ON THE
    # DEVICE (a real clone: the step updates the live state in place), put
    # the NEXT group in flight, and run the boundary's host I/O from the
    # snapshot on the worker while the device trains ahead.  Disabled when a
    # profiler window is configured (its trace must cover one dispatch).
    bwriter = L.AsyncBoundaryWriter() if cfg.tpu.async_checkpoint else None
    ctx.boundary_writer = bwriter  # finish() joins on exception paths

    def group_end(e0: int) -> int:
        """Last epoch (inclusive) of the group starting at e0: it runs
        through the first epoch whose post-epoch action fires (a checkpoint
        or histogram boundary), stops just short of the profile epoch, and
        is capped at the group size."""
        cap = min(epochs - 1, e0 + group_k - 1)
        last = e0
        while last < cap:
            if (interval and last % interval == 0 and last != 0) \
                    or (hist_every and last % hist_every == 0) \
                    or last == profile_epoch or last + 1 == profile_epoch:
                break
            last += 1
        return last

    total_t0 = time.perf_counter()
    io_s = 0.0  # loop-thread wall spent in boundary actions
    # boundary state fetches: [bytes, seconds] of device→host copies (the
    # worker mutates it; the end-of-run reads happen after flush())
    link_acc = [0.0, 0.0]

    def _meter_fetch(host, t0: float) -> None:
        link_acc[0] += sum(
            t.numel() * t.element_size()
            for t in tree_leaves((host.params, host.mu, host.nu)))
        link_acc[1] += time.perf_counter() - t0

    # steady-state marker: set when the FIRST group has finished (it
    # carries the kernels' build and the allocator's warm-up)
    steady_t0 = None
    steady_done = 0
    ctx.timer.start()
    epoch = start_epoch
    predispatched = None  # last epoch of a group already in flight
    while epoch < epochs:
        if predispatched is not None:
            last, predispatched = predispatched, None
        else:
            last = group_end(epoch)
            k = last - epoch + 1
            profiling = profile_epoch == epoch and k == 1
            tracer = None
            if profiling:
                drain()  # bound the trace to this epoch's dispatch
                tracer = trace_capture(
                    ctx.workspace.log_dir / "profile").__enter__()
            pending.append(dispatch(epoch, k))
            if steady_t0 is None:
                if on_cuda:
                    pending[-1][3].synchronize()
                steady_t0 = time.perf_counter()
                steady_done = last + 1 - start_epoch
            if profiling:
                drain()
                tracer.__exit__(None, None, None)
            elif len(pending) >= 4 and pending[0][3] is not None:
                # backpressure: wait for the OLDEST group (without draining)
                # so queued work and interrupt latency stay bounded
                pending[0][3].synchronize()
        epoch = last  # the boundary checks below refer to the LAST epoch run

        hist_fires = bool(hist_every and epoch % hist_every == 0)
        ckpt_fires = bool(interval and epoch % interval == 0 and epoch != 0)
        # one synced read a group: every rank evaluates it at the same point
        stop_now = _sync_stop(stop, multihost)
        if not (hist_fires or ckpt_fires or stop_now):
            epoch += 1
            continue

        # dispatch-ahead before blocking on the drain
        snap = snap_ready = next_group = None
        recon_done = False
        if ((hist_fires or ckpt_fires) and not stop_now
                and profile_epoch < 0 and epoch + 1 < epochs):
            snap = ctx.state.clone()
            if on_cuda:
                snap_ready = torch.cuda.Event()
                snap_ready.record()
            if ckpt_fires and cfg.dataset.generate_test:
                # the reconstruction must be queued BEFORE the next group,
                # or the checkpoint artifact trails by that much
                live_state, ctx.state = ctx.state, snap
                try:
                    L.reconstruct_test_set(ctx, epoch)
                finally:
                    ctx.state = live_state
                recon_done = True
            nlast = group_end(epoch + 1)
            next_group = (*dispatch(epoch + 1, nlast - epoch), nlast)

        drain()  # only groups ≤ the boundary: next_group isn't pending yet
        io_t0 = time.perf_counter()
        live = None
        if snap is not None:
            live, ctx.state = ctx.state, snap  # actions see boundary state
        # with a device snapshot in hand the boundary I/O leaves this thread
        use_async = bwriter is not None and snap is not None
        if bwriter is not None and not use_async:
            # synchronous fallback (last-epoch boundary, profiling): settle
            # the PREVIOUS boundary's worker first, or the two race on the
            # same artifacts and the best gate runs out of order
            bwriter.flush()
        host = host_p = None
        if (hist_fires or ckpt_fires) and not use_async:
            ft0 = time.perf_counter()
            host, host_p = L.boundary_host_state(ctx)
            _meter_fetch(host, ft0)
        try:
            if hist_fires and not use_async:
                L.log_param_histograms(ctx, epoch, params=host_p)
            # re-check: a signal may have landed after the dispatch-ahead
            # (every rank takes the same branch, so the collective matches)
            if stop_now or _sync_stop(stop, multihost):
                if bwriter is not None:
                    # settle any in-flight boundary first: the best gate and
                    # artifact trail must be in order before the interrupt
                    # checkpoint
                    bwriter.flush()
                if hist_fires and use_async:  # not logged above
                    host = L.fetch_host_state(ctx.state, snap_ready)
                    L.log_param_histograms(ctx, epoch, params=host.params)
                ckpt_state = host  # valid unless the state runs ahead below
                if next_group is not None:
                    # the next group is already queued: fold it in — drain
                    # its losses and checkpoint the post-group state — so
                    # the returned context, the checkpoint label and the TB
                    # trail all agree
                    pending.append(next_group[:4])
                    epoch = next_group[4]
                    next_group = None
                    if live is not None:
                        ctx.state, live = live, None
                    drain()
                    ckpt_state = None  # the snapshot is stale
                print(f"Interrupted after epoch {epoch}; checkpointing.")
                L.save_periodic_checkpoint(ctx, {"epoch": epoch},
                                           label=epoch,
                                           host_state=ckpt_state)
                return ctx
            if use_async:
                if ckpt_fires:
                    print(f"Checkpoint - Epoch {epoch}")
                    if cfg.dataset.generate_test and not recon_done:
                        L.reconstruct_test_set(ctx, epoch)

                # the worker owns the snapshot from here; the closure never
                # touches ctx.state (best_loss / cfg / writer mutations are
                # worker-sequential, and the loop reads them only after a
                # flush — interrupt or end of run)
                def boundary_io(bs=ctx.state, ready=snap_ready, ep=epoch,
                                tl=train_loss, hist=hist_fires,
                                ck=ckpt_fires):
                    ft0 = time.perf_counter()
                    h = L.fetch_host_state(bs, ready)
                    _meter_fetch(h, ft0)
                    if hist or (ck and not hist_every):
                        L.log_param_histograms(ctx, ep, params=h.params)
                    if ck:
                        # best gate first: the checkpoint meta must record
                        # this boundary's gate
                        L.maybe_save_best(ctx, tl, ep,
                                          cfg.training.save_best_model_after,
                                          host_params=h.params)
                        L.save_periodic_checkpoint(ctx, {"epoch": ep},
                                                   label=ep, host_state=h)

                bwriter.submit(boundary_io)
            elif ckpt_fires:
                print(f"Checkpoint - Epoch {epoch}")
                if not hist_every:
                    L.log_param_histograms(ctx, epoch, params=host_p)
                if cfg.dataset.generate_test and not recon_done:
                    L.reconstruct_test_set(ctx, epoch)
                L.maybe_save_best(ctx, train_loss, epoch,
                                  cfg.training.save_best_model_after,
                                  host_params=host_p)
                L.save_periodic_checkpoint(ctx, {"epoch": epoch},
                                           label=epoch, host_state=host)
        finally:
            if live is not None:
                ctx.state = live
        if next_group is not None:
            pending.append(next_group[:4])
            predispatched = next_group[4]
        io_s += time.perf_counter() - io_t0
        ctx.timer.start()  # exclude boundary I/O from the next window
        epoch += 1

    drain()
    if bwriter is not None:
        bwriter.flush()  # settle the last boundary before the tail reads
    wall = time.perf_counter() - total_t0
    done = epochs - start_epoch
    if done > 0:
        # every trained frame over the full wall clock, with the loop's
        # boundary share broken out
        print(f"====> Resident epochs e2e: {done} epochs in {wall:.2f}s = "
              f"{done * n_batches * batch_size / max(wall, 1e-9):,.0f} "
              f"frames/s wall-clock incl. checkpoints "
              f"({io_s:.2f}s of that is boundary host I/O)")
        if link_acc[1] > 0:
            mb = link_acc[0] / 1e6
            print(f"[boundary-link] {mb:.1f} MB of state drained in "
                  f"{link_acc[1]:.2f}s = {mb / link_acc[1]:.1f} MB/s")
        if steady_t0 is not None and done > steady_done:
            sd = done - steady_done
            sw = max(time.perf_counter() - steady_t0, 1e-9)
            print(f"====> Resident steady e2e (excl. the first group: "
                  f"kernel build and warm-up): {sd} epochs in {sw:.2f}s = "
                  f"{sd * n_batches * batch_size / sw:,.0f} frames/s")
            if io_s > 0:
                ex = max(sw - io_s, 1e-9)
                print(f"====> Resident steady e2e ex-boundary-I/O: {sd} "
                      f"epochs in {ex:.2f}s = "
                      f"{sd * n_batches * batch_size / ex:,.0f} frames/s")

    final_epoch = max(epochs - 1, 0)
    print(f"Last Checkpoint - Epoch {final_epoch}")
    host, host_p = L.boundary_host_state(ctx)  # one fetch, whole tail
    if not hist_every and epochs > start_epoch and not (
            interval and final_epoch % interval == 0 and final_epoch != 0):
        # (guard: the checkpoint branch already logged this epoch)
        L.log_param_histograms(ctx, final_epoch, params=host_p)
    if cfg.dataset.generate_test:
        L.reconstruct_test_set(ctx, epochs)
    if np.isfinite(train_loss):
        L.maybe_save_best(ctx, train_loss, epochs,
                          cfg.training.save_best_model_after,
                          host_params=host_p)
    L.save_periodic_checkpoint(ctx, {"epoch": epochs}, label=epochs,
                               host_state=host)
    L.save_last(ctx, host_params=host_p)
    return ctx


def datapath_audio_dir(cfg: Config) -> Path:
    return cfg.dataset.datapath_path / "audio"

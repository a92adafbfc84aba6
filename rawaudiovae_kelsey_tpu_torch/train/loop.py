"""Machinery of the epoch and stream trainers — the JAX package's
``train/loop.py``, ported: workspace, writer, test fixture, model and state
construction, resume, periodic reconstruction, the best/last model
bookkeeping, and the boundary machinery of the device-resident engines
(one shared host copy of the state, the background boundary writer).

Under several ranks (``parallel/mesh.py``) :func:`setup` builds the mesh
and broadcasts rank 0's params, rank 0 creates ``run-NNN`` and broadcasts
its path (:func:`_make_workspace_coordinated`), every rank restores the
checkpoint rank 0 found, and only rank 0 writes: TensorBoard (the others
get a writer that drops everything), wavs, checkpoints, the best and last
models, the config snapshot (the console log: ``train/stream.py``).  The
data replicas are equal bit for bit, so rank 0's copy is the run's.
Under tensor parallelism (``model_parallel > 1``) :func:`setup` keeps each
rank's shards of rank 0's params (``parallel/sharding.py``), and every
path that needs whole leaves — the histograms, the best and last models,
an npz checkpoint, a boundary's host state — gathers them on every rank of
the model group first (:func:`full_state`, a collective; JAX's
``_host_params`` gathers the shards no process holds whole), then rank 0
writes.  The sharded format (``[tpu] checkpoint_format = orbax``,
``train/checkpoint.py``) takes the shards as they are.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.config.workspace import (
    Workspace,
    create_workspace,
    iter_runs,
    open_workspace,
)
from rawaudiovae_kelsey_tpu_torch.data.datasets import TestFrameDataset
from rawaudiovae_kelsey_tpu_torch.data.loader import pad_batches_for_mesh
from rawaudiovae_kelsey_tpu_torch.eval.fixtures import init_test_audio
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.models.registry import (
    ModelDef,
    build_model,
)
from rawaudiovae_kelsey_tpu_torch.observe import EventWriter, StepTimer
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    batch_sharding,
    broadcast_tensors,
    broadcast_text,
    is_coordinator,
    local_device,
    make_mesh,
    maybe_initialize_distributed,
    world_size,
)
from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
    gather_params,
    param_specs,
    shard_params,
)
from rawaudiovae_kelsey_tpu_torch.parallel.step import (
    build_eval_step,
    build_train_step,
    eval_generator,
)
from rawaudiovae_kelsey_tpu_torch.train import checkpoint as ckpt
from rawaudiovae_kelsey_tpu_torch.train.state import Params, TrainState
from rawaudiovae_kelsey_tpu_torch.tree import flatten, tree_map
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves


@dataclass
class TrainContext:
    cfg: Config
    workspace: Workspace
    model: ModelDef
    state: TrainState
    train_step: Callable
    eval_step: Callable
    writer: EventWriter
    timer: StepTimer
    mesh: Optional[Mesh] = None
    # the spec tree of the params under tensor parallelism (the state then
    # holds this rank's shards), else None
    specs: Optional[Any] = None
    test_dataset: Optional[TestFrameDataset] = None
    audio_log_dir: Optional[Path] = None
    best_loss: float = float("inf")
    start_step: int = 0
    start_meta: dict = field(default_factory=dict)
    boundary_writer: Optional["AsyncBoundaryWriter"] = None

    def close(self) -> None:
        self.writer.close()


class NullWriter:
    """The TensorBoard writer of a rank other than 0: takes every call,
    writes nothing."""
    path = None

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    add_histogram = add_audio = add_scalar

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def describe_device(device: torch.device) -> str:
    """Device banner (the reference crashed here on CPU-only hosts,
    train.py:89 — quirk #3)."""
    if device.type == "cuda":
        return (f"cuda:{torch.cuda.get_device_name(device)} "
                f"x{torch.cuda.device_count()}")
    return device.type


def summarize(params) -> str:
    """Per-leaf shapes under dotted tree names and the parameter count
    (the ``plot_model`` summary)."""
    named = flatten(params)
    lines = [f"  {name}: {tuple(t.shape)}" for name, t in named]
    total = sum(t.numel() for _, t in named)
    return "\n".join(["Model:", *lines, f"  total parameters: {total:,}"])


def setup(cfg: Config, device: torch.device | str,
          resume: Optional[bool] = None) -> TrainContext:
    """Everything up to (but excluding) the batch loop, mirroring the
    preamble of the reference script (train.py:88-163).  ``[tpu]
    multihost``, ``coordinator_address`` or torchrun's ``WORLD_SIZE``
    joins the process group first
    (``parallel/mesh.py`` ``maybe_initialize_distributed``); in a group of
    several ranks the trainer runs on a mesh of them, and asking for
    ``data_parallel > 1`` outside one raises (no rank trains alone where
    several were asked for)."""
    device = local_device(device)
    cfg.validate()
    cfg.stamp_start()
    # a process torchrun started is a rank whatever the config says: it
    # joins the group rather than train a copy of its own
    if (cfg.tpu.multihost or cfg.tpu.coordinator_address
            or "WORLD_SIZE" in os.environ):
        maybe_initialize_distributed(cfg.tpu.coordinator_address,
                                     device=device)
    mesh = None
    if world_size() > 1:
        mesh = make_mesh(cfg.tpu.data_parallel, cfg.tpu.model_parallel,
                         device)
    elif cfg.tpu.data_parallel > 1 or cfg.tpu.model_parallel > 1:
        key = ("data_parallel" if cfg.tpu.data_parallel > 1
               else "model_parallel")
        raise ValueError(
            f"[tpu] {key} = {getattr(cfg.tpu, key)} but this process "
            "is not part of a group of ranks: the train and stream commands "
            "start the ranks on one host; across hosts use torchrun with "
            "[tpu] multihost = true")
    device_name = describe_device(device)
    if mesh is not None:
        device_name += f" (rank {mesh.rank} of {mesh.size})"
    print(f"Device: {device_name}")
    cfg.vae.device_name = device_name

    ws = _make_workspace_coordinated(cfg)
    print(f"Workspace: {ws.workdir}")

    model = build_model(cfg, device)
    params = model.init(torch.Generator().manual_seed(cfg.tpu.seed))
    state = TrainState.create(params, seed=cfg.tpu.seed)
    if mesh is not None:
        # every replica starts from rank 0's params: equal gradients then
        # keep them equal bit for bit
        broadcast_tensors(tree_leaves(state.params))
    if cfg.extra.plot_model:
        print(summarize(params))     # the whole leaves' shapes
    specs = None
    if mesh is not None and mesh.model > 1:
        # each rank keeps its shards of rank 0's params; Adam's moments
        # are made from them, so they are sharded too
        specs = param_specs(model.name, state.params, mesh.model)
        state = TrainState.create(shard_params(state.params, mesh, specs),
                                  seed=cfg.tpu.seed)

    ctx = TrainContext(
        cfg=cfg, workspace=ws, model=model, state=state,
        train_step=build_train_step(model, cfg, mesh=mesh),
        eval_step=build_eval_step(model, cfg, mesh=mesh),
        writer=EventWriter(ws.log_dir) if is_coordinator() else NullWriter(),
        timer=StepTimer(device=device), mesh=mesh, specs=specs,
    )

    # resume (new capability; the reference never reloaded checkpoints);
    # every rank restores the file rank 0 found
    want_resume = cfg.training.resume if resume is None else resume
    if want_resume:
        latest = None
        if is_coordinator():
            found = _find_resume_checkpoint(cfg, exclude=ws.workdir)
            latest = "" if found is None else str(found)
        latest = broadcast_text(latest)
        if latest:
            ctx.state, meta = ckpt.restore_checkpoint(
                Path(latest), ctx.state, mesh, specs)
            ctx.start_step = ctx.state.step
            ctx.best_loss = float(meta.get("best_loss", float("inf")))
            ctx.start_meta = meta
            print(f"Resumed from {latest} at step {ctx.start_step}")

    # held-out reconstruction fixture (train.py:153-155)
    if cfg.dataset.generate_test:
        test_dir = cfg.dataset.datapath_path / cfg.dataset.test_dataset
        if not test_dir.exists():
            raise FileNotFoundError(test_dir.resolve())
        ctx.test_dataset, ctx.audio_log_dir = init_test_audio(
            ws.workdir, cfg.dataset.test_dataset, test_dir,
            cfg.audio.sampling_rate, cfg.audio.segment_length,
            mono=cfg.dataset.mono,
        )

    ws.snapshot_config(cfg)
    return ctx


def _make_workspace_coordinated(cfg: Config) -> Workspace:
    """One rank: plain ``create_workspace``.  Several: rank 0 creates
    ``run-NNN`` and broadcasts the path, the others open it (independent
    creation would race into N distinct run dirs).  The path travels in a
    length-prefixed buffer, so an over-long one fails on every rank."""
    if world_size() <= 1:
        return create_workspace(cfg)
    ws = failed = None
    if is_coordinator():
        try:
            ws = create_workspace(cfg)
        except OSError as err:
            failed = err     # raised after the broadcast, on every rank
    path = broadcast_text("" if ws is None else str(ws.workdir.resolve()))
    if failed is not None:
        raise failed
    if not path:
        raise RuntimeError("rank 0 could not create the run workspace")
    cfg.dataset.workspace = path
    if ws is not None:
        return ws
    # the dir may take a moment to appear on shared storage
    p = Path(path)
    for _ in range(100):
        if p.is_dir():
            break
        time.sleep(0.05)
    return open_workspace(p)


def _find_resume_checkpoint(cfg: Config,
                            exclude: Optional[Path] = None) -> Optional[Path]:
    """Newest checkpoint across prior runs of this description, skipping the
    just-created (empty) workspace."""
    my_runs = cfg.dataset.datapath_path / cfg.extra.description
    if not my_runs.is_dir():
        return None
    for run in reversed(iter_runs(my_runs)):
        if exclude is not None and run.resolve() == Path(exclude).resolve():
            continue
        found = ckpt.latest_checkpoint(Workspace(run).checkpoint_dir)
        if found is not None:
            return found
    return None


def reconstruct_test_set(ctx: TrainContext, step_label: int) -> np.ndarray:
    """Periodic eval reconstruction (train.py:214-237): run the full test set
    through the model, flatten to one waveform, write
    ``test_reconst_{step:05d}.wav`` and log it as TB audio.  Under a mesh
    every rank takes part (a collective): each batch is wrap-padded to the
    world size, each rank reconstructs its block, the blocks are
    all-gathered and the pad dropped; rank 0 writes."""
    assert ctx.test_dataset is not None and ctx.audio_log_dir is not None
    device = ctx.model.device
    mesh = ctx.mesh
    outs = []
    for i, batch in enumerate(
        ctx.test_dataset.batches(ctx.cfg.training.batch_size)
    ):
        rows = batch.shape[0]
        if mesh is not None:
            (batch,) = pad_batches_for_mesh([batch], mesh.data)
            batch = batch[batch_sharding(mesh, batch.shape[0])]
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        recon = ctx.eval_step(ctx.state.params,
                              eval_generator(device, ctx.state.seed, i),
                              x.to(device))
        if mesh is not None:
            recon = all_gather_rows(recon, mesh)[:rows]
        outs.append(recon.float().cpu().numpy())
    wave = np.concatenate(outs, axis=0).reshape(-1)
    if not is_coordinator():
        return wave  # every rank computed (a collective); one writes
    if ctx.cfg.extra.normalize_examples:
        # the reference's dead normalize_examples key (default.ini:35,
        # quirk #9), made functional: peak-normalize written examples
        peak = float(np.abs(wave).max())
        if peak > 0:
            wave = wave / peak
    out_path = ctx.audio_log_dir / f"test_reconst_{step_label:05d}.wav"
    write_wav(out_path, wave, ctx.cfg.audio.sampling_rate)
    print(f"Audio examples generated: {out_path}")
    # TB example cropped to example_length seconds (dead reference key
    # default.ini:36, quirk #9 — the wav on disk stays full length)
    tb_wave = wave
    ex_len = ctx.cfg.extra.example_length
    if ex_len > 0:
        tb_wave = wave[: ex_len * ctx.cfg.audio.sampling_rate]
    ctx.writer.add_audio("Reconstructed Audio", tb_wave, step_label,
                         sample_rate=ctx.cfg.audio.sampling_rate)
    return wave


def fetch_host_state(state: TrainState,
                     ready: Optional["torch.cuda.Event"] = None
                     ) -> TrainState:
    """The whole train state with its tensors on the host, in ONE pass
    shared by every action of a checkpoint boundary (histograms, the best
    gate and the checkpoint writer each used to pull their own copy).

    For a state on a CUDA device the copies run on a side stream that
    waits for ``ready`` (an event recorded after the state was written;
    by default, everything queued so far on the current stream) and for
    nothing later: called from the boundary worker with a snapshot, it
    does not wait for the steps the training thread keeps queueing."""
    leaves = tree_leaves((state.params, state.mu, state.nu))
    cuda = next((t.device for t in leaves if t.device.type == "cuda"), None)

    def to_host(tree: Params) -> Params:
        return tree_map(lambda t: t.detach().to("cpu"), tree)

    def fetch() -> TrainState:
        return TrainState(params=to_host(state.params),
                          mu=to_host(state.mu), nu=to_host(state.nu),
                          count=state.count, seed=state.seed,
                          step=state.step)

    if cuda is None:
        return fetch()
    side = torch.cuda.Stream(cuda)
    if ready is not None:
        side.wait_event(ready)
    else:
        side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        host = fetch()
    side.synchronize()
    return host


def full_params(ctx: TrainContext, params: Optional[Params] = None
                ) -> Params:
    """``params`` (the live ones by default) with whole leaves: under
    tensor parallelism the model group's shards gathered — a collective
    every rank calls — else as they are."""
    params = ctx.state.params if params is None else params
    if ctx.specs is None:
        return params
    return gather_params(params, ctx.mesh, ctx.specs)


def full_state(ctx: TrainContext) -> TrainState:
    """The live state with whole leaves (:func:`full_params` of the
    params and both moments; a collective under tensor parallelism)."""
    if ctx.specs is None:
        return ctx.state
    s = ctx.state
    return TrainState(params=full_params(ctx, s.params),
                      mu=full_params(ctx, s.mu), nu=full_params(ctx, s.nu),
                      count=s.count, seed=s.seed, step=s.step)


def boundary_host_state(ctx: TrainContext
                        ) -> Tuple[Optional[TrainState], Params]:
    """``(host_state, host_params)`` of the live state for a checkpoint
    boundary's writers: one device→host pass of whole leaves (gathered
    first under tensor parallelism, on every rank).  Under the sharded
    format the params alone (the histograms and the best gate read them):
    its writer takes the live shards itself, as JAX's orbax writer takes
    the live arrays (``train/loop.py:319-330``)."""
    if ctx.cfg.tpu.checkpoint_format == "orbax":
        params = full_params(ctx)
        return None, tree_map(lambda t: t.detach().to("cpu"), params)
    host = fetch_host_state(full_state(ctx))
    return host, host.params


class AsyncBoundaryWriter:
    """Checkpoint-boundary host I/O on a background thread.

    With the boundary state snapshotted on the device and the next group
    of epochs already queued, the training thread would still block on the
    boundary's host work: one full state fetch plus the histogram, best
    and checkpoint writes.  Submitting the boundary closure here takes it
    off the loop: the loop trains ahead while the worker fetches and
    writes.

    Depth 1 by design: ``submit`` first waits for the previous boundary,
    so at most one snapshot is alive off-loop and boundaries execute
    strictly in order (the best gate mutates shared bookkeeping).
    ``flush()`` joins the in-flight boundary and re-raises any worker
    exception on the caller — the trainer flushes before interrupt
    checkpoints and the end-of-run tail, so those always see settled
    ``best_loss`` and artifacts."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> float:
        """Queue ``fn``; returns the seconds spent waiting for the PREVIOUS
        boundary to clear (the only part of the I/O left on the loop)."""
        t0 = time.perf_counter()
        self.flush()
        wait_s = time.perf_counter() - t0

        def run() -> None:
            try:
                fn()
            except BaseException as e:  # re-raised on the loop at flush
                self._err = e

        self._thread = threading.Thread(
            target=run, name="boundary-io", daemon=True)
        self._thread.start()
        return wait_s

    def flush(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("checkpoint-boundary I/O failed") from err


def log_param_histograms(ctx: TrainContext, step: int,
                         params: Optional[Params] = None) -> None:
    """Per-parameter histograms.  The dense model keeps the reference's
    torch names (``fc1.weight`` in ``nn.Linear``'s ``(out, in)`` layout,
    ``fc1.bias``; train.py:203-204); the other families log under dotted
    tree names (``enc.0.w``, ``mu_head.b``), leaves as stored.  ``params``
    may pass a pre-fetched host tree (:func:`fetch_host_state`) to skip the
    device pull.  Rank 0 writes; under tensor parallelism every rank takes
    part in gathering the live params."""
    if params is None:
        params = full_params(ctx)
    if not is_coordinator():
        return
    if ctx.model.name != "dense":
        for name, leaf in flatten(params):
            ctx.writer.add_histogram(name, leaf.detach().cpu().numpy(), step)
        return
    for name in sorted(params):
        layer = params[name]
        ctx.writer.add_histogram(f"{name}.weight",
                                 layer["w"].detach().t().cpu().numpy(), step)
        ctx.writer.add_histogram(f"{name}.bias",
                                 layer["b"].detach().cpu().numpy(), step)


def save_periodic_checkpoint(ctx: TrainContext, extra: dict,
                             label: int | None = None,
                             host_state: Optional[TrainState] = None) -> Path:
    """``ckpt_{label:05d}.npz`` of the whole state, then retention
    (``[training] keep_checkpoints``) and a TB flush.  ``host_state`` may
    pass a pre-fetched host copy (:func:`fetch_host_state`)."""
    extra = dict(extra)
    extra["best_loss"] = ctx.best_loss
    if ctx.cfg.tpu.checkpoint_format == "orbax":
        # the sharded format: every rank calls it, the live shards as they
        # are (or a host copy of a one-rank state); async_checkpoint
        # returns after the device→host copy
        live = host_state is None
        path = ckpt.save_checkpoint_sharded(
            ctx.workspace.checkpoint_dir,
            ctx.state if live else host_state, extra, label=label,
            mesh=ctx.mesh, specs=ctx.specs if live else None,
            wait=not ctx.cfg.tpu.async_checkpoint)
    else:
        path = ckpt.save_checkpoint(
            ctx.workspace.checkpoint_dir,
            full_state(ctx) if host_state is None else host_state, extra,
            label=label)
    # prune AFTER the new save so a failed write can't leave fewer than
    # `keep` on disk
    keep = ctx.cfg.training.keep_checkpoints
    if keep > 0:
        ckpt.prune_checkpoints(ctx.workspace.checkpoint_dir, keep)
    # a checkpoint boundary is the natural TB durability point
    ctx.writer.flush()
    return path


def maybe_save_best(ctx: TrainContext, train_loss: float, step_label: int,
                    after: int, host_params: Optional[Params] = None) -> bool:
    """Best-model gate with a real best tracker (the reference's
    ``train_loss_prev`` started at 1e6 and was never updated — quirk #7).
    ``host_params`` may pass a pre-fetched host tree."""
    if step_label > after and train_loss < ctx.best_loss:
        ctx.best_loss = train_loss
        ctx.cfg.training.best_epoch = str(step_label)
        params = full_params(ctx) if host_params is None else host_params
        if is_coordinator():
            path = ctx.workspace.model_dir / "best_model.npz"
            ckpt.save_params(path, params)
            print(f"Step {step_label:05d}: Saved {path}")
        return True
    if train_loss > ctx.best_loss:
        print("Loss did not improve.")
    return False


def save_last(ctx: TrainContext, host_params: Optional[Params] = None
              ) -> Path:
    path = ctx.workspace.model_dir / "last_model.npz"
    params = full_params(ctx) if host_params is None else host_params
    if is_coordinator():
        ckpt.save_params(path, params)
    print("Training Finished: Saved the last model")
    return path


def finish(ctx: TrainContext) -> None:
    if ctx.boundary_writer is not None:
        # exception-path safety net: the trainer flushes on every normal
        # path, so an error here means the run is already failing — report
        # the secondary failure without masking the primary one
        try:
            ctx.boundary_writer.flush()
        except Exception as e:
            print(f"WARNING: checkpoint-boundary I/O failed during "
                  f"shutdown: {e!r}")
    # a pending sharded save commits before the run ends (every rank)
    ckpt.wait_for_orbax()
    keep = ctx.cfg.training.keep_checkpoints
    if keep > 0:
        ckpt.prune_checkpoints(ctx.workspace.checkpoint_dir, keep)
    ctx.cfg.stamp_end()
    ctx.workspace.snapshot_config(ctx.cfg)
    ctx.close()

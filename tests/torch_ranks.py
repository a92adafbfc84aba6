"""Ranks of the PyTorch port on the CPU, for the multi-process tests.

Imports no JAX: every rank is a process of its own started with
``torch.multiprocessing`` (start method ``spawn``), and a spawned process
imports the module that holds its target — a test module would pull in
JAX and the suite's 8-device setup with it.  :func:`launch` starts
``world`` ranks on a ``gloo`` group that meets at a ``FileStore`` under the
test's ``tmp_path`` (no port, so the xdist workers never race for one),
with a timeout of its own for every collective and a deadline for the
join, so that a hang fails one test instead of eating the suite's limit.
A target is ``fn(rank, world, *args)``; what it returns comes back
pickled, one entry a rank.

The targets below each check several things in one start (a start costs
seconds: every rank imports torch and the package).
"""

from __future__ import annotations

import pickle
import time
import uuid
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT = timedelta(seconds=60)


def _entry(rank, target, world, store, out, args, backend):
    torch.set_num_threads(2)
    kwargs = {}
    if torch.cuda.is_available():
        # the ranks of one card share it; NCCL takes one card a rank
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kwargs)
    try:
        result = target(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def launch(target, world: int, tmp_path: Path, *args, deadline: float = 240,
           backend: str = "gloo") -> list:
    """Run ``target(rank, world, *args)`` on ``world`` ranks (CPU
    processes; on a machine with a card they share ``cuda:0`` under gloo,
    or take one card each under NCCL); returns their results in rank
    order.  A rank's exception re-raises here; past ``deadline`` seconds
    the ranks are killed and ``TimeoutError`` is raised."""
    tag = uuid.uuid4().hex[:8]
    out = Path(tmp_path) / f"ranks-{tag}"
    out.mkdir(parents=True)
    store = out / "store"
    ctx = mp.start_processes(_entry, args=(target, world, str(store),
                                           str(out), args, backend),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=5):
        if time.monotonic() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks of {target.__name__} did not "
                               f"finish in {deadline} s")
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


# --------------------------------------------------------------- helpers

def _tiny_cfg(seg=128, units=64, latent=16, **tpu):
    from rawaudiovae_kelsey_tpu_torch.config import Config

    cfg = Config()
    cfg.audio.segment_length = seg
    cfg.audio.hop_length = seg // 4
    cfg.vae.n_units = units
    cfg.vae.latent_dim = latent
    cfg.training.learning_rate = 1e-3
    cfg.tpu.backend = "xla"
    cfg.tpu.precision = "highest"
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def _np_params(params):
    from rawaudiovae_kelsey_tpu_torch.tree import flatten

    return {name: t.detach().cpu().numpy().copy()
            for name, t in flatten(params)}


def _state_from(case):
    """A port train state from the case's numpy params (the JAX init)."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    return TrainState.create(params_from_jax(case["params"]), case["seed"])


# ---------------------------------------------------------------- targets

def mesh_steps(rank, world, cases):
    """The mesh step on this rank's rows for each case: ``cases`` holds the
    config, the JAX init, the global batch and the injected global eps by
    (step, microbatch).  Returns each case's losses and final params."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
        local_rows,
        make_mesh,
    )

    mesh = make_mesh()
    out = []
    for case in cases:
        cfg = _tiny_cfg(**case["tpu"])
        cfg.training.loss_reduction = case["reduction"]
        model = build_model(cfg, "cpu")
        eps = case["eps"]

        def noise(step, i, shape, eps=eps):
            e = eps[(step, i)]
            assert e.shape == shape, (e.shape, shape)
            return torch.from_numpy(e)

        step = build_train_step(model, cfg, noise=noise, mesh=mesh)
        state = _state_from(case)
        batch = case["batch"]
        rows = local_rows(mesh, len(batch), cfg.tpu.microbatch_size)
        losses = []
        for _ in range(case["steps"]):
            state, m = step(state, torch.from_numpy(batch[rows]))
            losses.append([float(m[k]) for k in ("loss", "mse", "kld")])
        out.append({"losses": losses, "params": _np_params(state.params),
                    "mu": _np_params(state.mu), "step": state.step})
    return out


def _trainer_cfg(datapath, kind, settings):
    cfg = _tiny_cfg(seg=256, units=64, latent=16)
    cfg.tpu.precision = "float32"
    cfg.dataset.datapath = str(datapath)
    cfg.training.batch_size = 16
    cfg.training.epochs = 3
    cfg.training.checkpoint_interval = 2
    cfg.training.save_best_model_after = 0
    cfg.training.total_num_frames = 16 * 8
    cfg.extra.description = f"mp_{kind}"
    for section, values in settings.items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    return cfg


_STEPS = [0]


def _count_steps(build):
    def counted(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(*a, **k):
            _STEPS[0] += 1
            return step(*a, **k)
        return run
    return counted


class _StopAfter:
    """A stand-in for ``GracefulInterrupt``: truthy on one rank once that
    rank has taken ``steps`` optimizer steps."""

    def __init__(self, fire: bool, steps: int):
        self.fire, self.steps = fire, steps

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return self.fire and _STEPS[0] >= self.steps


def trainer_run(rank, world, datapath, kind, settings, stop=None):
    """One run of the ``kind`` trainer (``epoch`` or ``stream``) on this
    rank, on the CPU.  ``stop = (rank, steps)`` raises the stop flag on
    that rank alone once it has taken that many steps.  Returns the step,
    the workspace, the params and the TB file this rank wrote (if any)."""
    from rawaudiovae_kelsey_tpu_torch.parallel import resident, spmd
    from rawaudiovae_kelsey_tpu_torch.train import epoch, loop, stream

    module = epoch if kind == "epoch" else stream
    saved = (loop.build_train_step, resident.per_rank_step,
             module.GracefulInterrupt)
    _STEPS[0] = 0
    loop.build_train_step = _count_steps(loop.build_train_step)
    resident.per_rank_step = _count_steps(spmd.per_rank_step)
    if stop is not None:
        module.GracefulInterrupt = (
            lambda: _StopAfter(rank == stop[0], stop[1]))
    try:
        cfg = _trainer_cfg(datapath, kind, settings)
        ctx = module.train(cfg, verbose=False, device="cpu")
    finally:
        (loop.build_train_step, resident.per_rank_step,
         module.GracefulInterrupt) = saved
    return {"step": ctx.state.step, "workdir": str(ctx.workspace.workdir),
            "params": _np_params(ctx.state.params),
            "writer": None if ctx.writer.path is None
            else str(ctx.writer.path),
            "best_loss": ctx.best_loss, "steps_taken": _STEPS[0]}


def run_jobs(rank, world, jobs):
    """Several targets in one start of the ranks: ``jobs`` is a list of
    ``(name, args)`` of this module's targets, run in order on the same
    group; returns their results in order."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


def spmd_steps(rank, world, case):
    """The explicit-collective step for ``case["steps"]`` steps on this
    rank's block of the global batch, with its own seeded noise (or, with
    ``case["eps"]``, the global eps block of this rank injected), and, with
    ``case["mesh_too"]``, the mesh step on the same blocks fed the same
    global eps.  Returns the losses and params of each."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_shard_map_train_step,
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import batch_sharding

    mesh = make_mesh()
    cfg = _tiny_cfg(**case.get("tpu", {}))
    cfg.training.loss_reduction = case.get("reduction", "mean")
    model = build_model(cfg, "cpu")
    batch = case["batch"]
    block = batch_sharding(mesh, len(batch))
    eps = case.get("eps")
    per_rank = global_ = None
    if eps is not None:
        def per_rank(step, i, shape):
            return torch.from_numpy(eps[step][block])

        def global_(step, i, shape):
            return torch.from_numpy(eps[step])

    out = {}
    steps = {"spmd": build_shard_map_train_step(model, cfg, None, mesh,
                                                noise=per_rank)}
    if case.get("mesh_too"):
        steps["mesh"] = build_train_step(model, cfg, noise=global_,
                                         mesh=mesh)
    for name, step in steps.items():
        state = _state_from(case)
        losses = []
        for _ in range(case["steps"]):
            state, m = step(state, torch.from_numpy(batch[block]))
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "params": _np_params(state.params)}
    return out


def sampler_seeds(rank, world, case):
    """One mesh step under ``rng = tpu_prng``, recording what reaches the
    sampler on this rank: the seed words, and whether its ``z`` equals the
    plain Philox of those words bit for bit."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import batch_sharding

    mesh = make_mesh()
    cfg = _tiny_cfg(rng="tpu_prng")
    model = build_model(cfg, "cpu")
    seen = []
    original = rng.reparameterize

    def recording(seed, mu, logvar):
        z = original(seed, mu, logvar)
        want = rng.reparameterize_prng_ref(seed, mu.detach(),
                                           logvar.detach())
        seen.append((tuple(seed), bool(torch.equal(z.detach(), want))))
        return z

    rng.reparameterize = recording
    try:
        step = build_train_step(model, cfg, mesh=mesh)
        batch = case["batch"]
        step(_state_from(case),
             torch.from_numpy(batch[batch_sharding(mesh, len(batch))]))
    finally:
        rng.reparameterize = original
    return seen


def two_pass(rank, world, n_local, seg):
    """``_two_pass_shuffle`` of a shard whose rows all hold the rank's
    id: the origins of the rows the rank holds after it."""
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh
    from rawaudiovae_kelsey_tpu_torch.parallel.resident import (
        _two_pass_shuffle,
    )

    mesh = make_mesh()
    frames = torch.full((n_local, seg), float(rank))
    shuffled = _two_pass_shuffle(frames, 1234 + rank, mesh)
    return shuffled[:, 0].long().numpy()


def resident_epochs(rank, world, case):
    """The sharded resident engine for ``case["epochs"]`` epochs on this
    rank's block of ``case["frames"]`` (a padded global matrix): with
    ``case["perm"]`` (per epoch, per rank) and ``case["eps"]`` (per step,
    the global eps) injected, or, with ``case["record"]``, a step that
    records the origin of every row it is fed (frames hold their shard's
    id) instead of training."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh, resident
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import batch_sharding

    mesh = make_mesh()
    cfg = _tiny_cfg(**case["tpu"])
    cfg.training.batch_size = case["batch_size"]
    model = build_model(cfg, "cpu")
    frames = case["frames"]
    data = resident.put_frames_sharded(
        frames[batch_sharding(mesh, len(frames))], cfg, mesh)
    perm = noise = None
    if "perm" in case:
        def perm(epoch, n_local):
            return torch.from_numpy(case["perm"][epoch][rank])
    if "eps" in case:
        local = case["batch_size"] // world

        def noise(step, i, shape):
            e = case["eps"][step]
            return torch.from_numpy(e[rank * local:(rank + 1) * local])
    seen = []
    original = resident.per_rank_step
    if case.get("record"):
        def recording(*args, **kwargs):
            def step(state, xb):
                seen.append(xb[:, 0].long().numpy().copy())
                state.step += 1
                return state, {"loss": torch.zeros(())}
            return step
        resident.per_rank_step = recording
    try:
        run_epochs, n_batches = resident.build_resident_epoch_sharded(
            model, cfg, None, len(frames), mesh, noise=noise, perm=perm)
        state = _state_from(case)
        state, losses = run_epochs(state, data, 0, k=case["epochs"])
    finally:
        resident.per_rank_step = original
    return {"losses": losses.numpy(), "params": _np_params(state.params),
            "n_batches": n_batches, "seen": seen,
            "block": data[:, 0].numpy().copy()}


def align_rows(rank, world, counts):
    """``align_local_rows`` and ``put_frames_sharded`` of a rank holding
    ``counts[rank]`` rows (row i of rank r holds 100·r + i)."""
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh
    from rawaudiovae_kelsey_tpu_torch.parallel.resident import (
        align_local_rows,
        put_frames_sharded,
    )

    mesh = make_mesh()
    cfg = _tiny_cfg()
    cfg.tpu.precision = "float32"
    local = (np.arange(counts[rank] * 8, dtype=np.float32).reshape(-1, 8)
             + 100.0 * rank)
    aligned = align_local_rows(local, mesh)
    dev = put_frames_sharded(aligned, cfg, mesh)
    return local, aligned, dev.numpy()


def encode_sharded(rank, world, case):
    """``encode_trajectory_sharded`` of ``case["audio"]`` on every rank."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
    from rawaudiovae_kelsey_tpu_torch.infer import encode_trajectory_sharded
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh

    cfg = _tiny_cfg()
    model = build_model(cfg, "cpu")
    return encode_trajectory_sharded(
        model, params_from_jax(case["params"]), case["audio"], make_mesh(),
        batch_frames=case.get("batch_frames", 0), hop=case.get("hop"))


def trainer_error(rank, world, datapath, kind, settings):
    """``"<exception type>: <message>"`` of what a trainer run raises on
    this rank (``None`` if it trains)."""
    try:
        trainer_run(rank, world, datapath, kind, settings)
    except (ValueError, OSError, RuntimeError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def train_cfg(rank, world, cfg):
    """The epoch trainer on ``cfg`` as it is: ``(step, workspace)``."""
    from rawaudiovae_kelsey_tpu_torch.train.epoch import train

    ctx = train(cfg, verbose=False, device="cpu")
    return ctx.state.step, str(ctx.workspace.workdir)


def cuda_mesh_step(rank, world, precision):
    """On the card: one mesh step of the dense model (1024/2048/256, batch
    512, microbatch 128) on this rank's rows against the one-device step
    on the whole batch (rank 0), same init and global noise; the relative
    update difference, the update's digest, the launches, and the sampler
    words of a ``tpu_prng`` step."""
    import hashlib

    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import local_rows
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _tiny_cfg(seg=1024, units=2048, latent=256, precision=precision,
                    backend="pallas", microbatch_size=128)
    model = build_model(cfg, dev)
    init = model.init(torch.Generator().manual_seed(0))
    batch = np.random.default_rng(1).uniform(-1, 1, (512, 1024)).astype(
        np.float32)
    mesh = make_mesh(device=dev)

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(100 * step + (i or 0))
        return torch.randn(shape, generator=g)

    def update(step, x):
        state = TrainState.create(tree_map(torch.clone, init), 0)
        before = tree_map(torch.clone, state.params)
        state, m = step(state, x)
        return float(m["loss"]), torch.cat([
            (a - b).ravel() for a, b in zip(leaves(state.params),
                                             leaves(before))])

    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    rows = torch.from_numpy(batch[local_rows(mesh, 512, 128)]).to(dev)
    loss, delta = update(build_train_step(model, cfg, noise=noise,
                                          mesh=mesh), rows)
    out = {"launches": {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS},
           "digest": hashlib.sha256(delta.cpu().numpy().tobytes()
                                    ).hexdigest(), "loss": loss}
    if rank == 0:
        one_loss, one = update(build_train_step(model, cfg, noise=noise),
                               torch.from_numpy(batch).to(dev))
        out["rel"] = float((delta - one).norm() / one.norm())
        out["one_loss"] = one_loss
    words = rng.shard_seed((1234, 5678), mesh.data_index)
    out["words_equal"] = bool(torch.equal(
        rng.philox_words(words, 64, 256, dev).cpu(),
        rng.philox_words_ref(words, 64, 256)))
    out["words"] = words
    return out


# ------------------------------------------------- tensor parallelism

def _tp_cfg(case):
    cfg = _tiny_cfg(**case["tpu"])
    cfg.training.loss_reduction = case.get("reduction", "mean")
    for k, v in case.get("vae", {}).items():
        setattr(cfg.vae, k, v)
    return cfg


def tp_steps(rank, world, cases):
    """The tensor-parallel mesh step (``make_mesh(0, model)``) on this
    rank's rows for each case: ``cases`` holds the config, the JAX init,
    the global batch and the injected global eps by (step, microbatch),
    and the backward-fusion switch (``case["fusion"]``, "auto" if absent)
    while the model and the step are built.  Returns the losses, the whole
    params and mu (gathered) and this rank's shards after ``steps`` steps,
    and the mesh position."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    out = []
    for case in cases:
        mlp.BWD_FUSION = case.get("fusion", "auto")
        try:
            out.append(_tp_step_case(case))
        finally:
            mlp.BWD_FUSION = "auto"
    return out


def _tp_step_case(case):
    """One case of :func:`tp_steps`."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_to_shards
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import local_rows
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
        gather_params,
        param_specs,
    )
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    mesh = make_mesh(0, case["model"])
    cfg = _tp_cfg(case)
    model = build_model(cfg, "cpu")
    eps = case["eps"]

    def noise(step, i, shape):
        e = eps[(step, i)]
        assert e.shape == shape, (e.shape, shape)
        return torch.from_numpy(e)

    specs = param_specs(model.name, case["params"], mesh.model)
    state = TrainState.create(
        params_to_shards(case["params"], mesh, specs), case["seed"])
    step = build_train_step(model, cfg, noise=noise, mesh=mesh)
    batch = case["batch"]
    rows = local_rows(mesh, len(batch), cfg.tpu.microbatch_size)
    losses = []
    for _ in range(case["steps"]):
        state, m = step(state, torch.from_numpy(batch[rows]))
        losses.append([float(m[k]) for k in ("loss", "mse", "kld")])
    return {
        "losses": losses,
        "params": _np_params(gather_params(state.params, mesh, specs)),
        "mu": _np_params(gather_params(state.mu, mesh, specs)),
        "shards": _np_params(state.params),
        "position": (mesh.data_index, mesh.model_index)}


def tp_grads(rank, world, cases):
    """The whole gradients of one tensor-parallel forward and backward of
    the loss (no optimizer) for each case on this rank's rows, gathered;
    ``case["fp32_backward"]`` picks the dense kernels' backward mode."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_to_shards
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import make_loss_fn, make_mesh
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import batch_sharding
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
        gather_params,
        param_specs,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.tensor_parallel import (
        tensor_parallel_model,
    )
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map, unflatten

    out = []
    for case in cases:
        mesh = make_mesh(0, case["model"])
        cfg = _tp_cfg(case)
        model = tensor_parallel_model(build_model(cfg, "cpu"), cfg, mesh)
        specs = param_specs(model.name, case["params"], mesh.model)
        params = tree_map(lambda t: t.requires_grad_(),
                          params_to_shards(case["params"], mesh, specs))
        batch = torch.from_numpy(case["batch"])
        block = batch_sharding(mesh, len(batch))
        eps = torch.from_numpy(case["eps"])[block]
        loss, _ = make_loss_fn(model, cfg)(params, eps, batch[block])
        grads = torch.autograd.grad(loss, leaves(params))
        whole = gather_params(unflatten(params, [g.float() for g in grads]),
                              mesh, specs)
        out.append({"loss": float(loss), "grads": _np_params(whole)})
    return out


def tp_sampler_seeds(rank, world, case):
    """One tensor-parallel step under ``rng = tpu_prng``: the seed words
    that reached this rank's sampler, and its mesh position."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_to_shards
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import batch_sharding
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import param_specs
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    mesh = make_mesh(0, case["model"])
    cfg = _tiny_cfg(rng="tpu_prng", model_parallel=case["model"])
    model = build_model(cfg, "cpu")
    seen = []
    original = rng.reparameterize

    def recording(seed, mu, logvar):
        seen.append(tuple(seed))
        return original(seed, mu, logvar)

    rng.reparameterize = recording
    try:
        specs = param_specs(model.name, case["params"], mesh.model)
        state = TrainState.create(
            params_to_shards(case["params"], mesh, specs), case["seed"])
        batch = case["batch"]
        build_train_step(model, cfg, mesh=mesh)(
            state, torch.from_numpy(batch[batch_sharding(mesh, len(batch))]))
    finally:
        rng.reparameterize = original
    return {"seeds": seen, "position": (mesh.data_index, mesh.model_index)}


def tp_mesh_groups(rank, world, models):
    """For each model count: the mesh this rank builds, and what its model
    group and data group sum (rank ids), gather (model_all_gather of the
    rank id) and slice (model_slice of a row 0..7)."""
    import torch.distributed as dist

    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
        all_reduce_flat,
        model_all_gather,
        model_all_reduce,
        model_slice,
    )

    out = []
    for model in models:
        mesh = make_mesh(0, model)
        me = torch.tensor([float(rank)])
        out.append({
            "shape": (mesh.data, mesh.model), "rank": mesh.rank,
            "position": (mesh.data_index, mesh.model_index),
            "model_sum": float(model_all_reduce([me], mesh)[0]),
            "data_sum": float(all_reduce_flat([me], False, mesh)[0][0]),
            "gathered": model_all_gather(me[None], mesh, 1).tolist(),
            "slice": model_slice(torch.arange(8.0)[None], mesh, 1).tolist(),
            "groups": (mesh.model_group is not None,
                       mesh.data_group is not None)})
        dist.barrier()
    return out


def tp_checkpoint(rank, world, job):
    """Save or restore a dense model's checkpoint on ``make_mesh(0,
    model)``: ``job`` = (kind, model, params, path, extra).  "save" writes
    the JAX init's shards (moments made from the params) at label 7 in the
    sharded format, or gathered as an npz (``extra["npz"]``); "restore"
    reads ``path`` into this rank's template and returns the shards."""
    from rawaudiovae_kelsey_tpu_torch.compat import params_to_shards
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
        gather_params,
        param_specs,
    )
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.train import checkpoint as ckpt
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    kind, model, params, path, extra = job
    mesh = make_mesh(0, model)
    specs = param_specs("dense", params, mesh.model)
    shards = params_to_shards(params, mesh, specs)
    state = TrainState(params=shards, mu=tree_map(lambda t: 0.5 * t, shards),
                       nu=tree_map(lambda t: t * t, shards), count=3,
                       seed=11, step=7)
    if kind == "save":
        if extra.get("npz"):
            whole = TrainState(
                params=gather_params(state.params, mesh, specs),
                mu=gather_params(state.mu, mesh, specs),
                nu=gather_params(state.nu, mesh, specs),
                count=3, seed=11, step=7)
            return str(ckpt.save_checkpoint(Path(path), whole,
                                            {"epoch": 7}, label=7))
        return str(ckpt.save_checkpoint_sharded(
            Path(path), state, {"epoch": 7}, label=7, mesh=mesh,
            specs=specs))
    template = TrainState.create(tree_map(torch.zeros_like, shards), 0)
    got, meta = ckpt.restore_checkpoint(Path(path), template, mesh, specs)
    return {"params": _np_params(got.params), "mu": _np_params(got.mu),
            "nu": _np_params(got.nu), "count": got.count, "seed": got.seed,
            "step": got.step, "meta": meta,
            "position": (mesh.data_index, mesh.model_index)}

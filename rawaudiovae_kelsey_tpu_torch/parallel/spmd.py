"""Explicit-collective data parallelism — the JAX package's
``parallel/spmd.py`` (``build_shard_map_train_step``) on
``torch.distributed``.

The mesh step (``parallel/step.py`` ``build_train_step(mesh=)``) keeps the
GSPMD step's semantics: every rank draws the GLOBAL batch's noise and keeps
its rows.  This step is the ``shard_map`` form: each rank works on its own
rows with noise of its own — the rank's data index folded into the step's
seed (``parallel/step.py`` ``fold_rank``; JAX folds ``axis_index`` into the
step's key, ``spmd.py:66-69``) — and exactly ONE all-reduce of the fp32
gradients and the three metrics, as one flat bucket.  Under ``sum``
reduction the bucket is summed (a mean of per-rank sums would scale the
gradients by 1/n, ``spmd.py:56-60``), under ``mean`` averaged.  Under
``[tpu] rng = tpu_prng`` the sampler's seed words are folded as the mesh
step folds them (``ops/rng.py`` ``shard_seed``).  Trajectories match the
mesh step in distribution, not bit for bit; fed the same per-rank noise
the two steps are the same function.  No microbatch accumulation: it raises
as JAX does (``spmd.py:44-49``).  The state is updated in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.ops import rng
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import Mesh, all_reduce_flat
from rawaudiovae_kelsey_tpu_torch.parallel.step import (
    NoiseFn,
    _generator,
    fold_rank,
    make_loss_fn,
    noise_seed,
)
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam, build_optimizer
from rawaudiovae_kelsey_tpu_torch.train.state import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves
from rawaudiovae_kelsey_tpu_torch.tree import tree_map, unflatten


def build_shard_map_train_step(
    model: ModelDef,
    cfg: Config,
    optimizer: Optional[Adam],
    mesh: Mesh,
    noise: Optional[NoiseFn] = None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """``(state, batch) → (state, metrics)`` with ``batch`` this rank's
    rows; params and moments replicated.  ``noise(step, None, (rows,
    latent))`` replaces the rank's draw (the caller's function knows the
    rank).  Raises for ``microbatch_size > 0``, as JAX does."""
    if cfg.tpu.microbatch_size:
        raise ValueError(
            "build_shard_map_train_step does not implement microbatch "
            "gradient accumulation; use build_train_step(mesh=) for "
            "microbatch_size > 0")
    return per_rank_step(model, cfg, optimizer, mesh, noise)


def per_rank_step(model: ModelDef, cfg: Config, optimizer: Optional[Adam],
                  mesh: Mesh, noise: Optional[NoiseFn] = None) -> Callable:
    """The body of :func:`build_shard_map_train_step`, one full-batch
    gradient a step (also the sharded resident epoch's step,
    ``parallel/resident.py``)."""
    loss_fn = make_loss_fn(model, cfg)
    optimizer = optimizer or build_optimizer(cfg)
    tpu_prng = cfg.tpu.rng == "tpu_prng"
    seg, latent = model.segment_length, model.latent_dim
    mean = cfg.training.loss_reduction.split()[0] == "mean"
    index = mesh.data_index

    def eps_for(state: TrainState, rows: int, device: torch.device):
        seed = noise_seed(state.seed, state.step)
        if tpu_prng:
            return rng.shard_seed(rng.seed_words(seed), index)
        if noise is not None:
            return noise(state.step, None, (rows, latent)).to(
                device=device, dtype=torch.float32)
        return torch.randn((rows, latent), device=device,
                           generator=_generator(device,
                                                fold_rank(seed, index)))

    def step(state: TrainState, batch: torch.Tensor):
        x = batch.reshape(-1, seg)
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          state.params)
        leaves = tree_leaves(params)
        loss, (mse, kld) = loss_fn(params, eps_for(state, x.shape[0],
                                                   x.device), x)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        # THE collective: one reduction of grads and the scalar metrics
        reduced = all_reduce_flat(
            grads + [loss.detach(), mse.detach(), kld.detach()], mean)
        grads, metrics = reduced[:len(grads)], reduced[len(grads):]
        optimizer.update(state, unflatten(state.params, grads))
        state.step += 1
        return state, dict(zip(("loss", "mse", "kld"), metrics))

    return step

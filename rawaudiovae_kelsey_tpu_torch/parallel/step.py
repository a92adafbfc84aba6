"""The train step — the counterpart of the JAX package's
``parallel/step.py`` on one device.

``build_train_step`` returns ``step(state, batch) → (state, metrics)``:
forward, reparameterization, loss, backward and Adam, with

* the JAX package's precision policy: ``bfloat16`` casts the params and
  the batch to bf16, brings ``mu`` / ``logvar`` back to fp32, samples ``z``
  in fp32, casts ``z`` to bf16 for the decoder and the reconstruction back
  to fp32, so the loss and the optimizer run in fp32 on fp32 master params
  (``step.py:86-102``).  ``float32``, ``high`` and ``highest`` all hold
  fp32 operands (TF32 stays off).  Under ``backend = pallas`` the backward
  mode is the switch ``ops/mlp.py`` ``BWD_FUSION`` as the model was built
  with it (under "auto": the bf16 step "split", ``float32`` and
  ``highest`` the "primitive" composition in IEEE fp32, ``high`` the
  "full" chains), every product at the forward's pass count; the forward
  runs IEEE fp32 under ``float32`` and ``highest`` and three bf16 passes
  under ``high``, bound here as JAX's step scope binds
  its ambient tier (``models/registry.py`` ``under_tier``; the train and
  eval steps, and through them the resident, spmd and stream engines);
* microbatch accumulation: the fp32 gradient sum of the full microbatches
  is scaled by ``micro/total`` after summing, and a ragged tail is one more
  gradient call weighted ``rem/total``; under ``sum`` reduction both
  weights are 1 (``step.py:182-228``);
* explicit noise: the ``eps`` of step ``s`` and microbatch ``i`` is drawn
  from a ``torch.Generator`` on the device seeded by
  :func:`noise_seed` ``(seed, s, i)`` — a function of those three alone, so
  a resumed run replays it.  It is not JAX's threefry stream; ``noise``
  injects other numbers (the tests feed both packages the same ``eps``).
  Under ``[tpu] rng = tpu_prng`` no ``eps`` tensor exists: the sampler of
  ``ops/rng.py`` draws it inside its kernel from the two words of the same
  seed, and ``noise`` does not apply;
* ``[tpu] remat``: the loss under ``torch.utils.checkpoint``
  (:func:`make_loss_fn`), the counterpart of ``jax.checkpoint``;
* ``mesh=`` (``parallel/mesh.py``): the JAX GSPMD step's semantics — the
  loss and gradient of the GLOBAL batch — on ranks that each hold their
  block of it (:func:`~rawaudiovae_kelsey_tpu_torch.parallel.mesh.local_rows`:
  block ``r`` of every global microbatch).  Each rank computes its rows'
  loss and gradient, then ONE all-reduce of the fp32 gradients and the
  three metrics as a flat bucket, a mean under ``loss_reduction = mean``
  and a sum under ``sum``, and the same Adam: the replicas stay equal bit
  for bit (they start from rank 0's params, ``train/loop.py`` ``setup``).
  The noise has the one-device step's semantics: each rank draws the
  global microbatch's ``eps`` from the same generator (``noise_seed(seed,
  s, i)``) and takes its rows, so the mesh step equals the one-device
  step up to the order of the reduction.  Under ``rng = tpu_prng`` each
  rank's sampler gets the seed words with its data index folded into
  word 0 (``ops/rng.py`` :func:`~rawaudiovae_kelsey_tpu_torch.ops.rng.shard_seed`,
  JAX ``sharded_pallas_reparameterize``).  JAX falls back to threefry,
  loudly, for a microbatch whose rows do not divide the data axis
  (``step.py:72-77``); here a rank holds equal blocks by construction
  (:func:`~rawaudiovae_kelsey_tpu_torch.parallel.mesh.batch_sharding`
  raises for a global batch that does not divide the ranks), so that case
  has no counterpart;
* ``weights`` (:func:`make_weighted_loss_fn`): the row-weighted loss of
  padded batches, rows of weight 0 carrying no loss and no gradient;
* a mesh with ``model > 1`` (tensor parallelism): ``state`` holds the
  rank's shards (``parallel/sharding.py`` ``shard_params``; Adam's moments
  are made from them, so they are sharded too) and the model runs the
  Megatron split on them (``parallel/tensor_parallel.py``
  ``tensor_parallel_model``).  The ranks of one data index hold the same
  rows and draw the same noise (the global microbatch's, sliced by data
  index; ``shard_seed`` folds the data index only), the gradients and the
  metrics are reduced over the data group alone, and every rank's Adam
  updates its own shards; the replicated leaves get equal gradients on the
  ranks of a model group, so they stay equal bit for bit.

The state is updated in place; clone it first to keep the old one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef, under_tier
from rawaudiovae_kelsey_tpu_torch.observe.spans import span
from rawaudiovae_kelsey_tpu_torch.ops import rng
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_flat,
    batch_sharding,
)
from rawaudiovae_kelsey_tpu_torch.parallel.tensor_parallel import (
    tensor_parallel_model,
)
from rawaudiovae_kelsey_tpu_torch.train.optim import Adam, build_optimizer
from rawaudiovae_kelsey_tpu_torch.train.state import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves
from rawaudiovae_kelsey_tpu_torch.tree import tree_map, unflatten

Tensor = torch.Tensor
# (step, microbatch index or None, shape) → eps, fp32
NoiseFn = Callable[[int, Optional[int], Tuple[int, int]], Tensor]
# the eval stream's step: one no training run reaches, so its noise is
# disjoint from every training step's (the JAX package folds in 0x7E57)
EVAL_STREAM = -1

_MASK = (1 << 64) - 1


def mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def noise_seed(seed: int, step: int, i: Optional[int] = None) -> int:
    """The generator seed of step ``step``'s noise (of its microbatch
    ``i``; ``None`` for a step without microbatches): a hash of the three,
    63 bits."""
    h = mix64(mix64(seed & _MASK) ^ (step & _MASK))
    if i is not None:
        h = mix64(h ^ ((i + 1) & _MASK))
    return h >> 1


def fold_rank(seed: int, index: int) -> int:
    """``seed`` with a data index folded in (the analog of JAX's
    ``fold_in(key, axis_index)``): a hash of the two, 63 bits."""
    return mix64((seed & _MASK) ^ mix64(index & _MASK)) >> 1


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _make_forward(model: ModelDef, cfg: Config) -> Callable:
    """``(params, eps, batch) → (x, recon, mu, logvar)``: the forward flow
    shared by the plain and the row-weighted loss (bf16 casts, encode,
    reparameterize, decode; JAX ``step.py:86-102``), the model under the
    step's precision tier (:func:`under_tier`)."""
    model = under_tier(model, cfg)
    tpu_prng = cfg.tpu.rng == "tpu_prng"
    seg = model.segment_length
    work = torch.bfloat16 if cfg.tpu.precision == "bfloat16" else torch.float32

    def forward(params, eps, batch):
        x = batch.reshape(-1, seg)
        cparams = tree_map(lambda t: t.to(work), params)
        mu, logvar = model.encode(cparams, x.to(work))
        mu, logvar = mu.float(), logvar.float()
        if tpu_prng:
            z = rng.reparameterize(eps, mu, logvar).to(work)
        else:
            z = vae.reparameterize(mu, logvar, eps=eps).to(work)
        recon = model.decode(cparams, z).float()
        return x, recon, mu, logvar

    return forward


def _remat(cfg: Config, loss_fn: Callable) -> Callable:
    if not cfg.tpu.remat:
        return loss_fn

    def remat_loss_fn(*args):
        # the noise is an input (eps, or the sampler's seed words), so the
        # forward the backward recomputes is the same function of the same
        # inputs: no generator state to stash
        return checkpoint(loss_fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return remat_loss_fn


def make_loss_fn(model: ModelDef, cfg: Config) -> Callable:
    """``(params, eps, batch) → (loss, (mse, kld))``, all reductions fp32.
    ``eps`` is the fp32 noise of ``z = mu + eps·exp(logvar/2)``; under
    ``[tpu] rng = tpu_prng`` it is instead the seed's two 32-bit words, and
    the in-kernel sampler (``ops/rng.py``) draws the noise itself.  The
    loss compares the reconstruction with ``batch`` as it is stored: a bf16
    batch (the resident corpus under ``precision = bfloat16``) is the
    rounded target, as in the JAX step (``step.py:86-102``).

    ``[tpu] remat`` wraps the loss in ``torch.utils.checkpoint`` (non-
    reentrant), as the JAX step wraps it in ``jax.checkpoint``: the
    backward keeps only the inputs and recomputes the forward, so each
    microbatch runs its forward twice and holds no activations between
    forward and backward.  The recomputed forward is the same function of
    the same inputs, so the step's bits do not change."""
    forward = _make_forward(model, cfg)
    seg = model.segment_length
    kl_beta = cfg.vae.kl_beta
    reduction = cfg.training.loss_reduction.split()[0]

    def loss_fn(params, eps, batch):
        x, recon, mu, logvar = forward(params, eps, batch)
        loss, mse, kld = vae.loss_components(recon, x, mu, logvar, kl_beta,
                                             seg, reduction)
        return loss, (mse, kld)

    return _remat(cfg, loss_fn)


def make_weighted_loss_fn(model: ModelDef, cfg: Config) -> Callable:
    """``(params, eps, batch, weights, n_real) → (loss, (mse, kld))``: the
    row-masked :func:`make_loss_fn` of JAX ``make_weighted_loss_fn``
    (``step.py:115-129``, ``:143-152``).  Rows of weight 0 (padding that
    makes a batch divide the ranks) contribute nothing to the loss or the
    gradients, and the mean's denominators count only real rows:
    ``n_real``, the sum of the weights over ALL ranks (the caller
    all-reduces it), so each rank's value is its share of the global mean
    and the ranks' values SUM to it."""
    forward = _make_forward(model, cfg)
    seg = model.segment_length
    kl_beta = cfg.vae.kl_beta
    mean = cfg.training.loss_reduction.split()[0] == "mean"

    def loss_fn(params, eps, batch, weights, n_real):
        x, recon, mu, logvar = forward(params, eps, batch)
        wv = weights.float()
        se = torch.sum(torch.square(recon - x), dim=1)
        kl = -0.5 * torch.sum(
            1.0 + logvar - torch.square(mu) - torch.exp(logvar), dim=1)
        if mean:
            mse = torch.dot(se, wv) / (n_real * seg)
            kld = torch.dot(kl, wv) / (n_real * mu.shape[-1])
        else:
            mse, kld = torch.dot(se, wv), torch.dot(kl, wv)
        return mse + kl_beta * kld, (mse, kld)

    return _remat(cfg, loss_fn)


def build_train_step(model: ModelDef, cfg: Config,
                     optimizer: Optional[Adam] = None,
                     noise: Optional[NoiseFn] = None,
                     mesh: Optional[Mesh] = None
                     ) -> Callable[..., Tuple[TrainState, dict]]:
    """The full update ``(state, batch, weights=None) → (state,
    metrics)``; ``metrics`` holds the ``loss``, ``mse`` and ``kld`` as 0-d
    tensors on the device (no host sync).  ``noise`` replaces the seeded
    draws (with a mesh it gets the GLOBAL microbatch's shape and each rank
    takes its rows); it does not apply under ``[tpu] rng = tpu_prng``,
    where the sampler's kernel draws the noise from the seed's words.

    With a ``mesh``, ``batch`` is this rank's rows (``parallel/mesh.py``
    ``local_rows``) and ``microbatch_size`` must divide the ranks.
    ``weights`` (one per row; the resident stream's padded batches) takes
    :func:`make_weighted_loss_fn` in one full-batch gradient: ``n_real``
    is all-reduced first and the ranks' shares are summed.  On a mesh with
    ``model > 1`` the state holds the rank's shards (the module's
    docstring)."""
    if mesh is not None:
        model = tensor_parallel_model(model, cfg, mesh)
    loss_fn = make_loss_fn(model, cfg)
    wloss_fn = make_weighted_loss_fn(model, cfg)
    tpu_prng = cfg.tpu.rng == "tpu_prng"
    optimizer = optimizer or build_optimizer(cfg)
    micro = cfg.tpu.microbatch_size
    seg, latent = model.segment_length, model.latent_dim
    n = mesh.data if mesh is not None else 1
    if micro and micro % n:
        raise ValueError(
            f"microbatch_size {micro} does not divide the {n} ranks of the "
            "data axis")
    # mean-reduced losses average microbatch grads; sum-reduced losses SUM
    # them (averaging would silently scale the effective LR by 1/n_micro)
    mean_reduced = cfg.training.loss_reduction.split()[0] == "mean"

    def eps_for(state: TrainState, i: Optional[int], rows: int,
                device: torch.device):
        seed = noise_seed(state.seed, state.step, i)
        if tpu_prng:
            words = rng.seed_words(seed)
            return (words if mesh is None
                    else rng.shard_seed(words, mesh.data_index))
        # the global microbatch's noise; a rank keeps its block of it
        shape = (rows * n, latent)
        if noise is not None:
            eps = noise(state.step, i, shape).to(device=device,
                                                 dtype=torch.float32)
        else:
            eps = torch.randn(shape, generator=_generator(device, seed),
                              device=device)
        return eps if mesh is None else eps[batch_sharding(mesh, shape[0])]

    def step(state: TrainState, batch: Tensor,
             weights: Optional[Tensor] = None):
        with span("rvk.step"):
            return update(state, batch, weights)

    def update(state: TrainState, batch: Tensor,
               weights: Optional[Tensor]):
        batch = batch.reshape(-1, seg)
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          state.params)
        leaves = tree_leaves(params)

        def value_and_grad(i, rows, *weighted):
            with span("rvk.forward"):
                eps = eps_for(state, i, rows.shape[0], rows.device)
                if weighted:
                    loss, (mse, kld) = wloss_fn(params, eps, rows, *weighted)
                else:
                    loss, (mse, kld) = loss_fn(params, eps, rows)
            with span("rvk.backward"):
                grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
            return [loss.detach(), mse.detach(), kld.detach()], grads

        total = batch.shape[0]           # this rank's rows
        local_micro = micro // n
        if weights is not None:
            if micro and micro < total * n:
                raise ValueError(
                    "the row-weighted step takes one full-batch gradient "
                    f"(microbatch_size {micro} < the batch's {total * n} "
                    "rows)")
            n_real = weights.float().sum()
            if mesh is not None:
                with span("rvk.allreduce"):
                    (n_real,) = all_reduce_flat([n_real], mean=False,
                                                mesh=mesh)
            metrics, grads = value_and_grad(None, batch, weights, n_real)
        elif micro and local_micro < total:
            # a ragged final batch (the loader keeps it) is one extra grad
            # call, weighted by its row count
            n_micro, rem = divmod(total, local_micro)
            msum, gsum = value_and_grad(0, batch[:local_micro])
            for i in range(1, n_micro):
                m, g = value_and_grad(
                    i, batch[i * local_micro:(i + 1) * local_micro])
                msum = [a + b for a, b in zip(msum, m)]
                for a, b in zip(gsum, g):
                    a.add_(b)
            # grad of the mean over the full batch is the row-count-
            # weighted sum of per-part mean grads; sum-reduction just adds
            # (a rank's ratios equal the global ones: equal blocks)
            w_main = (local_micro / total) if mean_reduced else 1.0
            grads = [g * w_main for g in gsum]
            metrics = [m * w_main for m in msum]
            if rem:
                m, g = value_and_grad(n_micro, batch[n_micro * local_micro:])
                w_rem = (rem / total) if mean_reduced else 1.0
                grads = [a + b * w_rem for a, b in zip(grads, g)]
                metrics = [a + b * w_rem for a, b in zip(metrics, m)]
        else:
            metrics, grads = value_and_grad(None, batch)
        if mesh is not None:
            # THE collective: grads and metrics in one flat bucket; the
            # weighted shares are already fractions of the global mean
            with span("rvk.allreduce"):
                reduced = all_reduce_flat(
                    grads + metrics, mean=mean_reduced and weights is None,
                    mesh=mesh)
            grads, metrics = reduced[:len(grads)], reduced[len(grads):]
        with span("rvk.adam"):
            optimizer.update(state, unflatten(state.params, grads))
        state.step += 1
        return state, dict(zip(("loss", "mse", "kld"), metrics))

    return step


def build_eval_step(model: ModelDef, cfg: Config,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Reconstruction ``(params, generator, batch) → recon``, without
    gradients.  Stochastic by default — the reference sampled the latent
    even during eval reconstruction (train.py:224; quirk #13);
    ``[tpu] deterministic_inference`` switches to z = mu.  Runs on the
    (fp32 master) params as they are, as the JAX eval step does.  With a
    ``mesh``, ``batch`` is this rank's block: the generator draws the
    global batch's noise and the rank keeps its rows; with ``model > 1``
    the params are the rank's shards and every rank of the model group
    runs the sharded forward.  The forward runs under the step's precision
    tier (:func:`under_tier`), as JAX's eval step runs in its scope."""
    if mesh is not None:
        model = tensor_parallel_model(model, cfg, mesh)
    model = under_tier(model, cfg)
    seg = model.segment_length
    deterministic = cfg.tpu.deterministic_inference

    def eval_fn(params, generator: Optional[torch.Generator], batch):
        with torch.inference_mode():
            x = batch.reshape(-1, seg)
            mu, logvar = model.encode(params, x)
            eps = None
            if mesh is not None and not deterministic:
                rows = mu.shape[0] * mesh.data
                eps = torch.randn((rows, mu.shape[1]), generator=generator,
                                  device=mu.device, dtype=mu.dtype)
                eps = eps[batch_sharding(mesh, rows)]
            z = vae.reparameterize(mu, logvar, generator, deterministic,
                                   eps=eps)
            return model.decode(params, z)

    return eval_fn


def eval_generator(device: torch.device, seed: int, i: int
                   ) -> torch.Generator:
    """The generator of eval batch ``i``: the stream of step
    ``EVAL_STREAM``, disjoint from training's."""
    return _generator(device, noise_seed(seed, EVAL_STREAM, i))

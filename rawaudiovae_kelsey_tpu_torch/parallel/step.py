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
  of ``float32`` and ``highest`` is the JAX package's "primitive"
  composition in IEEE fp32, that of ``high`` its "full" chains
  (``enc_bwd_full`` / ``dec_bwd_full``) with every product in three bf16
  passes; the forward runs IEEE fp32 in all three
  (``models/registry.py``);
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
  (:func:`make_loss_fn`), the counterpart of ``jax.checkpoint``.

The row-weighted loss of mesh training is not ported (one device only).
The state is updated in place; clone it first to keep the old one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.ops import rng
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


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


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
    tpu_prng = cfg.tpu.rng == "tpu_prng"
    seg = model.segment_length
    kl_beta = cfg.vae.kl_beta
    reduction = cfg.training.loss_reduction.split()[0]
    bf16 = cfg.tpu.precision == "bfloat16"
    work = torch.bfloat16 if bf16 else torch.float32

    def loss_fn(params, eps, batch):
        x = batch.reshape(-1, seg)
        cparams = tree_map(lambda t: t.to(work), params)
        mu, logvar = model.encode(cparams, x.to(work))
        mu, logvar = mu.float(), logvar.float()
        if tpu_prng:
            z = rng.reparameterize(eps, mu, logvar).to(work)
        else:
            z = vae.reparameterize(mu, logvar, eps=eps).to(work)
        recon = model.decode(cparams, z).float()
        loss, mse, kld = vae.loss_components(recon, x, mu, logvar, kl_beta,
                                             seg, reduction)
        return loss, (mse, kld)

    if not cfg.tpu.remat:
        return loss_fn

    def remat_loss_fn(params, eps, batch):
        # the noise is an input (eps, or the sampler's seed words), so the
        # forward the backward recomputes is the same function of the same
        # inputs: no generator state to stash
        return checkpoint(loss_fn, params, eps, batch, use_reentrant=False,
                          preserve_rng_state=False)

    return remat_loss_fn


def build_train_step(model: ModelDef, cfg: Config,
                     optimizer: Optional[Adam] = None,
                     noise: Optional[NoiseFn] = None
                     ) -> Callable[[TrainState, Tensor],
                                   Tuple[TrainState, dict]]:
    """The full update ``(state, batch) → (state, metrics)``; ``metrics``
    holds the ``loss``, ``mse`` and ``kld`` as 0-d tensors on the device
    (no host sync).  ``noise`` replaces the seeded draws; it does not apply
    under ``[tpu] rng = tpu_prng``, where the sampler's kernel draws the
    noise from the seed's words."""
    loss_fn = make_loss_fn(model, cfg)
    tpu_prng = cfg.tpu.rng == "tpu_prng"
    optimizer = optimizer or build_optimizer(cfg)
    micro = cfg.tpu.microbatch_size
    seg, latent = model.segment_length, model.latent_dim
    # mean-reduced losses average microbatch grads; sum-reduced losses SUM
    # them (averaging would silently scale the effective LR by 1/n_micro)
    mean_reduced = cfg.training.loss_reduction.split()[0] == "mean"

    def eps_for(state: TrainState, i: Optional[int], rows: int,
                device: torch.device):
        seed = noise_seed(state.seed, state.step, i)
        if tpu_prng:
            return rng.seed_words(seed)
        if noise is not None:
            return noise(state.step, i, (rows, latent)).to(
                device=device, dtype=torch.float32)
        return torch.randn((rows, latent), generator=_generator(device, seed),
                           device=device)

    def step(state: TrainState, batch: Tensor):
        batch = batch.reshape(-1, seg)
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          state.params)
        leaves = tree_leaves(params)

        def value_and_grad(i, rows):
            eps = eps_for(state, i, rows.shape[0], rows.device)
            loss, (mse, kld) = loss_fn(params, eps, rows)
            grads = torch.autograd.grad(loss, leaves)
            return ([loss.detach(), mse.detach(), kld.detach()],
                    [g.float() for g in grads])

        total = batch.shape[0]
        if micro and micro < total:
            # a ragged final batch (the loader keeps it) is one extra grad
            # call, weighted by its row count
            n_micro, rem = divmod(total, micro)
            msum, gsum = value_and_grad(0, batch[:micro])
            for i in range(1, n_micro):
                m, g = value_and_grad(i, batch[i * micro:(i + 1) * micro])
                msum = [a + b for a, b in zip(msum, m)]
                for a, b in zip(gsum, g):
                    a.add_(b)
            # grad of the mean over the full batch is the row-count-
            # weighted sum of per-part mean grads; sum-reduction just adds
            w_main = (micro / total) if mean_reduced else 1.0
            grads = [g * w_main for g in gsum]
            metrics = [m * w_main for m in msum]
            if rem:
                m, g = value_and_grad(n_micro, batch[n_micro * micro:])
                w_rem = (rem / total) if mean_reduced else 1.0
                grads = [a + b * w_rem for a, b in zip(grads, g)]
                metrics = [a + b * w_rem for a, b in zip(metrics, m)]
        else:
            metrics, grads = value_and_grad(None, batch)
        optimizer.update(state, unflatten(state.params, grads))
        state.step += 1
        return state, dict(zip(("loss", "mse", "kld"), metrics))

    return step


def build_eval_step(model: ModelDef, cfg: Config) -> Callable:
    """Reconstruction ``(params, generator, batch) → recon``, without
    gradients.  Stochastic by default — the reference sampled the latent
    even during eval reconstruction (train.py:224; quirk #13);
    ``[tpu] deterministic_inference`` switches to z = mu.  Runs on the
    (fp32 master) params as they are, as the JAX eval step does."""
    seg = model.segment_length
    deterministic = cfg.tpu.deterministic_inference

    def eval_fn(params, generator: Optional[torch.Generator], batch):
        with torch.inference_mode():
            x = batch.reshape(-1, seg)
            mu, logvar = model.encode(params, x)
            z = vae.reparameterize(mu, logvar, generator, deterministic)
            return model.decode(params, z)

    return eval_fn


def eval_generator(device: torch.device, seed: int, i: int
                   ) -> torch.Generator:
    """The generator of eval batch ``i``: the stream of step
    ``EVAL_STREAM``, disjoint from training's."""
    return _generator(device, noise_seed(seed, EVAL_STREAM, i))

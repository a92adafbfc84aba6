"""Long-horizon training parity of the port against the JAX package:
tests/test_training_parity.py's ``test_long_horizon_training_parity`` with
the port's train step (rawaudiovae_kelsey_tpu_torch/parallel/step.py, its
Adam) in place of the reference's torch loop.

500 coupled Adam steps at SEG 512 from the JAX test's weights
(``torch.nn.Linear``'s init under seed 1), on the same batch, with
deterministic latents on both sides (z = mu: the port's step is given zero
noise), at ``precision = highest``.  The bounds are the JAX
test's: per-step lockstep over the first 60 steps (rtol 3e-3, atol 1e-5),
then the 50-step moving averages within 0.30 relative, the last 50 steps'
means within 10 %, both trajectories below a tenth of their start, and
both reconstructing to the same noise-floor band.  Adam's per-parameter
normalisation amplifies fp32 reduction-order noise chaotically over a long
horizon, so lockstep is claimed only early (see the JAX test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rawaudiovae_kelsey_tpu.compat import state_dict_to_params
from rawaudiovae_kelsey_tpu.models import vae as jvae
from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
from rawaudiovae_kelsey_tpu_torch.train import TrainState

SEG, UNITS, LATENT, STEPS, BATCH = 512, 768, 64, 500, 64
KL_BETA, LR = 1e-4, 1e-3


@pytest.mark.slow
def test_long_horizon_training_parity():
    # the JAX test's weights: torch.nn.Linear's init under seed 1
    torch.manual_seed(1)
    layers = {"fc1": (SEG, UNITS), "fc21": (UNITS, LATENT),
              "fc22": (UNITS, LATENT), "fc3": (LATENT, UNITS),
              "fc4": (UNITS, SEG)}
    init = {name: torch.nn.Linear(*shape) for name, shape in layers.items()}
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
        {f"{name}.{k}": v for name, layer in init.items()
         for k, v in layer.state_dict().items()}))
    x_np = np.random.default_rng(1).uniform(
        -1, 1, (BATCH, SEG)).astype(np.float32)
    xj = jnp.asarray(x_np)

    # the JAX package: its model functions under optax's Adam, z = mu
    def loss_fn(p):
        mu, logvar = jvae.encode(p, xj)
        recon = jvae.decode(p, mu)
        return jvae.loss_fn(recon, xj, mu, logvar, KL_BETA, SEG)

    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jparams, opt_state = params, opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    j_losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            loss, grads = grad_fn(jparams)
            updates, opt_state = opt.update(grads, opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            j_losses.append(float(loss))

    # the port: its train step, zero noise (z = mu), the JAX init
    cfg = Config()
    cfg.audio.segment_length = SEG
    cfg.vae.n_units, cfg.vae.latent_dim = UNITS, LATENT
    cfg.vae.kl_beta = KL_BETA
    cfg.training.learning_rate = LR
    cfg.tpu.precision, cfg.tpu.backend = "highest", "xla"
    step = build_train_step(build_model(cfg, "cpu"), cfg,
                            noise=lambda s, i, shape: torch.zeros(shape))
    state = TrainState.create(params_from_jax(jax.device_get(params)), 0)
    tx = torch.from_numpy(x_np)
    t_losses = []
    for _ in range(STEPS):
        state, m = step(state, tx)
        t_losses.append(float(m["loss"]))

    j, t = np.asarray(j_losses), np.asarray(t_losses)
    np.testing.assert_allclose(t[:60], j[:60], rtol=3e-3, atol=1e-5)

    def ma(a, w=50):
        return np.convolve(a, np.ones(w) / w, mode="valid")

    rel_s = np.abs(ma(t) - ma(j)) / np.maximum(ma(j), 1e-9)
    assert float(rel_s.max()) < 0.30, f"smoothed drift {rel_s.max():.3f}"
    assert abs(t[-50:].mean() - j[-50:].mean()) / j[-50:].mean() < 0.10
    assert j[-1] < j[0] * 0.1 and t[-1] < t[0] * 0.1
    # both reconstruct to the same noise-floor band
    with torch.no_grad():
        mu, _ = vae.encode(state.params, tx)
        t_recon = vae.decode(state.params, mu).numpy()
    jmu, _ = jvae.encode(jparams, xj)
    j_recon = np.asarray(jvae.decode(jparams, jmu))
    t_mse = float(np.mean((t_recon - x_np) ** 2))
    j_mse = float(np.mean((j_recon - x_np) ** 2))
    assert t_mse < 5e-5 and j_mse < 5e-5, (t_mse, j_mse)

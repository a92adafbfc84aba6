from rawaudiovae_kelsey_tpu_torch.compat.from_jax import (  # noqa: F401
    params_from_jax,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)

from rawaudiovae_kelsey_tpu_torch.compat.from_jax import (  # noqa: F401
    params_from_jax,
    params_to_jax,
    params_to_shards,
    train_state_from_jax,
    train_state_to_jax,
)
from rawaudiovae_kelsey_tpu_torch.compat.torch_import import (  # noqa: F401
    load_torch_checkpoint,
    params_to_state_dict,
    state_dict_to_params,
)

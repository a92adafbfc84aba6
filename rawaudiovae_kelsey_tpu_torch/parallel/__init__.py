from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    host_shard_info,
    is_coordinator,
    make_mesh,
    maybe_initialize_distributed,
)
from rawaudiovae_kelsey_tpu_torch.parallel.step import (  # noqa: F401
    build_eval_step,
    build_train_step,
    make_loss_fn,
    make_weighted_loss_fn,
    noise_seed,
)
from rawaudiovae_kelsey_tpu_torch.parallel.spmd import (  # noqa: F401
    build_shard_map_train_step,
)

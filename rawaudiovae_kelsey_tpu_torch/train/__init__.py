from rawaudiovae_kelsey_tpu_torch.train.state import TrainState  # noqa: F401
from rawaudiovae_kelsey_tpu_torch.train.optim import (  # noqa: F401
    Adam,
    build_optimizer,
)
from rawaudiovae_kelsey_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_params,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)

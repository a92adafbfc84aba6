from rawaudiovae_kelsey_tpu_torch.train.checkpoint import (  # noqa: F401
    load_params,
    save_params,
)

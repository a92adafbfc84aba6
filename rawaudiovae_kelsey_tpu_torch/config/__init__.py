from rawaudiovae_kelsey_tpu_torch.config.schema import (  # noqa: F401
    AudioConfig,
    Config,
    DatasetConfig,
    ExtraConfig,
    NotesConfig,
    TPUConfig,
    TrainingConfig,
    VAEConfig,
)
from rawaudiovae_kelsey_tpu_torch.config.ini import (  # noqa: F401
    load_config,
    save_config,
)

from rawaudiovae_kelsey_tpu_torch.models.vae import (  # noqa: F401
    DenseVAE,
    decode,
    encode,
    forward,
    init_dense,
    linear,
    loss_components,
    loss_fn,
    reparameterize,
)
from rawaudiovae_kelsey_tpu_torch.models.registry import (  # noqa: F401
    ModelDef,
    build_model,
)
from rawaudiovae_kelsey_tpu_torch.models.variants import (  # noqa: F401
    Conv1dVAE,
    DeepVAE,
)

from rawaudiovae_kelsey_tpu_torch.eval.fixtures import (  # noqa: F401
    init_test_audio,
)

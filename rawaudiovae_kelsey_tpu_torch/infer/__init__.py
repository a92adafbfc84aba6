from rawaudiovae_kelsey_tpu_torch.infer.api import (  # noqa: F401
    frame_audio,
    sine_alfa,
    stretch_alfa,
)
from rawaudiovae_kelsey_tpu_torch.infer.synthesis import (  # noqa: F401
    OverlapAddStream,
    flat_concat,
    overlap_add,
    stretch_resynthesis,
)
from rawaudiovae_kelsey_tpu_torch.infer.server import (  # noqa: F401
    InferenceServer,
    LiveSession,
)
from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer  # noqa: F401

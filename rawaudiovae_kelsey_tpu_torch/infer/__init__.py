from rawaudiovae_kelsey_tpu_torch.infer.api import (  # noqa: F401
    decode_trajectory,
    encode_trajectory,
    encode_trajectory_sharded,
    frame_audio,
    interpolate_stepwise,
    interpolate_timevarying,
    reconstruct,
    sample_z,
    sine_alfa,
    stretch_alfa,
)
from rawaudiovae_kelsey_tpu_torch.infer.audio_utils import (  # noqa: F401
    concat_random_audio,
    match_audio_size,
)
from rawaudiovae_kelsey_tpu_torch.infer.som import (  # noqa: F401
    SomClusters,
    concat_audio_som,
)
from rawaudiovae_kelsey_tpu_torch.infer.synthesis import (  # noqa: F401
    OverlapAddStream,
    flat_concat,
    overlap_add,
    stretch_resynthesis,
)
from rawaudiovae_kelsey_tpu_torch.infer.export import (  # noqa: F401
    export_npz,
    export_program,
    load_program,
    make_forward_fn,
)
from rawaudiovae_kelsey_tpu_torch.infer.onnx_model import (  # noqa: F401
    OnnxDecodeError,
    OnnxModel,
    export_onnx,
)
from rawaudiovae_kelsey_tpu_torch.infer.server import (  # noqa: F401
    InferenceServer,
    LiveSession,
)
from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer  # noqa: F401
from rawaudiovae_kelsey_tpu_torch.infer.som_train import (  # noqa: F401
    assign_clusters,
    train_som,
    train_som_for_corpus,
    write_som_artifacts,
)

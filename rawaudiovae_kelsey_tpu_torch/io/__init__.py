from rawaudiovae_kelsey_tpu_torch.io.wavio import (  # noqa: F401
    WavFormatError,
    decode_wav_bytes,
    encode_wav_bytes,
    read_wav,
    to_mono,
    wav_info,
    write_wav,
)
from rawaudiovae_kelsey_tpu_torch.io.resample import (  # noqa: F401
    load,
    resample,
)

from rawaudiovae_kelsey_tpu_torch.data.framing import (  # noqa: F401
    nonoverlapping_frame_count,
    nonoverlapping_frames,
    overlapping_frame_count,
    overlapping_frames,
    pad_to_multiple,
    streaming_file_frames,
)

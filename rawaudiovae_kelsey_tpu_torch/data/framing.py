"""Frame-extraction math.

Three framing contracts, matching the reference exactly (same counts, same
window starts, same zero-padding):

* **Overlapping** (training): window ``i`` covers
  ``audio[i*hop : i*hop + segment]`` over a corpus zero-padded to a hop
  multiple; count = ``len//hop - segment//hop + 1``  (AudioDataset,
  dataset.py:86-121).
* **Non-overlapping** (eval/inference): stride = segment, corpus zero-padded
  to a segment multiple; count = ``len//segment``  (TestDataset,
  dataset.py:129-160).
* **Streaming per-file** (iterable training): pad each file to a hop
  multiple, then yield ``range(0, len - segment + 1, hop)`` windows
  (IterableAudioDataset.process_data, dataset.py:44-75) — note this drops a
  short tail rather than padding it to a full window.

Unlike the reference's per-item ``__getitem__``, extraction here is a
vectorized zero-copy ``stride_tricks`` view — the whole batch materializes in
one gather when it is copied to the device, which keeps the host side off
the critical path at large batch sizes.  A copy of the JAX package's
``data/framing.py`` (pure NumPy).
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(audio: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad the tail so ``len(audio) % multiple == 0`` (dataset.py:99-101)."""
    rem = len(audio) % multiple
    if rem == 0:
        return audio
    return np.pad(audio, (0, multiple - rem), "constant")


def overlapping_frame_count(n: int, segment: int, hop: int) -> int:
    """AudioDataset.__len__ (dataset.py:121), for a corpus of raw length n."""
    padded = n + (-n % hop)
    return padded // hop - segment // hop + 1


def nonoverlapping_frame_count(n: int, segment: int) -> int:
    """TestDataset.__len__ (dataset.py:160), for a corpus of raw length n."""
    padded = n + (-n % segment)
    return padded // segment


def overlapping_frames(audio: np.ndarray, segment: int, hop: int) -> np.ndarray:
    """All overlapping windows of a (possibly unpadded) corpus as a zero-copy
    strided view of shape ``(count, segment)``."""
    if segment % hop != 0:
        raise ValueError(
            f"segment_length {segment} is not a multiple of hop_size {hop}"
        )
    audio = pad_to_multiple(np.ascontiguousarray(audio), hop)
    count = len(audio) // hop - segment // hop + 1
    if count <= 0:
        return np.zeros((0, segment), dtype=audio.dtype)
    itemsize = audio.itemsize
    return np.lib.stride_tricks.as_strided(
        audio, shape=(count, segment),
        strides=(hop * itemsize, itemsize), writeable=False,
    )


def nonoverlapping_frames(audio: np.ndarray, segment: int) -> np.ndarray:
    """All non-overlapping windows (padded tail) — shape ``(count, segment)``."""
    audio = pad_to_multiple(np.ascontiguousarray(audio), segment)
    return audio.reshape(-1, segment)


def streaming_file_frames(audio: np.ndarray, segment: int, hop: int) -> np.ndarray:
    """Per-file overlapping windows with the streaming loader's tail rule
    (dataset.py:61-69): pad to a hop multiple, then keep only windows that fit
    entirely (``range(0, len - segment + 1, hop)``)."""
    audio = pad_to_multiple(np.ascontiguousarray(audio), hop)
    n = len(audio)
    if n < segment:
        return np.zeros((0, segment), dtype=audio.dtype)
    count = (n - segment) // hop + 1
    itemsize = audio.itemsize
    return np.lib.stride_tricks.as_strided(
        audio, shape=(count, segment),
        strides=(hop * itemsize, itemsize), writeable=False,
    )

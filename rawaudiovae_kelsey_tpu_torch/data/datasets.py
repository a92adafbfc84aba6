"""Dataset objects of the epoch trainer, batch-first — the JAX package's
``data/datasets.py`` ``AudioFrameDataset`` and ``TestFrameDataset``, ported
(pure NumPy).  The streaming dataset comes with the streaming trainer.

The reference fed per-item torch Datasets through DataLoader (train.py:133-134);
here the unit of work is the device batch, so these classes index and
iterate whole ``(batch, segment)`` float32 arrays that go to the device
through ``data/loader.py``.  The shuffle is ``np.random.default_rng(seed)``,
as in the JAX package, so both trainers see the same batch order.
Item-level indexing is kept for contract tests against the reference's
``__getitem__`` math.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from rawaudiovae_kelsey_tpu_torch.data import framing


class AudioFrameDataset:
    """Map-style overlapping-window dataset over a concatenated corpus —
    the AudioDataset contract (dataset.py:86-121)."""

    def __init__(self, audio: np.ndarray, segment_length: int, hop_size: int,
                 sampling_rate: int = 44100):
        if segment_length % hop_size != 0:
            raise ValueError(
                f"segment_length {segment_length} is not a multiple of "
                f"hop_size {hop_size}"
            )
        self.segment_length = segment_length
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.audio = framing.pad_to_multiple(
            np.asarray(audio, dtype=np.float32), hop_size
        )
        self.frames = framing.overlapping_frames(
            self.audio, segment_length, hop_size
        )

    def __len__(self) -> int:
        # dataset.py:121 — clamped at 0: the reference formula goes negative
        # for a corpus shorter than one segment (where DataLoader would have
        # crashed on the same __len__).
        return max(
            0,
            len(self.audio) // self.hop_size
            - self.segment_length // self.hop_size + 1,
        )

    def __getitem__(self, index: int) -> np.ndarray:
        # dataset.py:107-112
        start = index * self.hop_size
        return self.audio[start:start + self.segment_length]

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: Optional[int] = None, drop_last: bool = False
                ) -> Iterator[np.ndarray]:
        """One epoch of ``(B, segment)`` batches.  ``shuffle=True`` permutes
        frame order like DataLoader(shuffle=True) (train.py:134); the final
        short batch is kept by default (DataLoader drop_last=False)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield np.ascontiguousarray(self.frames[idx])

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)


class TestFrameDataset:
    """Non-overlapping eval dataset — the TestDataset contract
    (dataset.py:129-160)."""

    __test__ = False  # keep pytest from collecting this as a test class

    def __init__(self, audio: np.ndarray, segment_length: int,
                 sampling_rate: int = 44100):
        self.segment_length = segment_length
        self.sampling_rate = sampling_rate
        self.audio = framing.pad_to_multiple(
            np.asarray(audio, dtype=np.float32), segment_length
        )
        self.frames = framing.nonoverlapping_frames(self.audio, segment_length)

    def __len__(self) -> int:
        return len(self.audio) // self.segment_length  # dataset.py:160

    def __getitem__(self, index: int) -> np.ndarray:
        start = index * self.segment_length
        return self.audio[start:start + self.segment_length]

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        for i in range(0, len(self.frames), batch_size):
            yield self.frames[i:i + batch_size]

"""The parts of the JAX package's ``infer/api.py`` that the server and the
HTTP layer use: framing a waveform for encoding, and the time-varying α
curves of the reference tutorial (cells 36-37).  Pure NumPy, copied.  The
trajectory, interpolation and SOM functions come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rawaudiovae_kelsey_tpu_torch.data.framing import (
    nonoverlapping_frames,
    overlapping_frames,
)


def frame_audio(audio: np.ndarray, segment_length: int,
                hop: Optional[int] = None) -> np.ndarray:
    """Frame a waveform for encoding.  ``hop=None`` → non-overlapping
    (TestDataset semantics, the normal inference path, tutorial cell 13);
    ``hop=k`` → overlapping (AudioDataset semantics — decoding these and
    flat-concatenating reproduces the reference's ~segment/hop× time-stretch
    "extension" effect, cell 52)."""
    if hop is None:
        return nonoverlapping_frames(np.asarray(audio, np.float32),
                                     segment_length)
    return np.asarray(
        overlapping_frames(np.asarray(audio, np.float32), segment_length, hop)
    )


def sine_alfa(n_points: int = 20000, cycles: float = 500.0,
              lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """The reference's time-varying α source (cell 36:
    ``np.sin(np.linspace(-cycles·π, cycles·π, n))``, cell 53 uses cycles=1).
    The reference lerps with the RAW sine in [-1, 1] — half the time the mix
    extrapolates past source A, which is part of the audible effect — so
    that is the default; pass ``lo=0.0`` for a pure within-endpoints
    crossfade."""
    s = np.sin(np.linspace(-cycles * np.pi, cycles * np.pi, n_points))
    return (lo + (s + 1.0) * 0.5 * (hi - lo)).astype(np.float32)


def stretch_alfa(alfa: np.ndarray, length: int) -> np.ndarray:
    """Stretch an α curve to trajectory length by linear interpolation — the
    scipy ``interp1d`` step of tutorial cells 37/54."""
    alfa = np.asarray(alfa, np.float32)
    if len(alfa) == length:
        return alfa
    xs = np.linspace(0.0, 1.0, len(alfa))
    return np.interp(np.linspace(0.0, 1.0, length), xs, alfa).astype(np.float32)

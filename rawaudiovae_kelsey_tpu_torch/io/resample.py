"""Sample-rate conversion for the HTTP layer.

The JAX package's ``io/resample.py`` ``resample``, copied (pure NumPy and
SciPy): windowed-sinc polyphase resampling on the host with
``scipy.signal.resample_poly`` and a Kaiser window — the filter family of
torchaudio's ``resampling_method='kaiser_window'``.  The ``load`` helper
there (native decode + resample) is not ported yet.
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy.signal import resample_poly


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resample of a 1-D float waveform."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    if orig_sr <= 0 or target_sr <= 0:
        # a corrupt-but-parseable fmt chunk can carry rate=0; fail with a
        # clear message instead of a ZeroDivision deep inside scipy
        raise ValueError(
            f"invalid sample rates for resampling: {orig_sr} -> {target_sr}"
        )
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    # Kaiser beta 14.77 ≈ torchaudio's default "kaiser_window" quality
    # (rolloff 0.9475937, width 64 taps per phase).
    y = resample_poly(np.asarray(x, dtype=np.float64), up, down,
                      window=("kaiser", 14.769656459379492))
    return y.astype(np.float32)

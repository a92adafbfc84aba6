"""Audio source preparation for interpolation — the JAX package's
``infer/audio_utils.py``, copied onto the port's ``io.load`` (pure NumPy;
``random.Random(seed)`` picks the same files for the same seed).

Contracts from tutorial.ipynb:
  * :func:`match_audio_size` (cells 13, 34, 51): make two waveforms equal
    length — crop the longer, or repeat the shorter end-to-end then crop;
  * :func:`concat_random_audio` (cells 24, 41): concatenate randomly chosen
    files from a folder until at least ``duration × sr`` samples, then crop.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from rawaudiovae_kelsey_tpu_torch.io import load


def match_audio_size(a: np.ndarray, b: np.ndarray,
                     mode: str = "repeat") -> Tuple[np.ndarray, np.ndarray]:
    """Equalize lengths.  ``mode="repeat"``: tile the shorter until it covers
    the longer, then crop (tutorial cell 34).  ``mode="crop"``: crop the
    longer to the shorter (cell 13)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if len(a) == len(b):
        return a, b
    if mode == "crop":
        n = min(len(a), len(b))
        return a[:n], b[:n]
    if mode == "repeat":
        n = max(len(a), len(b))

        def fit(x):
            if len(x) == n:
                return x
            reps = -(-n // len(x))
            return np.tile(x, reps)[:n]

        return fit(a), fit(b)
    raise ValueError(f"unknown mode {mode!r}")


def concat_random_audio(folder: Path, duration_s: float, sampling_rate: int,
                        mono: str = "mean",
                        seed: Optional[int] = None,
                        resample: bool = False) -> np.ndarray:
    """Randomly pick wavs (with replacement across passes) until the
    concatenation reaches ``duration_s * sampling_rate`` samples; crop to
    exactly that length.

    The reference loads every file at its NATIVE rate (tutorial cells
    24/41: ``librosa.load(path, sr=None)``) and crops by the target-rate
    sample count — a quirk kept as the default; ``resample=True`` converts
    each file to ``sampling_rate`` first."""
    files = sorted(Path(folder).glob("*.wav"))
    if not files:
        raise FileNotFoundError(f"no wav files in {folder}")
    rng = random.Random(seed)
    target = int(duration_s * sampling_rate)
    parts = []
    total = 0
    while total < target:
        wave, _ = load(rng.choice(files),
                       sr=sampling_rate if resample else None, mono=mono)
        parts.append(wave)
        total += len(wave)
    return np.concatenate(parts)[:target].astype(np.float32)

"""Held-out reconstruction fixture — the JAX package's
``eval/fixtures.py``, ported (pure NumPy).

Rebuilds ``rawvae/tests.py:13-42``: glob ``<datapath>/<test_dataset>/*.wav``,
write the provenance file list ``audio_logs/<name>.txt``, concatenate the
decoded audio, write the ground truth ``test_original.wav``, and return a
non-overlapping :class:`TestFrameDataset` plus the audio-log directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

from rawaudiovae_kelsey_tpu_torch.data.datasets import TestFrameDataset
from rawaudiovae_kelsey_tpu_torch.io import load, write_wav


def concat_test_audio(folder: Path, sampling_rate: int,
                      mono: str = "mean") -> np.ndarray:
    """Sorted-glob + load + concatenate of a test-audio folder — the ONE
    ingest both the training fixture and the eval CLI's ground-truth
    fallback share (raises clearly on an empty folder)."""
    files = sorted(Path(folder).glob("*.wav"))
    parts = [load(f, sr=sampling_rate, mono=mono)[0] for f in files]
    if not parts:
        raise FileNotFoundError(f"no wav files in {folder}")
    return np.concatenate(parts, axis=0)


def init_test_audio(
    workdir: Path,
    test_audio: str,
    my_test_audio: Path,
    sampling_rate: int,
    segment_length: int,
    mono: str = "mean",
) -> Tuple[TestFrameDataset, Path]:
    audio_log_dir = Path(workdir) / "audio_logs"
    os.makedirs(audio_log_dir, exist_ok=True)

    test_files = sorted(Path(my_test_audio).glob("*.wav"))
    with open(audio_log_dir / f"{test_audio}.txt", "w") as fh:
        fh.writelines(f"{f}\n" for f in test_files)

    test_dataset_audio = concat_test_audio(my_test_audio, sampling_rate,
                                           mono=mono)

    test_dataset = TestFrameDataset(
        test_dataset_audio, segment_length=segment_length,
        sampling_rate=sampling_rate,
    )
    write_wav(audio_log_dir / "test_original.wav", test_dataset_audio,
              sampling_rate)
    return test_dataset, audio_log_dir


def reconstruction_mse(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Frame-aligned MSE between the fixture ground truth and a decoded
    reconstruction (the quality-parity metric of BASELINE.json)."""
    n = min(len(original), len(reconstructed))
    diff = original[:n].astype(np.float64) - reconstructed[:n].astype(np.float64)
    return float(np.mean(np.square(diff)))

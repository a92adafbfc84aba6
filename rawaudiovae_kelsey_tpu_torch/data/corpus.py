"""Eager corpus ingest — the JAX package's ``data/corpus.py``, ported
(pure NumPy).

The reference's eager path (train.py:113-130) globbed ``<datapath>/audio/*.wav``,
``librosa.load``-ed each at the config rate and concatenated everything into a
single 1-D float32 array in host RAM.  Same contract here, with our own codec
(io/) and a deterministic sorted file order (the reference inherited the
filesystem's glob order; sorting is the only divergence, documented).

A model of ``[VAE] io_channels = 2`` or more (the Oobleck VAE's stereo)
takes its corpus with the channels kept, interleaved as a WAV stores them
(``L, R, L, R, ...``): ``build_corpus(..., channels=2)`` downmixes
nothing (:func:`load_interleaved`), so a frame of ``segment_length``
samples at a hop that is a multiple of the channels holds whole time
steps.  A port-only path; the JAX package's ingest is mono.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from rawaudiovae_kelsey_tpu_torch.io import load, read_wav, resample


def list_wavs(folder: Path) -> List[Path]:
    return sorted(Path(folder).glob("*.wav"))


def shard_files(files: Sequence[Path], host_id: int, num_hosts: int) -> List[Path]:
    """Per-host file-list sharding for multi-host ingest (the TPU-native
    replacement for the reference's single-process DataLoader — SURVEY.md §2
    parallelism table)."""
    return [f for i, f in enumerate(files) if i % num_hosts == host_id]


def load_interleaved(path: Path, sr: int | None, channels: int
                     ) -> np.ndarray:
    """``channels`` channels of the WAV at ``path`` at ``sr`` Hz (its own
    rate for ``None``), float32, interleaved into one 1-D array: a mono
    file on every channel, a file of more channels cut to the first
    ``channels``."""
    samples, native_sr = read_wav(path)
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] == 1:
        samples = np.repeat(samples, channels, axis=1)
    elif samples.shape[1] < channels:
        raise ValueError(f"{path}: {samples.shape[1]} channels, the model "
                         f"takes {channels}")
    samples = samples[:, :channels]
    if sr is not None and sr != native_sr:
        samples = np.stack([resample(samples[:, c], native_sr, sr)
                            for c in range(channels)], axis=1)
    return np.ascontiguousarray(samples, np.float32).reshape(-1)


def build_corpus(
    audio_dir: Path,
    sampling_rate: int,
    mono: str = "mean",
    host_id: int = 0,
    num_hosts: int = 1,
    verbose: bool = False,
    channels: int = 1,
) -> Tuple[np.ndarray, int]:
    """Decode + resample + concatenate a wav folder; ``channels > 1``
    keeps that many channels interleaved (:func:`load_interleaved`) in
    place of the ``mono`` mixdown.

    Returns ``(corpus, total_frames)`` where ``total_frames`` uses the
    reference's accounting ``len(corpus) // segment`` computed by the caller
    (train.py:129 divides by segment_length; we return the raw corpus and let
    the caller do that division since segment isn't an ingest concern).
    """
    files = shard_files(list_wavs(audio_dir), host_id, num_hosts)
    parts = []
    for f in files:
        if verbose:
            print(f"adding-> {f.stem}")
        if channels > 1:
            wave = load_interleaved(f, sampling_rate, channels)
        else:
            wave, _ = load(f, sr=sampling_rate, mono=mono)
        parts.append(wave)
    if not parts:
        return np.zeros((0,), dtype=np.float32), 0
    # parts are already float32 — copy=False avoids a second full-corpus
    # allocation while `parts` still holds every per-file array
    corpus = np.concatenate(parts, axis=0).astype(np.float32, copy=False)
    return corpus, len(corpus)

"""Eager corpus ingest — the JAX package's ``data/corpus.py``, ported
(pure NumPy).

The reference's eager path (train.py:113-130) globbed ``<datapath>/audio/*.wav``,
``librosa.load``-ed each at the config rate and concatenated everything into a
single 1-D float32 array in host RAM.  Same contract here, with our own codec
(io/) and a deterministic sorted file order (the reference inherited the
filesystem's glob order; sorting is the only divergence, documented).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from rawaudiovae_kelsey_tpu_torch.io import load


def list_wavs(folder: Path) -> List[Path]:
    return sorted(Path(folder).glob("*.wav"))


def shard_files(files: Sequence[Path], host_id: int, num_hosts: int) -> List[Path]:
    """Per-host file-list sharding for multi-host ingest (the TPU-native
    replacement for the reference's single-process DataLoader — SURVEY.md §2
    parallelism table)."""
    return [f for i, f in enumerate(files) if i % num_hosts == host_id]


def build_corpus(
    audio_dir: Path,
    sampling_rate: int,
    mono: str = "mean",
    host_id: int = 0,
    num_hosts: int = 1,
    verbose: bool = False,
) -> Tuple[np.ndarray, int]:
    """Decode + resample + concatenate a wav folder.

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
        wave, _ = load(f, sr=sampling_rate, mono=mono)
        parts.append(wave)
    if not parts:
        return np.zeros((0,), dtype=np.float32), 0
    # parts are already float32 — copy=False avoids a second full-corpus
    # allocation while `parts` still holds every per-file array
    corpus = np.concatenate(parts, axis=0).astype(np.float32, copy=False)
    return corpus, len(corpus)

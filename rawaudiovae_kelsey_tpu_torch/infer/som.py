"""SOM-cluster-driven audio selection — the JAX package's ``infer/som.py``,
copied onto the port's ``io.load``.

The reference consumed artifacts of an external SOM training repo
(``ktatar/mlaudiosalad``, README.md:14) in tutorial cells 28-33/45-48:

  * ``som/clusters.json`` — ``{str(cluster_idx): [sample_index, ...]}``
  * ``som/data-concatenated.json`` — ``{str(index): [<meta>, wav_path]}``

``concat_audio_som`` (cell 29) concatenated every wav of a cluster, loading
at the file's **native** rate (``librosa.load(path, sr=None)``).  Same
contract here, with an optional target rate for convenience.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from rawaudiovae_kelsey_tpu_torch.io import load


class SomClusters:
    def __init__(self, clusters_path: Path, data_path: Path):
        with open(clusters_path) as fh:
            self.clusters: Dict[str, List[int]] = json.load(fh)
        with open(data_path) as fh:
            self.data: Dict[str, list] = json.load(fh)

    def cluster_ids(self) -> List[int]:
        return sorted(int(k) for k in self.clusters)

    def cluster_files(self, cluster_idx: int) -> List[str]:
        """Relative wav paths of one cluster (data[index][1], cell 29)."""
        if str(cluster_idx) not in self.clusters:
            raise KeyError(f"cluster {cluster_idx} not in clusters.json")
        return [self.data[str(i)][1] for i in self.clusters[str(cluster_idx)]]

    def concat_audio(self, audio_root: Path, cluster_idx: int,
                     sr: Optional[int] = None,
                     mono: str = "mean") -> np.ndarray:
        """``concat_audio_som``: concatenate all wavs of a cluster.
        ``sr=None`` keeps each file's native rate (reference behavior)."""
        parts = []
        for rel in self.cluster_files(cluster_idx):
            wave, _ = load(Path(audio_root) / rel, sr=sr, mono=mono)
            parts.append(wave)
        if not parts:
            raise ValueError(f"cluster {cluster_idx} is empty")
        return np.concatenate(parts, axis=0)


def concat_audio_som(audio_files: Path, sampling_rate: int, cluster_idx: int,
                     som_clusters_dict: dict, som_data_dict: dict,
                     mono: str = "mean") -> np.ndarray:
    """Drop-in function form matching the reference signature (cell 29).
    Note: like the reference, loads at native rate (``sampling_rate`` is
    accepted for signature parity but unused there too)."""
    cluster = som_clusters_dict[str(cluster_idx)]
    parts = []
    for index in cluster:
        rel = som_data_dict[str(index)][1]
        wave, _ = load(Path(audio_files) / rel, sr=None, mono=mono)
        parts.append(wave)
    return np.concatenate(parts, axis=0)

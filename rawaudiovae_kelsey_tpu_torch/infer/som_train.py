"""Self-organizing-map training on latent features — the JAX package's
``infer/som_train.py``, ported.

The reference's SOM-cluster workflow consumed artifacts produced by an
external repo (``ktatar/mlaudiosalad``, README.md:14): ``som/clusters.json``
and ``som/data-concatenated.json`` (tutorial cells 28-29).  This module
trains a batch SOM on latent trajectories from the port's own encoder and
writes artifacts in the exact schema :class:`infer.som.SomClusters` (and the
reference notebook) consume.

One training iteration, on the features' device:
  * BMU search — ``‖x − w‖²`` for all (sample, unit) pairs as
    ``‖x‖² − 2·x@wᵀ + ‖w‖²`` (one matrix product) and an ``argmin``;
  * batch update — every unit moves toward the neighborhood-weighted mean
    of the samples: ``h @ x`` over a (units, samples) weight matrix.
These products are plain XLA in the JAX package (no Pallas kernel), so they
are plain ``torch`` products here.  :func:`fit_som` is the fit alone, from a
given initial codebook; :func:`train_som` draws that codebook
(:func:`initial_codebook`) from a ``torch.Generator`` seeded by ``seed``
(random samples plus 1e-3 noise, as in JAX, but not JAX's threefry draw:
ROADMAP.md queue C).  :func:`fit_quality` holds two fits of the same data
alike where rounding has them part ways.

Feature extraction: one vector per wav file = the time-mean of its latent
trajectory (``encode_trajectory`` mu, mean-pooled) — the standard audio-
corpus SOM setup.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.infer.api import encode_trajectory
from rawaudiovae_kelsey_tpu_torch.io import load
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef


def _sq_distances(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances of every row of ``x`` to every unit."""
    return (torch.sum(x * x, dim=1)[:, None] - 2.0 * x @ w.T
            + torch.sum(w * w, dim=1)[None, :])


def fit_som(features: torch.Tensor, w0: torch.Tensor,
            grid: Tuple[int, int] = (8, 8), iters: int = 200,
            sigma0: float = 2.5, lr0: float = 0.5) -> torch.Tensor:
    """The batch-SOM fit from codebook ``w0`` (``(grid[0]*grid[1], dim)``)
    over ``features`` (``(n, dim)``), on the features' device; returns the
    codebook there.  It runs in fp32, as the JAX fit does; float64
    features keep float64 (a reference fit with far smaller rounding)."""
    x = torch.as_tensor(features)
    if x.dtype != torch.float64:
        x = x.float()
    w = torch.as_tensor(w0).to(x.device, x.dtype)
    # unit coordinates on the grid, for the neighborhood kernel
    gy, gx = torch.meshgrid(torch.arange(grid[0], device=x.device),
                            torch.arange(grid[1], device=x.device),
                            indexing="ij")
    coords = torch.stack([gy.ravel(), gx.ravel()], dim=1).to(x.dtype)
    grid_d2 = torch.sum((coords[:, None, :] - coords[None, :, :]) ** 2,
                        dim=-1)  # (m, m)
    with torch.inference_mode():
        for t in range(iters):
            # the schedule in fp32 on the host, as the JAX fit computes it
            frac = np.float32(t) / np.float32(max(iters - 1, 1))
            decay = np.exp(np.float32(-3.0) * frac)
            sigma = np.float32(sigma0) * decay + np.float32(1e-3)
            lr = float(np.float32(lr0) * decay)
            # BMU per sample: argmin ‖x−w‖² (GEMM + norms)
            bmu = torch.argmin(_sq_distances(x, w), dim=1)         # (n,)
            # neighborhood weight of every unit wrt each sample's BMU
            h = torch.exp(-grid_d2[:, bmu]
                          / float(np.float32(2.0) * sigma * sigma))  # (m, n)
            support = torch.sum(h, dim=1, keepdim=True)            # (m, 1)
            target = (h @ x) / torch.clamp(support, min=1e-8)      # (m, dim)
            # batch-SOM rule: a unit with no meaningful support HOLDS its
            # position (otherwise the epsilon denominator makes target≈0
            # and dead units get dragged to the origin, where they steal
            # small-norm features at assignment time)
            w = torch.where(support > 1e-6, w + lr * (target - w), w)
    return w


def train_som(
    features: np.ndarray,
    grid: Tuple[int, int] = (8, 8),
    iters: int = 200,
    sigma0: float = 2.5,
    lr0: float = 0.5,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Batch-SOM fit on ``device`` (the card unless the caller names
    another) from :func:`initial_codebook` → codebook of shape
    ``(grid[0]*grid[1], dim)``."""
    x = torch.as_tensor(np.asarray(features, np.float32))
    w0 = initial_codebook(x, grid, seed)
    device = torch.device(device)
    return fit_som(x.to(device), w0.to(device), grid, iters, sigma0,
                   lr0).cpu().numpy()


def initial_codebook(features: torch.Tensor, grid: Tuple[int, int],
                     seed: int = 0) -> torch.Tensor:
    """:func:`train_som`'s initial codebook: random samples, with
    replacement, plus 1e-3 noise, drawn on the CPU from a generator seeded
    by ``seed``, so it is the same for every device the fit runs on."""
    x = torch.as_tensor(features, dtype=torch.float32).cpu()
    n, dim = x.shape
    m = grid[0] * grid[1]
    g = torch.Generator().manual_seed(seed)
    init_idx = torch.randint(0, n, (m,), generator=g)
    return x[init_idx] + 1e-3 * torch.randn((m, dim), generator=g)


def fit_quality(features: np.ndarray, codebook: np.ndarray,
                bmu: np.ndarray) -> Tuple[float, float]:
    """``(quantization error, BMU gap)`` of a codebook, in float64 from
    direct differences: the mean distance of a feature to its nearest unit,
    and the largest excess of a feature's squared distance to its assigned
    unit ``bmu`` over that to its nearest, relative to ``‖x‖² + ‖w‖²``.
    Where units sit within the fp32 search's rounding of a sample, two
    fits of the same data (two devices, two summation orders) pick other
    winners and part ways value by value; these two measures still hold
    them alike."""
    x = np.asarray(features, np.float64)
    w = np.asarray(codebook, np.float64)
    d2 = np.sum((x[:, None, :] - w[None, :, :]) ** 2, axis=-1)
    nearest = d2.min(axis=1)
    norms = np.sum(x * x, axis=1)[:, None] + np.sum(w * w, axis=1)[None, :]
    gap = (d2[np.arange(len(x)), bmu] - nearest) / norms.max(axis=1)
    return float(np.sqrt(nearest).mean()), float(gap.max())


def assign_clusters(features: np.ndarray, codebook: np.ndarray,
                    device: torch.device | str = "cuda") -> np.ndarray:
    """BMU index per feature row, searched on ``device`` (the card unless
    the caller names another)."""
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(features, np.float32)).to(device)
        w = torch.as_tensor(np.asarray(codebook, np.float32)).to(device)
        return torch.argmin(_sq_distances(x, w), dim=1).cpu().numpy()


def extract_file_features(model: ModelDef, params, audio_dir: Path,
                          sampling_rate: int, mono: str = "mean",
                          batch_size: int = 256
                          ) -> Tuple[np.ndarray, List[Path]]:
    """One latent vector per wav: time-mean of the mu trajectory."""
    files = sorted(Path(audio_dir).glob("*.wav"))
    if not files:
        raise FileNotFoundError(f"no wav files in {audio_dir}")
    feats = []
    kept = []
    for f in files:
        wave, _ = load(f, sr=sampling_rate, mono=mono)
        if len(wave) == 0:
            continue
        mu, _ = encode_trajectory(model, params, wave, batch_size)
        feats.append(mu.mean(axis=0))
        kept.append(f)
    return np.stack(feats), kept


def write_som_artifacts(out_dir: Path, assignments: np.ndarray,
                        files: List[Path],
                        relative_to: Path | None = None) -> Tuple[Path, Path]:
    """Write ``clusters.json`` + ``data-concatenated.json`` in the schema the
    reference notebook consumed (cells 28-29):

        clusters.json           {str(cluster_idx): [sample_index, ...]}
        data-concatenated.json  {str(index): [metadata, wav_path]}
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    clusters: Dict[str, List[int]] = {}
    for i, c in enumerate(assignments.tolist()):
        clusters.setdefault(str(int(c)), []).append(i)
    data = {}
    for i, f in enumerate(files):
        rel = f.relative_to(relative_to) if relative_to else f.name
        data[str(i)] = [{"cluster": int(assignments[i])}, str(rel)]
    clusters_path = out_dir / "clusters.json"
    data_path = out_dir / "data-concatenated.json"
    clusters_path.write_text(json.dumps(clusters, indent=1))
    data_path.write_text(json.dumps(data, indent=1))
    return clusters_path, data_path


def train_som_for_corpus(model: ModelDef, params, audio_dir: Path,
                         out_dir: Path, sampling_rate: int,
                         grid: Tuple[int, int] = (8, 8), iters: int = 200,
                         seed: int = 0, mono: str = "mean"
                         ) -> Tuple[Path, Path]:
    """End-to-end on ``model.device``: encode corpus → fit SOM → write
    reference-schema artifacts consumable by :class:`infer.som.SomClusters`."""
    feats, files = extract_file_features(model, params, audio_dir,
                                         sampling_rate, mono)
    codebook = train_som(feats, grid=grid, iters=iters, seed=seed,
                         device=model.device)
    assignments = assign_clusters(feats, codebook, model.device)
    return write_som_artifacts(out_dir, assignments, files,
                               relative_to=Path(audio_dir))

"""Batch inference API: encode → interpolate → decode — the JAX package's
``infer/api.py``, ported.

Replaces the reference's notebook-only inference layer (tutorial.ipynb) with a
library API.  Contract sources:

  * :func:`encode_trajectory` = ``raw_to_z_dist`` (tutorial cell 14): batched
    no-grad encode of framed audio → (num_frames, latent) mu/logvar
    trajectories;
  * :func:`interpolate_stepwise` = ``raw_interpolate_stepwise_z_dist``
    (cells 16-17): for each α in a grid, lerp the two trajectories, sample,
    decode, concatenate all steps;
  * :func:`interpolate_timevarying` = the meso-scale α(t) interpolation
    (cells 36-37, 53-54): a per-timestep α curve stretched to the trajectory
    length by linear interpolation (the scipy ``interp1d`` of cell 37 — here
    ``np.interp``), broadcast across latent dims (the ``repeat_interleave``
    of cell 37), lerp, sample, decode;
  * :func:`sine_alfa` builds the reference's sine curves
    (``np.sin(np.linspace(-500π, 500π, 20000))``, cell 36).

Every model call runs under ``torch.inference_mode()`` on ``model.device``:
a ``backend = pallas`` model launches the hand-written kernels there
(``ops/mlp.py`` for the dense family, ``ops/linear.py`` for the deep one).
Batches go to the device as they are cut, the last one ragged: the kernels
take any row count, so no pad keeps one compiled shape as in JAX.

Noise: where the JAX functions take a threefry ``key``, these take
``seed: Optional[int]``; ``None`` means z = mu, as ``key=None`` does.  eps is
drawn on ``model.device`` from :func:`seeded_generator` — ``(seed,)`` for
one sample, ``(seed, i)`` for step ``i`` of :func:`interpolate_stepwise`
(the analog of ``fold_in(key, i)``).  It is not JAX's stream: parity with
the JAX package is held at ``deterministic=True``.

:func:`encode_trajectory_sharded` is the mesh-parallel encode: every rank
of a group (``parallel/mesh.py``) encodes its block of each chunk of
frames on its own device, and the blocks are all-gathered.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.data.framing import (
    nonoverlapping_frames,
    overlapping_frames,
)
from rawaudiovae_kelsey_tpu_torch.data.loader import pad_batches_for_mesh
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.models.vae import reparameterize
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    batch_sharding,
)


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of ints (the analog of
    folding words into a threefry key): distinct tuples give independent
    streams, equal tuples the same one."""
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words])
    seed = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


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


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _run_batched(fn: Callable, frames: np.ndarray, batch_size: int,
                 device: torch.device) -> Tuple[np.ndarray, ...]:
    """``fn`` over ``frames`` in batches of ``batch_size`` rows on
    ``device``; each output's batches concatenated on the host."""
    n = len(frames)
    if n == 0:
        raise ValueError(
            "no frames to process — audio is shorter than one segment "
            "(or an empty trajectory was passed)"
        )
    outs = []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            res = fn(_to_device(frames[i:i + batch_size], device))
            outs.append(tuple(r.float().cpu().numpy()
                              for r in (res if isinstance(res, tuple)
                                        else (res,))))
    return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))


def encode_trajectory(model: ModelDef, params, audio_or_frames: np.ndarray,
                      batch_size: int = 256,
                      hop: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``raw_to_z_dist``: (mu, logvar) trajectories, each (N, latent).

    Accepts a 1-D waveform (framed at ``hop``) or pre-framed 2-D
    ``(N, segment_length)`` rows.  A ``(samples, channels)`` matrix straight
    from :func:`io.read_wav` is neither — select a channel first.
    """
    frames = np.asarray(audio_or_frames)
    if frames.ndim == 1:
        frames = frame_audio(frames, model.segment_length, hop)
    elif frames.ndim != 2 or frames.shape[-1] != model.segment_length:
        raise ValueError(
            f"encode_trajectory: expected a 1-D waveform or (N, "
            f"{model.segment_length}) frames, got shape {frames.shape}. "
            "io.read_wav returns (samples, channels) — pass wave[:, 0] "
            "(or a mono mixdown) for multi-channel audio.")
    mu, logvar = _run_batched(lambda x: model.encode(params, x), frames,
                              batch_size, model.device)
    return mu, logvar


def decode_trajectory(model: ModelDef, params, z: np.ndarray,
                      batch_size: int = 256) -> np.ndarray:
    """Decode (N, latent) → (N, segment) frames."""
    (frames,) = _run_batched(lambda zz: model.decode(params, zz),
                             np.asarray(z, np.float32), batch_size,
                             model.device)
    return frames


def sample_z(seed: Optional[int], mu: np.ndarray, logvar: np.ndarray,
             deterministic: bool = False,
             device: torch.device | str = "cuda",
             step: Optional[int] = None) -> np.ndarray:
    """z = mu + eps·exp(0.5·logvar), eps drawn on ``device`` (the card
    unless the caller names another) from :func:`seeded_generator` of
    ``(seed,)`` (``(seed, step)`` when ``step`` is given); z = mu when
    ``deterministic`` or ``seed`` is None."""
    if deterministic or seed is None:
        return np.asarray(mu, np.float32)
    device = torch.device(device)
    words = (seed,) if step is None else (seed, step)
    with torch.inference_mode():
        z = reparameterize(_to_device(mu, device), _to_device(logvar, device),
                           seeded_generator(device, *words))
        return z.cpu().numpy()


def _check_pair(mu_a, logvar_a, mu_b, logvar_b, hint: str) -> None:
    if mu_a.shape != mu_b.shape:
        raise ValueError(
            f"trajectory shapes differ: {mu_a.shape} vs {mu_b.shape}{hint}"
        )
    if logvar_a.shape != mu_a.shape or logvar_b.shape != mu_b.shape:
        # a (1, latent) logvar would broadcast silently, sampling with the
        # wrong per-frame variance
        raise ValueError(
            f"logvar shapes {logvar_a.shape}/{logvar_b.shape} must match "
            f"the mu trajectories {mu_a.shape}"
        )


def interpolate_stepwise(
    model: ModelDef, params,
    mu_a: np.ndarray, logvar_a: np.ndarray,
    mu_b: np.ndarray, logvar_b: np.ndarray,
    alphas=None,
    seed: Optional[int] = None,
    deterministic: bool = False,
    batch_size: int = 256,
) -> np.ndarray:
    """``raw_interpolate_stepwise_z_dist`` (tutorial cells 16-17): decode the
    lerp of two trajectories at each α and concatenate the resulting frame
    sequences.  Default α grid = ``np.arange(0, 1.1, 0.2)`` (cell 17).
    Trajectories must have equal length (use audio_utils.match_audio_size
    upstream, as the reference does at cell 13).  Step ``i`` draws its
    noise from ``(seed, i)``."""
    if alphas is None:
        alphas = np.arange(0.0, 1.1, 0.2)
    _check_pair(mu_a, logvar_a, mu_b, logvar_b,
                " (match_audio_size the sources first)")
    outs = []
    for i, a in enumerate(np.asarray(alphas, np.float32)):
        mu = (1.0 - a) * mu_a + a * mu_b
        logvar = (1.0 - a) * logvar_a + a * logvar_b
        z = sample_z(seed, mu, logvar, deterministic, model.device, step=i)
        outs.append(decode_trajectory(model, params, z, batch_size))
    return np.concatenate(outs, axis=0)


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


def interpolate_timevarying(
    model: ModelDef, params,
    mu_a: np.ndarray, logvar_a: np.ndarray,
    mu_b: np.ndarray, logvar_b: np.ndarray,
    alfa: np.ndarray,
    seed: Optional[int] = None,
    deterministic: bool = False,
    batch_size: int = 256,
) -> np.ndarray:
    """Meso-scale interpolation (cells 36-37): α varies per frame; the curve
    is stretched to the trajectory length and broadcast across latent dims."""
    _check_pair(mu_a, logvar_a, mu_b, logvar_b, "")
    a = stretch_alfa(alfa, len(mu_a))[:, None]  # (N, 1) broadcast over latent
    mu = (1.0 - a) * mu_a + a * mu_b
    logvar = (1.0 - a) * logvar_a + a * logvar_b
    z = sample_z(seed, mu, logvar, deterministic, model.device)
    return decode_trajectory(model, params, z, batch_size)


def reconstruct(model: ModelDef, params, audio: np.ndarray,
                seed: Optional[int] = None,
                deterministic: bool = False,
                batch_size: int = 256) -> np.ndarray:
    """encode → sample → decode of a waveform (frames, not yet flattened)."""
    mu, logvar = encode_trajectory(model, params, audio, batch_size)
    z = sample_z(seed, mu, logvar, deterministic, model.device)
    return decode_trajectory(model, params, z, batch_size)


def encode_trajectory_sharded(model: ModelDef, params, audio: np.ndarray,
                              mesh: Mesh, batch_frames: int = 0,
                              hop: Optional[int] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh-parallel batch encode of a long waveform (JAX
    ``infer/api.py:227-270``).

    The reference's "long sequence" story is framing: minutes of audio
    become tens of thousands of independent frames, so the parallel form
    shards the frame axis over the ranks — every rank encodes its block, no
    cross-rank dependency but the final all-gather.  The audio is framed
    (non-overlapping, or at ``hop``), cut into chunks of ``batch_frames``
    (0: one chunk), each chunk wrap-padded to a multiple of the ranks
    (``data/loader.py`` ``pad_batches_for_mesh``); every rank encodes its
    rows of it, the blocks are all-gathered in rank order and the pad is
    dropped.  Every rank of the group must call it; every rank returns the
    whole ``(mu, logvar)``."""
    frames = frame_audio(np.asarray(audio, np.float32),
                         model.segment_length, hop)
    n = len(frames)
    if n == 0:
        raise ValueError("audio shorter than one segment — nothing to encode")
    chunk = batch_frames or n
    mus, lvs = [], []
    with torch.inference_mode():
        for i in range(0, n, chunk):
            part = frames[i:i + chunk]
            (padded,) = pad_batches_for_mesh([part], mesh.data)
            rows = padded[batch_sharding(mesh, len(padded))]
            mu, logvar = model.encode(params, _to_device(rows, mesh.device))
            keep = len(part)
            mus.append(all_gather_rows(mu)[:keep].float().cpu().numpy())
            lvs.append(all_gather_rows(logvar)[:keep].float().cpu().numpy())
    return np.concatenate(mus, axis=0), np.concatenate(lvs, axis=0)

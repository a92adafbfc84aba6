"""Visualization helpers (the JAX package's ``observe/viz.py``, copied) —
the library form of the reference notebook's
plotting cells (tutorial cells 21-22, 26-27: ``librosa.display.waveshow``
and log-magnitude ``specshow``), implemented on numpy + matplotlib.

matplotlib is imported lazily; without it these raise a clear ImportError
rather than poisoning library import.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def stft_mag(audio: np.ndarray, n_fft: int = 2048,
             hop: int = 512, center: bool = True) -> np.ndarray:
    """Magnitude STFT, shape (n_fft//2+1, frames) — librosa.stft defaults:
    centered frames (n_fft//2 reflect padding) and a PERIODIC hann window,
    so visual comparisons line up with the reference notebook's specshow
    (a symmetric window + no centering would shift everything by half a
    frame)."""
    audio = np.asarray(audio, np.float32)
    if center:
        pad = n_fft // 2
        mode = "reflect" if len(audio) > 1 else "constant"
        audio = np.pad(audio, (pad, pad), mode=mode)
    if len(audio) < n_fft:
        audio = np.pad(audio, (0, n_fft - len(audio)))
    n_frames = 1 + (len(audio) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    k = np.arange(n_fft)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * k / n_fft)).astype(np.float32)
    frames = audio[idx] * win[None, :]
    return np.abs(np.fft.rfft(frames, axis=1)).T


def amplitude_to_db(mag: np.ndarray, ref: Optional[float] = None,
                    amin: float = 1e-5, top_db: float = 80.0) -> np.ndarray:
    """librosa.amplitude_to_db-equivalent (20·log10, ref=max, top_db floor)."""
    mag = np.asarray(mag, np.float64)
    ref = float(np.max(mag)) if ref is None else ref
    db = 20.0 * np.log10(np.maximum(mag, amin))
    db -= 20.0 * np.log10(max(ref, amin))
    return np.maximum(db, db.max() - top_db)


def waveshow(audio: np.ndarray, sampling_rate: int, ax=None, **kw):
    """Time-domain waveform plot (tutorial cell 21's waveshow)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(12, 3))
    t = np.arange(len(audio)) / sampling_rate
    ax.plot(t, audio, linewidth=0.5, **kw)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("amplitude")
    ax.set_xlim(0, t[-1] if len(t) else 1)
    return ax


def specshow(audio: np.ndarray, sampling_rate: int, n_fft: int = 2048,
             hop: int = 512, ax=None):
    """Log-magnitude spectrogram (tutorial cell 22's
    ``specshow(amplitude_to_db(stft))``)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    db = amplitude_to_db(stft_mag(audio, n_fft, hop))
    extent = [0, len(audio) / sampling_rate, 0, sampling_rate / 2 / 1000]
    im = ax.imshow(db, origin="lower", aspect="auto", extent=extent,
                   cmap="magma")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("freq (kHz)")
    # figure-scoped colorbar: plt.colorbar would touch pyplot global state
    # even when the caller provided its own (non-pyplot) axes
    ax.figure.colorbar(im, ax=ax, format="%+2.0f dB")
    return ax


def save_comparison(original: np.ndarray, reconstructed: np.ndarray,
                    sampling_rate: int, path: Path) -> Path:
    """Waveform + spectrogram side-by-side of original vs reconstruction —
    the visual QA the reference did by hand in the notebook.

    Renders to an explicit Agg-canvas Figure: ``matplotlib.use("Agg")``
    would hijack the caller's backend process-wide and close their open
    interactive figures."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(14, 6))
    FigureCanvasAgg(fig)
    axes = fig.subplots(2, 2)
    waveshow(original, sampling_rate, ax=axes[0][0])
    axes[0][0].set_title("original")
    waveshow(reconstructed, sampling_rate, ax=axes[0][1])
    axes[0][1].set_title("reconstruction")
    specshow(original, sampling_rate, ax=axes[1][0])
    specshow(reconstructed, sampling_rate, ax=axes[1][1])
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=100)
    return path

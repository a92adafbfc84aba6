"""Waveform resynthesis from decoded frames.

The reference flat-concatenated decoded frames (``tensor.view(-1)``,
train.py:232, tutorial cell 18) with no windowing — correct for
non-overlapping encode, and deliberately "wrong" (a ~segment/hop× time
stretch) for overlapping encode (tutorial cell 52).  Both behaviors are kept
for parity, plus a principled windowed overlap-add mode the reference lacked
(quirk #14 extension).
"""

from __future__ import annotations

import numpy as np


def flat_concat(frames: np.ndarray) -> np.ndarray:
    """``view(-1)`` resynthesis — bit-parity with the reference path."""
    return np.asarray(frames, np.float32).reshape(-1)


def _make_window(seg: int, hop: int, window: str) -> np.ndarray:
    if window == "hann" and hop >= seg:
        # periodic hann is COLA only for hop = seg/k with k >= 2; at
        # hop == seg its zero first sample would zero one sample per frame
        # (a click train) — non-overlapping frames need no window at all
        return np.ones(seg, np.float32)
    if window == "hann":
        # periodic hann (COLA-exact when hop divides seg, hop < seg)
        k = np.arange(seg)
        return (0.5 - 0.5 * np.cos(2 * np.pi * k / seg)).astype(np.float32)
    if window == "rect":
        return np.ones(seg, np.float32)
    raise ValueError(f"unknown window {window!r}")


def overlap_add(frames: np.ndarray, hop: int,
                window: str = "hann") -> np.ndarray:
    """Windowed overlap-add of decoded frames laid out at stride ``hop``.

    Use with frames decoded from an overlapping encode (``frame_audio(...,
    hop=k)``): output length = ``(n_frames - 1) * hop + segment``.  Windows
    are normalized by the summed window envelope so constant signals
    reconstruct to constants (COLA-safe for any hop dividing the segment).
    """
    frames = np.asarray(frames, np.float32)
    n, seg = frames.shape
    if n == 0:
        return np.zeros(0, np.float32)
    win = _make_window(seg, hop, window)
    out_len = (n - 1) * hop + seg
    out = np.zeros(out_len, np.float64)
    norm = np.zeros(out_len, np.float64)
    for i in range(n):
        out[i * hop:i * hop + seg] += frames[i] * win
        norm[i * hop:i * hop + seg] += win
    norm[norm < 1e-8] = 1.0
    return (out / norm).astype(np.float32)


class OverlapAddStream:
    """Incremental :func:`overlap_add` for chunked resynthesis.

    Feed decoded frame chunks in order with :meth:`add`; each call returns
    the samples that are FINAL (no future frame can touch them — a frame
    starting at ``k*hop`` only reaches back ``segment - hop`` samples), and
    :meth:`finish` flushes the carried tail.  The concatenation of every
    returned array is bit-identical to ``overlap_add(all_frames, hop)``:
    the float64 accumulation order per sample is the same, only the emit
    points differ.  Serving's long-clip streaming path (server.py
    ``reconstruct_stream``) stitches chunk responses with this.
    """

    def __init__(self, hop: int, window: str = "hann"):
        self.hop = hop
        self.window = window
        self._out = np.zeros(0, np.float64)   # un-final tail accumulator
        self._norm = np.zeros(0, np.float64)

    def add(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        if len(frames) == 0:
            return np.zeros(0, np.float32)
        n, seg = frames.shape
        if self.hop > seg:
            # emit = n*hop would overrun the (n-1)*hop+seg buffer (numpy
            # clamps the slice silently → short, non-matching audio) and
            # the trailing gap after the LAST frame must not be emitted at
            # all; gapped layouts need the one-shot path
            raise ValueError(
                f"OverlapAddStream requires hop <= segment length; got "
                f"hop={self.hop}, segment={seg} — use overlap_add() for "
                f"gapped (hop > segment) layouts")
        win = _make_window(seg, self.hop, self.window)
        length = (n - 1) * self.hop + seg
        out = np.zeros(length, np.float64)
        norm = np.zeros(length, np.float64)
        # carry FIRST: earlier frames' contributions precede this chunk's in
        # overlap_add's per-sample accumulation order (bit-equality contract)
        c = len(self._out)
        out[:c] += self._out
        norm[:c] += self._norm
        for i in range(n):
            out[i * self.hop:i * self.hop + seg] += frames[i] * win
            norm[i * self.hop:i * self.hop + seg] += win
        # samples >= n*hop can still receive the NEXT chunk's first frame
        emit = n * self.hop
        self._out = out[emit:].copy()
        self._norm = norm[emit:].copy()
        final_out, final_norm = out[:emit], norm[:emit].copy()
        final_norm[final_norm < 1e-8] = 1.0
        return (final_out / final_norm).astype(np.float32)

    def finish(self) -> np.ndarray:
        out, norm = self._out, self._norm.copy()
        self._out = np.zeros(0, np.float64)
        self._norm = np.zeros(0, np.float64)
        norm[norm < 1e-8] = 1.0
        return (out / norm).astype(np.float32)


def stretch_resynthesis(frames_overlapping: np.ndarray) -> np.ndarray:
    """The reference's "extension" effect (tutorial cell 52): encode with
    overlapping windows (hop < segment), decode, then flat-concat — yielding
    a ~segment/hop× time-stretched texture.  Identical to flat_concat; named
    separately to document intent."""
    return flat_concat(frames_overlapping)

"""Native TensorBoard event writer — zero dependencies (the JAX package's
``observe/tb.py``, ported: pure Python).

The reference logged through ``torch.utils.tensorboard.SummaryWriter``
(train.py:151,189,196,199-204,237): scalars ``Loss/Batch``, ``Learning Rate``,
``Loss/train_total``, ``Loss/train_average``, per-parameter histograms, and
reconstructed audio.  This module reimplements the event-file format from the
wire spec so the framework needs no tensorflow or tensorboard at runtime:

  * TFRecord framing: ``len(u64 LE) | masked_crc32c(len) | payload |
    masked_crc32c(payload)`` with the Castagnoli CRC and TF's mask constant;
  * hand-encoded protobufs for ``Event``, ``Summary``, ``Summary.Value``
    (simple_value / histo / audio), ``HistogramProto``;
  * audio values embed WAV bytes via our own codec (io/wavio.py).

Files written here open in stock TensorBoard (the JAX package's writer is
validated in tests/test_observe.py against the official reader; the port's
writes the same bytes, tests/test_torch_train_e2e.py).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

# ----------------------------------------------------------- crc32c ---------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """Castagnoli CRC — the C++ fast path (``io/native.py``) for large
    payloads (an audio event is megabytes; the Python loop would stall the
    training loop for seconds), the table in Python otherwise and where the
    library is absent."""
    if len(data) > 4096:
        from rawaudiovae_kelsey_tpu_torch.io.native import native_crc32c

        got = native_crc32c(data)
        if got is not None:
            return got
    return _crc32c_py(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------ proto encoding ------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


def _f_packed_doubles(field: int, vs) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vs)
    return _f_bytes(field, payload)


# Summary.Value field numbers (tensorflow/core/framework/summary.proto):
#   tag=1, simple_value=2, image=4, histo=5, audio=6
# Summary: repeated Value value = 1
# Event (tensorflow/core/util/event.proto):
#   wall_time=1 (double), step=2 (int64), file_version=3, summary=5


def _event(payload_field: bytes, step: int = 0,
           wall_time: Optional[float] = None) -> bytes:
    t = time.time() if wall_time is None else wall_time
    ev = _f_double(1, t)
    if step:
        ev += _f_int64(2, step)
    ev += payload_field
    return ev


def _bucket_edges() -> np.ndarray:
    # bucket edges: ±1e-12 · 1.1^k, like tensorboard's default generator —
    # input-independent, built once (histograms log every parameter at
    # every checkpoint cadence)
    limits = [1e-12]
    while limits[-1] < 1e20:
        limits.append(limits[-1] * 1.1)
    limits = np.asarray(limits)
    return np.concatenate([-limits[::-1], [0.0], limits])


_EDGES = _bucket_edges()
_BINS = np.concatenate([[-np.inf], _EDGES, [np.inf]])


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto with tensorboard's standard exponential buckets."""
    values = np.asarray(values, dtype=np.float64).ravel()
    # a diverging run (±inf/NaN params — exactly when histograms matter)
    # must stay renderable: drop NaNs, clip ±inf into the end buckets
    values = values[~np.isnan(values)]
    if values.size == 0:
        values = np.zeros(1)
    values = np.clip(values, -1e150, 1e150)  # keeps sum of squares finite
    edges = _EDGES
    counts, _ = np.histogram(values, bins=_BINS)
    # fold the +inf overflow bin into the last real bucket so
    # sum(bucket) == num
    counts = counts.copy()
    counts[-2] += counts[-1]
    counts = counts[:-1]
    nz = np.nonzero(counts)[0]
    if len(nz):
        lo, hi = nz[0], nz[-1] + 1
    else:
        lo, hi = 0, 1
    bucket_limit = edges[lo:hi]
    bucket = counts[lo:hi]
    msg = _f_double(1, float(values.min()))
    msg += _f_double(2, float(values.max()))
    msg += _f_double(3, float(values.size))
    msg += _f_double(4, float(values.sum()))
    msg += _f_double(5, float(np.square(values).sum()))
    msg += _f_packed_doubles(6, bucket_limit)
    msg += _f_packed_doubles(7, bucket)
    return msg


class EventWriter:
    """Minimal SummaryWriter-compatible event writer."""

    def __init__(self, log_dir: Union[str, Path]):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        import os

        fname = "events.out.tfevents.{:.0f}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid()
        )
        self.path = self.log_dir / fname  # this process's own event file
        self._fh = open(self.path, "ab")
        # records may be appended from the trainer thread and the async
        # checkpoint-boundary worker concurrently; each record is 4 writes
        # that must not interleave or the TFRecord stream tears
        self._lock = threading.Lock()
        self._write_event(_event(_f_str(3, "brain.Event:2")))

    # -- record framing --
    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        with self._lock:
            if self._fh.closed:
                # a straggling boundary-worker write after close() on an
                # exception path: drop it rather than raise over a run
                # that is already unwinding
                return
            self._fh.write(header)
            self._fh.write(struct.pack("<I", _masked_crc(header)))
            self._fh.write(payload)
            self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def _write_event(self, event: bytes) -> None:
        self._write_record(event)

    def _write_summary(self, value_msg: bytes, step: int) -> None:
        summary = _f_bytes(1, value_msg)          # Summary.value
        self._write_event(_event(_f_bytes(5, summary), step=step))

    # -- public API (SummaryWriter-compatible names) --
    def add_scalar(self, tag: str, value: float, step: int = 0) -> None:
        v = _f_str(1, tag) + _f_float(2, float(value))
        self._write_summary(v, step)

    def add_histogram(self, tag: str, values, step: int = 0) -> None:
        v = _f_str(1, tag) + _f_bytes(5, _histogram_proto(np.asarray(values)))
        self._write_summary(v, step)

    def add_audio(self, tag: str, audio, step: int = 0,
                  sample_rate: int = 44100) -> None:
        """audio: 1-D float waveform in [-1, 1] (the reference passed the
        flattened reconstruction, train.py:237)."""
        from rawaudiovae_kelsey_tpu_torch.io.wavio import encode_wav_bytes

        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        wav_bytes = encode_wav_bytes(audio, sample_rate)
        audio_msg = _f_float(1, float(sample_rate))
        audio_msg += _f_int64(2, 1)                 # num_channels
        audio_msg += _f_int64(3, len(audio))        # length_frames
        audio_msg += _f_bytes(4, wav_bytes)         # encoded_audio_string
        audio_msg += _f_str(5, "audio/wav")         # content_type
        v = _f_str(1, tag) + _f_bytes(6, audio_msg)
        self._write_summary(v, step)

    def flush(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()

    def close(self) -> None:
        # flush+close under ONE lock hold (the lock is non-reentrant, and a
        # concurrent worker write must not land between them)
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

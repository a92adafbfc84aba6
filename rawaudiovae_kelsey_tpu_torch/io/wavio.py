"""Pure-NumPy RIFF/WAVE codec.

The reference leaned on three external decoders — ``librosa.load``
(train.py:120, tests.py:30), ``torchaudio.load`` + resample (dataset.py:47-51)
and ``soundfile.write`` (tests.py:41, train.py:233) — none of which exist in
this environment, so the framework ships its own codec.  Supported on read:
PCM u8 / s16 / s24 / s32, IEEE float32 / float64, and WAVE_FORMAT_EXTENSIBLE
wrappers; chunks are walked properly (``fmt ``/``data``/anything else skipped),
so files with LIST/INFO/fact chunks decode fine.  On write: PCM16 or float32.

A copy of the JAX package's ``io/wavio.py`` (pure NumPy, byte-identical
output; ``tests/test_torch_config_io.py`` holds the two together).  The
C++ decode fast path is ``io/native.py``, which falls back to this codec.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(ValueError):
    pass


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode a WAV file.

    Returns ``(samples, sample_rate)`` where ``samples`` is float32 in
    [-1, 1] with shape ``(num_frames, num_channels)``.
    """
    return decode_wav_bytes(Path(path).read_bytes(), name=str(path))


def decode_wav_bytes(data: bytes, name: str = "<bytes>"
                     ) -> Tuple[np.ndarray, int]:
    """Bytes-level decode (HTTP bodies, embedded payloads) — same contract
    as :func:`read_wav`."""
    path = name
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavFormatError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    while pos + 8 <= end:
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            fmt = _parse_fmt(body, path)
        elif cid == b"data":
            payload = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned

    if fmt is None:
        raise WavFormatError(f"{path}: missing fmt chunk")
    if payload is None:
        raise WavFormatError(f"{path}: missing data chunk")

    tag, channels, rate, bits = fmt
    samples = _decode_payload(payload, tag, bits, path)
    if channels > 1:
        samples = samples[: (len(samples) // channels) * channels]
        samples = samples.reshape(-1, channels)
    else:
        samples = samples.reshape(-1, 1)
    return samples, rate


def _parse_fmt(body: bytes, path) -> Tuple[int, int, int, int]:
    if len(body) < 16:
        raise WavFormatError(f"{path}: short fmt chunk")
    tag, channels, rate, _byte_rate, _block_align, bits = struct.unpack_from(
        "<HHIIHH", body, 0
    )
    if tag == WAVE_FORMAT_EXTENSIBLE:
        if len(body) < 40:
            raise WavFormatError(f"{path}: short extensible fmt chunk")
        # SubFormat GUID: first two bytes are the real format tag.
        (tag,) = struct.unpack_from("<H", body, 24)
    if channels < 1:
        raise WavFormatError(f"{path}: invalid channel count {channels}")
    return tag, channels, rate, bits


def _decode_payload(payload: bytes, tag: int, bits: int, path) -> np.ndarray:
    # tolerate truncated files: drop a partial trailing sample rather than
    # crashing in frombuffer ("buffer size must be a multiple of element size")
    item = max(1, bits // 8)
    if len(payload) % item:
        payload = payload[: len(payload) - len(payload) % item]
    if tag == WAVE_FORMAT_PCM:
        if bits == 8:
            x = np.frombuffer(payload, dtype=np.uint8).astype(np.float32)
            return (x - 128.0) / 128.0
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32)
            return x / 32768.0
        if bits == 24:
            n = len(payload) // 3
            raw = np.frombuffer(payload[: n * 3], dtype=np.uint8).reshape(n, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x ^ 0x800000) - 0x800000  # sign-extend 24 bit
            return x.astype(np.float32) / 8388608.0
        if bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float64)
            return (x / 2147483648.0).astype(np.float32)
        raise WavFormatError(f"{path}: unsupported PCM bit depth {bits}")
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            return np.frombuffer(payload, dtype="<f4").astype(np.float32)
        if bits == 64:
            with np.errstate(over="ignore", invalid="ignore"):
                x = np.frombuffer(payload, dtype="<f8").astype(np.float32)
            return np.nan_to_num(x, posinf=1.0, neginf=-1.0)
        raise WavFormatError(f"{path}: unsupported float bit depth {bits}")
    raise WavFormatError(f"{path}: unsupported format tag 0x{tag:04x}")


def write_wav(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    subtype: str = "float32",
) -> None:
    """Encode ``samples`` (float, shape ``(n,)`` or ``(n, channels)``) to WAV.

    ``subtype``: ``"float32"`` (default — matches what ``soundfile.write``
    produced for the reference's float arrays at tests.py:41) or ``"pcm16"``.
    """
    Path(path).write_bytes(encode_wav_bytes(samples, sample_rate, subtype))


def encode_wav_bytes(samples: np.ndarray, sample_rate: int,
                     subtype: str = "float32") -> bytes:
    """Bytes-level encode — same contract as :func:`write_wav`."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    elif samples.ndim != 2:
        raise ValueError("samples must be 1-D or 2-D (frames, channels)")
    return (wav_header_bytes(samples.shape[0], sample_rate,
                             channels=samples.shape[1], subtype=subtype)
            + encode_wav_payload(samples, subtype))


def encode_wav_payload(samples: np.ndarray, subtype: str = "float32") -> bytes:
    """Raw data-chunk bytes for ``samples`` — pair with
    :func:`wav_header_bytes` to write a WAV progressively (the HTTP
    streaming path emits the header once, then one payload per decoded
    chunk).  ``encode_wav_bytes`` is exactly header + payload."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    if subtype == "float32":
        return samples.astype("<f4").tobytes()
    if subtype == "pcm16":
        clipped = np.clip(samples.astype(np.float64), -1.0, 1.0 - 1.0 / 32768)
        return (clipped * 32768.0).round().astype("<i2").tobytes()
    raise ValueError(f"unsupported subtype {subtype!r}")


def wav_header_bytes(n_frames: int, sample_rate: int, channels: int = 1,
                     subtype: str = "float32") -> bytes:
    """Complete RIFF prefix (through the ``data`` chunk size) for a WAV of
    exactly ``n_frames`` sample frames: a streaming writer that knows its
    output length up front sends this first, then payload bytes as they
    are produced."""
    if subtype == "float32":
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
    elif subtype == "pcm16":
        tag, bits = WAVE_FORMAT_PCM, 16
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    data_len = n_frames * block_align
    fmt_body = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits
    )
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        # float WAVs conventionally carry cbSize=0 and a fact chunk
        fmt_body += struct.pack("<H", 0)
        fact = b"fact" + struct.pack("<II", 4, n_frames)
    else:
        fact = b""
    chunks = (
        b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
        + fact
        + b"data" + struct.pack("<I", data_len)
    )
    riff_len = len(b"WAVE") + len(chunks) + data_len
    return b"RIFF" + struct.pack("<I", riff_len) + b"WAVE" + chunks


def to_mono(samples: np.ndarray, mode: str = "mean") -> np.ndarray:
    """Collapse ``(frames, channels)`` to 1-D mono.

    ``mode="mean"`` averages channels (librosa.load behavior — the eager
    ingest path, train.py:120); ``mode="first"`` keeps channel 0 (the
    streaming path, dataset.py:54-55).
    """
    if samples.ndim == 1:
        return samples
    if samples.shape[1] == 1:
        return samples[:, 0]
    if mode == "mean":
        return samples.mean(axis=1, dtype=np.float32)
    if mode == "first":
        return np.ascontiguousarray(samples[:, 0])
    raise ValueError(f"unknown mono mode {mode!r}")


def wav_info(path: Union[str, Path]) -> Tuple[int, int, int, int]:
    """Header-only inspection: (num_frames, channels, sample_rate, bits).

    Reads only chunk headers (seeking over payloads), so sizing a 100 GB
    folder costs KBs of I/O per file — unlike :func:`read_wav`, nothing is
    decoded."""
    path = Path(path)
    fsize = path.stat().st_size
    with open(path, "rb") as fh:
        head = fh.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise WavFormatError(f"{path}: not a RIFF/WAVE file")
        riff_end = min(fsize, 8 + struct.unpack_from("<I", head, 4)[0])
        fmt = None
        payload_len = 0
        pos = 12
        while pos + 8 <= riff_end:
            fh.seek(pos)
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            (csize,) = struct.unpack_from("<I", hdr, 4)
            if cid == b"fmt ":
                fmt = _parse_fmt(fh.read(min(csize, 64)), path)
            elif cid == b"data":
                payload_len = min(csize, fsize - pos - 8)
            pos += 8 + csize + (csize & 1)
    if fmt is None:
        raise WavFormatError(f"{path}: missing fmt chunk")
    tag, channels, rate, bits = fmt
    # same format gate as the decoders: a compressed file (e.g. ADPCM)
    # would otherwise yield a garbage frame count that poisons header-only
    # consumers (validate_dataset fast scan, stream frame estimates)
    if tag not in (1, 3):
        raise WavFormatError(f"{path}: unsupported format tag {tag}")
    if (tag == 1 and bits not in (8, 16, 24, 32)) or \
            (tag == 3 and bits not in (32, 64)):
        raise WavFormatError(f"{path}: unsupported bit depth {bits}")
    frame_bytes = max(1, channels * (bits // 8))
    return payload_len // frame_bytes, channels, rate, bits

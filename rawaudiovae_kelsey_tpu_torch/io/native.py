"""ctypes binding to libtpuaudio (``native/tpuaudio.cc``) with transparent
fallback to the pure-NumPy codec — the JAX package's ``io/native.py``,
ported.

``decode_mono(path, mono)`` is the single entry point: it returns
``(mono_float32_wave, native_sample_rate)`` exactly like
``wavio.read_wav`` + ``wavio.to_mono``, but does the byte→float conversion
and channel mixdown in one C++ pass.  If the library cannot be built or
loaded, the NumPy path is used — the samples are the same
(tests/test_torch_native.py); ``native_available()`` says which codec runs.

The port builds its own copy of the library at first use, from the
checkout's ``native/tpuaudio.cc`` with ``g++ -O3 -fPIC -shared
-std=c++17``, into the git-ignored ``build/native/`` beside the package
(the directory ``ops/_build.py`` builds the kernels in).  No
``-march=native``: a library built on one host must not fault on another.
The file's name carries a hash of the source and the flags, so an edited
source rebuilds.  It never writes under ``native/`` and never loads the
committed ``native/libtpuaudio.so``.  A failed build is remembered for the
process: later calls take the NumPy codec at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tpuaudio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def library_path() -> Optional[Path]:
    """Where the build of the checkout's source lies (or will), named by
    the hash of the source and the flags; ``None`` without a source."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtpuaudio_{digest.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the source (or reuse the cached build) → its path; ``None``
    when there is no source or no compiler, or the compiler failed."""
    out = library_path()
    if out is None:
        return None
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        tmp.rename(out)  # atomic: a concurrent loader never sees a torn file
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.ta_abi_version.restype = ctypes.c_int
            if lib.ta_abi_version() != ABI_VERSION:
                return None
            lib.ta_wav_info.restype = ctypes.c_int
            lib.ta_wav_info.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.ta_decode_mono.restype = ctypes.c_int64
            lib.ta_decode_mono.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.ta_crc32c.restype = ctypes.c_uint32
            lib.ta_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            _lib = lib
        except (OSError, AttributeError):
            # AttributeError: a library missing a symbol — the contract is
            # the fallback to the numpy codec, not a crash
            _lib = None
        return _lib


def native_available() -> bool:
    """Whether ``decode_mono`` runs the C++ codec (else the NumPy one)."""
    return _load() is not None


def decode_mono(path, mono: str = "mean",
                force_fallback: bool = False) -> Tuple[np.ndarray, int]:
    """Decode a wav file to (mono float32 wave, native sample rate)."""
    from rawaudiovae_kelsey_tpu_torch.io.wavio import (
        decode_wav_bytes,
        read_wav,
        to_mono,
    )

    if mono not in ("mean", "first"):
        raise ValueError(f"unknown mono mode {mono!r}")
    lib = None if force_fallback else _load()
    if lib is None:
        samples, sr = read_wav(path)
        return to_mono(samples, mode=mono), sr
    data = Path(path).read_bytes()
    channels, rate, bits = (ctypes.c_int32() for _ in range(3))
    n_frames = ctypes.c_int64()
    rc = lib.ta_wav_info(data, len(data), ctypes.byref(channels),
                         ctypes.byref(rate), ctypes.byref(bits),
                         ctypes.byref(n_frames))
    if rc == 0:
        out = np.empty(n_frames.value, dtype=np.float32)
        got = lib.ta_decode_mono(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames.value, 1 if mono == "first" else 0)
        if got >= 0:
            return out[:got], int(rate.value)
    # the C++ codec refused the file: the NumPy codec decodes the bytes
    # already in memory (it raises a WavFormatError naming the file)
    samples, sr = decode_wav_bytes(data, name=str(path))
    return to_mono(samples, mode=mono), sr


def native_crc32c(data: bytes) -> Optional[int]:
    """Castagnoli CRC via the C++ library, or ``None`` when unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.ta_crc32c(data, len(data)))

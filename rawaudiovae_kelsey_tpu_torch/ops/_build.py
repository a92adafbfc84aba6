"""Build the package's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, at first use, in ``build/kernels/`` beside the package
(git-ignored).  The library's name carries a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the cached
file.  A build failure raises: nothing runs without the kernels.  Sources
in the package are the only input; no PyTorch headers are compiled, which
keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_L = ctypes.c_longlong
# C entry point → argument types (pointers and the stream as c_void_p: a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "rvk_encoder_fwd": [_P] * 10 + [_I] * 5 + [_P],
    "rvk_decoder_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "rvk_quantized_decoder_fwd": [_P] * 9 + [_I] * 4 + [_P],
    "rvk_grad_accum": [_P] * 4 + [_I] * 4 + [_P],
    "rvk_grad_accum2": [_P] * 7 + [_I] * 4 + [_P],
    "rvk_enc_bwd_dw1": [_P] * 9 + [_I] * 5 + [_P],
    "rvk_dec_bwd_fused": [_P] * 9 + [_I] * 5 + [_P],
    "rvk_enc_bwd_full": [_P] * 13 + [_I] * 5 + [_P],
    "rvk_dec_bwd_full": [_P] * 11 + [_I] * 5 + [_P],
    "rvk_loss_sums": [_P] * 6 + [_L] * 2 + [_I] * 2 + [_P],
    "rvk_matmul_nt": [_P] * 3 + [_I] * 4 + [_P],
    "rvk_matmul_nt_mask": [_P] * 4 + [_I] * 4 + [_P],
    "rvk_matmul_nt2_mask": [_P] * 6 + [_I] * 4 + [_P],
    "rvk_reparameterize": [_U] * 2 + [_P] * 3 + [_I] * 2 + [_P],
    "rvk_philox_words": [_U] * 2 + [_P] + [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "toolkit is needed to build the package's kernels")
    return str(path)


def build() -> Path:
    """Compile ``csrc/*.cu`` (or reuse the cached library) → its path.
    The compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills per kernel) is kept beside it as ``<library>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"librvk_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{p.stem}.{tag}.o") for p in sources]
    # one compiler per source, all at once: the templates of each file
    # compile in parallel; each writes its own report
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{out.name}.{tag}")
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"kernel build failed (nvcc exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel link failed (nvcc exit {proc.returncode}):\n"
                f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    tmp.rename(out)  # atomic: a concurrent loader never sees a torn file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rvk_error_string.argtypes = [ctypes.c_int]
            lib.rvk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream.  Tensor
    arguments pass as device pointers, ints as ints; the caller has checked
    device, dtype, shape and contiguity.  Raises if the launch failed."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        rc = getattr(lib, name)(*cargs, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} "
            f"({lib.rvk_error_string(rc).decode()})")

"""Build the package's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into ONE shared library with a plain
C interface, at first use, in ``build/kernels/`` beside the package
(git-ignored).  The library's name carries a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the cached
file.  A build failure raises: nothing runs without the kernels.  The
failure is remembered for that hash, so every later call in the process
raises it again at once instead of running the compiler again; an edited
source has another hash and builds.  Sources in the package are the only
input; no PyTorch headers are compiled, which keeps the build to seconds.
The ranks of a multi-GPU run on one host build once: a lock file beside
the build directory lets the first compile and the others load its file.
"""

from __future__ import annotations

import ctypes
import fcntl
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
_L, _F = ctypes.c_longlong, ctypes.c_float
# C entry point → argument types (pointers and the stream as c_void_p: a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "rvk_encoder_fwd": [_P] * 11 + [_I] * 10 + [_P],
    "rvk_decoder_fwd": [_P] * 8 + [_I] * 10 + [_P],
    "rvk_encoder_fwd_partial": [_P] * 9 + [_I] * 10 + [_P],
    "rvk_decoder_fwd_partial": [_P] * 7 + [_I] * 10 + [_P],
    "rvk_encoder_fwd3": [_P] * 11 + [_I] * 7 + [_P],
    "rvk_decoder_fwd3": [_P] * 8 + [_I] * 7 + [_P],
    "rvk_linear_partial": [_P] * 4 + [_I] * 8 + [_P],
    "rvk_quantized_decoder_fwd": [_P] * 10 + [_I] * 9 + [_P],
    "rvk_grad_accum": [_P] * 5 + [_I] * 7 + [_P],
    "rvk_grad_accum2": [_P] * 8 + [_I] * 7 + [_P],
    "rvk_enc_bwd_dw1": [_P] * 10 + [_I] * 9 + [_P],
    "rvk_dec_bwd_fused": [_P] * 10 + [_I] * 10 + [_P],
    "rvk_enc_bwd_full": [_P] * 15 + [_I] * 12 + [_P],
    "rvk_dec_bwd_full": [_P] * 13 + [_I] * 13 + [_P],
    "rvk_grad_accum3": [_P] * 6 + [_I] * 6 + [_P],
    "rvk_grad_accum2_3": [_P] * 9 + [_I] * 6 + [_P],
    "rvk_enc_bwd_dw1_3": [_P] * 11 + [_I] * 8 + [_P],
    "rvk_dec_bwd_fused3": [_P] * 11 + [_I] * 9 + [_P],
    "rvk_split_hi_lo": [_P] * 5 + [_I] * 3 + [_P],
    "rvk_loss_sums": [_P] * 6 + [_L] * 2 + [_I] * 3 + [_P],
    "rvk_loss_grads": [_P] * 9 + [_L] * 2 + [_F] * 3 + [_I] * 3 + [_P],
    "rvk_matmul_nt": [_P] * 3 + [_I] * 6 + [_P],
    "rvk_matmul_nt_mask": [_P] * 4 + [_I] * 6 + [_P],
    "rvk_matmul_nt2_mask": [_P] * 6 + [_I] * 6 + [_P],
    "rvk_matmul_nt3": [_P] * 4 + [_I] * 5 + [_P],
    "rvk_matmul_nt_mask3": [_P] * 5 + [_I] * 5 + [_P],
    "rvk_matmul_nt2_mask3": [_P] * 7 + [_I] * 5 + [_P],
    "rvk_reparameterize": [_U] * 2 + [_P] * 3 + [_I] * 2 + [_P],
    "rvk_philox_words": [_U] * 2 + [_P] + [_I] * 2 + [_P],
    "rvk_linear_fwd": [_P] * 4 + [_I] * 7 + [_P],
    "rvk_linear_ksplit_fwd": [_P] * 5 + [_I] * 9 + [_P],
    "rvk_toeplitz_fwd": [_P] * 5 + [_I] * 16 + [_P],
    "rvk_dw_fused": [_P] * 6 + [_I] * 8 + [_P],
    "rvk_dx_fused": [_P] * 4 + [_I] * 7 + [_P],
    "rvk_leaf_update": [_P] * 6 + [_L] + [_F] * 6 + [_P],
    "rvk_adam_tree": [_P] * 7 + [_I] + [_P] * 2 + [_F] * 8 + [_P],
    "rvk_snake_fwd": [_P] * 4 + [_I] * 6 + [_P],
    "rvk_snake_bwd": [_P] * 9 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# the sources' hash → the error its build raised, raised again by library()
_failed: dict = {}
# entry point name → its bound ctypes function, filled when the library
# loads: a launch then costs one dict lookup, not an attribute walk
_entry: dict = {}
# the raw cudaStream_t of a device's current stream, as an int, without
# building a torch.cuda.Stream object (the public call builds one); a build
# of torch without CUDA has none, and never launches
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def source_digest() -> str:
    """The hash of the sources and the flags that names the library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (or reuse the cached library) → its path.
    The compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills per kernel) is kept beside it as ``<library>.log``."""
    out = BUILD_DIR / f"librvk_{source_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # ranks of one host (the train command's, torchrun's) build once: the
    # first takes the lock and compiles, the others wait and load its file
    with open(BUILD_DIR.with_name(BUILD_DIR.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    sources = sorted(CSRC.glob("*.cu"))
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  A build that failed
    is not run again for the same sources: the call raises its error."""
    global _lib
    with _lock:
        if _lib is None:
            digest = source_digest()
            if digest in _failed:
                raise _failed[digest]
            try:
                path = build()
            except RuntimeError as err:
                _failed[digest] = err
                raise
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entry[name] = fn
            lib.rvk_error_string.argtypes = [ctypes.c_int]
            lib.rvk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream.  Tensor
    arguments pass as device pointers, ints and floats as they are (a float
    is rounded to the fp32 the entry point takes); the caller has checked
    device, dtype, shape and contiguity.  Raises if the launch failed.

    The entry points launch on the calling thread's current device: it is
    switched to ``device`` only where it is another (a ``device`` without
    an index is the current one)."""
    fn = _entry.get(name)
    if fn is None:
        library()
        fn = _entry[name]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    if index == current:
        rc = fn(*cargs, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*cargs, _raw_stream(index))
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} "
            f"({library().rvk_error_string(rc).decode()})")

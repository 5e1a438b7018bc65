"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
headers, so ``nvcc`` compiles them in seconds into a shared library that is
loaded with ``ctypes``; the Python wrappers pass device pointers and the
current stream. The library is built from the sources in the checkout at
first use, into ``build/torch_kernels/`` at the repository root, under a
name that hashes the sources and flags, so an edited source is rebuilt.

Nothing here runs at import: the build happens only when a CUDA tensor first
reaches a kernel (or a caller asks for :func:`library`). A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "modal_rollout.cu",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_i64 = ctypes.c_int64
_c_dbl = ctypes.c_double

# Argument types of the extern "C" functions in csrc/modal_rollout.cu.
_SIGNATURES = {
    "modal_steps_launch": [_c_int, _c_int, _c_i64, _c_int, _c_int]
    + [_c_ptr] * 7 + [_c_dbl] * 5 + [_c_ptr],
    "modal_frames_launch": [_c_int, _c_int, _c_i64, _c_int, _c_int, _c_int]
    + [_c_ptr] * 6 + [_c_dbl] * 5 + [_c_ptr],
    "affine_steps_launch": [_c_int, _c_i64, _c_int, _c_int] + [_c_ptr] * 9,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    """Path of the built library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"modal_rollout_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources with nvcc (if not built yet); returns the library path.

    The compiler's output (including ``-Xptxas=-v`` register and spill
    counts) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
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
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")

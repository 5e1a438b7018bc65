"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
headers, so ``nvcc`` compiles each in seconds into a shared library that is
loaded with ``ctypes``; the Python wrappers pass device pointers and the
current stream. A library is built from its source in the checkout at
first use, into ``build/torch_kernels/`` at the repository root, under a
name that hashes the source and flags, so an edited source is rebuilt.
:func:`build_all` starts one ``nvcc`` per source, all at once.

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
import time

import torch
import torch.autograd.forward_ad as fwAD

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# One shared library per source, built by its own nvcc process.
SOURCES = {
    "modal_rollout": CSRC / "modal_rollout.cu",
    "rom_rollout": CSRC / "rom_rollout.cu",
    "btd_solve": CSRC / "btd_solve.cu",
    "fused_rollout": CSRC / "fused_rollout.cu",
    "roofline": CSRC / "roofline.cu",
}
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
_c_fptr = ctypes.POINTER(ctypes.c_float)

# Argument types of the extern "C" functions of each source.
_SIGNATURES = {
    "modal_rollout": {
        "modal_steps_launch": [_c_int, _c_int, _c_i64, _c_int, _c_int]
        + [_c_ptr] * 7 + [_c_dbl] * 5 + [_c_ptr],
        "modal_frames_launch": [_c_int, _c_int, _c_int, _c_i64, _c_int, _c_int, _c_int]
        + [_c_ptr] * 8 + [_c_dbl] * 5 + [_c_ptr],
        "modal_frames_envs": [_c_i64, _c_int],
        "affine_steps_launch": [_c_int, _c_i64, _c_int, _c_int] + [_c_ptr] * 9,
        "affine_drive_launch": [_c_int, _c_i64, _c_int, _c_int] + [_c_ptr] * 13,
        "affine_frames_launch": [_c_int, _c_i64, _c_int, _c_int] + [_c_ptr] * 11,
    },
    "rom_rollout": {
        "rom_alpha_point_launch": [_c_int] * 2 + [_c_ptr] * 5 + [_c_fptr, _c_ptr],
        "rom_tensor_map": [_c_ptr, _c_ptr, _c_int, _c_int, _c_i64],
        "rom_expand_launch": [_c_int] * 3 + [_c_ptr, _c_i64] + [_c_ptr] * 3
        + [_c_i64, _c_ptr],
        "rom_correction_window_launch": [_c_int] * 2 + [_c_ptr, _c_i64]
        + [_c_ptr] * 2 + [_c_i64, _c_ptr],
        "rom_correction_gathered_launch": [_c_int] * 2 + [_c_ptr, _c_i64]
        + [_c_ptr] * 2 + [_c_i64, _c_ptr],
        "rom_project_launch": [_c_int] * 4 + [_c_ptr, _c_i64] + [_c_ptr] * 4,
        "rom_update_launch": [_c_int] * 3 + [_c_ptr] * 9 + [_c_int]
        + [_c_ptr] * 3 + [_c_fptr, _c_ptr],
        "rom_newton_dense_launch": [_c_int] * 3 + [_c_ptr] * 9 + [_c_i64, _c_int]
        + [_c_ptr] * 3 + [_c_fptr, _c_ptr],
        "rom_expand_f32_launch": [_c_int] * 3 + [_c_ptr, _c_i64] + [_c_ptr] * 2
        + [_c_i64, _c_ptr],
        "rom_project_f32_launch": [_c_int] * 4 + [_c_ptr, _c_i64] + [_c_ptr] * 3,
    },
    "btd_solve": {
        "btd_solve_launch": [_c_int] * 3 + [_c_i64] * 2 + [_c_ptr] * 5,
        "btd_solve_adjoint_launch": [_c_int] * 3 + [_c_i64] * 3 + [_c_ptr] * 8,
        "btd_solve_adjoint_geometry": [_c_int, _c_int],
    },
    "fused_rollout": {
        "fused_gen_alpha_launch": [_c_int] * 6 + [_c_dbl] * 9 + [_c_ptr] * 9,
        "fused_gen_alpha_geometry": [_c_int] * 3 + [ctypes.POINTER(_c_int)],
    },
    "roofline": {
        "fma_chain_launch": [_c_i64, _c_int, ctypes.c_float] + [_c_ptr] * 3,
    },
}

_lock = threading.Lock()
_libs = {}
# Wall seconds of each source's nvcc in the last build_all (0.0: already built).
build_seconds = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> pathlib.Path:
    """Path of the built library of source ``name`` for the current source,
    the headers beside it and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], *sorted(CSRC.glob("*.h"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless it is built; ``(proc, tmp, out, cmd)``."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, cmd


def _finish(job) -> None:
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file


def build(name: str) -> pathlib.Path:
    """Compile source ``name`` with nvcc (if not built yet); returns the
    library path. The compiler's output (including ``-Xptxas=-v`` register
    and spill counts) is kept beside the library as ``<name>.log``."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return library_path(name)


def build_all() -> dict:
    """Build every source at once, one nvcc process each; returns
    ``{name: library path}``. A script that drives every kernel (such as
    ``chip_smoke.py``, which runs under a fixed time limit) calls it first, so
    its build takes as long as the slowest source, not the sum of all. Each
    source's wall seconds, from the common start to its nvcc's exit (0.0 for
    a library already built), go to :data:`build_seconds`."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    build_seconds.clear()
    errors = []

    def finish(name, job):
        try:
            _finish(job)
        except RuntimeError as exc:
            errors.append(str(exc))
        build_seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=finish, args=item)
               for item in jobs.items() if item[1] is not None]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build_seconds.update({name: 0.0 for name, job in jobs.items() if job is None})
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of source ``name``, built on first call."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _derivative_asked(t) -> bool:
    """Whether ``t`` carries a reverse-mode graph (under grad mode), a
    forward-mode tangent or a ``torch.func`` transform's wrapper."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.requires_grad and torch.is_grad_enabled():
        return True
    if fwAD._current_level >= 0 and fwAD.unpack_dual(t).tangent is not None:
        return True
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a caller asks kernel ``name`` for a derivative.

    A kernel launched through raw device pointers returns a tensor with no
    ``grad_fn`` and no tangent, so a gradient through it would silently
    lose the kernel's contribution. The kernels without a backward call this
    on their tensor inputs before launching: with grad mode on and an input
    that requires grad, or an input with a forward-mode tangent, they raise
    instead (there is no switch to the plain version). ``btd_solve`` has a
    backward and a tangent of its own (``btd_solve.py``)."""
    grad, tangents = torch.is_grad_enabled(), fwAD._current_level >= 0
    if not (grad or tangents):
        return
    # Cheap checks only: a ROM span calls this thousands of times. (A
    # torch.func transform's wrapper has no storage: its launch raises.)
    if any(isinstance(t, torch.Tensor) and (
            (grad and t.requires_grad)
            or (tangents and fwAD.unpack_dual(t).tangent is not None)) for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no derivative; an input requires grad or "
            "carries a tangent (run it under torch.no_grad() on detached inputs, or "
            "differentiate the plain PyTorch version on CPU tensors)"
        )

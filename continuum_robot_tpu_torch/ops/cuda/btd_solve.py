"""Block-tridiagonal solve: CUDA on the card, the plain sweep elsewhere.

Counterpart of ``continuum_robot_tpu/ops/pallas/btd_solve.py``. The TPU
kernel ``btd_solve_pallas`` becomes the hand-written CUDA kernel of
``csrc/btd_solve.cu``; its plain PyTorch version is
:func:`continuum_robot_tpu_torch.ops.banded.btd_solve`, which sums every
3x3 product in the kernel's order, so the two agree bit for bit.

:func:`btd_solve` dispatches by the device of the right-hand sides: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (building
it on first use) or raises. ``btd_solve.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from .. import banded
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

btd_solve_plain = banded.btd_solve


def btd_solve(factors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``T x = rhs`` for a batch of right-hand sides, one shared ``T``.

    Args:
      factors: ``(dinv (N, 3, 3), lw (N-1, 3, 3), upper (N-1, 3, 3))`` from
        :func:`~continuum_robot_tpu_torch.ops.banded.btd_factor` (unbatched),
        on ``rhs``'s device and in its dtype.
      rhs: ``(..., N, 3)`` right-hand sides (every leading axis is a batch
        axis; the kernel sees the contiguous ``(B, 3N)`` rows).

    Returns the ``(..., N, 3)`` solutions. CPU tensors run the plain
    version; CUDA tensors (float32 or float64) one kernel launch.
    """
    dev = rhs.device
    if dev.type == "cpu":
        return banded.btd_solve(factors, rhs)
    if dev.type != "cuda":
        raise ValueError(f"btd_solve takes CPU or CUDA tensors, got {dev}")
    if rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA btd_solve takes float32/float64, got {rhs.dtype}")
    n = rhs.shape[-2]
    dinv, lw, up = factors
    want = ((n, 3, 3), (n - 1, 3, 3), (n - 1, 3, 3))
    if rhs.shape[-1] != 3 or tuple(tuple(f.shape) for f in factors) != want:
        raise ValueError(
            f"btd_solve needs rhs (..., N, 3) and unbatched factors {want}, got rhs "
            f"{tuple(rhs.shape)} and factors {[tuple(f.shape) for f in factors]}"
        )
    if any(f.device != dev or f.dtype != rhs.dtype for f in factors):
        raise ValueError("btd_solve factors must be on rhs's device, in its dtype")
    r = rhs.contiguous().reshape(-1, 3 * n)
    dinv, lw, up = (f.contiguous() for f in factors)
    out = torch.empty_like(r)
    if r.shape[0] and n:
        lib = _build.library("btd_solve")
        with torch.cuda.device(dev):
            rc = lib.btd_solve_launch(
                _DTYPE_CODES[rhs.dtype], r.shape[0], n, dinv.data_ptr(), lw.data_ptr(),
                up.data_ptr(), r.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "btd_solve")
        btd_solve.launches += 1
    return out.reshape(rhs.shape)


btd_solve.launches = 0

KERNELS = (btd_solve,)


def reset_launch_counts() -> None:
    """Set the kernel wrapper's launch count to 0."""
    btd_solve.launches = 0

"""Block-tridiagonal solve: CUDA on the card, the plain sweep elsewhere.

Counterpart of ``continuum_robot_tpu/ops/pallas/btd_solve.py``. The TPU
kernel ``btd_solve_pallas`` becomes the hand-written CUDA kernel of
``csrc/btd_solve.cu``; its plain PyTorch version is
:func:`continuum_robot_tpu_torch.ops.banded.btd_solve`, which sums every
3x3 product in the kernel's order, so the two agree bit for bit.

:func:`btd_solve` dispatches by the device of the right-hand sides: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (building
it on first use) or raises. ``btd_solve.launches`` counts the launches.

The kernel moves rows and factors with 16-byte bulk copies. It reads rows
whose pitch is a multiple of 16 bytes (the implicit operator pads its
right-hand sides to a multiple of :data:`PITCH` elements; other rows are
copied into such a buffer) and returns its solutions as a view of such a
buffer. Its factors are packed once into 16-byte aligned blocks
(:func:`pack_factors`, :class:`BTDFactors`).
"""

from __future__ import annotations

import torch

from .. import banded
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
PITCH = 4  # rows the kernel reads and writes: a multiple of 4 elements

btd_solve_plain = banded.btd_solve


def padded_width(n: int) -> int:
    """``n`` rounded up to a multiple of :data:`PITCH`."""
    return -(-n // PITCH) * PITCH


def _blocks(m: torch.Tensor) -> torch.Tensor:
    """``(n, 3, 3)`` blocks as ``(n, 12)``: each row padded by a zero."""
    return torch.nn.functional.pad(m, (0, 1)).reshape(m.shape[0], 12)


class BTDFactors(tuple):
    """Block-Thomas factors ``(dinv, lw, upper)`` (a tuple, for the plain
    sweep) with the kernel's packed copies: ``fwd (N, 12)``, node ``n``'s
    forward multiplier ``lw[n-1]`` (zero at node 0), and ``bwd (N, 24)``,
    ``dinv[n]`` then ``upper[n]`` (zero at node N-1); each 3x3 block as
    three rows of four, the fourth zero. The same nine values per block."""

    def __new__(cls, factors):
        self = super().__new__(cls, tuple(factors))
        dinv, lw, up = self
        zero = dinv.new_zeros((1, 3, 3))
        self.fwd = _blocks(torch.cat([zero, lw])).contiguous()
        self.bwd = torch.cat([_blocks(dinv), _blocks(torch.cat([up, zero]))], 1).contiguous()
        return self


def pack_factors(factors) -> BTDFactors:
    """The factors with the kernel's packed copies (once per upload)."""
    return factors if isinstance(factors, BTDFactors) else BTDFactors(factors)


def _kernel_rows(r: torch.Tensor) -> bool:
    """Whether the kernel can read ``(B, 3N)`` rows ``r`` in place: unit
    column stride, a pitch of a multiple of :data:`PITCH`, a 16-byte aligned
    base, and storage for each row's width rounded up to :data:`PITCH`."""
    rows, width = r.shape
    if r.stride(1) != 1 or r.data_ptr() % 16 or (rows > 1 and r.stride(0) % PITCH):
        return False
    end = r.storage_offset() + (rows - 1) * r.stride(0) + padded_width(width)
    return end * r.element_size() <= r.untyped_storage().nbytes()


def btd_solve(factors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``T x = rhs`` for a batch of right-hand sides, one shared ``T``.

    Args:
      factors: ``(dinv (N, 3, 3), lw (N-1, 3, 3), upper (N-1, 3, 3))`` from
        :func:`~continuum_robot_tpu_torch.ops.banded.btd_factor` (unbatched),
        on ``rhs``'s device and in its dtype; a :class:`BTDFactors` carries
        the kernel's packed copies (otherwise they are packed per call).
      rhs: ``(..., N, 3)`` right-hand sides (every leading axis is a batch
        axis; the kernel sees ``(B, 3N)`` rows, in place when their pitch
        is a multiple of :data:`PITCH` elements).

    Returns the ``(..., N, 3)`` solutions. CPU tensors run the plain
    version; CUDA tensors (float32 or float64) one kernel launch, whose
    result is a view of rows padded to :data:`PITCH`.
    """
    dev = rhs.device
    if dev.type == "cpu":
        return banded.btd_solve(factors, rhs)
    if dev.type != "cuda":
        raise ValueError(f"btd_solve takes CPU or CUDA tensors, got {dev}")
    if rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA btd_solve takes float32/float64, got {rhs.dtype}")
    n = rhs.shape[-2]
    want = ((n, 3, 3), (n - 1, 3, 3), (n - 1, 3, 3))
    if rhs.shape[-1] != 3 or tuple(tuple(f.shape) for f in factors) != want:
        raise ValueError(
            f"btd_solve needs rhs (..., N, 3) and unbatched factors {want}, got rhs "
            f"{tuple(rhs.shape)} and factors {[tuple(f.shape) for f in factors]}"
        )
    if any(f.device != dev or f.dtype != rhs.dtype for f in factors):
        raise ValueError("btd_solve factors must be on rhs's device, in its dtype")
    r = rhs.reshape(-1, 3 * n)
    if not _kernel_rows(r):
        r = torch.empty((r.shape[0], padded_width(3 * n)), dtype=r.dtype,
                        device=dev)[:, :3 * n].copy_(r)
    out = torch.empty((r.shape[0], padded_width(3 * n)), dtype=r.dtype,
                      device=dev)[:, :3 * n]
    if r.shape[0] and n:
        packed = pack_factors(factors)
        lib = _build.library("btd_solve")
        with torch.cuda.device(dev):
            rc = lib.btd_solve_launch(
                _DTYPE_CODES[rhs.dtype], r.shape[0], n,
                r.stride(0) if r.shape[0] > 1 else padded_width(3 * n), out.stride(0),
                packed.fwd.data_ptr(), packed.bwd.data_ptr(), r.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "btd_solve")
        btd_solve.launches += 1
    return out.reshape(rhs.shape)


btd_solve.launches = 0

KERNELS = (btd_solve,)


def reset_launch_counts() -> None:
    """Set the kernel wrapper's launch count to 0."""
    btd_solve.launches = 0

"""Block-tridiagonal solve and its adjoint: CUDA on the card, plain sweeps elsewhere.

Counterpart of ``continuum_robot_tpu/ops/pallas/btd_solve.py``. The TPU
kernel ``btd_solve_pallas`` becomes the hand-written CUDA kernel of
``csrc/btd_solve.cu``; its plain PyTorch version is
:func:`continuum_robot_tpu_torch.ops.banded.btd_solve`, which sums every
3x3 product in the kernel's order, so the two agree bit for bit.

:func:`btd_solve` dispatches by the device of the right-hand sides: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (building
it on first use) or raises. ``btd_solve.launches`` counts the launches.
On the card the solve is a ``torch.autograd.Function`` (:class:`_Solve`):
its backward launches the second kernel of the source,
:func:`btd_solve_adjoint` (no TPU counterpart: the JAX package
differentiates the plain jnp scans), whose plain version is
``banded.btd_solve_adjoint``; its forward-mode tangent is one more
``btd_solve`` launch. ``btd_solve_adjoint.launches`` counts its launches.

Both kernels move rows and factors with 16-byte bulk copies. They read rows
whose pitch is a multiple of 16 bytes (the implicit operator pads its
right-hand sides to a multiple of :data:`PITCH` elements; other rows are
copied into such a buffer; the adjoint reads a cotangent shared by the
whole batch as one row of pitch 0) and return their results as views of
such buffers. The factors are packed once into 16-byte aligned blocks
(:func:`pack_factors`, :class:`BTDFactors`).
"""

from __future__ import annotations

import math

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
    three rows of four, the fourth zero. The same nine values per block.

    The packed copies are made once, at the first launch (or at the first
    read of ``fwd`` / ``bwd``), from the factors' values and outside any
    graph: a launch reads values only, and the derivatives go to the
    factors themselves (:class:`_Solve`)."""

    def __new__(cls, factors):
        self = super().__new__(cls, tuple(factors))
        self._packed = None
        return self

    def packed(self, dinv=None, lw=None, up=None):
        """``(fwd, bwd)``, packed from ``(dinv, lw, up)`` (default: this
        tuple's) on first use."""
        if self._packed is None:
            if dinv is None:
                dinv, lw, up = self
            with torch.no_grad():
                dinv, lw, up = (t.detach() for t in (dinv, lw, up))
                zero = dinv.new_zeros((1, 3, 3))
                fwd = _blocks(torch.cat([zero, lw])).contiguous()
                bwd = torch.cat([_blocks(dinv), _blocks(torch.cat([up, zero]))], 1).contiguous()
            self._packed = (fwd, bwd)
        return self._packed

    @property
    def fwd(self) -> torch.Tensor:
        return self.packed()[0]

    @property
    def bwd(self) -> torch.Tensor:
        return self.packed()[1]


def pack_factors(factors) -> BTDFactors:
    """The factors as a :class:`BTDFactors`, which packs them for the
    kernel once."""
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


def _check(factors, rhs: torch.Tensor, what: str) -> None:
    """The CUDA kernels' contract: float32/float64 ``(..., N, 3)`` rows and
    unbatched factors on their device, in their dtype."""
    dev = rhs.device
    if rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA {what} takes float32/float64, got {rhs.dtype}")
    n = rhs.shape[-2]
    want = ((n, 3, 3), (n - 1, 3, 3), (n - 1, 3, 3))
    if rhs.shape[-1] != 3 or tuple(tuple(f.shape) for f in factors) != want:
        raise ValueError(
            f"{what} needs rhs (..., N, 3) and unbatched factors {want}, got rhs "
            f"{tuple(rhs.shape)} and factors {[tuple(f.shape) for f in factors]}"
        )
    if any(f.device != dev or f.dtype != rhs.dtype for f in factors):
        raise ValueError(f"{what} factors must be on rhs's device, in its dtype")


def _kernel_operand(t: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., N, 3)`` ``t`` as the ``(B, 3N)`` rows the kernels read: a view
    where :func:`_kernel_rows` allows it, else a copy into rows padded to
    :data:`PITCH` (one copy, whatever ``t``'s strides)."""
    try:
        r = t.view(-1, 3 * n)
    except RuntimeError:  # not one pitch apart
        r = None
    if r is not None and _kernel_rows(r):
        return r
    rows = math.prod(t.shape[:-2])
    buf = torch.empty((rows, padded_width(3 * n)), dtype=t.dtype, device=t.device)[:, :3 * n]
    buf.view(t.shape).copy_(t)
    return buf


def _pointers(args) -> list:
    """A launch's arguments with each tensor replaced by its data pointer."""
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def _launch_solve(packed, rhs: torch.Tensor) -> torch.Tensor:
    """One ``btd_solve`` launch on plain (graph-free) tensors."""
    dev = rhs.device
    n = rhs.shape[-2]
    r = _kernel_operand(rhs, n)
    out = torch.empty((r.shape[0], padded_width(3 * n)), dtype=r.dtype,
                      device=dev)[:, :3 * n]
    if r.shape[0] and n:
        fwd, bwd = packed
        lib = _build.library("btd_solve")
        with torch.cuda.device(dev):
            rc = lib.btd_solve_launch(
                _DTYPE_CODES[rhs.dtype], r.shape[0], n,
                r.stride(0) if r.shape[0] > 1 else padded_width(3 * n), out.stride(0),
                fwd.data_ptr(), bwd.data_ptr(), r.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "btd_solve")
        btd_solve.launches += 1
    return out.view(rhs.shape)


def _adjoint_operands(packed, b: torch.Tensor, g: torch.Tensor):
    """The ``btd_solve_adjoint`` launch's arguments, tensors in place of their
    pointers and without the stream, and its outputs ``(y, s, b_bar)``,
    shaped like ``b``.

    ``b`` is read in place where :func:`_kernel_rows` allows it (the
    implicit operator's padded rows). A ``g`` that every row of the batch
    shares (an expanded cotangent) is one row of pitch 0; otherwise ``g``
    is read in place or copied once into padded rows. The outputs are
    views of one ``(3, B, padded_width(3N))`` buffer."""
    n = b.shape[-2]
    rows = _kernel_operand(b, n)
    gx = g.expand(b.shape)
    lead = gx.dim() - 2
    if rows.shape[0] and all(st == 0 for st in gx.stride()[:lead]):  # one row for the batch
        grows, ld_g = _kernel_operand(gx[(0,) * lead], n), 0
    else:
        grows = _kernel_operand(gx, n)
        ld_g = grows.stride(0)
    out = torch.empty((3, rows.shape[0], padded_width(3 * n)), dtype=b.dtype,
                      device=b.device)[..., :3 * n]
    fwd, bwd = packed
    args = (_DTYPE_CODES[b.dtype], rows.shape[0], n, rows.stride(0), ld_g, out.stride(1),
            fwd, bwd, rows, grows, *out.unbind(0))
    return args, tuple(t.view(b.shape) for t in out.unbind(0))


def _launch_adjoint(packed, b: torch.Tensor, g: torch.Tensor):
    """One ``btd_solve_adjoint`` launch: ``(y, s, b_bar)`` shaped like ``b``."""
    dev = b.device
    args, outs = _adjoint_operands(packed, b, g)
    if outs[0].numel():
        lib = _build.library("btd_solve")
        with torch.cuda.device(dev):
            rc = lib.btd_solve_adjoint_launch(*_pointers(args),
                                              torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "btd_solve_adjoint")
        btd_solve_adjoint.launches += 1
    return outs


def adjoint_geometry(dtype: torch.dtype) -> tuple:
    """``(nodes a chunk, ring slots)`` of the ``btd_solve_adjoint`` kernel in
    ``dtype``, read from the built library."""
    lib = _build.library("btd_solve")
    code = _DTYPE_CODES[dtype]
    return lib.btd_solve_adjoint_geometry(code, 0), lib.btd_solve_adjoint_geometry(code, 1)


def _cache_for(factors):
    return factors if isinstance(factors, BTDFactors) else BTDFactors(factors)


class _Solve(torch.autograd.Function):
    """``x = T^{-1} rhs`` through the kernels, with its derivatives.

    Inputs ``(dinv, lw, upper, rhs, cache)``: the factors as tensors (their
    gradients are the factor cotangents), the right-hand sides, and the
    :class:`BTDFactors` holding the packed copies (packed here, from the
    values, on first use). Forward: one ``btd_solve`` launch. Backward: one
    ``btd_solve_adjoint`` launch (the three sweeps) and the batch sums of
    ``banded.btd_adjoint_factors``. Forward mode: the tangent right-hand
    side ``banded.btd_solve_tangent_rhs`` (vectorized torch ops) and one
    more ``btd_solve`` launch. Both launch the kernels whether or not grad
    mode is on; ``torch.utils.checkpoint`` and ``torch.func.jvp`` compose
    with it."""

    @staticmethod
    def forward(dinv, lw, upper, rhs, cache):
        return _launch_solve(cache.packed(dinv, lw, upper), rhs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dinv, lw, upper, rhs, cache = inputs
        ctx.cache = cache
        ctx.save_for_backward(dinv, lw, upper, rhs, output)
        ctx.save_for_forward(dinv, lw, upper, output)

    @staticmethod
    def backward(ctx, gx):
        dinv, lw, upper, rhs, x = ctx.saved_tensors
        factors = (dinv, lw, upper)
        y, s, bbar = _launch_adjoint(ctx.cache.packed(*factors), rhs, gx)
        if any(ctx.needs_input_grad[:3]):
            d_dinv, d_lw, d_up = banded.btd_adjoint_factors(factors, x, gx, y, s, bbar)
        else:
            d_dinv = d_lw = d_up = None
        return d_dinv, d_lw, d_up, bbar if ctx.needs_input_grad[3] else None, None

    @staticmethod
    def jvp(ctx, d_dinv, d_lw, d_up, d_rhs, _):
        dinv, lw, upper, x = ctx.saved_tensors
        factors = (dinv, lw, upper)
        c = banded.btd_solve_tangent_rhs(factors, x, (d_dinv, d_lw, d_up), d_rhs)
        return _launch_solve(ctx.cache.packed(*factors), c)


def btd_solve(factors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``T x = rhs`` for a batch of right-hand sides, one shared ``T``.

    Args:
      factors: ``(dinv (N, 3, 3), lw (N-1, 3, 3), upper (N-1, 3, 3))`` from
        :func:`~continuum_robot_tpu_torch.ops.banded.btd_factor` (unbatched),
        on ``rhs``'s device and in its dtype; a :class:`BTDFactors` keeps
        the kernel's packed copies across calls (otherwise they are packed
        per call).
      rhs: ``(..., N, 3)`` right-hand sides (every leading axis is a batch
        axis; the kernel sees ``(B, 3N)`` rows, in place when their pitch
        is a multiple of :data:`PITCH` elements).

    Returns the ``(..., N, 3)`` solutions. CPU tensors run the plain
    version; CUDA tensors (float32 or float64) one kernel launch, whose
    result is a view of rows padded to :data:`PITCH`. On the card the
    result is differentiable in the factors and ``rhs``: when an input
    requires grad or carries a tangent the launch goes through
    :class:`_Solve`, whose reverse mode launches :func:`btd_solve_adjoint`'s
    kernel and forward mode one more ``btd_solve``; the kernel runs either
    way.
    """
    dev = rhs.device
    if dev.type == "cpu":
        return banded.btd_solve(factors, rhs)
    if dev.type != "cuda":
        raise ValueError(f"btd_solve takes CPU or CUDA tensors, got {dev}")
    _check(factors, rhs, "btd_solve")
    dinv, lw, up = factors
    cache = _cache_for(factors)
    if not any(map(_build._derivative_asked, (dinv, lw, up, rhs))):
        # No derivative asked: the launch without the Function's host cost
        # (tens of microseconds a call, on a path of thousands of solves).
        return _launch_solve(cache.packed(dinv, lw, up), rhs)
    return _Solve.apply(dinv, lw, up, rhs, cache)


btd_solve.launches = 0


def btd_solve_adjoint(factors, b: torch.Tensor, x: torch.Tensor, g: torch.Tensor):
    """Reverse-mode derivative of :func:`btd_solve` (``x = T^{-1} b``).

    Returns ``(dinv_bar, lw_bar, upper_bar, b_bar)`` for the cotangent ``g
    = dL/dx``, as :func:`~continuum_robot_tpu_torch.ops.banded.btd_solve_adjoint`
    (the plain version) does. On CUDA tensors the three sweeps are one
    launch of the hand-written kernel ``btd_solve_adjoint`` (``csrc/btd_solve.cu``;
    the factors shared by the batch), the factor cotangents its batch
    sums (``banded.btd_adjoint_factors``); CPU tensors run the plain version.
    """
    if b.device.type == "cpu":
        return banded.btd_solve_adjoint(factors, b, x, g)
    _check(factors, b, "btd_solve_adjoint")
    y, s, bbar = _launch_adjoint(_cache_for(factors).packed(), b, g)
    d_dinv, d_lw, d_up = banded.btd_adjoint_factors(tuple(factors), x, g, y, s, bbar)
    return d_dinv, d_lw, d_up, bbar


btd_solve_adjoint.launches = 0

KERNELS = (btd_solve, btd_solve_adjoint)


def reset_launch_counts() -> None:
    """Set the kernel wrappers' launch counts to 0."""
    for fn in KERNELS:
        fn.launches = 0

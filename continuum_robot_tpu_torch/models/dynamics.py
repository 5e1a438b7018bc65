"""Functional ODE core: the reduced-coordinate beam dynamics on tensors.

Counterpart of ``continuum_robot_tpu/models/dynamics.py``. The complete
right-hand side

    dx/dt = [ v,  M^-1 (F_ext(x, t) + u - k(q)) ]

is a plain function of tensors: the internal force, one pre-inverted mass
apply and composable force terms, batched over any leading axes and kept
on the state's device and dtype. The JAX package's expression order is
kept, so float64 agrees with it to roundoff.

The dense products of a small beam (at most :data:`ROWSUM_MAX` reduced
DOFs) run as an elementwise product and a last-axis sum rather than a
matrix multiply: the order of a row's sum then depends on the row's length
only, never on the batch, so one environment of a batch comes out bit for
bit as it does alone (a BLAS or cuBLAS matmul picks its kernel, and its
summation order, by the batch size).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

# Widest reduced system whose dense products are batch-invariant row sums:
# the DOFs of the largest beam the polynomial internal force serves
# (dynamic_beam_model.POLY_MAX_ELEMENTS), so every such beam's RHS is
# batch-invariant. On the H100 row sums and matmuls took the same time a
# Dopri5 trial within the host's noise up to 72 DOFs (chip_compare.py
# --sections adaptive).
ROWSUM_MAX = 72


def dense_apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ m.mT`` over the last axis of ``x``: a batch-invariant row sum
    for small operators (:data:`ROWSUM_MAX`), a matmul beyond."""
    if m.shape[-1] <= ROWSUM_MAX:
        return (x[..., None, :] * m).sum(-1)
    return x @ m.mT


def make_mass_inverse_apply(m_reduced: np.ndarray):
    """Dense precomputed ``M^-1`` application (reference semantics).

    The reduced mass is inverted once on the host in float64; the inverse
    goes to a tensor's device and dtype on first use there and is applied
    as :func:`dense_apply`. Returns ``(apply, m_inv)``.
    """
    m_inv = np.linalg.inv(np.asarray(m_reduced, dtype=np.float64))
    uploads = {}

    def apply(f: torch.Tensor) -> torch.Tensor:
        key = (f.device, f.dtype)
        if key not in uploads:
            uploads[key] = torch.as_tensor(m_inv, dtype=f.dtype, device=f.device)
        return dense_apply(uploads[key], f)

    return apply, m_inv


def build_system_fn(
    k_red: Callable,
    m_inv_apply: Callable,
    forces_fn: Optional[Callable] = None,
):
    """Autonomous part of the dynamics: ``system(x, t) -> dx/dt``.

    Split state, stiffness force, aggregated external forces, mass solve;
    the real time ``t`` (a float or a tensor) is threaded to the forces.
    """

    def system(x: torch.Tensor, t=0.0) -> torch.Tensor:
        x = torch.as_tensor(x)
        n = x.shape[-1] // 2
        q = x[..., :n]
        v = x[..., n:]
        rhs_force = -k_red(q)
        if forces_fn is not None:
            rhs_force = rhs_force + torch.as_tensor(forces_fn(x, t))
        acc = m_inv_apply(rhs_force)
        return torch.cat([v, acc], dim=-1)

    return system


def build_input_fn(m_inv_apply: Callable):
    """Input map ``(x, u, t) -> [0; M^-1 u]``; the zero block of ``B`` is a
    zero tensor, never a matrix."""

    def input_function(x: torch.Tensor, u, t=0.0) -> torch.Tensor:
        x = torch.as_tensor(x)
        u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
        acc = m_inv_apply(u)
        return torch.cat([torch.zeros_like(acc), acc], dim=-1)

    return input_function


def build_rhs(
    system_fn: Callable,
    input_fn: Optional[Callable] = None,
):
    """Full ``rhs(t, x, u) -> dx/dt`` for the integrators.

    ``u`` may be ``None``, a force over position DOFs, or a callable ``t ->
    force`` (``t`` a float or a tensor of the controller's batch shape).
    """

    def rhs(t, x, u=None):
        dx = system_fn(x, t)
        if u is None or input_fn is None:
            return dx
        force = u(t) if callable(u) else u
        return dx + input_fn(x, force, t)

    return rhs


def sum_forces(force_fns: Sequence[Callable]):
    """Compose pure force terms by summation (registry algebra, pure form)."""

    def total(x, t):
        x = torch.as_tensor(x)
        n = x.shape[-1] // 2
        out = x.new_zeros((*x.shape[:-1], n))
        for fn in force_fns:
            out = out + torch.as_tensor(fn(x, t))
        return out

    return total

"""Batched Euler-Bernoulli element matrices.

Counterpart of ``continuum_robot_tpu/models/elements.py``: the linear
element matrices and the reference-parity von Kármán internal force. Every
function broadcasts over leading batch/element axes and takes NumPy arrays
(host setup, returns NumPy) or torch tensors (returns tensors on the same
device and dtype).

Element DOF convention: ``q6 = [u1, w1, phi1, u2, w2, phi2]`` with the
rotation sign convention ``phi = -dw/dx`` (the ``-6EI/L^2`` off-diagonals and
``-22L`` consistent-mass terms below).

The nonlinear polynomials are the exact rational form of the reference's
six sympy-generated von Kármán force expressions, in the JAX package's
expression order, including their non-variational quirks (``f1`` has no
``-EA*u2/L`` term; ``f4``/``f6`` are not mirror images). The variationally
consistent energy-gradient element (``use_consistent=True``) is not ported
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch


def _ns(*args):
    """Pick the array namespace: torch if any argument is a tensor, else NumPy."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return torch
    return np


def _as_arrays(*args):
    """``(namespace, arrays)``: tensors take the device and dtype of the
    first tensor argument; otherwise NumPy arrays."""
    xp = _ns(*args)
    if xp is np:
        return np, [np.asarray(a) for a in args]
    ref = next(a for a in args if isinstance(a, torch.Tensor))
    return torch, [
        a.to(dtype=ref.dtype, device=ref.device) if isinstance(a, torch.Tensor)
        else torch.tensor(np.asarray(a), dtype=ref.dtype, device=ref.device)
        for a in args
    ]


def _broadcast(xp, *arrays):
    if xp is np:
        return np.broadcast_arrays(*arrays)
    return torch.broadcast_tensors(*arrays)


def linear_stiffness_matrix(length, elastic_modulus, moment_inertia, cross_area):
    """6x6 linear frame-element stiffness, batched over leading axes.

    Axial EA/L block + bending 12EI/L^3 block. Inputs may be scalars or
    arrays of shape ``(...,)``; the result has shape ``(..., 6, 6)``.
    """
    xp, (L, E, I, A) = _as_arrays(length, elastic_modulus, moment_inertia, cross_area)
    EI = E * I
    EA = E * A
    L, EI, EA = _broadcast(xp, L, EI, EA)

    z = xp.zeros_like(L)
    ka = EA / L
    kb = 12.0 * EI / L**3
    kc = 6.0 * EI / L**2
    kd = 4.0 * EI / L
    ke = 2.0 * EI / L

    rows = [
        [ka, z, z, -ka, z, z],
        [z, kb, -kc, z, -kb, -kc],
        [z, -kc, kd, z, kc, ke],
        [-ka, z, z, ka, z, z],
        [z, -kb, kc, z, kb, kc],
        [z, -kc, ke, z, kc, kd],
    ]
    return xp.stack([xp.stack(r, -1) for r in rows], -2)


def consistent_mass_matrix(length, density, cross_area):
    """6x6 consistent mass matrix ``rho*A*L/420 * [...]``, batched.

    Identical for linear and nonlinear elements. Shape ``(..., 6, 6)``.
    """
    xp, (L, rho, A) = _as_arrays(length, density, cross_area)
    rhoAL = rho * A * L
    L, rhoAL = _broadcast(xp, L, rhoAL)

    z = xp.zeros_like(L)
    c = rhoAL / 420.0
    m140 = 140.0 * c
    m70 = 70.0 * c
    m156 = 156.0 * c
    m54 = 54.0 * c
    m22L = 22.0 * L * c
    m13L = 13.0 * L * c
    m4L2 = 4.0 * L**2 * c
    m3L2 = 3.0 * L**2 * c

    rows = [
        [m140, z, z, m70, z, z],
        [z, m156, -m22L, z, m54, m13L],
        [z, -m22L, m4L2, z, -m13L, -m3L2],
        [m70, z, z, m140, z, z],
        [z, m54, -m13L, z, m156, m22L],
        [z, m13L, -m3L2, z, m22L, m4L2],
    ]
    return xp.stack([xp.stack(r, -1) for r in rows], -2)


# ---------------------------------------------------------------------------
# Nonlinear (von Kármán) internal force, reference parity
# ---------------------------------------------------------------------------


def nonlinear_internal_force(q6, length, elastic_modulus, moment_inertia, cross_area):
    """Geometric-nonlinear internal force vector, reference parity.

    ``q6``: ``(..., 6)`` element state ``[u1, w1, t1, u2, w2, t2]``; the
    parameters broadcast over the leading axes. Returns ``(..., 6)`` forces
    ordered ``[f1, f3, f4, f2, f5, f6]``: node 1 (axial, transverse, moment)
    then node 2.
    """
    xp, (q6, L, E, I, A) = _as_arrays(
        q6, length, elastic_modulus, moment_inertia, cross_area
    )
    f1, f3, f4, f2, f5, f6 = nonlinear_force_planes(
        q6[..., 0], q6[..., 1], q6[..., 2],
        q6[..., 3], q6[..., 4], q6[..., 5],
        L, E * I, E * A,
    )
    return xp.stack([f1, f3, f4, f2, f5, f6], -1)


def nonlinear_correction_planes(u1, w1, t1, u2, w2, t2, L, D, A):
    """The quadratic + cubic terms of the six parity polynomials.

    ``g(q) = f(q) - K0_e q`` with ``K0_e`` the element's exact zero-state
    tangent. Only the membrane stiffness ``A = EA`` appears (every ``D =
    EI`` term of the polynomials is linear), and ``g`` vanishes at ``q = 0``.
    The modal-ROM engine evaluates only this correction through its basis
    transforms; the linear part is its exactly diagonal ``lam * eta``.

    Planes are ``(..., E)`` arrays or tensors; returns the six force planes
    in slot order ``(n1 axial, n1 transverse, n1 moment, n2 axial, n2
    transverse, n2 moment)``.
    """
    dw = w1 - w2
    du = u1 - u2
    s = t1 + t2
    t1t2 = t1 * t2
    tsq = t1 * t1 + t2 * t2
    dw2 = dw * dw
    dw3 = dw2 * dw

    invL = 1.0 / L
    invL2 = invL * invL
    invL3 = invL2 * invL

    # Quadratic part of f1 (its linear term +EA*u1/L, with no matching
    # -EA*u2/L, lives in nonlinear_linear_planes).
    g1 = A * (
        -tsq / 15.0
        + t1t2 / 30.0
        + s * u2 * (invL / 20.0)
        + s * dw * (invL / 10.0)
        - 0.6 * u2 * dw * invL2
        - 0.6 * dw2 * invL2
    )

    # Quadratic part of f2 (linear term -EA*du/L).
    g2 = A * (
        tsq / 15.0
        - t1t2 / 30.0
        - s * dw * (invL / 10.0)
        + 0.6 * dw2 * invL2
    )

    # Nonlinear part of f3; g5 = -g3 exactly.
    t3sum = t1 * t1 * t1 + t2 * t2 * t2
    g3 = A * (
        t3sum / 280.0
        - 3.0 * t1t2 * s / 280.0
        + (9.0 / 70.0) * tsq * dw * invL
        + du * s * (invL / 10.0)
        - (27.0 / 70.0) * s * dw2 * invL2
        - 1.2 * du * dw * invL2
        + (36.0 / 35.0) * dw3 * invL3
    )

    g5 = -g3

    # Nonlinear part of f4 (its cubic rotation terms are not the mirror of
    # g6's, as in the reference).
    g4 = A * (
        L * (t1 * t1 * t1) / 35.0
        - 3.0 * L * t1 * t1 * t2 / 280.0
        + L * t1 * t2 * t2 / 140.0
        - L * (t2 * t2 * t2) / 280.0
        + (3.0 / 280.0) * dw * (t1 * t1 - 2.0 * t1t2 - t2 * t2)
        - (2.0 / 15.0) * t1 * du
        + t2 * du / 30.0
        + (9.0 / 70.0) * t1 * dw2 * invL
        + du * dw * (invL / 10.0)
        - (9.0 / 70.0) * dw3 * invL2
    )

    # Nonlinear part of f6.
    g6 = A * (
        -L * (t1 * t1 * t1) / 280.0
        + L * t1 * t1 * t2 / 140.0
        - 3.0 * L * t1 * t2 * t2 / 280.0
        + L * (t2 * t2 * t2) / 35.0
        + (3.0 / 280.0) * dw * (-t1 * t1 - 2.0 * t1t2 + t2 * t2)
        + t1 * du / 30.0
        - (2.0 / 15.0) * t2 * du
        + (9.0 / 70.0) * t2 * dw2 * invL
        + du * dw * (invL / 10.0)
        - (9.0 / 70.0) * dw3 * invL2
    )

    return g1, g3, g4, g2, g5, g6


def nonlinear_linear_planes(u1, w1, t1, u2, w2, t2, L, D, A):
    """The linear (zero-state tangent) terms of the six parity polynomials.

    Not the linear element's stiffness: ``f1``'s linear term is
    ``+EA*u1/L`` with no ``-EA*u2/L`` coupling, which makes the tangent
    pencil non-symmetric (see ``ModalROMGenAlpha``).
    """
    dw = w1 - w2
    du = u1 - u2
    s = t1 + t2
    invL = 1.0 / L
    invL2 = invL * invL
    invL3 = invL2 * invL

    l1 = A * u1 * invL
    l2 = -A * du * invL
    l3 = D * (-6.0 * s * invL2 + 12.0 * dw * invL3)
    l5 = -l3
    l4 = D * ((4.0 * t1 + 2.0 * t2) * invL - 6.0 * dw * invL2)
    l6 = D * ((2.0 * t1 + 4.0 * t2) * invL - 6.0 * dw * invL2)
    return l1, l3, l4, l2, l5, l6


def nonlinear_force_planes(u1, w1, t1, u2, w2, t2, L, D, A):
    """The six parity polynomials on separate state planes: the linear
    planes plus the correction, so the force/correction split the modal-ROM
    engine relies on holds by construction."""
    args = (u1, w1, t1, u2, w2, t2, L, D, A)
    g1, g3, g4, g2, g5, g6 = nonlinear_correction_planes(*args)
    l1, l3, l4, l2, l5, l6 = nonlinear_linear_planes(*args)
    return l1 + g1, l3 + g3, l4 + g4, l2 + g2, l5 + g5, l6 + g6


def linear_force_planes(u1, w1, t1, u2, w2, t2, L, D, A):
    """Linear-element internal force ``Ke q6`` on separate state planes, in
    the slot order of :func:`nonlinear_force_planes`."""
    ka = A / L
    invL = 1.0 / L
    invL2 = invL * invL
    kb = 12.0 * D * invL * invL2
    kc = 6.0 * D * invL2
    kd = 4.0 * D * invL
    ke = 2.0 * D * invL

    dw = w1 - w2
    f_ax1 = ka * (u1 - u2)
    f_tr1 = kb * dw - kc * (t1 + t2)
    f_mo1 = -kc * dw + kd * t1 + ke * t2
    f_mo2 = -kc * dw + ke * t1 + kd * t2
    return f_ax1, f_tr1, f_mo1, -f_ax1, -f_tr1, f_mo2


def element_internal_force(
    q6,
    length,
    elastic_modulus,
    moment_inertia,
    cross_area,
    nonlinear_mask,
    use_consistent: bool = False,
):
    """Hybrid element force: ``Ke q6`` where the mask is False, the parity
    polynomials where it is True. Both are evaluated and selected
    elementwise. ``use_consistent=True`` (the energy-gradient element) is
    not ported and raises."""
    if use_consistent:
        raise NotImplementedError(
            "the consistent (energy-gradient) nonlinear element is not yet "
            "ported"
        )
    xp, (q6, L, E, I, A) = _as_arrays(
        q6, length, elastic_modulus, moment_inertia, cross_area
    )
    K = linear_stiffness_matrix(L, E, I, A)
    f_lin = xp.einsum("...ij,...j->...i", K, q6)
    nl = nonlinear_internal_force(q6, L, E, I, A)
    if xp is np:
        mask = np.asarray(nonlinear_mask)
    else:
        mask = torch.as_tensor(nonlinear_mask, device=q6.device)
    return xp.where(mask[..., None], nl, f_lin)

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
consistent element (``use_consistent=True``) is the gradient of the
element's von Kármán strain energy, written out in closed form over the
same 5-point Gauss rule the JAX package differentiates with ``jax.grad``.
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
    # A tensor divisor on the tensor's device: CUDA divides by a host scalar
    # through its reciprocal (one rounding more), which would set the card's
    # mass apart from the host's by an ulp.
    c = rhoAL / (420.0 if xp is np else rhoAL.new_full((), 420.0))
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


# ---------------------------------------------------------------------------
# Variationally consistent alternative (energy gradient)
# ---------------------------------------------------------------------------

# 5-point Gauss-Legendre rule on [0, 1]: the element energy's integrand is
# of degree 8, so the rule is exact.
_GAUSS_X = (
    0.5 - 0.45308992296933193, 0.5 - 0.26923465505284155, 0.5,
    0.5 + 0.26923465505284155, 0.5 + 0.45308992296933193,
)
_GAUSS_W = (
    0.11846344252809454, 0.23931433524968324, 0.28444444444444444,
    0.23931433524968324, 0.11846344252809454,
)


def _hermite(xi):
    """First and second xi-derivatives of the four Hermite cubics at ``xi``."""
    d1 = (6.0 * xi * xi - 6.0 * xi, 3.0 * xi * xi - 4.0 * xi + 1.0,
          -6.0 * xi * xi + 6.0 * xi, 3.0 * xi * xi - 2.0 * xi)
    d2 = (12.0 * xi - 6.0, 6.0 * xi - 4.0, -12.0 * xi + 6.0, 6.0 * xi - 2.0)
    return d1, d2


def _consistent_matrices():
    """Constant matrices of the consistent element over the Gauss points.

    With the element planes ``X = [(w1 - w2)/L, t1, t2]``, ``w' = X @ D[:, :5]``
    and ``L w'' = X @ D[:, 5:]`` at the five points (``w = w1 H1 - t1 L H2 +
    w2 H3 - t2 L H4`` with ``phi = -w'``; ``H3' = -H1'`` and ``H3'' =
    -H1''``, so ``w1`` and ``w2`` enter through their difference). ``P``
    and ``Q`` hold the weighted slopes ``gw * (H1', H2', H4')`` and ``gw *
    (H1'', H2'', H4'')`` that the axial term ``N w'`` and the moment
    contract with."""
    h1 = np.array([_hermite(x)[0] for x in _GAUSS_X])  # (point, H1'..H4')
    h2 = np.array([_hermite(x)[1] for x in _GAUSS_X])
    sel = [0, 1, 3]
    D = np.concatenate([h1[:, sel].T, h2[:, sel].T], axis=1) * np.array([[1.0], [-1.0], [-1.0]])
    gw = np.array(_GAUSS_W)
    return D, gw[:, None], gw[:, None] * h1[:, sel], gw[:, None] * h2[:, sel]


_CONSISTENT_NP = _consistent_matrices()
_CONSISTENT_UPLOADS = {}  # (device, dtype) -> _CONSISTENT_NP as tensors


def _consistent_consts(ref):
    """:data:`_CONSISTENT_NP` on the device and dtype of tensor ``ref``
    (uploaded once), or as NumPy when ``ref`` is None."""
    if ref is None:
        return _CONSISTENT_NP
    key = (ref.device, ref.dtype)
    if key not in _CONSISTENT_UPLOADS:
        _CONSISTENT_UPLOADS[key] = tuple(
            torch.tensor(a, dtype=ref.dtype, device=ref.device) for a in _CONSISTENT_NP
        )
    return _CONSISTENT_UPLOADS[key]


def _planes_matmul(M, planes):
    """``M^T`` applied across stacked planes: ``(k, ...) -> (m, ...)``."""
    return (M.T @ planes.reshape(planes.shape[0], -1)).reshape(M.shape[1], *planes.shape[1:])


def _gauss_slopes(u1, w1, t1, u2, w2, t2, L):
    """``(consts, 1/L, u', w', L w'')``: the element's axial strain and the
    transverse slope and curvature at the five Gauss points, stacked on a
    leading axis."""
    xp = _ns(u1, w1, t1, u2, w2, t2, L)
    consts = _consistent_consts(next(
        (a for a in (u1, w1, t1, u2, w2, t2, L) if isinstance(a, torch.Tensor)), None))
    invL = 1.0 / L
    X = xp.stack(_broadcast(xp, (w1 - w2) * invL, t1, t2), 0)
    G = _planes_matmul(consts[0], X)
    return consts, invL, (u2 - u1) * invL, G[:5], G[5:]


def element_strain_energy(q6, length, elastic_modulus, moment_inertia, cross_area):
    """Von Kármán strain energy of one element by 5-point Gauss quadrature.

    ``U = 1/2 \\int EA (u' + w'^2/2)^2 + EI (w'')^2 dx`` with linear axial
    and Hermite-cubic transverse interpolation under the ``phi = -w'``
    convention. Broadcasts over leading axes; returns ``(...,)``.
    """
    _, (q6, L, E, I, A) = _as_arrays(
        q6, length, elastic_modulus, moment_inertia, cross_area
    )
    (_, gw, _, _), invL, up, wp, lwpp = _gauss_slopes(*(q6[..., i] for i in range(6)), L)
    strain = up + 0.5 * wp * wp
    wpp = lwpp * invL
    dens = 0.5 * (E * A * strain * strain + E * I * wpp * wpp)
    return _planes_matmul(gw, dens)[0] * L


def consistent_force_planes(u1, w1, t1, u2, w2, t2, L, D, A):
    """The energy-consistent element force on separate state planes, in the
    slot order of :func:`nonlinear_force_planes`.

    ``f = dU/dq`` of :func:`element_strain_energy`: at each Gauss point the
    axial force ``N = EA (u' + w'^2/2)`` and the moment ``M = EI w''``
    contract with the derivatives of ``u'``, ``w'`` and ``w''`` with respect
    to the six DOFs. The five points are handled at once as small matrix
    products over stacked planes (:func:`_consistent_matrices`).
    """
    (_, gw, P, Q), invL, up, wp, lwpp = _gauss_slopes(u1, w1, t1, u2, w2, t2, L)
    N = A * (up + 0.5 * wp * wp)
    SN = _planes_matmul(gw, N)[0]
    Pv = _planes_matmul(P, N * wp)
    Qv = _planes_matmul(Q, (D * invL) * lwpp)  # the moment M = EI w''
    fw1 = Pv[0] + Qv[0] * invL
    ft1 = -(L * Pv[1] + Qv[1])
    ft2 = -(L * Pv[2] + Qv[2])
    return -SN, fw1, ft1, SN, -fw1, ft2


def nonlinear_internal_force_consistent(
    q6, length, elastic_modulus, moment_inertia, cross_area
):
    """Energy-consistent von Kármán internal force ``f = dU/dq``.

    The gradient of :func:`element_strain_energy`, written out
    (:func:`consistent_force_planes`). Returns ``(..., 6)`` in ``q6`` order
    ``[u1, w1, t1, u2, w2, t2]``.
    """
    xp, (q6, L, E, I, A) = _as_arrays(
        q6, length, elastic_modulus, moment_inertia, cross_area
    )
    planes = consistent_force_planes(*(q6[..., i] for i in range(6)), L, E * I, E * A)
    return xp.stack(_broadcast(xp, *planes), -1)


# ---------------------------------------------------------------------------
# Unified per-element dispatch (hybrid beams)
# ---------------------------------------------------------------------------


def element_internal_force(
    q6,
    length,
    elastic_modulus,
    moment_inertia,
    cross_area,
    nonlinear_mask,
    use_consistent: bool = False,
):
    """Hybrid element force: ``Ke q6`` where the mask is False, the
    nonlinear element where it is True (the parity polynomials, or the
    energy gradient with ``use_consistent=True``). Both are evaluated and
    selected elementwise. A tensor mask stays on its device."""
    xp, (q6, L, E, I, A) = _as_arrays(
        q6, length, elastic_modulus, moment_inertia, cross_area
    )
    nl_force = (nonlinear_internal_force_consistent if use_consistent
                else nonlinear_internal_force)
    if isinstance(nonlinear_mask, np.ndarray) and xp is torch:
        # A host mask that is all one kind selects one branch: skip the
        # other (the same values; tensor masks evaluate both).
        if not nonlinear_mask.any():
            return torch.einsum("...ij,...j->...i", linear_stiffness_matrix(L, E, I, A), q6)
        if nonlinear_mask.all():
            return nl_force(q6, L, E, I, A)
    K = linear_stiffness_matrix(L, E, I, A)
    f_lin = xp.einsum("...ij,...j->...i", K, q6)
    nl = nl_force(q6, L, E, I, A)
    if xp is np:
        mask = np.asarray(nonlinear_mask)
    elif isinstance(nonlinear_mask, torch.Tensor):
        mask = nonlinear_mask.to(q6.device)
    else:
        mask = torch.as_tensor(np.asarray(nonlinear_mask), device=q6.device)
    return xp.where(mask[..., None], nl, f_lin)

"""Batched Euler-Bernoulli element matrices.

Counterpart of ``continuum_robot_tpu/models/elements.py`` (linear element
matrices). Every function broadcasts over leading batch/element axes and
takes NumPy arrays (host setup, returns NumPy) or torch tensors (returns
tensors on the same device and dtype).

Element DOF convention: ``q6 = [u1, w1, phi1, u2, w2, phi2]`` with the
rotation sign convention ``phi = -dw/dx`` (the ``-6EI/L^2`` off-diagonals and
``-22L`` consistent-mass terms below).

The von Kármán nonlinear internal-force polynomials are not ported yet.
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
        torch.as_tensor(a, dtype=ref.dtype, device=ref.device) for a in args
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

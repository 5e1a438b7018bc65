"""Global assembly: batched element matrices -> global operators.

Counterpart of ``continuum_robot_tpu/models/assembly.py`` (the mass and
linear-stiffness operators and the boundary-condition reduction). The
mass operator is kept block-tridiagonal ``(diag (N,3,3), off (E,3,3))``;
dense forms are host NumPy for eigensolves and control design.

The state-dependent internal force and tangent (nonlinear elements) are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import elements
from .config import BeamArrays


def _sum_node_blocks(Ke):
    """Diagonal node blocks ``(..., N, 3, 3)`` of element matrices
    ``(..., E, 6, 6)``: node i gets element i's first block and element
    i-1's second."""
    n_nodes = Ke.shape[-3] + 1
    shape = (*Ke.shape[:-3], n_nodes, 3, 3)
    if isinstance(Ke, torch.Tensor):
        diag = Ke.new_zeros(shape)
    else:
        diag = np.zeros(shape, dtype=Ke.dtype)
    diag[..., :-1, :, :] += Ke[..., 0:3, 0:3]
    diag[..., 1:, :, :] += Ke[..., 3:6, 3:6]
    return diag


def mass_block_tridiagonal(arrays: BeamArrays):
    """Global consistent mass as block-tridiagonal ``(diag (N,3,3), off (E,3,3))``.

    ``off[i]`` is the coupling block between node i and node i+1 (upper
    band); the lower band is its transpose by symmetry. NumPy or torch,
    following the type of the parameter arrays.
    """
    Me = elements.consistent_mass_matrix(
        arrays.length, arrays.density, arrays.cross_area
    )  # (E, 6, 6)
    return _sum_node_blocks(Me), Me[..., 0:3, 3:6]


def dense_from_block_tridiagonal(diag, off) -> np.ndarray:
    """Expand block-tridiagonal form to a dense ``(3N, 3N)`` NumPy matrix.

    ``off`` is the upper band; the lower band is its blockwise transpose
    (symmetric operators). Host setup helper.
    """
    diag = np.asarray(diag)
    off = np.asarray(off)
    n_nodes = diag.shape[-3]
    n = 3 * n_nodes
    M = np.zeros((*diag.shape[:-3], n, n), dtype=diag.dtype)
    for i in range(n_nodes):
        M[..., 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = diag[..., i, :, :]
    for i in range(n_nodes - 1):
        M[..., 3 * i : 3 * i + 3, 3 * i + 3 : 3 * i + 6] = off[..., i, :, :]
        M[..., 3 * i + 3 : 3 * i + 6, 3 * i : 3 * i + 3] = np.swapaxes(
            off[..., i, :, :], -1, -2
        )
    return M


def dense_mass_matrix(arrays: BeamArrays) -> np.ndarray:
    """Dense global mass matrix (host)."""
    return dense_from_block_tridiagonal(*mass_block_tridiagonal(arrays))


def dense_linear_stiffness_matrix(arrays: BeamArrays) -> np.ndarray:
    """Dense global stiffness for purely linear beams (host).

    The caller is responsible for the all-linear check (the beam facade
    raises otherwise).
    """
    Ke = np.asarray(
        elements.linear_stiffness_matrix(
            arrays.length,
            arrays.elastic_modulus,
            arrays.moment_inertia,
            arrays.cross_area,
        )
    )  # (E, 6, 6)
    return dense_from_block_tridiagonal(_sum_node_blocks(Ke), Ke[..., 0:3, 3:6])


def reduce_matrix(M, free_dofs: np.ndarray):
    """``M[free][:, free]`` — row/column deletion of the constrained DOFs."""
    if isinstance(M, torch.Tensor):
        free_dofs = torch.as_tensor(
            np.asarray(free_dofs, np.int64), device=M.device
        )
    return M[..., free_dofs, :][..., :, free_dofs]

"""Exact exponential propagation for linear beams (LTI discretization).

Counterpart of ``continuum_robot_tpu/ops/exponential.py``. For a purely
linear beam with no velocity-dependent forces the dynamics are LTI,
``dx/dt = A x + B u`` with ``A = [[0, I], [-M^-1 K, 0]]``; the flow is
discretized exactly once on the host (float64, ``scipy.linalg.expm``):

    Phi = expm(A h),   Gamma = A^-1 (Phi - I) B   (via the augmented expm)

after which ``x_{k+1} = Phi x_k + Gamma u_k`` propagates any horizon with
zero integration error for piecewise-constant inputs: two dense products
a frame on the device.

Applicability gate: all-linear elements and no registered forces (a
constant force such as gravity at fixed rotation enters through ``u``;
fluid drag does not qualify). Both raise ``ValueError`` otherwise.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..models.dynamics import dense_apply


def discretize_lti(A: np.ndarray, B: np.ndarray, dt: float) -> Tuple[np.ndarray, np.ndarray]:
    """Exact zero-order-hold discretization via the augmented exponential.

    ``expm([[A, B], [0, 0]] dt) = [[Phi, Gamma], [0, I]]`` (host float64).
    """
    from scipy.linalg import expm

    n = A.shape[0]
    m = B.shape[1]
    aug = np.zeros((n + m, n + m))
    aug[:n, :n] = A
    aug[:n, n:] = B
    M = expm(aug * dt)
    return M[:n, :n], M[:n, n:]


def make_expm_propagator(model, dt: float, dtype: torch.dtype = torch.float32,
                         device=None) -> Callable:
    """Exact discrete propagator for an all-linear beam model.

    Returns ``propagate(x0, u_frames) -> (frames+1, ..., 2n)`` where
    ``u_frames`` has shape ``(frames, n)`` (zero-order-hold force per output
    frame; an ``(n,)`` force is one frame). ``Phi`` and ``Gamma`` go to
    ``device`` (None: the card) in ``dtype``; NumPy inputs follow them.
    Raises ValueError for nonlinear configurations or registered
    state-dependent forces.
    """
    from ..models.simulate import resolve_device

    arrays = model.beam_model.arrays
    if bool(np.any(np.asarray(arrays.nonlinear_mask))):
        raise ValueError("Exponential propagation requires a purely linear beam")
    if len(model.force_registry) > 0:
        raise ValueError(
            "Exponential propagation cannot include state-dependent "
            "registry forces; fold constant forces into u instead"
        )

    device = resolve_device(device)
    K = model.beam_model.get_stiffness_matrix()
    M = model.beam_model.get_mass_matrix()
    n = K.shape[0]
    Minv = np.linalg.inv(M)
    A = np.zeros((2 * n, 2 * n))
    A[:n, n:] = np.eye(n)
    A[n:, :n] = -Minv @ K
    B = np.zeros((2 * n, n))
    B[n:, :] = Minv

    Phi_np, Gamma_np = discretize_lti(A, B, dt)
    Phi = torch.as_tensor(Phi_np, dtype=dtype, device=device)
    Gamma = torch.as_tensor(Gamma_np, dtype=dtype, device=device)

    def propagate(x0, u_frames) -> torch.Tensor:
        x = torch.as_tensor(x0, dtype=dtype, device=device)
        u_frames = torch.as_tensor(u_frames, dtype=dtype, device=device)
        if u_frames.ndim == 1:
            u_frames = u_frames[None]
        xs = [x]
        for u_k in u_frames:
            x = dense_apply(Phi, x) + dense_apply(Gamma, u_k)
            xs.append(x)
        return torch.stack(xs)

    return propagate

"""Continuous algebraic Riccati equation (CARE) solver on tensors.

Counterpart of ``continuum_robot_tpu/ops/care.py``. The CARE

    A' P + P A - P B R^-1 B' P + Q = 0

is solved with the matrix sign function of the Hamiltonian (Roberts'
method):

    H = [[A, -B R^-1 B'], [-Q, -A']]
    Z_{k+1} = (c_k Z_k + (c_k Z_k)^-1) / 2,   c_k = sqrt(||Z^-1||_F/||Z||_F)

which needs only inverses and solves (``torch.linalg``: cuSOLVER on the
card). The stable invariant subspace is read off sign(H) and P is recovered
from the stacked least-squares system

    [S12; S22 + I] P = -[S11 + I; S21]

by its normal equations. An optional Newton (Kleinman) refinement polishes P
by solving Lyapunov equations with the same sign-function machinery.

The JAX package's ``lax.while_loop`` becomes a Python loop whose condition
(``delta > tol``) is read on the host each iteration: a design-time solve
takes tens of them. Leading batch axes are solved together, each matrix
iterating until its own condition fails (the JAX package's ``vmap``).

Stiff-beam Hamiltonians are out of float32 range, so the design classes
(``control/lqr.py``, ``control/lqg.py``) use the host float64 twin
:func:`solve_care_numpy`, as the JAX package's do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CareResult(NamedTuple):
    P: torch.Tensor  # CARE solution
    iterations: torch.Tensor
    residual: torch.Tensor  # Frobenius norm of the CARE residual


def _fro(Z: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(Z)


def _sign_iteration(H: torch.Tensor, max_iters: int, tol: float):
    """Scaled Newton iteration for the matrix sign function.

    Starts from ``(Z, Z_prev) = (H, H + 1)`` and stops once the relative
    change falls to ``tol`` or after ``max_iters`` iterations, per matrix
    of the batch; returns ``(sign(H), iterations)``.
    """
    Z, Z_prev = H, H + 1.0
    k = torch.zeros(H.shape[:-2], dtype=torch.int64, device=H.device)
    for _ in range(int(max_iters)):
        delta = _fro(Z - Z_prev) / torch.clamp(_fro(Z), min=1e-30)
        active = delta > tol
        if not bool(active.any()):
            break
        Z_inv = torch.linalg.inv(Z)
        # Byers determinant-free scaling balances ||Z|| and ||Z^-1||.
        c = torch.sqrt(_fro(Z_inv) / torch.clamp(_fro(Z), min=1e-30))[..., None, None]
        Z_new = 0.5 * (c * Z + Z_inv / c)
        keep = active[..., None, None]
        Z, Z_prev = torch.where(keep, Z_new, Z), torch.where(keep, Z, Z_prev)
        k = k + active
    return Z, k


def care_residual(A, B, Q, R, P) -> torch.Tensor:
    """Frobenius norm of ``A'P + PA - PBR^-1B'P + Q``."""
    G = B @ torch.linalg.solve(R, B.mT)
    res = A.mT @ P + P @ A - P @ G @ P + Q
    return _fro(res)


def _as_tensors(*mats, device=None, dtype=None):
    """Tensors keep their device (unless ``device`` is given) and dtype
    (unless ``dtype`` is); NumPy inputs go to ``device`` (None: a tensor
    argument's, else the card) in ``dtype`` (default float64)."""
    from ..models.simulate import resolve_device

    ref = next((m for m in mats if isinstance(m, torch.Tensor)), None)
    if device is not None:
        dev = torch.device(device)
    elif ref is not None:
        dev = ref.device
    else:
        dev = resolve_device(None)
    if dtype is None:
        dtype = ref.dtype if ref is not None else torch.float64
    return [torch.as_tensor(np.asarray(m) if not isinstance(m, torch.Tensor) else m,
                            dtype=dtype, device=dev) for m in mats]


def _stable_subspace(S: torch.Tensor, n: int) -> torch.Tensor:
    """``P`` from ``[S12; S22 + I] P = -[S11 + I; S21]`` (normal equations),
    symmetrized."""
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    W = torch.cat([S[..., :n, n:], S[..., n:, n:] + eye], dim=-2)  # (2n, n)
    rhs = -torch.cat([S[..., :n, :n] + eye, S[..., n:, :n]], dim=-2)
    P = torch.linalg.solve(W.mT @ W, W.mT @ rhs)
    return 0.5 * (P + P.mT)


def _block(a, b, c, d):
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def solve_care(A, B, Q, R, max_iters: int = 100, tol: float = 1e-12,
               newton_refine: int = 0, device=None, dtype=None) -> CareResult:
    """Solve the CARE on the device; returns ``(P, iterations, residual)``.

    ``A``: (..., n, n); ``B``: (..., n, m); ``Q``: (..., n, n) PSD; ``R``:
    (..., m, m) PD; leading axes are a batch of designs. NumPy inputs go to
    the card in float64 unless ``device`` / ``dtype`` say otherwise;
    tensors keep theirs (float32 suits well-conditioned systems only).
    """
    A, B, Q, R = _as_tensors(A, B, Q, R, device=device, dtype=dtype)
    n = A.shape[-1]
    G = B @ torch.linalg.solve(R, B.mT)
    H = _block(A, -G, -Q, -A.mT)

    S, iters = _sign_iteration(H, max_iters, tol)
    # Stacked least squares via normal equations (the stable subspace
    # basis [I; P] has full column rank).
    P = _stable_subspace(S, n)

    # Optional Kleinman-Newton polish: each step solves the Lyapunov equation
    #   (A - G P)' X + X (A - G P) = -(Q + P G P)
    # again via the sign function of the associated Hamiltonian-like block.
    for _ in range(newton_refine):
        Acl = A - G @ P
        Qk = Q + P @ G @ P
        Sk, _ = _sign_iteration(_block(Acl, torch.zeros_like(A), -Qk, -Acl.mT),
                                max_iters, tol)
        P = _stable_subspace(Sk, n)

    return CareResult(P=P, iterations=iters, residual=care_residual(A, B, Q, R, P))


def solve_care_numpy(A, B, Q, R, max_iters: int = 100, tol: float = 1e-13) -> CareResult:
    """Float64 host implementation for the design-time path.

    The JAX package's host twin, verbatim: the sign-function iteration,
    then, when the result stabilizes the closed loop, Kleinman-Newton
    polish via Bartels-Stewart Lyapunov solves (each step exact in the
    Lyapunov sense and quadratically convergent). For low-rank actuation (a
    few tendons on an undamped beam) the Hamiltonian's eigenvalues can hug
    the imaginary axis and the plain sign iteration stalls; if it fails to
    deliver a stabilizing P this falls back to SciPy's QZ-based CARE and
    polishes that the same way. Returns NumPy arrays.
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    n = A.shape[-1]
    G = B @ np.linalg.solve(R, B.T)
    H = np.block([[A, -G], [-Q, -A.T]])

    def residual(P):
        return np.linalg.norm(A.T @ P + P @ A - P @ G @ P + Q)

    def is_stabilizing(P):
        return bool(
            np.all(np.isfinite(P))
            and np.all(np.real(np.linalg.eigvals(A - G @ P)) < 0)
        )

    def kleinman_polish(P, steps=10):
        """Newton iteration P_{k+1} solves the exact Lyapunov equation
        ``Acl' X + X Acl = -(Q + P G P)`` with ``Acl = A - G P``."""
        from scipy.linalg import solve_continuous_lyapunov

        best, best_res = P, residual(P)
        prev_res = best_res
        for _ in range(steps):
            Acl = A - G @ P
            X = solve_continuous_lyapunov(Acl.T, -(Q + P @ G @ P))
            P = 0.5 * (X + X.T)
            r = residual(P)
            if not (np.all(np.isfinite(P)) and is_stabilizing(P)):
                break
            if r < best_res:
                best, best_res = P, r
            if r >= prev_res * 0.99:  # converged / no longer improving
                break
            prev_res = r
        return best, best_res

    Z = H
    k = 0
    for k in range(1, max_iters + 1):
        Z_inv = np.linalg.inv(Z)
        c = np.sqrt(np.linalg.norm(Z_inv) / max(np.linalg.norm(Z), 1e-300))
        Z_new = 0.5 * (c * Z + Z_inv / c)
        delta = np.linalg.norm(Z_new - Z) / max(np.linalg.norm(Z_new), 1e-300)
        Z = Z_new
        if delta < tol:
            break

    S11, S12 = Z[:n, :n], Z[:n, n:]
    S21, S22 = Z[n:, :n], Z[n:, n:]
    eye = np.eye(n)
    W = np.concatenate([S12, S22 + eye], axis=0)
    rhs = -np.concatenate([S11 + eye, S21], axis=0)
    # Normal equations, matching solve_care: the residual directions this
    # projection leaves happen to be annihilated by B^T in the gain formula,
    # giving ~300x better K accuracy than lstsq on stiff beam Hamiltonians.
    P = np.linalg.solve(W.T @ W, W.T @ rhs)
    P = 0.5 * (P + P.T)

    if is_stabilizing(P):
        P, res = kleinman_polish(P)
    else:
        try:
            from scipy.linalg import solve_continuous_are

            P_qz = solve_continuous_are(A, B, Q, R)
            P_qz = 0.5 * (P_qz + P_qz.T)
            if is_stabilizing(P_qz):
                P, res = kleinman_polish(P_qz)
            else:
                res = residual(P)
        except Exception:
            res = residual(P)

    return CareResult(P=P, iterations=np.asarray(k), residual=np.asarray(res))


def lqe_gain(A, C, V, W, **kwargs):
    """Kalman-Bucy estimator gain from the dual (filter) CARE.

    Solves ``A P + P A' - P C' W^-1 C P + V = 0`` (the steady-state
    covariance of the continuous Kalman filter with process noise ``V`` and
    measurement noise ``W``) as the control CARE of ``(A', C')``. Returns
    ``(L, P, result)`` with ``L = P C' W^-1``, so that ``A - L C`` is
    stable. ``kwargs`` go to :func:`solve_care` (``device``, ``dtype``...).
    """
    A, C, V, W = _as_tensors(A, C, V, W, device=kwargs.pop("device", None),
                             dtype=kwargs.pop("dtype", None))
    result = solve_care(A.mT, C.mT, V, W, **kwargs)
    L = torch.linalg.solve(W, C @ result.P).mT
    return L, result.P, result


def lqe_gain_numpy(A, C, V, W, **kwargs):
    """Float64 host twin of :func:`lqe_gain` (the design-time path; see
    :func:`solve_care_numpy` for why stiff beams need float64 here)."""
    A = np.asarray(A, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    result = solve_care_numpy(A.T, C.T, V, W, **kwargs)
    P = np.asarray(result.P)
    L = np.linalg.solve(np.asarray(W, dtype=np.float64), C @ P).T
    return L, P, result


def lqr_gain(A, B, Q, R, **kwargs):
    """LQR gain ``K = R^-1 B' P`` from :func:`solve_care`.

    Returns ``(K, P, result)``, the (gain, Riccati solution) pair of the
    reference's ``ct.lqr`` outputs ``K, S``; ``kwargs`` go to
    :func:`solve_care`.
    """
    A, B, Q, R = _as_tensors(A, B, Q, R, device=kwargs.pop("device", None),
                             dtype=kwargs.pop("dtype", None))
    result = solve_care(A, B, Q, R, **kwargs)
    K = torch.linalg.solve(R, B.mT @ result.P)
    return K, result.P, result

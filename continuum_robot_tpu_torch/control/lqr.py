"""LQR control design (host float64).

Counterpart of ``continuum_robot_tpu/control/lqr.py``, itself the parity
surface of the reference's ``control/linear_quadratic_regulator.py:5-200``:
the same constructor and validation contracts (square, PSD and PD checks
with the same tolerances and messages), ``get_A``/``get_B`` state-space
construction from the beam's K and M, the cached gain and the closed-loop
stability check that raises on instability. The design solve is the
host float64 twin ``ops/care.solve_care_numpy`` (a stiff beam's Hamiltonian
is out of float32 range); ``ops/care.solve_care`` is the tensor solver for
the card.
"""

from __future__ import annotations

import numpy as np

from ..ops import care


def beam_state_matrix(K_beam, M_beam) -> np.ndarray:
    """``A = [[0, I], [-M^-1 K, 0]]`` — the shared plant construction of the
    LQR (parity: ``linear_quadratic_regulator.py:84-117``) and LQE classes."""
    n = M_beam.shape[0]
    A = np.zeros((2 * n, 2 * n))
    A[:n, n:] = np.eye(n)
    try:
        # Explicit inverse (not solve) to match the reference's arithmetic
        # (linear_quadratic_regulator.py:106-110) bit-for-bit in goldens.
        A[n:, :n] = -np.linalg.inv(M_beam) @ K_beam
    except np.linalg.LinAlgError:
        raise ValueError("Mass matrix is singular and cannot be inverted")
    return A


class LinearQuadraticRegulator:
    """LQR for linear beam systems built from stiffness/mass matrices.

    ``input_dofs`` (optional): indices of the *actuated* position DOFs. The
    reference always assumes a force actuator on every free DOF
    (``B = [0; M^-1]``, ``linear_quadratic_regulator.py:119-146``), which is
    physically unrealizable for a continuum robot with a few tendons/coils.
    With ``input_dofs`` the input matrix becomes ``B = [0; M^-1 S]`` where
    ``S`` selects the actuated columns, and ``R`` must be m x m for m
    actuators.
    """

    def __init__(self, K_beam, M_beam, Q, R, input_dofs=None):
        K_beam = np.asarray(K_beam)
        M_beam = np.asarray(M_beam)
        Q = np.asarray(Q)
        R = np.asarray(R)
        self._validate_beam_matrices(K_beam, M_beam)
        self._validate_weighting_matrices(Q, R)
        if input_dofs is not None:
            input_dofs = np.atleast_1d(np.asarray(input_dofs, dtype=int))
            n = K_beam.shape[0]
            if input_dofs.ndim != 1 or len(input_dofs) == 0:
                raise ValueError("input_dofs must be a non-empty 1D index array")
            if np.any(input_dofs < 0) or np.any(input_dofs >= n):
                raise ValueError(
                    f"input_dofs indices must lie in [0, {n}) (got {input_dofs})"
                )
            if len(np.unique(input_dofs)) != len(input_dofs):
                raise ValueError("input_dofs indices must be unique")
        self.input_dofs = input_dofs

        self.K_beam = K_beam
        self.M_beam = M_beam
        self.Q = Q
        self.R = R
        self._A = None
        self._B = None
        self._K = None
        self._S = None
        self._E = None

    def _validate_beam_matrices(self, K_beam, M_beam) -> None:
        if K_beam.ndim != 2 or K_beam.shape[0] != K_beam.shape[1]:
            raise ValueError("Stiffness matrix must be square")
        if M_beam.ndim != 2 or M_beam.shape[0] != M_beam.shape[1]:
            raise ValueError("Mass matrix must be square")
        if K_beam.shape != M_beam.shape:
            raise ValueError(
                "Stiffness and mass matrices must have the same dimensions"
            )

    def _validate_weighting_matrices(self, Q, R) -> None:
        if Q.ndim != 2 or Q.shape[0] != Q.shape[1]:
            raise ValueError("Q matrix must be square")
        if R.ndim != 2 or R.shape[0] != R.shape[1]:
            raise ValueError("R matrix must be square")
        try:
            eigenvals_Q = np.linalg.eigvals(Q)
            if np.any(eigenvals_Q < -1e-10):
                raise ValueError("Q matrix must be positive semidefinite")
        except np.linalg.LinAlgError:
            raise ValueError("Q matrix must be positive semidefinite")
        try:
            eigenvals_R = np.linalg.eigvals(R)
            if np.any(eigenvals_R <= 1e-10):
                raise ValueError("R matrix must be positive definite")
        except np.linalg.LinAlgError:
            raise ValueError("R matrix must be positive definite")

    def get_A(self) -> np.ndarray:
        """``A = [[0, I], [-M^-1 K, 0]]`` (parity: ``:84-117``)."""
        if self._A is None:
            self._A = beam_state_matrix(self.K_beam, self.M_beam)
        return self._A

    def get_B(self) -> np.ndarray:
        """``B = [0; M^-1]`` — full actuation (parity: ``:119-146``) — or
        ``[0; M^-1 S]`` for the actuated-subset columns when ``input_dofs``
        is set."""
        if self._B is not None:
            return self._B
        M = self.M_beam
        n = M.shape[0]
        try:
            M_inv = np.linalg.inv(M)
        except np.linalg.LinAlgError:
            raise ValueError("Mass matrix is singular and cannot be inverted")
        if self.input_dofs is None:
            B = np.zeros((2 * n, n))
            B[n:, :] = M_inv
        else:
            m = len(self.input_dofs)
            B = np.zeros((2 * n, m))
            B[n:, :] = M_inv[:, self.input_dofs]
        self._B = B
        return B

    def compute_gain_matrix(self) -> np.ndarray:
        """Optimal gain via the host float64 CARE solve; validates stability.

        Raises ``ValueError`` if the solver fails or the closed loop has any
        eigenvalue with nonnegative real part (parity: ``:148-191``). The
        eigenvalue check is a design-time assertion on the host.
        """
        if self._K is not None:
            return self._K

        A = self.get_A()
        B = self.get_B()

        if self.Q.shape[0] != A.shape[0]:
            raise ValueError(
                f"Q matrix dimension {self.Q.shape[0]} must match state dimension {A.shape[0]}"
            )
        if self.R.shape[0] != B.shape[1]:
            raise ValueError(
                f"R matrix dimension {self.R.shape[0]} must match input dimension {B.shape[1]}"
            )

        try:
            # Design-time solve at float64 on the host (the sign-function
            # algorithm with Kleinman polish; see ops/care.py).
            result = care.solve_care_numpy(A, B, self.Q, self.R)
            P = np.asarray(result.P)
            K = np.linalg.solve(self.R, B.T @ P)
        except Exception as e:
            raise ValueError(f"Failed to solve LQR problem: {e}")
        if not np.all(np.isfinite(K)):
            raise ValueError("Failed to solve LQR problem: non-finite gain")

        A_cl = A - B @ K
        eigenvals = np.linalg.eigvals(A_cl)
        if np.any(np.real(eigenvals) >= 0):
            raise ValueError("LQR solution results in unstable closed-loop system")

        self._K, self._S, self._E = K, P, eigenvals
        return self._K

    def get_K(self) -> np.ndarray:
        return self.compute_gain_matrix()

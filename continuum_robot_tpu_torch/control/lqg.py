"""Output-feedback control: Kalman-Bucy estimation and LQG.

Counterpart of ``continuum_robot_tpu/control/lqg.py``. The reference's only
controller is full-state LQR; a continuum robot measures a few outputs (tip
position, a handful of strain or curvature sensors), so this module adds the
estimation layer on the same design machinery:

* :class:`LinearQuadraticEstimator`: the steady-state Kalman-Bucy gain ``L``
  from the dual CARE, with the validation, caching and stability-raise
  contracts of the LQR class.
* :class:`LinearQuadraticGaussian`: LQR and LQE composed (the separation
  principle): observer dynamics, the control law ``u = K (r - x_hat)``, a
  closed-loop RHS over the augmented state ``[x; x_hat]`` for the
  integrators, and the exact discrete propagator of that loop.

Design solves run on the host in float64 (``ops/care.solve_care_numpy``);
everything evaluated in a rollout is torch on the state's device and dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import care
from .lqr import LinearQuadraticRegulator


def output_matrix(n_states: int, measured_states) -> np.ndarray:
    """Selection output matrix ``C``: ``y = C x`` reads the listed state indices.

    ``measured_states`` indexes into the full ``[q; v]`` state vector (so a
    tip-displacement sensor on an ``n``-DOF beam is index ``n_pos - 2``, and
    its velocity is ``n_pos + n_pos - 2``).
    """
    measured = np.atleast_1d(np.asarray(measured_states, dtype=int))
    if measured.ndim != 1 or len(measured) == 0:
        raise ValueError("measured_states must be a non-empty 1D index array")
    if np.any(measured < 0) or np.any(measured >= n_states):
        raise ValueError(
            f"measured_states indices must lie in [0, {n_states}) (got {measured})"
        )
    if len(np.unique(measured)) != len(measured):
        raise ValueError("measured_states indices must be unique")
    C = np.zeros((len(measured), n_states))
    C[np.arange(len(measured)), measured] = 1.0
    return C


class LinearQuadraticEstimator:
    """Steady-state Kalman-Bucy filter for a linear beam system.

    Built from the same ``(K_beam, M_beam)`` pair as the LQR class (the plant
    ``A = [[0, I], [-M^-1 K, 0]]``), an output matrix ``C`` (p, 2n), process
    noise covariance ``V`` (2n, 2n, PSD) and measurement noise covariance
    ``W`` (p, p, PD). ``compute_gain_matrix()`` returns ``L`` with stable
    error dynamics ``A - L C`` (raises otherwise).
    """

    def __init__(self, K_beam, M_beam, C, V, W):
        K_beam = np.asarray(K_beam)
        M_beam = np.asarray(M_beam)
        C = np.asarray(C)
        V = np.asarray(V)
        W = np.asarray(W)

        if K_beam.ndim != 2 or K_beam.shape[0] != K_beam.shape[1]:
            raise ValueError("Stiffness matrix must be square")
        if M_beam.ndim != 2 or M_beam.shape != K_beam.shape:
            raise ValueError(
                "Stiffness and mass matrices must have the same dimensions"
            )
        n2 = 2 * K_beam.shape[0]
        if C.ndim != 2 or C.shape[1] != n2:
            raise ValueError(
                f"C matrix must be (n_outputs, {n2}) for this beam"
            )
        if V.shape != (n2, n2):
            raise ValueError(f"V matrix must be ({n2}, {n2})")
        if W.shape != (C.shape[0], C.shape[0]):
            raise ValueError("W matrix dimension must match the output count")
        if np.any(np.linalg.eigvals(0.5 * (V + V.T)) < -1e-10):
            raise ValueError("V matrix must be positive semidefinite")
        if np.any(np.linalg.eigvals(0.5 * (W + W.T)) <= 1e-12):
            raise ValueError("W matrix must be positive definite")

        self.K_beam = K_beam
        self.M_beam = M_beam
        self.C = C
        self.V = V
        self.W = W
        self._A = None
        self._L = None
        self._P = None

    def get_A(self) -> np.ndarray:
        if self._A is None:
            from .lqr import beam_state_matrix

            self._A = beam_state_matrix(self.K_beam, self.M_beam)
        return self._A

    def compute_gain_matrix(self) -> np.ndarray:
        """Estimator gain ``L = P C' W^-1`` via the dual CARE (cached)."""
        if self._L is not None:
            return self._L
        A = self.get_A()
        try:
            L, P, _ = care.lqe_gain_numpy(A, self.C, self.V, self.W)
        except Exception as e:
            raise ValueError(f"Failed to solve LQE problem: {e}")
        if not np.all(np.isfinite(L)):
            raise ValueError("Failed to solve LQE problem: non-finite gain")
        eigenvals = np.linalg.eigvals(A - L @ self.C)
        if np.any(np.real(eigenvals) >= 0):
            raise ValueError(
                "LQE solution results in unstable estimator error dynamics"
            )
        self._L, self._P = L, P
        return self._L

    def get_L(self) -> np.ndarray:
        return self.compute_gain_matrix()


def _apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("ij,...j->...i", m, x)``."""
    return x @ m.mT


class LinearQuadraticGaussian:
    """LQG output-feedback controller: LQR gain + Kalman-Bucy observer.

    Composes a designed :class:`LinearQuadraticRegulator` and
    :class:`LinearQuadraticEstimator` over the same plant. By the separation
    principle the closed-loop spectrum is ``eig(A - B K) U eig(A - L C)``.
    The host matrices go to a state's device and dtype on first use there.
    """

    def __init__(
        self,
        lqr: LinearQuadraticRegulator,
        lqe: LinearQuadraticEstimator,
    ):
        if lqr.K_beam.shape != lqe.K_beam.shape:
            raise ValueError("LQR and LQE must be designed for the same beam")
        if not (
            np.allclose(lqr.K_beam, lqe.K_beam)
            and np.allclose(lqr.M_beam, lqe.M_beam)
        ):
            raise ValueError("LQR and LQE must share the same K/M matrices")
        self.lqr = lqr
        self.lqe = lqe
        self.A = lqr.get_A()
        self.B = lqr.get_B()
        self.C = lqe.C
        self.K = lqr.compute_gain_matrix()
        self.L = lqe.compute_gain_matrix()
        self._uploads = {}

    def _mat(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device, like.dtype)
        if key not in self._uploads:
            self._uploads[key] = torch.as_tensor(getattr(self, name), dtype=like.dtype,
                                                 device=like.device)
        return self._uploads[key]

    @staticmethod
    def _like(v, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                               dtype=like.dtype, device=like.device)

    # -- rollout pieces on tensors -------------------------------------------

    def control(self, x_hat: torch.Tensor, r=None) -> torch.Tensor:
        """``u = K (r - x_hat)`` (the :class:`FullStateLinear` convention)."""
        err = -x_hat if r is None else self._like(r, x_hat) - x_hat
        return _apply(self._mat("K", x_hat), err)

    def observer_rhs(self, x_hat: torch.Tensor, y, u) -> torch.Tensor:
        """``d x_hat/dt = A x_hat + B u + L (y - C x_hat)``."""
        innov = self._like(y, x_hat) - _apply(self._mat("C", x_hat), x_hat)
        return (
            _apply(self._mat("A", x_hat), x_hat)
            + _apply(self._mat("B", x_hat), self._like(u, x_hat))
            + _apply(self._mat("L", x_hat), innov)
        )

    def closed_loop_rhs(self, r=None) -> Callable:
        """RHS over the augmented state ``z = [x; x_hat]``.

        The plant sees only the observer-based control; the observer sees
        only the measured output ``y = C x``. Broadcasts over leading batch
        axes; the integrators' ``u`` is an extra force added to the control
        (a constant or a callable of ``t``).
        """
        n = self.A.shape[0]

        def rhs(t, z, u_ext=None):
            x, x_hat = z[..., :n], z[..., n:]
            u = self.control(x_hat, r)
            if u_ext is not None:
                u = u + self._like(u_ext(t) if callable(u_ext) else u_ext, z)
            dx = _apply(self._mat("A", z), x) + _apply(self._mat("B", z), u)
            y = _apply(self._mat("C", z), x)
            dx_hat = self.observer_rhs(x_hat, y, u)
            return torch.cat([dx, dx_hat], dim=-1)

        return rhs

    def make_closed_loop_propagator(self, dt: float, dtype: torch.dtype = torch.float32,
                                    device=None) -> Callable:
        """Exact discrete propagator for the augmented closed loop.

        The LQG loop is LTI, so zero-order-hold discretization via the
        matrix exponential (``ops/exponential.discretize_lti``, host
        float64) is exact and stable at any frame spacing, past the
        stability limit of any explicit stepper on cheap-control designs.
        ``Phi`` and ``Gamma`` go to ``device`` (None: the card) in
        ``dtype``; inputs follow them.

        Returns ``propagate(z0, r_frames, n_frames=None) -> (frames+1, ...,
        4n)`` over ``z = [x; x_hat]``; ``r_frames`` has shape ``(frames,
        ..., 2n)`` (per-frame reference, ZOH) or ``(2n,)``, a constant
        reference, which then requires ``n_frames``. A frame is one
        ``addmm`` on the card: ``z_{k+1} = z_k Phi' + (Gamma r_k)``, the
        reference terms formed for all frames at once.
        """
        from ..models.simulate import resolve_device
        from ..ops.exponential import discretize_lti

        dev = resolve_device(device)
        A_aug = self.augmented_matrix()
        BK = self.B @ self.K
        B_aug = np.concatenate([BK, BK], axis=0)  # reference feed-in
        Phi_np, Gamma_np = discretize_lti(A_aug, B_aug, dt)
        PhiT = torch.as_tensor(Phi_np.T, dtype=dtype, device=dev)
        GammaT = torch.as_tensor(Gamma_np.T, dtype=dtype, device=dev)

        def propagate(z0, r_frames, n_frames=None) -> torch.Tensor:
            z0 = torch.as_tensor(z0 if isinstance(z0, torch.Tensor) else np.asarray(z0),
                                 dtype=dtype, device=dev)
            r = torch.as_tensor(r_frames if isinstance(r_frames, torch.Tensor)
                                else np.asarray(r_frames), dtype=dtype, device=dev)
            if r.ndim == 1:
                if n_frames is None:
                    raise ValueError(
                        "a constant (2n,) reference needs n_frames to set "
                        "the rollout length"
                    )
                g = (r @ GammaT).expand(n_frames, *r.shape[:-1], PhiT.shape[0])
            else:
                g = r @ GammaT
            frames = g.shape[0]
            shape = torch.broadcast_shapes(z0.shape, g.shape[1:])
            zs = z0.new_empty((frames + 1, *shape))
            zs[0] = z0
            n4 = shape[-1]
            flat = zs.view(frames + 1, -1, n4)
            for k in range(frames):
                torch.addmm(g[k].reshape(-1, n4) if g[k].dim() > 1 else g[k],
                            flat[k], PhiT, out=flat[k + 1])
            return zs

        return propagate

    def augmented_matrix(self) -> np.ndarray:
        """Closed-loop matrix over ``[x; x_hat]`` (host-side analysis).

        ``[[A, -B K], [L C, A - B K - L C]]``: its spectrum is
        ``eig(A - B K) U eig(A - L C)`` by separation.
        """
        A, B, C, K, L = self.A, self.B, self.C, self.K, self.L
        return np.block([[A, -B @ K], [L @ C, A - B @ K - L @ C]])

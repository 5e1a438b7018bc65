"""Extended Kalman filtering for nonlinear beam state estimation.

Counterpart of ``continuum_robot_tpu/control/ekf.py``. The LQG stack
(``control/lqg.py``) covers linear beams with a steady-state Kalman-Bucy
gain; for nonlinear beams (von Kármán elements, state-dependent drag) the
estimator linearizes along the trajectory. This module is a discrete-time
EKF whose transition Jacobian comes from ``torch.func`` forward mode through
the actual step function, so the filter's model is the simulator's.

Batches of filters: every state carries leading batch axes (the JAX
package's ``vmap`` over filters). The transition Jacobian of all filters
comes from one forward-mode pass a basis vector: the step acts on each
filter's row alone, so the tangent ``e_j`` on every row gives column ``j``
of every filter's Jacobian. ``step_fn`` must therefore broadcast over
leading axes, as :func:`make_discrete_step`'s does; a measurement callable
``h`` sees one state, as in the JAX package, and is vectorized with
``torch.func.vmap``.

Usage sketch::

    step = make_discrete_step(model, dt)        # x_{k+1} = f(x_k, u_k)
    ekf = make_ekf(step, C, V, W)
    final, estimates = run_ekf(ekf, x0_hat, P0, ys)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class EKFState(NamedTuple):
    """Filter carry: state estimate and its error covariance."""

    x_hat: torch.Tensor  # (..., n)
    P: torch.Tensor  # (..., n, n)


def make_discrete_step(model, dt: float, substeps: int = 1) -> Callable:
    """Discrete transition ``x_{k+1} = f(x_k, u_k)`` for a dynamic beam model.

    One RK4 advance (``substeps`` inner steps) of the model's full RHS
    (``build_rhs``): the simulator's own physics, so the EKF's model is
    exact up to integration error. ``u_k`` is the constant force over the
    step (may be ``None``). Runs on ``x``'s device and dtype and broadcasts
    over its leading axes.
    """
    from ..ops.integrators import rk4_step

    rhs = model.build_rhs()
    h = dt / substeps

    def step(x, u=None):
        for _ in range(int(substeps)):
            x = rk4_step(rhs, 0.0, x, h, u)
        return x

    return step


def transition_jacobian(step_fn: Callable, x: torch.Tensor, u=None):
    """``(f(x, u), F)`` with ``F = df/dx`` of each filter, ``(..., n, n)``.

    One ``torch.func.jvp`` a basis vector under ``torch.func.vmap``: the
    primal does not depend on the tangent, so it runs once, as
    ``jax.linearize`` shares it.
    """
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = eye.reshape(n, *([1] * (x.dim() - 1)), n).expand(n, *x.shape)

    def push(t):
        return torch.func.jvp(lambda z: step_fn(z, u), (x,), (t,))

    x_next, cols = torch.func.vmap(push, out_dims=(None, 0))(basis)
    return x_next, cols.movedim(0, -1)


def make_ekf(
    step_fn: Callable,
    C,
    V,
    W,
    joseph: bool = True,
) -> Callable:
    """Build an EKF update ``(EKFState, y, u) -> (EKFState, x_hat)``.

    Args:
      step_fn: discrete transition ``f(x, u) -> x_next`` on tensors,
        broadcasting over leading axes (its Jacobian is taken at every
        predict by :func:`transition_jacobian`).
      C: measurement matrix ``(p, n)`` (``y = C x + noise``), or a callable
        ``h(x) -> y`` of one state (its Jacobian by ``torch.func.jacfwd``).
      V: process noise covariance ``(n, n)`` per step.
      W: measurement noise covariance ``(p, p)``.
      joseph: the Joseph-form covariance update (keeps ``P`` symmetric PSD
        in float32).

    Innovation gains come from ``torch.linalg.solve`` (no explicit
    inverse). The matrices go to the state's device and dtype on first use
    there.
    """
    h_fn: Optional[Callable] = C if callable(C) else None
    mats = {"V": np.asarray(V), "W": np.asarray(W)}
    if h_fn is None:
        mats["C"] = np.asarray(C)
    uploads = {}

    def mat(name, like):
        key = (name, like.device, like.dtype)
        if key not in uploads:
            uploads[key] = torch.as_tensor(mats[name], dtype=like.dtype, device=like.device)
        return uploads[key]

    def measure(x_pred):
        """``(H (..., p, n), y_pred (..., p))`` at the predicted state."""
        if h_fn is None:
            H = mat("C", x_pred)
            return H, x_pred @ H.mT
        flat = x_pred.reshape(-1, x_pred.shape[-1])
        H = torch.func.vmap(torch.func.jacfwd(h_fn))(flat)
        y_pred = torch.func.vmap(h_fn)(flat)
        batch = x_pred.shape[:-1]
        return H.reshape(*batch, *H.shape[1:]), y_pred.reshape(*batch, -1)

    def ekf_update(state: EKFState, y, u=None):
        x_hat, P = state

        # Predict: linearize the actual transition at the current estimate.
        x_pred, F = transition_jacobian(step_fn, x_hat, u)
        P_pred = F @ P @ F.mT + mat("V", x_hat)

        # Measurement linearization.
        H, y_pred = measure(x_pred)

        # Innovation and gain: K = P H' (H P H' + W)^-1 via solve.
        Wm = mat("W", x_hat)
        S = H @ P_pred @ H.mT + Wm
        K = torch.linalg.solve(S, H @ P_pred).mT
        y = torch.as_tensor(y if isinstance(y, torch.Tensor) else np.asarray(y),
                            dtype=x_hat.dtype, device=x_hat.device)
        x_new = x_pred + (K @ (y - y_pred)[..., None])[..., 0]

        eye = torch.eye(x_hat.shape[-1], dtype=x_hat.dtype, device=x_hat.device)
        if joseph:
            IKH = eye - K @ H
            P_new = IKH @ P_pred @ IKH.mT + K @ Wm @ K.mT
        else:
            P_new = (eye - K @ H) @ P_pred
        P_new = 0.5 * (P_new + P_new.mT)

        return EKFState(x_new, P_new), x_new

    return ekf_update


def run_ekf(
    ekf_update: Callable,
    x0_hat,
    P0,
    ys,
    us=None,
    device=None,
):
    """Run the filter over a measurement sequence.

    Args:
      ys: ``(T, ..., p)`` measurements (a batch of filters after the time
        axis).
      us: optional ``(T, ..., n)`` per-step inputs (or ``None``).
      device: where the filter runs; tensors keep theirs unless it is
        given, NumPy inputs go to it (None: the card).

    Returns ``(final EKFState, (T, ..., n) estimates)``.
    """
    from ..models.simulate import resolve_device

    ref = x0_hat if isinstance(x0_hat, torch.Tensor) else None
    dev = torch.device(device) if device is not None else (
        ref.device if ref is not None else resolve_device(None))
    dtype = ref.dtype if ref is not None else torch.float64

    def tensor(v):
        return torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                               dtype=dtype, device=dev)

    state = EKFState(tensor(x0_hat), tensor(P0))
    ys = tensor(ys)
    us = None if us is None else tensor(us)
    out = []
    for k in range(ys.shape[0]):
        state, x = ekf_update(state, ys[k], None if us is None else us[k])
        out.append(x)
    return state, torch.stack(out)

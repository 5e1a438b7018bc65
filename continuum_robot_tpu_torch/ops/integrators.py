"""Implicit time integration: Newmark-β and generalized-α with Newton.

Counterpart of the implicit part of ``continuum_robot_tpu/ops/integrators.py``:
:class:`NewmarkOperator`, :func:`newmark_step`,
:func:`generalized_alpha_step`, :func:`integrate_generalized_alpha` and
:func:`integrate_newmark`, with the JAX package's expression order. The
unknown is the end-of-step acceleration; a fixed number of Newton
iterations solves for it with the operator's block-tridiagonal (or dense
inverse) Jacobian solves. The JAX package's ``lax.scan``/``fori_loop``
become Python loops over steps and Newton iterations on the state
tensors, which keep their device and dtype; everything broadcasts over
leading batch axes.

The input force ``u`` is None, a constant (tensor or array over position
DOFs) or a callable ``t -> force``; ``op.external_force(x, t)`` takes the
state ``x = [q; v]``. Times are Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class NewmarkOperator:
    """Problem operators for the implicit stepper (callables on tensors).

    * ``mass_apply(q_like) -> M @ q_like``
    * ``internal_force(q) -> k(q)`` (reduced coordinates)
    * ``external_force(x, t) -> f`` over position DOFs (may be None)
    * ``solve(q, c, a=1.0) -> callable r -> (a M + c K_tan(q))^{-1} r`` —
      builds the effective-Jacobian solver at the Newton linearization
      point; the factorization happens when ``solve`` is called, not per
      application of the returned closure.
    * ``tangent_frozen``: True when ``K_tan`` does not depend on ``q``
      (all-linear beam, or modified Newton with the zero-state tangent); the
      steppers then build one solver per step and reuse it across Newton
      iterates.
    """

    mass_apply: Callable
    internal_force: Callable
    external_force: Optional[Callable]
    solve: Callable
    tangent_frozen: bool = False


def _input(u, like):
    """A constant input as a tensor on ``like``'s device and dtype; callables
    and None pass through."""
    if u is None or callable(u):
        return u
    return torch.as_tensor(u, dtype=like.dtype, device=like.device)


def _input_at(u, t, like):
    if callable(u):
        return torch.as_tensor(u(t), dtype=like.dtype, device=like.device)
    return _input(u, like)


def newmark_step(op: NewmarkOperator, t, q, v, a, dt, u=None, beta: float = 0.25,
                 gamma: float = 0.5, n_newton: int = 2):
    """One Newmark-β step (average acceleration by default).

    Newton on the end-of-step acceleration ``a1``:

        r(a1) = M a1 + k(q1(a1)) - F(x1, t1) - u
        J     = M + beta dt^2 K_tan(q1)

    with a fixed ``n_newton`` iteration count. Returns ``(q1, v1, a1)``.
    """
    t1 = t + dt
    q_pred = q + dt * v + (0.5 - beta) * dt * dt * a
    v_pred = v + (1.0 - gamma) * dt * a

    # Frozen tangent: one factored system serves every Newton iterate.
    frozen_solve = op.solve(q, beta * dt * dt) if op.tangent_frozen else None

    a1 = a
    for _ in range(int(n_newton)):
        q1 = q_pred + beta * dt * dt * a1
        r = op.mass_apply(a1) + op.internal_force(q1)
        if op.external_force is not None:
            v1 = v_pred + gamma * dt * a1
            r = r - op.external_force(torch.cat([q1, v1], dim=-1), t1)
        if u is not None:
            r = r - _input_at(u, t1, r)
        da = (frozen_solve or op.solve(q1, beta * dt * dt))(r)
        a1 = a1 - da
    q1 = q_pred + beta * dt * dt * a1
    v1 = v_pred + gamma * dt * a1
    return q1, v1, a1


def generalized_alpha_step(op: NewmarkOperator, t, q, v, a, dt, u=None,
                           rho_inf: float = 0.8, n_newton: int = 2):
    """One generalized-α (Chung-Hulbert) step.

    Balance at the shifted midpoints
    ``M a_{n+1-am} + k(q_{n+1-af}) = F(x_{n+1-af}, t_{n+1-af}) + u`` with
    effective Jacobian ``(1-am) M + (1-af) beta dt^2 K_tan``; ``rho_inf`` in
    [0, 1] sets the high-frequency dissipation. Returns ``(q1, v1, a1)``.
    """
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma = 0.5 - am + af

    t_af = t + (1.0 - af) * dt
    q_pred = q + dt * v + (0.5 - beta) * dt * dt * a
    v_pred = v + (1.0 - gamma) * dt * a

    c = (1.0 - af) * beta * dt * dt
    a_scale = 1.0 - am

    # Frozen tangent: one factored system serves every Newton iterate.
    frozen_solve = op.solve(q, c, a_scale) if op.tangent_frozen else None

    a1 = a
    for _ in range(int(n_newton)):
        q1 = q_pred + beta * dt * dt * a1
        q_af = (1.0 - af) * q1 + af * q
        a_am = (1.0 - am) * a1 + am * a
        r = op.mass_apply(a_am) + op.internal_force(q_af)
        if op.external_force is not None:
            v1 = v_pred + gamma * dt * a1
            v_af = (1.0 - af) * v1 + af * v
            r = r - op.external_force(torch.cat([q_af, v_af], dim=-1), t_af)
        if u is not None:
            r = r - _input_at(u, t_af, r)
        da = (frozen_solve or op.solve(q_af, c, a_scale))(r)
        a1 = a1 - da
    q1 = q_pred + beta * dt * dt * a1
    v1 = v_pred + gamma * dt * a1
    return q1, v1, a1


def initial_accel(op: NewmarkOperator, q0, v0, t0: float = 0.0, u=None):
    """Consistent initial acceleration: ``M a0 = F(x0, t0) + u - k(q0)``,
    solved with the operator's plain mass solve (``c = 0``)."""
    f0 = -op.internal_force(q0)
    if op.external_force is not None:
        f0 = f0 + op.external_force(torch.cat([q0, v0], dim=-1), t0)
    if u is not None:
        f0 = f0 + _input_at(u, t0, f0)
    return op.solve(q0, 0.0)(f0)


def _rollout(step, op, q0, v0, t0, dt, n_steps, u, substeps):
    u = _input(u, q0)
    q, v, a = q0, v0, initial_accel(op, q0, v0, t0, u)
    h = dt / substeps
    qs, vs = [q0], [v0]
    for i in range(int(n_steps)):
        t_frame = t0 + i * dt
        for j in range(int(substeps)):
            q, v, a = step(t_frame + j * h, q, v, a, h, u)
        qs.append(q)
        vs.append(v)
    ts = t0 + dt * torch.arange(int(n_steps) + 1, dtype=torch.float64, device=q0.device)
    return ts, torch.stack(qs), torch.stack(vs)


def integrate_generalized_alpha(op: NewmarkOperator, q0, v0, t0: float, dt: float,
                                n_steps: int, u=None, rho_inf: float = 0.8,
                                n_newton: int = 2, substeps: int = 1,
                                remat: bool = False):
    """Generalized-α rollout: ``n_steps`` frames of ``substeps`` steps.

    Returns ``(ts (n_steps+1,), qs (n_steps+1, ..., n), vs)`` including the
    initial state. ``remat=True`` (rematerialized frames for reverse-mode
    sweeps) is not ported and raises.
    """
    if remat:
        raise NotImplementedError("remat (rematerialized autograd sweeps) is not yet ported")

    def step(t, q, v, a, h, u):
        return generalized_alpha_step(op, t, q, v, a, h, u, rho_inf=rho_inf,
                                      n_newton=n_newton)

    return _rollout(step, op, q0, v0, t0, dt, n_steps, u, substeps)


def integrate_newmark(op: NewmarkOperator, q0, v0, t0: float, dt: float, n_steps: int,
                      u=None, beta: float = 0.25, gamma: float = 0.5, n_newton: int = 2,
                      substeps: int = 1):
    """Newmark rollout; returns ``(ts, qs, vs)`` including the initial state.

    The initial acceleration solves ``M a0 = F(x0, t0) + u - k(q0)`` with
    the operator's solver at ``c = 0`` (the plain mass solve).
    """

    def step(t, q, v, a, h, u):
        return newmark_step(op, t, q, v, a, h, u, beta=beta, gamma=gamma,
                            n_newton=n_newton)

    return _rollout(step, op, q0, v0, t0, dt, n_steps, u, substeps)

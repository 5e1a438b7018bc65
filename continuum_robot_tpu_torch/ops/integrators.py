"""Time integration: explicit, adaptive and implicit steppers on tensors.

Counterpart of ``continuum_robot_tpu/ops/integrators.py``, with the JAX
package's expression order:

* :func:`rk4_step` / :func:`integrate_fixed` — classic explicit
  fixed-step RK4 (``remat=True`` checkpoints each frame for reverse mode);
* :func:`dopri5_step` / :func:`integrate_adaptive` — Dormand-Prince 5(4)
  with its embedded estimate and step control;
* :class:`AdaptiveStats` / :func:`adaptive_drive` — the accept/reject
  interval driver behind every adaptive engine;
* :func:`newmark_step`, :func:`generalized_alpha_step` and their fixed-step
  rollouts (``integrate_generalized_alpha(remat=True)`` checkpoints each
  frame); :func:`integrate_generalized_alpha_adaptive` (Zienkiewicz-Xie
  estimate) and :func:`sdirk3_step` / :func:`integrate_sdirk3_adaptive`
  (L-stable SDIRK3), the error-controlled implicit engines.

The JAX package's ``lax.scan``/``fori_loop`` become Python loops on the
state tensors, which keep their device and dtype; everything broadcasts
over leading batch axes. Its ``lax.while_loop`` of adaptive trials becomes
a loop of masked trials that reads the device's loop flag on the host
every :data:`HOST_CHECK_INTERVAL` trials (a trial of a finished loop
changes nothing, so the interval moves no result). ``per_env=True`` on
the adaptive integrators is the counterpart of ``jax.vmap`` over the
leading axis: every environment gets its own step size, time and
counters; by default a batch shares one controller, as an un-vmapped
call does in the JAX package.

The input force ``u`` is None, a constant (tensor or array over position
DOFs) or a callable ``t -> force``; ``op.external_force(x, t)`` takes the
state ``x = [q; v]``. The fixed-step integrators pass times as Python
floats; the adaptive ones as tensors in the controller dtype, of the batch
shape with ``per_env``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint


# ---------------------------------------------------------------------------
# Explicit fixed-step: RK4
# ---------------------------------------------------------------------------


def rk4_step(rhs: Callable, t, x, dt, u=None):
    """One classic Runge-Kutta 4 step."""
    k1 = rhs(t, x, u)
    k2 = rhs(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    k3 = rhs(t + 0.5 * dt, x + 0.5 * dt * k2, u)
    k4 = rhs(t + dt, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate_fixed(rhs: Callable, x0: torch.Tensor, t0: float, dt: float, n_steps: int,
                    u=None, substeps: int = 1, step_fn: Callable = rk4_step,
                    remat: bool = False):
    """Fixed-step rollout: ``n_steps`` saved frames, ``substeps`` inner steps.

    Returns ``(ts (n_steps+1,), xs (n_steps+1, ...))`` including the initial
    state. Step times are Python floats ``t0 + i*dt + j*h``, the JAX
    package's arithmetic. ``remat=True`` runs each frame under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``):
    reverse mode stores one state per frame and recomputes the substeps.
    """
    u = _input(u, x0)
    h = dt / substeps

    def advance(x, t_frame):
        for j in range(int(substeps)):
            x = step_fn(rhs, t_frame + j * h, x, h, u)
        return x

    x, xs = x0, [x0]
    for i in range(int(n_steps)):
        t_frame = t0 + i * dt
        if remat:
            x = torch.utils.checkpoint.checkpoint(advance, x, t_frame, use_reentrant=False)
        else:
            x = advance(x, t_frame)
        xs.append(x)
    ts = t0 + dt * torch.arange(int(n_steps) + 1, dtype=torch.float64, device=x0.device)
    return ts, torch.stack(xs)


# ---------------------------------------------------------------------------
# Explicit adaptive: Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

# Butcher tableau (Dormand & Prince 1980), float64 literals.
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.zeros((7, 7))
_DP_A[1, 0] = 1 / 5
_DP_A[2, :2] = [3 / 40, 9 / 40]
_DP_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_DP_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_DP_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_DP_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)


# The tableau's nonzero weights in use order: the stages' a_ij (the last
# stage's row is b5: its argument is the fifth-order solution), then
# b5_i - b4_i; and the stage nodes c_1..c_6.
_DP_STAGE = [(i, j) for i in range(7) for j in range(i) if _DP_A[i, j] != 0.0]
_DP_ERR = [i for i in range(7) if _DP_B5[i] - _DP_B4[i] != 0.0]
_DP_WEIGHTS = np.array([_DP_A[i, j] for i, j in _DP_STAGE]
                       + [_DP_B5[i] - _DP_B4[i] for i in _DP_ERR])
_dp_uploads = {}


def _dp_consts(like: torch.Tensor):
    """The weights and nodes in ``like``'s dtype on its device (once)."""
    key = (like.device, like.dtype)
    if key not in _dp_uploads:
        _dp_uploads[key] = tuple(torch.as_tensor(v, dtype=like.dtype, device=like.device)
                                 for v in (_DP_WEIGHTS, _DP_C[1:]))
    return _dp_uploads[key]


def _dopri5(rhs: Callable, t, x, dt, u, k1=None):
    """``(x5, err, k7)``: one Dopri5 step, and the last stage's derivative.

    ``dt * w`` for every tableau weight is formed in one operation; each
    stage and the error sum then accumulate ``+ (dt w) k`` term by term in
    tableau order (``torch.addcmul``), the JAX package's ``x + dt * w * k``.
    The last stage's argument is the fifth-order solution (its row of the
    tableau is ``b5``, summed in the same order), so it is returned as
    ``x5``; and ``k7 = rhs(t + dt, x5)`` is the next step's ``k1`` (first
    same as last), which a caller passes back as ``k1`` bit for bit as the
    JAX package recomputes it.
    """
    weights, nodes = _dp_consts(x)
    if not isinstance(dt, torch.Tensor):
        dt = torch.tensor(dt, dtype=x.dtype, device=x.device)
    # dt * w_m for every term m, each a (..., 1) column against the state;
    # c_i * dt for the stage nodes.
    cols = (dt[..., None] * weights).unsqueeze(-1).unbind(-2)
    offsets = (dt[..., None] * nodes).unbind(-1)
    ks = [rhs(t, x, u) if k1 is None else k1]
    m = 0
    for i in range(1, 7):
        xi = x
        while m < len(_DP_STAGE) and _DP_STAGE[m][0] == i:
            xi = torch.addcmul(xi, cols[m], ks[_DP_STAGE[m][1]])
            m += 1
        ks.append(rhs(t + offsets[i - 1], xi, u))
    err = torch.zeros_like(x)
    for i in _DP_ERR:
        err = torch.addcmul(err, cols[m], ks[i])
        m += 1
    return xi, err, ks[6]


def dopri5_step(rhs: Callable, t, x, dt, u=None):
    """One Dopri5 step; returns ``(x5, err_vec)`` (5th-order sol + estimate).

    Seven right-hand sides; :func:`integrate_adaptive` carries the seventh
    into the next step as its first (first same as last), the same value
    the JAX package recomputes there.
    """
    x5, err, _ = _dopri5(rhs, t, x, dt, u)
    return x5, err


# Trials between two host reads of the adaptive loop's flag. A trial after
# the loop has ended changes nothing, so the value moves no result, only
# how often the host waits for the device and how many masked trials run.
# A trial is host issue at every width measured (H100: Dopri5 at 1 and
# 4096 envs, stiff60 generalized-alpha at 1 and 4096; chip_compare.py
# --sections adaptive), so a read costs the queue's tail while a masked
# trial costs a whole trial: over the four together 1 took the least time
# and 8 the most.
HOST_CHECK_INTERVAL = 1


class AdaptiveStats(NamedTuple):
    """Solver counters (int32 tensors; of the batch shape under ``per_env``).

    ``n_incomplete`` counts output intervals whose accept/reject loop
    exited without reaching the interval end (step cap hit, or time
    advance stalled at the dtype's resolution): nonzero means frames from
    that point on are truncated states, not converged ones.

    ``dt_next`` is the controller's learned step proposal at the end of
    the run: pass it back as ``dt0`` to resume a span without the
    controller's ramp-up. ``host_reads`` counts the times the host read the
    device's loop flag (one an interval, then one each
    :data:`HOST_CHECK_INTERVAL` trials) and ``trials_run`` the trials the
    device ran, the masked ones after a loop's end included (host ints).
    """

    n_steps: Any
    n_accepted: Any
    n_rejected: Any
    n_incomplete: Any = 0
    dt_next: Any = None
    host_reads: int = 0
    trials_run: int = 0


def _tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _where(mask, new, old):
    """``torch.where`` of a batch-shaped mask against ``(*batch, ...)`` leaves."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())),
                       new, old)


def _first_leaf(tree):
    return _first_leaf(tree[0]) if isinstance(tree, tuple) else tree


def adaptive_drive(
    trial: Callable,
    state0,
    t_eval,
    dt0,
    err_exponent: float,
    max_steps_per_interval: int = 100_000,
    safety: float = 0.9,
    frame_out: Callable = None,
    per_env: bool = False,
):
    """Shared accept/reject interval driver behind every adaptive engine.

    ``trial(t, dt, state) -> (state1, en)`` runs one trial step and returns
    the candidate state and its error norm (``en <= 1`` accepts). The driver
    owns the loop over output intervals, the accept/reject loop inside each,
    clamping to the interval end, the controller ``factor = clip(safety *
    en**err_exponent, 0.2, 5)`` and the :class:`AdaptiveStats` bookkeeping.

    Two controller policies, as in the JAX package:

    * **Interval-end clamping does not pollute the learned step.** When a
      trial dt clamped to the interval remainder is accepted, the next
      interval resumes from the pre-clamp ``dt_est``.
    * **Truncation is counted, never silent.** An interval that exits at
      ``max_steps_per_interval``, or whose ``t + dt == t`` at the working
      precision (a stall, which exits at once), increments
      ``stats.n_incomplete``; its frame holds the partial state.

    The JAX package's ``while_loop`` becomes a loop of trials each masked
    by the loop condition; the host reads the device's flag every
    :data:`HOST_CHECK_INTERVAL` trials, and stops without a read after
    ``max_steps_per_interval`` trials. ``per_env=True`` is the JAX
    package's ``jax.vmap`` over the leading axis of the state's leaves:
    ``t``, ``dt_est``, ``en`` and the counters have the batch shape (the
    leaves' shape but the last axis), each environment's update is masked
    by its own condition and the loop runs until every environment is done.

    ``t_eval`` (host array or tensor) runs in the controller dtype, that of
    ``dt0`` when it is a tensor, else the state's. Returns ``(final_state,
    frames, stats)`` with ``frames`` stacking ``frame_out(state)`` (default:
    the state) at each of the ``len(t_eval) - 1`` interval ends, frame axis
    leading.
    """
    if frame_out is None:
        def frame_out(s):
            return s

    ref = _first_leaf(state0)
    dev = ref.device
    if isinstance(dt0, torch.Tensor):
        dt0 = dt0.to(dev)
    else:
        dt0 = torch.tensor(float(dt0), dtype=ref.dtype, device=dev)
    dtype = dt0.dtype
    if isinstance(t_eval, torch.Tensor):
        t_eval = t_eval.to(device=dev, dtype=dtype)
    else:
        t_eval = torch.as_tensor(np.asarray(t_eval), dtype=dtype, device=dev)
    t_eps = 32.0 * torch.finfo(dtype).eps
    batch = tuple(ref.shape[:-1]) if per_env else ()

    def zeros():
        return torch.zeros(batch, dtype=torch.int32, device=dev)

    dt_est = dt0.expand(batch)
    state, frames, reads, runs = state0, [], 0, 0
    n_steps, n_acc, n_inc = zeros(), zeros(), zeros()
    for i in range(t_eval.shape[0] - 1):
        t_end = t_eval[i + 1]
        t_lim = t_end - t_eps * torch.clamp(t_end.abs(), min=1.0)
        t = t_eval[i].expand(batch)
        n, acc = zeros(), zeros()
        stalled = torch.zeros(batch, dtype=torch.bool, device=dev)
        active = t < t_lim
        k = 0
        while k < max_steps_per_interval:  # past it every loop has ended
            if k % HOST_CHECK_INTERVAL == 0:
                reads += 1
                if not bool(active.any()):
                    break
            k += 1
            dt_room = t_end - t
            dt = torch.minimum(dt_est, dt_room)
            clamped = dt_room < dt_est
            state1, en = trial(t, dt, state)
            accept = en <= 1.0
            factor = torch.clamp(
                safety * torch.pow(torch.clamp(en, min=1e-16), err_exponent), 0.2, 5.0)
            dt_next = torch.where(accept & clamped, dt_est, dt * factor)
            take = active & accept
            t_new = torch.where(take, t + dt, t)
            # Stall: an accepted step whose dt is below the resolution of t.
            stalled = stalled | (take & (t_new <= t))
            state = _tree_map(lambda new, old: _where(take, new, old), state1, state)
            t = t_new
            dt_est = torch.where(active, dt_next, dt_est)
            n = n + active
            acc = acc + take
            active = (t < t_lim) & (n < max_steps_per_interval) & ~stalled
        runs += k
        n_steps = n_steps + n
        n_acc = n_acc + acc
        n_inc = n_inc + (t < t_lim)
        frames.append(frame_out(state))
    if frames:
        frames = _tree_map(lambda *fs: torch.stack(fs), *frames)
    stats = AdaptiveStats(n_steps, n_acc, n_steps - n_acc, n_inc,
                          dt_next=dt_est, host_reads=reads, trials_run=runs)
    return state, frames, stats


def _floored_tols(rtol: float, atol: float, dtype):
    """Tolerances floored at the working precision (50 eps; atol 1e-3 of
    that): tighter ones are unreachable and the controller would reject
    until the step cap."""
    eps = torch.finfo(dtype).eps
    return max(float(rtol), 50.0 * eps), max(float(atol), 50.0 * eps * 1e-3)


def _rms(r: torch.Tensor, per_env: bool) -> torch.Tensor:
    return torch.sqrt(r.mean(-1) if per_env else r.mean())


def integrate_adaptive(
    rhs: Callable,
    x0: torch.Tensor,
    t_eval,
    u=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: float = 1e-4,
    max_steps_per_interval: int = 10_000,
    safety: float = 0.9,
    per_env: bool = False,
):
    """Adaptive Dopri5 hitting every ``t_eval`` point exactly.

    Error norm: the Hairer RMS over ``atol + rtol * max(|x_old|, |x_new|)``
    (over every axis, or per environment with ``per_env``); controller
    exponent -1/5. Returns ``(xs (len(t_eval), ...), AdaptiveStats)`` with
    ``xs[0] = x0``.
    """
    rtol, atol = _floored_tols(rtol, atol, x0.dtype)
    u = _input(u, x0)

    def trial(t, dt, xk):
        # The state carries rhs(t, x): a rejected trial keeps it, an
        # accepted one takes the step's last stage (first same as last).
        x, k1 = xk
        x_new, err, k7 = _dopri5(rhs, t, x, dt, u, k1)
        scale = atol + rtol * torch.maximum(x.abs(), x_new.abs())
        return (x_new, k7), _rms((err / scale) ** 2, per_env)

    # One drive an output interval, each from rhs at the interval's grid
    # time, as the JAX package's first trial there computes it (the last
    # step's time can miss the grid by an ulp); adaptive_drive's state, dt and
    # counters carry over exactly.
    te = _host_times(t_eval)
    x, dt_est, xs = x0, _controller_dt(dt0, x0), [x0]
    zero = torch.zeros(x0.shape[:-1] if per_env else (), dtype=torch.int32,
                       device=x0.device)
    stats = AdaptiveStats(zero, zero, zero, zero, dt_next=dt_est)
    for i in range(len(te) - 1):
        t_i = torch.as_tensor(te[i], dtype=dt_est.dtype, device=x0.device)
        k1 = rhs(t_i.expand(x0.shape[:-1]) if per_env else t_i, x, u)
        (x, _), _, st = adaptive_drive(
            trial, (x, k1), te[i : i + 2], dt_est, -0.2,
            max_steps_per_interval=max_steps_per_interval, safety=safety,
            per_env=per_env,
        )
        xs.append(x)
        dt_est = st.dt_next
        stats = AdaptiveStats(*(a + b for a, b in zip(stats[:4], st[:4])), dt_next=dt_est,
                              host_reads=stats.host_reads + st.host_reads,
                              trials_run=stats.trials_run + st.trials_run)
    return torch.stack(xs), stats


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


def _col(dt):
    """A per-environment step ``(B,)`` as a column ``(B, 1)`` against states
    ``(B, n)``; floats and 0-d tensors pass through."""
    if isinstance(dt, torch.Tensor) and dt.dim() > 0:
        return dt.unsqueeze(-1)
    return dt


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
    dt = _col(dt)  # (B, 1) against (B, n) states under per_env
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


def _rollout(step, op, q0, v0, t0, dt, n_steps, u, substeps, remat: bool = False):
    u = _input(u, q0)
    q, v, a = q0, v0, initial_accel(op, q0, v0, t0, u)
    h = dt / substeps

    def advance(q, v, a, t_frame):
        for j in range(int(substeps)):
            q, v, a = step(t_frame + j * h, q, v, a, h, u)
        return q, v, a

    qs, vs = [q0], [v0]
    for i in range(int(n_steps)):
        t_frame = t0 + i * dt
        if remat:
            q, v, a = torch.utils.checkpoint.checkpoint(advance, q, v, a, t_frame,
                                                        use_reentrant=False)
        else:
            q, v, a = advance(q, v, a, t_frame)
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
    initial state. ``remat=True`` runs each frame's substeps under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of a
    frame): reverse mode stores one state per frame instead of every
    substep and Newton iterate, and recomputes a frame in the backward
    pass; the values are those of ``remat=False``, bit for bit (the
    implicit twin of ``integrate_fixed(remat=True)``, for long stiff
    rollouts such as ``parallel.sweep.parametric_genalpha_rollout``).
    """

    def step(t, q, v, a, h, u):
        return generalized_alpha_step(op, t, q, v, a, h, u, rho_inf=rho_inf,
                                      n_newton=n_newton)

    return _rollout(step, op, q0, v0, t0, dt, n_steps, u, substeps, remat=remat)


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


def _host_times(t_eval) -> np.ndarray:
    if isinstance(t_eval, torch.Tensor):
        return t_eval.detach().cpu().numpy()
    return np.asarray(t_eval)


def _controller_dt(dt0, like: torch.Tensor) -> torch.Tensor:
    if isinstance(dt0, torch.Tensor):
        return dt0.to(device=like.device, dtype=like.dtype)
    return torch.tensor(float(dt0), dtype=like.dtype, device=like.device)


def integrate_generalized_alpha_adaptive(
    op: NewmarkOperator,
    q0,
    v0,
    t_eval,
    u=None,
    rho_inf: float = 0.9,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: float = None,
    n_newton: int = 2,
    max_steps_per_interval: int = 100_000,
    safety: float = 0.9,
    a0=None,
    return_final: bool = False,
    per_env: bool = False,
):
    """Error-controlled implicit stepping: adaptive generalized-α.

    Local error is the Zienkiewicz-Xie estimate ``e = (beta - 1/6) dt^2
    (a_{n+1} - a_n)`` (local order 3, controller exponent -1/3) on the
    Hairer RMS norm of the displacement. Each trial factors the effective
    Jacobian at the trial dt (the operator's not-prefactored solve with a
    tensor ``c``): once a trial with a frozen tangent, once a Newton
    iterate otherwise. A batch shares one step size unless ``per_env``.

    ``dt0`` defaults to ``(t_eval[1] - t_eval[0]) / 16``. The initial
    acceleration is the consistent one, ``op.solve(q0, 0.0)`` of ``F(x0,
    t0) + u - k(q0)``; ``a0`` supplies a carried one instead, and
    ``return_final=True`` appends the final ``(q, v, a)`` (the exact
    continuation hooks of ``simulate(chunk=...)``). Returns ``(qs, vs,
    AdaptiveStats)``, frame axis leading, ``qs[0] = q0``.
    """
    if dt0 is None:
        te = _host_times(t_eval)
        dt0 = float(te[1] - te[0]) / 16.0
    dtype = q0.dtype
    t_eval = torch.as_tensor(_host_times(t_eval), dtype=dtype, device=q0.device)

    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    zx_coeff = abs(float(beta - 1.0 / 6.0))
    rtol, atol = _floored_tols(rtol, atol, dtype)
    u = _input(u, q0)
    if a0 is None:
        a0 = initial_accel(op, q0, v0, t_eval[0], u)

    def trial(t, dt, qva):
        q, v, a = qva
        q1, v1, a1 = generalized_alpha_step(op, t, q, v, a, dt, u, rho_inf=rho_inf,
                                            n_newton=n_newton)
        dtx = _col(dt)
        e = zx_coeff * dtx * dtx * (a1 - a)
        scale = atol + rtol * torch.maximum(q.abs(), q1.abs())
        return (q1, v1, a1), _rms((e / scale) ** 2, per_env)

    state_f, (qs, vs), stats = adaptive_drive(
        trial, (q0, v0, a0), t_eval, _controller_dt(dt0, q0), -1.0 / 3.0,
        max_steps_per_interval=max_steps_per_interval, safety=safety,
        frame_out=lambda s: (s[0], s[1]), per_env=per_env,
    )
    qs = torch.cat([q0[None], qs], dim=0)
    vs = torch.cat([v0[None], vs], dim=0)
    if return_final:
        return qs, vs, stats, state_f
    return qs, vs, stats


# ---------------------------------------------------------------------------
# SDIRK3: L-stable 3rd-order diagonally-implicit RK with embedded 2nd-order
# error estimate (Alexander 1977)
# ---------------------------------------------------------------------------

# gamma is the root of x^3 - 3x^2 + 3/2 x - 1/6 in (1/6, 1/2): L-stable.
_SD_G = 0.43586652150845899941601945
_SD_B1 = -1.5 * _SD_G**2 + 4.0 * _SD_G - 0.25
_SD_B2 = 1.5 * _SD_G**2 - 5.0 * _SD_G + 1.25
_SD_C = (_SD_G, (1.0 + _SD_G) / 2.0, 1.0)
_SD_A = (
    (_SD_G,),
    ((1.0 - _SD_G) / 2.0, _SD_G),
    (_SD_B1, _SD_B2, _SD_G),  # stiffly accurate: last row = b
)
_SD_B = (_SD_B1, _SD_B2, _SD_G)
# Embedded 2nd-order weights (bhat3 = 0, sum = 1, bhat.c = 1/2).
_SD_BH2 = (1.0 - 2.0 * _SD_G) / (1.0 - _SD_G)
_SD_BHAT = (1.0 - _SD_BH2, _SD_BH2, 0.0)


def sdirk3_step(op: NewmarkOperator, t, q, v, dt, u=None, n_newton: int = 2):
    """One Alexander SDIRK3 step on the first-order form of ``M q'' = f``.

    Each stage eliminates ``V = (Q - Bq)/(dt g)`` and Newton-iterates on
    ``Q`` with the effective Jacobian ``M + (dt g)^2 K_tan``; with a frozen
    tangent one factored system serves every iterate of every stage and
    the error filter. The embedded estimate is filtered through ``(I - dt g
    J)^{-1}`` (Hairer & Wanner IV.8), whose ``K e_q`` is a
    ``torch.func.jvp`` of the internal force at the step end. Returns
    ``(q1, v1, err_q, err_v)``.
    """
    dtx = _col(dt)
    dt_g = dtx * _SD_G
    frozen_solve = op.solve(q, dt_g * dt_g) if op.tangent_frozen else None
    kqs, kvs = [], []
    for i in range(3):
        bq, bv = q, v
        for j in range(i):
            bq = bq + dtx * _SD_A[i][j] * kqs[j]
            bv = bv + dtx * _SD_A[i][j] * kvs[j]
        t_s = t + _SD_C[i] * dt
        qi = bq + dt_g * v  # predictor; exact after 1 Newton for linear k
        for _ in range(int(n_newton)):
            f = -op.internal_force(qi)
            if op.external_force is not None:
                vi = (qi - bq) / dt_g
                f = f + op.external_force(torch.cat([qi, vi], dim=-1), t_s)
            if u is not None:
                f = f + _input_at(u, t_s, f)
            r = op.mass_apply((qi - bq) / dt_g - bv) - dt_g * f
            dq = dt_g * (frozen_solve or op.solve(qi, dt_g * dt_g))(r)
            qi = qi - dq
        vi = (qi - bq) / dt_g
        kqs.append(vi)  # dq/dt at the stage is the stage velocity
        kvs.append((vi - bv) / dt_g)

    q1 = q + dtx * sum(b * k for b, k in zip(_SD_B, kqs))
    v1 = v + dtx * sum(b * k for b, k in zip(_SD_B, kvs))
    err_q = dtx * sum((b - bh) * k for b, bh, k in zip(_SD_B, _SD_BHAT, kqs))
    err_v = dtx * sum((b - bh) * k for b, bh, k in zip(_SD_B, _SD_BHAT, kvs))

    # Stiffly damped estimate: (M + (dt g)^2 K) x_v = M e_v - dt g K e_q,
    # x_q = e_q + dt g x_v, with K e_q the internal force's jvp at q1.
    _, K_eq = torch.func.jvp(op.internal_force, (q1,), (err_q,))
    rhs_v = op.mass_apply(err_v) - dt_g * K_eq
    err_v_f = (frozen_solve or op.solve(q1, dt_g * dt_g))(rhs_v)
    err_q_f = err_q + dt_g * err_v_f
    return q1, v1, err_q_f, err_v_f


def integrate_sdirk3_adaptive(
    op: NewmarkOperator,
    q0,
    v0,
    t_eval,
    u=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: float = None,
    n_newton: int = 2,
    max_steps_per_interval: int = 100_000,
    safety: float = 0.9,
    per_env: bool = False,
):
    """Error-controlled L-stable stiff integration (adaptive SDIRK3).

    The error is measured in displacement units: ``max(||e_q||, ||dt
    e_v||)`` on the Hairer RMS norm, controller exponent -1/3. A batch
    shares one step size unless ``per_env``; ``dt0`` defaults to
    ``(t_eval[1] - t_eval[0]) / 16``. The trial state is ``(q, v)``, so a
    restart from a run's last frame with its ``dt_next`` continues it
    exactly. Returns ``(qs, vs, AdaptiveStats)`` with ``qs[0] = q0``.
    """
    if dt0 is None:
        te = _host_times(t_eval)
        dt0 = float(te[1] - te[0]) / 16.0
    dtype = q0.dtype
    rtol, atol = _floored_tols(rtol, atol, dtype)
    u = _input(u, q0)

    def err_norm(e, x_old, x_new):
        scale = atol + rtol * torch.maximum(x_old.abs(), x_new.abs())
        return _rms((e / scale) ** 2, per_env)

    def trial(t, dt, qv):
        q, v = qv
        q1, v1, eq, ev = sdirk3_step(op, t, q, v, dt, u, n_newton=n_newton)
        en = torch.maximum(err_norm(eq, q, q1), err_norm(_col(dt) * ev, q, q1))
        return (q1, v1), en

    _, (qs, vs), stats = adaptive_drive(
        trial, (q0, v0), t_eval, _controller_dt(dt0, q0), -1.0 / 3.0,
        max_steps_per_interval=max_steps_per_interval, safety=safety, per_env=per_env,
    )
    qs = torch.cat([q0[None], qs], dim=0)
    vs = torch.cat([v0[None], vs], dim=0)
    return qs, vs, stats

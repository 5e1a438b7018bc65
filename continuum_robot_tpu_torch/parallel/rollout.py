"""Batched rollouts on one device.

Counterpart of the single-device half of
``continuum_robot_tpu/parallel/rollout.py``. Thousands of independent
environments are one leading batch axis: the port's engines step a
``(B, 2n)`` batch of states directly, so :func:`build_rollout_fn` returns a
closure over that batch and :func:`batched_rollout` calls it once, with no
``vmap``. Sharding the environment axis over a device mesh (``mesh=``) is
the parallel layer, not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.simulate import (
    PiecewiseConstant,
    SimulationResult,
    _frames_result,
    make_implicit_rollout_fn,
    make_modal_genalpha,
    make_modal_rollout_fn,
    make_modal_rom,
    resolve_device,
)
from ..ops import integrators

_METHODS = ("rk4", "newmark", "generalized_alpha", "modal", "modal_power", "modal_rom")


def build_rollout_fn(
    model,
    t_final: float,
    dt: float,
    method: str = "rk4",
    u=None,
    forces_func: Optional[Callable] = None,
    substeps: int = 1,
    n_newton: int = 2,
    linear_solver: str = None,
    rho_inf: float = 0.8,
    n_modes: int = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> Callable:
    """Batched rollout ``x0 (B, 2n) -> (ts, ys (frames, B, 2n))``.

    Methods: ``"rk4"`` (the default: classic RK4 on the model's
    ``build_rhs(forces_func)``, ``substeps`` steps a frame), ``"newmark"``
    and ``"generalized_alpha"`` (the full-order implicit integrators on
    :func:`make_newmark_operator`; ``forces_func`` None takes the model's
    force registry), ``"modal"``, ``"modal_power"`` (one composed
    ``substeps``-step map per frame; constant or :class:`PiecewiseConstant`
    force) and ``"modal_rom"``; any other method raises
    ``NotImplementedError``. The RK4 right-hand side of a beam of up to
    ``dynamic_beam_model.POLY_MAX_ELEMENTS`` (24) elements is
    batch-invariant (``models/dynamics.py``): each environment's rollout is
    bit for bit the one ``simulate(method="rk4")`` gives it alone; a wider
    beam's agrees to roundoff.
    ``device``/``dtype``:
    where NumPy inputs of the engines go (None: the card); a tensor ``x0``
    keeps its own device and dtype.

    For long float32 implicit rollouts prefer ``generalized_alpha``:
    undamped Newmark keeps high modes exactly on the unit circle, where
    float32 roundoff accumulates over thousands of steps.
    """
    if method not in _METHODS:
        raise NotImplementedError(
            f"build_rollout_fn(method={method!r}) is not yet ported "
            f"(ported: {', '.join(_METHODS)})"
        )
    device = resolve_device(device)
    n_steps = int(round(t_final / dt))
    h = dt / substeps

    if method == "rk4":
        rhs = model.build_rhs(forces_func)

        def rollout(x0):
            return integrators.integrate_fixed(rhs, x0, 0.0, dt, n_steps, u=u,
                                               substeps=substeps)

        return rollout
    if method in ("newmark", "generalized_alpha"):
        return make_implicit_rollout_fn(
            model, dt, n_steps, method, u=u, forces_func=forces_func, substeps=substeps,
            n_newton=n_newton, linear_solver=linear_solver, rho_inf=rho_inf,
            device=device, dtype=dtype,
        )
    if method == "modal":
        return make_modal_rollout_fn(model, dt, n_steps, substeps=substeps,
                                     rho_inf=rho_inf, u=u, forces_func=forces_func,
                                     device=device, dtype=dtype)

    if method == "modal_power":
        # Each output frame is ONE application of the host-composed
        # substeps-step affine map: the trajectory of method="modal" to
        # roundoff. The maps bake a constant or piecewise-constant force in.
        if forces_func is not None:
            raise ValueError("method='modal_power' cannot include state-dependent forces")
        if callable(u) and not isinstance(u, PiecewiseConstant):
            raise ValueError(
                "method='modal_power' requires a constant or PiecewiseConstant "
                "input force; use method='modal' for arbitrary time-varying inputs"
            )
        ms = make_modal_genalpha(model, h, rho_inf=rho_inf, device=device, dtype=dtype)
        if u is None:
            u_modal = None
        elif isinstance(u, PiecewiseConstant):
            u_modal = u.map_values(ms.project_force_host)
        else:
            u_modal = ms.project_force_host(u)
        drive = ms.rollout_frames_power
    else:  # modal_rom
        ms = make_modal_rom(model, h, rho_inf=rho_inf, n_modes=n_modes,
                            forces_func=forces_func, device=device, dtype=dtype)
        if u is None:
            u_modal = None
        elif callable(u):
            u_modal = lambda t: ms.project_force(u(t))  # noqa: E731
        else:
            u_modal = ms.project_force_host(u)

        def drive(eta, etad, u_m, n_frames, substeps):
            return ms.rollout_frames(eta, etad, u_m, n_frames, substeps=substeps,
                                     n_newton=n_newton)

    def rollout(x0):
        res = _frames_result(ms, x0, u_modal, n_steps, substeps, drive)
        return res.ts, res.ys

    return rollout


def batched_rollout(model, x0_batch, t_final: float, dt: float, mesh=None,
                    batch_axis: str = "dp", device=None, dtype: torch.dtype = None,
                    **kwargs) -> SimulationResult:
    """Run a batch of rollouts on one device.

    ``x0_batch``: ``(n_envs, 2*n_free)``, a tensor (kept on its device
    unless ``device`` is given) or a NumPy array (put on ``device``, by
    default the card); ``dtype`` defaults to its own. ``kwargs`` go to
    :func:`build_rollout_fn`. Returns ``ys`` as ``(frames, envs, state)``.
    A device ``mesh`` (and its ``batch_axis``) belongs to the parallel
    layer, not ported yet: a mesh raises ``NotImplementedError``.
    """
    del batch_axis
    if mesh is not None:
        raise NotImplementedError("sharded batched rollouts (mesh=) are not yet ported")
    if isinstance(x0_batch, torch.Tensor):
        x0 = x0_batch if device is None else x0_batch.to(device)
    else:
        x0 = torch.as_tensor(np.asarray(x0_batch), device=resolve_device(device))
    if dtype is not None:
        x0 = x0.to(dtype)
    rollout = build_rollout_fn(model, t_final, dt, device=x0.device, dtype=x0.dtype,
                               **kwargs)
    ts, ys = rollout(x0)
    return SimulationResult(ts=ts, ys=ys)


def sweep_statistics(ys: torch.Tensor) -> dict:
    """Cross-env summary statistics of a sweep, as 0-d tensors.

    ``ys`` layout is ``[..., q; v]``: the tip transverse displacement is
    position index ``n-2`` (the last free node's w), NOT ``-2`` (which would
    be the tip *velocity*).
    """
    n = ys.shape[-1] // 2
    tip = ys[..., n - 2]
    return {
        "tip_abs_max": tip.abs().max(),
        "tip_mean_final": tip[-1].mean(),
        "tip_vel_abs_max": ys[..., -2].abs().max(),
        "state_rms": torch.sqrt(torch.mean(ys**2)),
    }

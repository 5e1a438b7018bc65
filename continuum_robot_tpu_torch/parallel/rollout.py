"""Batched and mesh-sharded rollouts.

Counterpart of ``continuum_robot_tpu/parallel/rollout.py``. Thousands of
independent environments are one leading batch axis: the port's engines
step a ``(B, 2n)`` batch of states directly, so :func:`build_rollout_fn`
returns a closure over that batch and :func:`batched_rollout` calls it
once, with no ``vmap``. With a device mesh (``mesh=``) the environment axis
is split over the mesh axis ``batch_axis``: each rank runs its block (no
communication; environments are independent) and ``ys`` comes back as a
DTensor sharded on the environment axis, so reductions such as
:func:`sweep_statistics` are global.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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
    """Run a batch of rollouts, optionally split over a device mesh.

    ``x0_batch``: ``(n_envs, 2*n_free)``, a tensor (kept on its device
    unless ``device`` is given) or a NumPy array (put on ``device``, by
    default the card); ``dtype`` defaults to its own. ``kwargs`` go to
    :func:`build_rollout_fn`. Returns ``ys`` as ``(frames, envs, state)``.

    ``mesh`` (a ``DeviceMesh``, :func:`make_mesh`; every rank calls with the
    same inputs): the environments are split over ``batch_axis`` in
    DTensor ``Shard`` chunks, each rank runs its chunk on the mesh's device
    and ``ys`` stays sharded: a DTensor of global shape ``(frames, envs,
    state)`` placed ``Shard(1)`` on ``batch_axis`` (replicated over the
    mesh's other axes).
    """
    if mesh is not None:
        return _batched_rollout_mesh(model, x0_batch, t_final, dt, mesh, batch_axis,
                                     dtype, kwargs)
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


def _batched_rollout_mesh(model, x0_batch, t_final, dt, mesh, batch_axis, dtype, kwargs):
    from .collectives import MeshAxis, env_chunk
    from .mesh import mesh_device

    ax = MeshAxis(mesh, batch_axis)
    dev = mesh_device(mesh)
    x0 = (x0_batch.to(dev) if isinstance(x0_batch, torch.Tensor)
          else torch.as_tensor(np.asarray(x0_batch), device=dev))
    if dtype is not None:
        x0 = x0.to(dtype)
    n = x0.shape[0]
    c = env_chunk(n, ax)
    lo = min(ax.index * c, n)
    hi = min(lo + c, n)
    rollout = build_rollout_fn(model, t_final, dt, device=dev, dtype=x0.dtype, **kwargs)
    # A rank past the last environment runs a copy of it for the frame times.
    ts, ys = rollout(x0[lo:hi] if hi > lo else x0[-1:])
    ys = ys[:, : hi - lo]
    place = [Shard(1) if name == batch_axis else Replicate() for name in mesh.mesh_dim_names]
    shape = torch.Size((ys.shape[0], n) + tuple(ys.shape[2:]))
    ys = DTensor.from_local(ys, mesh, place, run_check=False, shape=shape,
                            stride=torch.empty(shape, device="meta").stride())
    return SimulationResult(ts=ts, ys=ys)


def sweep_statistics(ys) -> dict:
    """Cross-env summary statistics of a sweep, as 0-d tensors.

    ``ys`` layout is ``[..., q; v]``: the tip transverse displacement is
    position index ``n-2`` (the last free node's w), NOT ``-2`` (which would
    be the tip *velocity*). A DTensor ``ys`` (:func:`batched_rollout` with
    a mesh) gives the global statistics, the same on every rank.
    """
    n = ys.shape[-1] // 2
    tip = ys[..., n - 2]
    out = {
        "tip_abs_max": tip.abs().max(),
        "tip_mean_final": tip[-1].mean(),
        "tip_vel_abs_max": ys[..., -2].abs().max(),
        "state_rms": torch.sqrt(torch.mean(ys**2)),
    }
    if isinstance(ys, DTensor):
        out = {k: v.full_tensor() for k, v in out.items()}
    return out

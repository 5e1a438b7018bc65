"""``simulate()``-contract facade over the spatially-sharded engines.

Counterpart of ``continuum_robot_tpu/parallel/facade.py``.
``models.simulate.simulate`` is the single-device facade; this module gives
the same reduced-coordinate contract for beams sharded over the ``sp`` mesh
axis: reduced ``[q; v]`` in, :class:`SimulationResult` out (the same on
every rank), fluid drag and gravity wired from the model's
:class:`ForceParams`. A workload moves from one device to a mesh by adding
``mesh=``, without the node-layout plumbing (``make_spatial_beam``,
``reduced_to_node_layout``, the per-engine ``build_spatial_*`` functions) underneath.

Every method of ``simulate()`` with a sharded engine is dispatched here:
the node-layout engines (rk4, gen-α, adaptive gen-α, SDIRK3) and the modal
tier (modal, modal_rom, modal_rom_adaptive, :func:`_simulate_sharded_modal`).
The ECSW workflows keep the engine API (``build_spatial_modal_rom``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.simulate import PiecewiseConstant, SimulationResult
from ..ops.integrators import AdaptiveStats
from .mesh import mesh_device
from .spatial import make_spatial_beam, reduced_to_node_layout, spatial_rollout
from .spatial_implicit import (
    build_spatial_genalpha,
    build_spatial_genalpha_adaptive,
    build_spatial_sdirk3,
)

_METHODS = ("rk4", "generalized_alpha", "generalized_alpha_adaptive", "sdirk3")
_MODAL_METHODS = ("modal", "modal_rom", "modal_rom_adaptive")


def _spatial_beam_of(model, mesh, axis: str):
    return make_spatial_beam(model.beam_model.arrays,
                             model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh,
                             axis=axis)


def _chunked_adaptive(roll, method, xn, t_eval, chunk, u_node, rtol, atol, arrays=None):
    """Chunked drive of the sharded adaptive rollouts: one call per
    ``chunk`` output intervals, threading the controller's proposal
    (``stats.dt_next``, per environment when batched) and, for gen-α, the
    exact 3-plane ``[q; v; a]`` carry (``return_carry``); SDIRK3 restarts
    exactly from the last frame. Bit for bit the one-call drive."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    is_ga = method == "generalized_alpha_adaptive"
    n_iv = len(t_eval) - 1
    dt0 = float(t_eval[1] - t_eval[0]) / 16.0
    state = xn
    xs_parts, totals, reads, runs = [], None, 0, 0
    i = 0
    while i < n_iv:
        j = min(i + chunk, n_iv)
        grid = t_eval[i:j + 1]
        if is_ga:
            xs_c, stats, state = roll(state, grid, u=u_node, rtol=rtol, atol=atol, dt0=dt0,
                                      arrays=arrays, return_carry=True)
        else:
            xs_c, stats = roll(state, grid, u=u_node, rtol=rtol, atol=atol, dt0=dt0,
                               arrays=arrays)
            state = xs_c[-1]
        xs_parts.append(xs_c if i == 0 else xs_c[1:])
        dt0 = stats.dt_next
        counts = stats[:4]
        totals = counts if totals is None else tuple(a + b for a, b in zip(totals, counts))
        reads += stats.host_reads
        runs += stats.trials_run
        i = j
    stats = AdaptiveStats(*totals, dt_next=dt0, host_reads=reads, trials_run=runs)
    return torch.cat(xs_parts, dim=0), stats


def _node_force(model, u_red, Np: int, like: torch.Tensor):
    """Reduced position-DOF force vector -> ``(Np, 3)`` node layout."""
    bc = model.beam_model.bc_info
    free = np.asarray(bc.free_dofs)
    n_full = bc.n_dofs_full
    u_red = torch.as_tensor(u_red if isinstance(u_red, torch.Tensor) else np.asarray(u_red),
                            dtype=like.dtype, device=like.device)
    if tuple(u_red.shape) != (len(free),):
        raise ValueError(
            f"u must be a constant reduced force vector of shape "
            f"({len(free)},), got {tuple(u_red.shape)}"
        )
    out = like.new_zeros(Np * 3)
    out[torch.as_tensor(free, device=like.device)] = u_red
    return out.reshape(Np, 3)


def _node_frames_to_reduced(model, xs):
    """Node-layout frames ``(..., 2, Np, 3)`` -> reduced ``(..., 2n)``."""
    bc = model.beam_model.bc_info
    free = torch.as_tensor(np.asarray(bc.free_dofs), device=xs.device)
    nn = bc.n_dofs_full // 3
    lead = xs.shape[:-3]
    q = xs[..., 0, :nn, :].reshape(*lead, 3 * nn)[..., free]
    v = xs[..., 1, :nn, :].reshape(*lead, 3 * nn)[..., free]
    return torch.cat([q, v], dim=-1)


def _state(x0, mesh):
    dev = mesh_device(mesh)
    if isinstance(x0, torch.Tensor):
        x0 = x0.to(dev)
    else:
        x0 = torch.as_tensor(np.asarray(x0), device=dev)
    if x0.dim() not in (1, 2):
        raise ValueError(
            "x0 must be reduced [q; v] with at most one leading batch "
            f"axis, got shape {tuple(x0.shape)}"
        )
    return x0


def simulate_sharded(
    model,
    x0,
    t_final: float,
    dt: float,
    mesh,
    method: str = "generalized_alpha",
    u=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    substeps: int = 1,
    n_newton: Optional[int] = None,
    rho_inf: float = 0.8,
    use_consistent: bool = False,
    fluid_density: Optional[float] = None,
    gravity=None,
    node_force: Optional[Callable] = None,
    arrays=None,
    axis: str = "sp",
    cg_iters: int = 32,
    cg_tol: float = 1e-8,
    n_modes: Optional[int] = None,
    rayleigh: Optional[tuple] = None,
    engine: str = "xla",
    chunk: Optional[int] = None,
    local_solver: Optional[str] = None,
):
    """Run a sharded rollout with the single-device ``simulate()`` contract.

    Every rank calls it with the same inputs and gets the same result.

    Args:
        model: a :class:`DynamicEulerBernoulliBeam`. Its ``ForceParams``
            (fluid density, gravity vector) are wired into the sharded
            engines unless ``fluid_density=`` / ``gravity=`` override them.
        x0: reduced ``[q; v]``, optionally with one leading environment axis
            (split over the mesh's ``dp`` axis); a tensor or a NumPy array,
            put on the mesh's device.
        t_final, dt: horizon and output-frame spacing.
        mesh: a ``DeviceMesh`` (:func:`make_mesh`) with the node-sharding
            axis ``axis`` (default ``"sp"``; a ``dp`` axis splits envs).
        method: ``rk4`` (explicit, ``psum``-CG mass solves) |
            ``generalized_alpha`` (fixed-step distributed SPIKE; the inner
            step is ``dt / substeps``) | ``generalized_alpha_adaptive`` /
            ``sdirk3`` (error-controlled: ``rtol``/``atol`` pick every step,
            ``dt`` spaces the frames) | ``modal`` (linear beams,
            node-sharded bases and transforms) | ``modal_rom`` (nonlinear
            Petrov-Galerkin reduction, the correction force sharded;
            ``n_modes`` truncates) | ``modal_rom_adaptive``. The modal
            methods accept ``rayleigh=`` and reject ``node_force`` and the
            explicit fluid/gravity dials (the single-device modal force
            scope).
        u: constant reduced force over position DOFs, or None.
        node_force: nodewise external force ``f(x, t) -> (..., m, 3)`` on a
            shard's block ``x = (..., 2, m, 3)`` (node-local forces:
            springs, dampers, time-harmonic loads), on every node-layout
            method; see :func:`build_spatial_genalpha`.
        arrays: traced parameters for the implicit methods
            (``generalized_alpha``, ``generalized_alpha_adaptive``,
            ``sdirk3``; ``chunk=`` too): a :class:`BeamArrays` shaped like
            the padded sharded beam's (``make_spatial_beam(...).arrays``),
            whose fields may be tensors that require grad or carry
            forward-mode tangents (see ``build_spatial_genalpha``'s
            rollout); ``rk4`` raises.
        engine: the stepping engine of ``method='modal'`` (``simulate()``'s
            dial): ``"xla"`` (plain torch), ``"pallas"`` (one
            ``modal_frames`` launch on the card) or ``"power"`` (one
            ``affine_frames`` launch; ``u`` may be a
            :class:`PiecewiseConstant`). Stepping is replicated either way.
        local_solver: the within-shard solve of the SPIKE methods,
            ``"thomas"`` | ``"cr"`` | ``"dense"``, all exact; None:
            ``"thomas"`` (the ``btd_solve`` kernel on the card).
        chunk: adaptive methods only — drive the span one call per ``chunk``
            output intervals, threading the controller's proposal and the
            full carry (bit for bit the one-call drive).

    Returns:
        :class:`SimulationResult` with reduced-layout ``ys`` (environments
        leading, then frames, as in the JAX package's facade); adaptive
        methods carry per-environment :class:`AdaptiveStats`, ``rk4`` with
        ``cg_tol`` the CG cap-hit counts.
    """
    if method in _MODAL_METHODS:
        return _simulate_sharded_modal(
            model, x0, t_final, dt, mesh, method, u=u, rtol=rtol, atol=atol,
            substeps=substeps, n_newton=n_newton, rho_inf=rho_inf,
            use_consistent=use_consistent, fluid_density=fluid_density,
            gravity=gravity, node_force=node_force, axis=axis, n_modes=n_modes,
            rayleigh=rayleigh, engine=engine,
        )
    if method not in _METHODS:
        raise ValueError(
            f"Unknown sharded method: {method!r} "
            f"(use one of {_METHODS + _MODAL_METHODS})"
        )
    if engine != "xla":
        raise ValueError(
            "engine= selects the modal stepping engine "
            "(method='modal'; 'xla'|'pallas'|'power', matching simulate())"
        )
    if rayleigh is not None:
        raise ValueError(
            "rayleigh structural damping is supported by the modal "
            "sharded methods (method='modal'/'modal_rom'/"
            "'modal_rom_adaptive'), matching simulate()"
        )
    if local_solver is not None and method == "rk4":
        raise ValueError(
            "local_solver= selects the within-shard solve of the implicit "
            "SPIKE methods (generalized_alpha / *_adaptive / sdirk3); the "
            "explicit rk4 path solves its mass system with CG"
        )
    fp = getattr(model, "force_params", None)
    if fp is not None:
        if fluid_density is None and fp.enable_fluid_effects:
            fluid_density = float(fp.fluid_density)
        if gravity is None and fp.enable_gravity_effects:
            gravity = np.asarray(fp.gravity_vector, dtype=float)

    beam = _spatial_beam_of(model, mesh, axis)
    x0 = _state(x0, mesh)
    batched = x0.dim() == 2
    xn = reduced_to_node_layout(model, x0, beam.n_nodes)
    if callable(u):
        raise ValueError(
            "simulate_sharded takes a constant reduced force vector; "
            "for time-varying inputs use the per-engine rollouts (build_spatial_*)"
        )
    u_node = None if u is None else _node_force(model, u, beam.n_nodes, x0)
    n_frames = int(round(t_final / dt))
    stats = None

    if chunk is not None and method not in ("generalized_alpha_adaptive", "sdirk3"):
        raise ValueError(
            "chunk= applies to the adaptive sharded methods "
            "('generalized_alpha_adaptive' / 'sdirk3'); fixed-step spans "
            "are already one bounded device call per frame (got "
            f"method={method!r})"
        )

    kw_forces = dict(use_consistent=use_consistent, fluid_density=fluid_density,
                     gravity=gravity, node_force=node_force)
    if method == "rk4":
        if arrays is not None:
            raise ValueError(
                "arrays= (traced parameters) is supported by the implicit methods; "
                "for explicit differentiable rollouts use build_spatial_rhs directly "
                "with cg_tol=None"
            )
        out = spatial_rollout(beam, xn, t_final, dt, u=u_node, substeps=substeps,
                              cg_iters=cg_iters, cg_tol=cg_tol,
                              cg_stats=cg_tol is not None, **kw_forces)
        ts, xs = out[:2]
        stats = out[2] if cg_tol is not None else None
    elif method == "generalized_alpha":
        roll = build_spatial_genalpha(
            beam, dt / substeps, rho_inf=rho_inf,
            n_newton=1 if n_newton is None else n_newton, local_solver=local_solver,
            **kw_forces,
        )
        ts, xs = roll(xn, n_frames, u=u_node, substeps=substeps, arrays=arrays)
    else:
        build = (build_spatial_genalpha_adaptive if method == "generalized_alpha_adaptive"
                   else build_spatial_sdirk3)
        kw = dict(n_newton=2 if n_newton is None else n_newton, local_solver=local_solver,
                  **kw_forces)
        if method == "generalized_alpha_adaptive":
            kw["rho_inf"] = rho_inf
        roll = build(beam, **kw)
        t_eval = np.linspace(0.0, t_final, n_frames + 1)
        if chunk is None:
            xs, stats = roll(xn, t_eval, u=u_node, rtol=rtol, atol=atol, arrays=arrays)
        else:
            xs, stats = _chunked_adaptive(roll, method, xn, t_eval, chunk, u_node, rtol,
                                          atol, arrays)
        ts = torch.as_tensor(t_eval, dtype=torch.float64, device=x0.device)

    ys = _node_frames_to_reduced(model, xs)
    if batched:  # the node-layout rollouts put frames first, envs second
        ys = ys.movedim(1, 0)
    return SimulationResult(ts=ts, ys=ys, stats=stats)


def _simulate_sharded_modal(
    model, x0, t_final, dt, mesh, method, *, u, rtol, atol, substeps, n_newton, rho_inf,
    use_consistent, fluid_density, gravity, node_force, axis, n_modes, rayleigh,
    engine="xla",
):
    """``simulate()``-contract front end of the sharded modal/ROM tier.

    Engine selection and argument semantics follow ``simulate(method=
    'modal'/'modal_rom'/'modal_rom_adaptive')``; the bases, the transforms
    and (for the ROM) the per-Newton correction force are split over
    ``axis``. The force scope is the single-device modal engines': the ROM
    methods carry the model's registered fluid drag and gravity as exact
    reduced corrections (``ext_modal``); the linear ``modal`` method and
    ``node_force`` raise.
    """
    from .spatial_modal import build_spatial_modal, build_spatial_modal_rom

    if engine not in ("xla", "pallas", "power"):
        raise ValueError(f"Unknown engine: {engine!r} (use 'xla'|'pallas'|'power')")
    if engine != "xla" and method != "modal":
        raise ValueError(
            "engine='pallas'/'power' applies to method='modal' here; the "
            "sharded ROM tiers step through the sp-sharded correction "
            "force (fused single-chip ROM kernels live in simulate())"
        )
    if node_force is not None:
        raise ValueError(
            "node_force is supported by the node-layout sharded methods; "
            "the modal tier's force scope is a constant reduced u (same "
            "as the single-chip modal engines)"
        )
    fp = getattr(model, "force_params", None)
    if fluid_density is not None or gravity is not None:
        raise ValueError(
            "the sharded modal methods take forces from the model's "
            "force registry (ForceParams / register_force), same as the "
            "single-chip modal engines — the explicit fluid_density/"
            "gravity dials configure the node-layout methods "
            "('generalized_alpha'/'sdirk3')"
        )
    registry_forces = fp is not None and (fp.enable_fluid_effects or fp.enable_gravity_effects)
    if registry_forces and method == "modal":
        raise ValueError(
            "the sharded linear modal method supports no fluid/gravity "
            "forces (same scope as make_modal_genalpha); use "
            "method='modal_rom' — registered forces ride its sharded "
            "rollouts as exact reduced corrections — or the node-layout "
            "methods ('generalized_alpha'/'sdirk3')"
        )
    if use_consistent and method != "modal":
        raise ValueError(
            "the sharded ROM engine requires the parity element "
            "(use_consistent=False) — see build_spatial_modal_rom"
        )

    x0 = _state(x0, mesh)
    batched = x0.dim() == 2
    n = x0.shape[-1] // 2
    n_frames = int(round(t_final / dt))
    u_is_pwc = isinstance(u, PiecewiseConstant)
    if callable(u) and not (u_is_pwc and engine == "power"):
        raise ValueError(
            "simulate_sharded takes a constant reduced force vector "
            "(engine='power' additionally accepts a PiecewiseConstant "
            "schedule, matching simulate()); for arbitrary time-varying "
            "inputs use the per-engine rollouts (build_spatial_*)"
        )

    h = dt / substeps
    build = build_spatial_modal if method == "modal" else build_spatial_modal_rom
    eng = build(model, mesh, h, rho_inf=rho_inf, n_modes=n_modes, rayleigh=rayleigh,
                axis=axis)
    xn = reduced_to_node_layout(model, x0, eng.n_nodes)
    eta, etad = eng.to_modal(xn)
    u_shape = None if u is None or u_is_pwc else tuple(
        u.shape if isinstance(u, torch.Tensor) else np.shape(u))
    if u_shape is not None and u_shape != (n,):
        raise ValueError(
            f"u must be a constant reduced force vector of shape ({n},), got {u_shape}"
        )
    if u is None:
        u_m = None
    elif u_is_pwc:
        u_m = u.map_values(eng.ms.project_force_host)
    else:
        # Host float64, converted to the state's dtype by the engines, as
        # simulate() passes it.
        u_m = eng.ms.project_force_host(u)

    stats = None
    if method == "modal":
        if engine == "power":
            ts, etas, etads = eng.ms.rollout_frames_power(eta, etad, u_m, n_frames,
                                                          substeps=substeps)
        elif engine == "pallas":
            if not batched:  # the kernel's state layout is (B, m)
                eta, etad = eta[None, :], etad[None, :]
            ts, etas, etads = eng.ms.rollout_frames_pallas(eta, etad, u_m, n_frames,
                                                           substeps=substeps)
            if not batched:
                etas, etads = etas[:, 0, :], etads[:, 0, :]
        else:
            ts, etas, etads = eng.rollout_frames(eta, etad, u_m, n_frames, substeps=substeps)
    elif method == "modal_rom":
        ts, etas, etads = eng.rollout_frames(eta, etad, u_m, n_frames, substeps=substeps,
                                             n_newton=2 if n_newton is None else n_newton)
    else:
        t_eval = np.linspace(0.0, t_final, n_frames + 1)
        etas, etads, stats = eng.rollout_adaptive(
            eta, etad, u_m, t_eval, rtol=rtol, atol=atol,
            n_newton=2 if n_newton is None else n_newton)
        ts = torch.as_tensor(t_eval, dtype=torch.float64, device=x0.device)

    qs, vs = eng.ms.from_modal(etas, etads)
    ys = torch.cat([qs, vs], dim=-1)
    if batched:  # frames first, envs second -> envs first
        ys = ys.movedim(1, 0)
    return SimulationResult(ts=ts, ys=ys, stats=stats)

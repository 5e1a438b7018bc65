"""Spatially-sharded modal / modal-ROM engines over the ``sp`` axis.

Counterpart of ``continuum_robot_tpu/parallel/spatial_modal.py``. The
modal engines (``models/simulate.py``: ``ModalGenAlpha``,
``ModalROMGenAlpha``) carry a tiny replicated state, ``(B, m)`` modal
amplitudes, while everything that grows with the beam's length lives in
the bases (``(3N, m)`` each) and, for the nonlinear ROM, in the per-step
correction force (expand to physical nodes, evaluate the element
correction, project back). Splitting the node axis over ``sp`` therefore:

* splits every basis by rows: a rank holds an ``(Np/S, 3, m)`` block;
* makes the ROM's per-Newton correction a local element batch (the
  one-node halo ``ppermute``) followed by one ``(m,)`` ``psum``: per-step
  communication is O(modes), independent of the beam's length;
* keeps the per-mode recurrence replicated.

The linear modal engine does no physical-space work per step, so its
sharded value is in the transforms and the basis memory
(:class:`SpatialModal`); the nonlinear ROM carries per-step load on ``sp``
(:class:`SpatialModalROM`). Split fast path only (the exactly diagonal
reduced operator ``ms.lam``); registered fluid drag and gravity ride every
sharded rollout as the engine's replicated ``ext_modal`` term, as on one
device. The correction is ``elements.nonlinear_correction_planes`` masked
by the per-element ``nonlinear_mask``, so hybrid beams work unchanged.

Batched modal states ``(B, m)`` are split over the mesh's ``dp`` axis in
the ROM rollouts and gathered back; the transforms and the linear engine's
replicated stepping run the whole batch on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models import elements
from ..models.simulate import (
    ModalGenAlpha,
    ModalROMGenAlpha,
    make_modal_genalpha,
    make_modal_rom,
)
from ..ops import integrators
from .collectives import MeshAxis, env_block, gather_env_blocks, psum
from .mesh import mesh_device
from .spatial import NodeBlocks, _halo_scatter, pad_arrays_for_shards


def _scatter_node_basis(B_red: np.ndarray, free, n_full: int, n_nodes_padded: int) -> np.ndarray:
    """Reduced-coordinate basis ``(n_red, m)`` -> node layout ``(Np, 3, m)``;
    constrained DOFs and padding nodes get zero rows."""
    B_red = np.asarray(B_red, np.float64)
    m = B_red.shape[1]
    full = np.zeros((3 * n_nodes_padded, m))
    full[np.asarray(free)] = B_red
    return np.ascontiguousarray(full.reshape(n_nodes_padded, 3, m))


def spatial_correction_force_local(q_local, el_L, el_EI, el_EA, el_nl, axis: MeshAxis):
    """Per-shard von Kármán correction force with the one-node halo.

    ``q_local``: ``(..., n_loc, 3)``. Only the quadratic/cubic correction
    planes are evaluated (the linear force rides the diagonal reduced
    operator); ``el_nl`` masks them to the nonlinear elements. The halo
    pattern of ``spatial.spatial_internal_force_local``.
    """

    def element_fn(q_ext):
        u1, w1, t1 = q_ext[..., :-1, 0], q_ext[..., :-1, 1], q_ext[..., :-1, 2]
        u2, w2, t2 = q_ext[..., 1:, 0], q_ext[..., 1:, 1], q_ext[..., 1:, 2]
        g1, g3, g4, g2, g5, g6 = elements.nonlinear_correction_planes(
            u1, w1, t1, u2, w2, t2, el_L, el_EI, el_EA)
        nl = el_nl.to(q_ext.dtype)[:, None]
        return torch.stack([g1, g3, g4], dim=-1) * nl, torch.stack([g2, g5, g6], dim=-1) * nl

    return _halo_scatter(q_local, axis, element_fn)


def _make_force_modal(Phi, Wn, eL, eEI, eEA, eNL, lam, axis: MeshAxis, ext_modal=None):
    """Shard-local reduced force of the split path:

    ``f_m(eta, etad, t) = lam eta + psum(W^T g(Phi eta)) - ext_modal(eta,
    etad, t)``, the term order of ``ModalROMGenAlpha._force_modal``.
    ``ext_modal`` maps modal coordinates through replicated restricted rows,
    so every shard evaluates the same value with no collective. ``Phi`` and
    ``Wn`` are this shard's ``(n_loc, 3, m)`` basis blocks.
    """
    n_loc, _, m = Phi.shape
    Phi_f = Phi.reshape(n_loc * 3, m)
    W_f = Wn.reshape(n_loc * 3, m)

    def force_modal(eta_af, etad_af, t_af):
        q_loc = (eta_af @ Phi_f.T).reshape(*eta_af.shape[:-1], n_loc, 3)
        g_loc = spatial_correction_force_local(q_loc, eL, eEI, eEA, eNL, axis)
        corr = psum(g_loc.flatten(-2) @ W_f, axis)
        f = lam * eta_af + corr
        if ext_modal is not None:
            f = f - ext_modal(eta_af, etad_af, t_af, precision=None)
        return f

    return force_modal


def _colm(s):
    """A per-environment scalar ``(B,)`` against modal rows ``(B, m)``."""
    return s[..., None] if isinstance(s, torch.Tensor) and s.dim() > 0 else s


@dataclasses.dataclass
class _SpatialModalBase(NodeBlocks):
    """Shared node-sharded basis transforms (linear and ROM engines)."""

    mesh: object
    axis: str
    n_nodes: int  # Np, padded to a multiple of the sp axis size
    n_nodes_real: int
    Phi_nodes: np.ndarray  # (Np, 3, m) trial basis, node layout
    PhiTM_nodes: np.ndarray  # (Np, 3, m) projector rows, node layout

    @property
    def n_modes(self) -> int:
        return self.Phi_nodes.shape[-1]

    def _block(self, name: str, dtype) -> torch.Tensor:
        """This shard's rows of a node-layout basis, ``(n_loc * 3, m)``."""
        memo = self.__dict__.setdefault("_blocks", {})
        key = (name, dtype)
        if key not in memo:
            full = torch.as_tensor(getattr(self, name), dtype=dtype, device=self.device)
            memo[key] = self.local(full, 0).reshape(-1, self.n_modes)
        return memo[key]

    def _state(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x.to(self.device) if dtype is None else x.to(self.device, dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype or torch.float64,
                               device=self.device)

    def to_modal(self, x_node):
        """Node-layout state ``(..., 2, Np, 3)`` -> replicated ``(eta, etad)``:
        one ``psum`` over ``sp`` a projection (the projector's rows are
        split with the nodes)."""
        x = self._state(x_node)
        PTM = self._block("PhiTM_nodes", x.dtype)
        x_loc = self.local(x)
        eta = psum(x_loc[..., 0, :, :].flatten(-2) @ PTM, self.sp)
        etad = psum(x_loc[..., 1, :, :].flatten(-2) @ PTM, self.sp)
        return eta, etad

    def project_force(self, u_node):
        """Node-layout force ``(Np, 3)`` -> replicated modal force ``(m,)``:
        the Petrov-Galerkin test-basis projection, one ``psum``."""
        if getattr(self, "W_nodes", None) is None:
            raise AttributeError("engine records no separate test basis")
        u = self._state(u_node)
        return psum(self.local(u).flatten(-2) @ self._block("W_nodes", u.dtype), self.sp)

    def physical_frames(self, etas, etads):
        """Modal frames ``(F, ..., m)`` -> node-sharded ``(qs, vs)``.

        Local on every shard (each expands its own basis rows); the outputs
        are DTensors of global shape ``(F, ..., Np, 3)`` split on the node
        axis over ``sp``, so the full trajectory never gathers on one rank.
        """
        etas, etads = self._state(etas), self._state(etads)
        Phi = self._block("Phi_nodes", etas.dtype)
        out = []
        for e in (etas, etads):
            q = (e @ Phi.T).reshape(*e.shape[:-1], -1, 3)
            place = [Shard(q.dim() - 2) if n == self.axis else Replicate()
                     for n in self.mesh.mesh_dim_names]
            out.append(DTensor.from_local(q, self.mesh, place, run_check=False))
        return tuple(out)


@dataclasses.dataclass
class SpatialModal(_SpatialModalBase):
    """Node-sharded linear modal engine.

    The per-mode recurrence does no physical-space work, so stepping
    delegates to the single-device :class:`ModalGenAlpha` (replicated
    ``(B, m)`` state); the sharded value is the basis memory and the
    transforms.
    """

    ms: ModalGenAlpha = None

    def rollout_frames(self, eta, etad, u_modal, n_frames: int, substeps: int = 1,
                       t0: float = 0.0):
        """Delegates to :meth:`ModalGenAlpha.rollout_frames` (replicated)."""
        return self.ms.rollout_frames(eta, etad, u_modal, n_frames, substeps=substeps, t0=t0)


@dataclasses.dataclass
class SpatialModalROM(_SpatialModalBase):
    """Node-sharded nonlinear modal-ROM generalized-α engine.

    The recurrence of :class:`ModalROMGenAlpha`'s split fast path, ``f_m =
    lam eta + W^T g(Phi eta)`` with the exact element correction, with the
    expand/correct/project pipeline split over the beam axis: a Newton
    correction expands each shard's node block, evaluates its elements (one
    halo ``ppermute``) and reduces with one ``(m,)`` ``psum``.
    """

    ms: ModalROMGenAlpha = None
    W_nodes: np.ndarray = None  # (Np, 3, m) test basis, node layout
    el_L: np.ndarray = None  # (Np,) padded element lengths
    el_EI: np.ndarray = None
    el_EA: np.ndarray = None
    el_nl: np.ndarray = None  # (Np,) padded nonlinear mask

    @property
    def is_hyper_reduced(self) -> bool:
        return self.ms.sampled_params is not None

    def hyper_reduce(self, snapshots, tau: float = 1e-3, return_info: bool = False):
        """ECSW-train on host float64 snapshots; returns a sharded ECSW engine.

        Training delegates to :meth:`ModalROMGenAlpha.hyper_reduce` (the
        offline step). The returned engine steps on the replicated gathered
        sample (``O(s)`` work) while ``sp`` keeps what scales with the
        beam's length: the transforms, :meth:`physical_frames` and the
        full-correction guard (:meth:`ecsw_residual`,
        :meth:`rollout_frames_guarded`).
        """
        out = self.ms.hyper_reduce(snapshots, tau, return_info=return_info)
        if return_info:
            reduced, info = out
            return dataclasses.replace(self, ms=reduced), info
        return dataclasses.replace(self, ms=out)

    def apply_ecsw(self, sel, xi_sel, train_tau: float = None):
        """Apply a pretrained ECSW sample (see :meth:`hyper_reduce`)."""
        return dataclasses.replace(self, ms=self.ms.apply_ecsw(sel, xi_sel,
                                                               train_tau=train_tau))

    def _sampled_correction_fn(self):
        """Replicated gathered-sample correction ``W6^T g(Phi6 eta)``: the
        computation of :meth:`ModalROMGenAlpha.ecsw_residual`'s sample."""
        ms = self.ms

        def sampled(eta):
            q_p = eta @ ms._upload("Phi_planar", eta).T
            n3 = q_p.shape[-1]
            g = ms.planar_correction(q_p.reshape(*q_p.shape[:-1], 3, n3 // 3))
            return g.reshape(q_p.shape) @ ms._upload("PhiW_planar", eta)

        return sampled

    def _node_consts(self, like):
        memo = self.__dict__.setdefault("_consts", {})
        key = (like.dtype, like.device)
        if key not in memo:
            t = lambda a: self.local(torch.as_tensor(a, dtype=like.dtype,  # noqa: E731
                                                     device=like.device), 0)
            n_loc = self.m_local
            memo[key] = (
                self._block("Phi_nodes", like.dtype).reshape(n_loc, 3, -1),
                self._block("W_nodes", like.dtype).reshape(n_loc, 3, -1),
                t(self.el_L), t(self.el_EI), t(self.el_EA),
                self.local(torch.as_tensor(np.asarray(self.el_nl), device=like.device), 0),
            )
        return memo[key]

    def _full_correction(self, like):
        """The sharded full correction ``psum(W^T g(Phi eta))``."""
        Phi, Wn, eL, eEI, eEA, eNL = self._node_consts(like)
        n_loc = Phi.shape[0]
        Phi_f, W_f = Phi.reshape(n_loc * 3, -1), Wn.reshape(n_loc * 3, -1)
        sp = self.sp

        def full(eta):
            q_loc = (eta @ Phi_f.T).reshape(*eta.shape[:-1], n_loc, 3)
            g_loc = spatial_correction_force_local(q_loc, eL, eEI, eEA, eNL, sp)
            return psum(g_loc.flatten(-2) @ W_f, sp)

        return full

    def _residual_fn(self, like):
        sampled, full = self._sampled_correction_fn(), self._full_correction(like)

        def residual(eta):
            f_full = full(eta)
            num = torch.linalg.vector_norm(sampled(eta) - f_full, dim=-1)
            den = torch.linalg.vector_norm(f_full, dim=-1)
            return num / torch.clamp_min(den, 1e-30)

        return residual

    def ecsw_residual(self, eta):
        """Sharded ECSW envelope audit: the sampled against the full
        correction (the contract of :meth:`ModalROMGenAlpha.ecsw_residual`),
        the full one split over ``sp`` (one ``psum``). ``eta``: ``(m,)`` or
        ``(B, m)``; returns per-environment ``rho``."""
        if self.ms.guard_Phi is None:
            raise ValueError(
                "ecsw_residual requires a hyper-reduced engine "
                "(call hyper_reduce first)"
            )
        eta = self._state(eta)
        return self._residual_fn(eta)(eta)

    def _env_split(self, *xs):
        """Split ``(B, m)`` states over ``dp``; returns (blocks, B or None)."""
        if xs[0].dim() < 2:
            return xs, None
        return tuple(env_block(x, self.dp) for x in xs), xs[0].shape[0]

    def rollout_frames_guarded(self, eta, etad, u_modal, n_frames: int, substeps: int = 1,
                               t0: float = 0.0, n_newton: int = 1, guard_tol: float = None):
        """Guarded ECSW rollout with the envelope audit split over ``sp``.

        Stepping is the replicated gathered-sample recurrence (that of
        :meth:`ModalROMGenAlpha.rollout_frames_guarded`); the per-frame
        audit evaluates the full correction node-sharded. Returns ``(ts,
        etas, etads, guard)`` with the single-device guard contract.
        """
        ms = self.ms
        if ms.guard_Phi is None:
            raise ValueError("rollout_frames_guarded requires a hyper-reduced engine")
        if guard_tol is None:
            guard_tol = 10.0 * (ms.guard_train_tau or 1e-3)
        eta = self._state(eta)
        etad = self._state(etad, eta.dtype)
        (eta_l, etad_l), n_env = self._env_split(eta, etad)
        residual = self._residual_fn(eta)
        step = ms._step_fn(eta, u_modal, n_newton)
        h = ms.dt
        s = (eta_l, etad_l, ms.initial_accel(eta_l, etad_l, u_modal, t0))
        res_max = eta_l.new_zeros(eta_l.shape[:-1])
        qs, vs = [eta_l], [etad_l]
        for i in range(int(n_frames)):
            t_frame = t0 + (i * substeps) * h
            for j in range(int(substeps)):
                s = step(s, t_frame + j * h)
            res_max = torch.maximum(res_max, residual(s[0]))
            qs.append(s[0])
            vs.append(s[1])
        etas, etads = torch.stack(qs), torch.stack(vs)
        if n_env is not None:
            etas = gather_env_blocks(etas, self.dp, n_env, dim=1)
            etads = gather_env_blocks(etads, self.dp, n_env, dim=1)
            res_max = gather_env_blocks(res_max, self.dp, n_env)
        ts = t0 + (h * substeps) * torch.arange(int(n_frames) + 1, dtype=torch.float64,
                                                device=eta.device)
        guard = {"max_residual": res_max, "flagged": res_max > guard_tol,
                 "guard_tol": guard_tol}
        return ts, etas, etads, guard

    def _force_modal(self, like):
        Phi, Wn, eL, eEI, eEA, eNL = self._node_consts(like)
        lam = self.ms._upload("lam", like)
        return _make_force_modal(Phi, Wn, eL, eEI, eEA, eNL, lam, self.sp,
                                 ext_modal=self.ms.ext_modal)

    def rollout_frames(self, eta, etad, u_modal, n_frames: int, substeps: int = 1,
                       n_newton: int = 1, t0: float = 0.0):
        """Sharded frame-collecting rollout (``solve_ivp(t_eval=...)`` contract).

        ``eta``/``etad``: ``(m,)`` or ``(B, m)`` (a batch split over ``dp``);
        ``u_modal``: constant modal force ``(m,)`` or None. Returns ``(ts,
        etas, etads)`` with the initial state, the same on every rank. A
        hyper-reduced engine steps on the replicated gathered sample (use
        :meth:`rollout_frames_guarded` for the sharded audit).
        """
        ms = self.ms
        if self.is_hyper_reduced:
            return ms.rollout_frames(eta, etad, u_modal, n_frames, substeps=substeps, t0=t0,
                                     n_newton=n_newton)
        am, af, beta, gamma = ms._coeffs()
        dt = ms.dt
        eta = self._state(eta)
        etad = self._state(etad, eta.dtype)
        if ms.Sinv_diag is not None:
            sinv_d = ms._upload("Sinv_diag", eta)

            def solve(r):
                return sinv_d * r
        else:
            Sinv = ms._upload("Sinv", eta)

            def solve(r):
                return r @ Sinv.T

        cdamp = None if ms.cdamp is None else ms._upload("cdamp", eta)
        u_m = (eta.new_zeros(self.n_modes) if u_modal is None
               else torch.as_tensor(np.asarray(u_modal) if not isinstance(u_modal, torch.Tensor)
                                    else u_modal, dtype=eta.dtype, device=eta.device))
        t_af_off = (1.0 - af) * dt
        force_modal = self._force_modal(eta)
        (q, v), n_env = self._env_split(eta, etad)

        # Consistent initial acceleration (ModalROMGenAlpha.initial_accel).
        r0 = -force_modal(q, v, t0)
        if cdamp is not None:
            r0 = r0 - cdamp * v
        a = r0 + u_m
        qs, vs = [q], [v]
        for i in range(int(n_frames)):
            t_frame = t0 + (i * substeps) * dt
            for j in range(int(substeps)):
                t_af = t_frame + j * dt + t_af_off
                q_pred = q + dt * v + (0.5 - beta) * dt * dt * a
                v_pred = v + (1.0 - gamma) * dt * a
                a1 = a
                for _ in range(int(n_newton)):
                    q1 = q_pred + beta * dt * dt * a1
                    v1 = v_pred + gamma * dt * a1
                    q_af = (1.0 - af) * q1 + af * q
                    v_af = (1.0 - af) * v1 + af * v
                    a_am = (1.0 - am) * a1 + am * a
                    r = a_am + force_modal(q_af, v_af, t_af) - u_m
                    if cdamp is not None:
                        r = r + cdamp * v_af
                    a1 = a1 - solve(r)
                q = q_pred + beta * dt * dt * a1
                v = v_pred + gamma * dt * a1
                a = a1
            qs.append(q)
            vs.append(v)
        etas, etads = torch.stack(qs), torch.stack(vs)
        if n_env is not None:
            etas = gather_env_blocks(etas, self.dp, n_env, dim=1)
            etads = gather_env_blocks(etads, self.dp, n_env, dim=1)
        ts = t0 + (dt * substeps) * torch.arange(int(n_frames) + 1, dtype=torch.float64,
                                                 device=eta.device)
        return ts, etas, etads

    def rollout_adaptive(self, eta, etad, u_modal, t_eval, rtol: float = 1e-6,
                         atol: float = 1e-9, dt0: float = None, n_newton: int = 2,
                         max_steps_per_interval: int = 100_000, safety: float = 0.9):
        """Error-controlled sharded ROM stepping (no manual dt).

        The counterpart of :meth:`ModalROMGenAlpha.rollout_adaptive`: the
        Zienkiewicz-Xie estimate and the controller of
        ``integrators.adaptive_drive``, with the per-Newton correction split
        over the beam axis. The correction's ``psum`` makes every shard's
        force, error norm and decision identical. A diagonal reduced
        Jacobian makes a trial dt's factorization a per-mode reciprocal.

        ``eta``/``etad``: ``(m,)`` or ``(B, m)``; a batch controls each
        environment's step (split over ``dp``). Returns ``(etas, etads,
        AdaptiveStats)``, frames leading, ``etas[0] = eta``. A hyper-reduced
        engine steps on the single-device engine (one shared controller).
        """
        ms = self.ms
        if self.is_hyper_reduced:
            return ms.rollout_adaptive(eta, etad, u_modal, t_eval, rtol=rtol, atol=atol,
                                       dt0=dt0, n_newton=n_newton,
                                       max_steps_per_interval=max_steps_per_interval,
                                       safety=safety)
        am, af, beta, gamma = ms._coeffs()
        zx_coeff = abs(float(beta - 1.0 / 6.0))
        eta = self._state(eta)
        etad = self._state(etad, eta.dtype)
        dtype = eta.dtype
        rtol, atol = integrators._floored_tols(rtol, atol, dtype)
        lam = ms._upload("lam", eta)
        cdamp = None if ms.cdamp is None else ms._upload("cdamp", eta)
        u_m = (eta.new_zeros(self.n_modes) if u_modal is None
               else torch.as_tensor(np.asarray(u_modal) if not isinstance(u_modal, torch.Tensor)
                                    else u_modal, dtype=dtype, device=eta.device))
        t_eval_np = integrators._host_times(t_eval)
        if dt0 is None:
            dt0 = float(t_eval_np[1] - t_eval_np[0]) / 16.0
        force_modal = self._force_modal(eta)
        (q0, v0), n_env = self._env_split(eta, etad)
        dt0 = torch.as_tensor(dt0, dtype=dtype, device=eta.device)
        if n_env is not None and dt0.dim() > 0:
            dt0 = env_block(dt0, self.dp)
        t_first = torch.as_tensor(t_eval_np[0], dtype=dtype, device=eta.device)
        r0 = -force_modal(q0, v0, t_first)
        if cdamp is not None:
            r0 = r0 - cdamp * v0
        a0 = r0 + u_m

        def trial(t, dt, state):
            q, v, a = state
            h = _colm(dt)
            # Modified Newton: jd keeps the force-free diagonal.
            jd = (1.0 - am) + ((1.0 - af) * beta) * h * h * lam
            if cdamp is not None:
                jd = jd + ((1.0 - af) * gamma) * h * cdamp
            t_af = t + (1.0 - af) * dt
            q_pred = q + h * v + (0.5 - beta) * h * h * a
            v_pred = v + (1.0 - gamma) * h * a
            a1 = a
            for _ in range(int(n_newton)):
                q1 = q_pred + beta * h * h * a1
                v1 = v_pred + gamma * h * a1
                q_af = (1.0 - af) * q1 + af * q
                v_af = (1.0 - af) * v1 + af * v
                a_am = (1.0 - am) * a1 + am * a
                r = a_am + force_modal(q_af, v_af, t_af) - u_m
                if cdamp is not None:
                    r = r + cdamp * v_af
                a1 = a1 - r / jd
            q1 = q_pred + beta * h * h * a1
            v1 = v_pred + gamma * h * a1
            e = zx_coeff * h * h * (a1 - a)
            scale = atol + rtol * torch.maximum(q.abs(), q1.abs())
            return (q1, v1, a1), torch.sqrt(((e / scale) ** 2).mean(-1))

        _, (etas, etads), stats = integrators.adaptive_drive(
            trial, (q0, v0, a0), t_eval_np, dt0, -1.0 / 3.0,
            max_steps_per_interval=max_steps_per_interval, safety=safety,
            frame_out=lambda s: (s[0], s[1]), per_env=n_env is not None,
        )
        etas = torch.cat([q0[None], etas], dim=0)
        etads = torch.cat([v0[None], etads], dim=0)
        if n_env is not None:
            etas = gather_env_blocks(etas, self.dp, n_env, dim=1)
            etads = gather_env_blocks(etads, self.dp, n_env, dim=1)
            stats = integrators.AdaptiveStats(
                *(gather_env_blocks(s, self.dp, n_env) for s in stats[:5]),
                host_reads=stats.host_reads, trials_run=stats.trials_run)
        return etas, etads, stats


def _padded_layout(model, n_shards: int):
    """Shared node/element padding and scatter geometry of both engines."""
    bc_info = model.beam_model.bc_info
    arrays = model.beam_model.arrays
    padded, n_pad_nodes = pad_arrays_for_shards(arrays, n_shards)
    E = np.asarray(padded.elastic_modulus, np.float64)
    return {
        "free": bc_info.free_dofs,
        "n_full": bc_info.n_dofs_full,
        "n_pad_nodes": n_pad_nodes,
        "n_real": arrays.n_elements + 1,
        "el_L": np.asarray(padded.length, np.float64),
        "el_EI": E * np.asarray(padded.moment_inertia, np.float64),
        "el_EA": E * np.asarray(padded.cross_area, np.float64),
        "el_nl": np.asarray(padded.nonlinear_mask),
    }


def build_spatial_modal(model, mesh, dt: float, rho_inf: float = 0.8, n_modes: int = None,
                        rayleigh: tuple = None, axis: str = "sp") -> SpatialModal:
    """Node-sharded linear modal engine (see :class:`SpatialModal`).

    Host float64 eigensolve by :func:`make_modal_genalpha` (which raises for
    nonlinear beams and registered forces); the bases are scattered to the
    padded node layout and each rank keeps its rows.
    """
    ms = make_modal_genalpha(model, dt, rho_inf=rho_inf, n_modes=n_modes, rayleigh=rayleigh,
                             device=mesh_device(mesh))
    lay = _padded_layout(model, MeshAxis(mesh, axis).size)
    Np = lay["n_pad_nodes"]
    return SpatialModal(
        mesh=mesh, axis=axis, n_nodes=Np, n_nodes_real=lay["n_real"],
        Phi_nodes=_scatter_node_basis(ms.Phi, lay["free"], lay["n_full"], Np),
        PhiTM_nodes=_scatter_node_basis(ms.PhiTM.T, lay["free"], lay["n_full"], Np),
        ms=ms,
    )


def build_spatial_modal_rom(model, mesh, dt: float, rho_inf: float = 0.8,
                            n_modes: int = None, rayleigh: tuple = None, basis=None,
                            axis: str = "sp") -> SpatialModalROM:
    """Node-sharded nonlinear modal-ROM engine (see :class:`SpatialModalROM`).

    Host float64 setup by :func:`make_modal_rom` (``basis``: a Petrov-Galerkin
    basis to reuse, e.g. ``load_basis``); needs the split fast path (the
    parity element). Registered fluid drag and gravity ride the sharded
    rollouts as exact reduced corrections; forces that need the general
    full-transform ``external_force`` path are rejected.
    """
    ms = make_modal_rom(model, dt, rho_inf=rho_inf, n_modes=n_modes, rayleigh=rayleigh,
                        basis=basis, device=mesh_device(mesh))
    if ms.lam is None:
        raise ValueError(
            "the sharded ROM engine requires the split fast path "
            "(exactly-diagonal reduced linear operator); "
            "use_consistent_nonlinear models are not supported"
        )
    if ms.external_force is not None:
        raise ValueError(
            "the sharded ROM engine supports registered external forces "
            "only through their reduced-modal closures (fluid drag / "
            "gravity, make_reduced_modal); this registry needs the "
            "general external_force path — use build_spatial_genalpha"
        )
    lay = _padded_layout(model, MeshAxis(mesh, axis).size)
    Np = lay["n_pad_nodes"]
    return SpatialModalROM(
        mesh=mesh, axis=axis, n_nodes=Np, n_nodes_real=lay["n_real"],
        Phi_nodes=_scatter_node_basis(ms.Phi, lay["free"], lay["n_full"], Np),
        PhiTM_nodes=_scatter_node_basis(ms.PhiTM.T, lay["free"], lay["n_full"], Np),
        ms=ms,
        W_nodes=_scatter_node_basis(ms.PhiW, lay["free"], lay["n_full"], Np),
        el_L=lay["el_L"], el_EI=lay["el_EI"], el_EA=lay["el_EA"], el_nl=lay["el_nl"],
    )

"""Modal generalized-alpha engine and the ``simulate`` entry point (PyTorch).

Counterpart of the modal slice of ``continuum_robot_tpu/models/simulate.py``:
:class:`ModalGenAlpha` (exact modal superposition of the linear beam's
generalized-α recurrence), its composed-propagator drive
(:meth:`ModalGenAlpha.rollout_power`), :class:`PiecewiseConstant` forcing,
:func:`make_modal_genalpha`, :func:`make_modal_rollout_fn` and
:func:`simulate` for ``method="modal"``.

Host setup stays NumPy float64 (eigensolve, map composition); rollouts run
on the device and dtype of the state tensors. The engine names of
:func:`simulate` are those of the JAX package: ``"xla"`` is the plain
PyTorch path, ``"pallas"`` the hand-written kernels of
``ops/cuda/modal_rollout.py``, ``"power"`` the composed maps applied by the
affine kernel. On CPU tensors every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.cuda import modal_rollout as kernels

# Bound of each engine's memo of composed maps and device uploads.
_MEMO_SIZE = 16

_NOT_PORTED = (
    "rk4", "dopri5", "newmark", "generalized_alpha",
    "generalized_alpha_adaptive", "implicit_adaptive", "sdirk3",
    "sdirk3_adaptive", "modal_rom", "modal_rom_adaptive",
)


@dataclasses.dataclass
class SimulationResult:
    """Rollout output: times, stacked states ``[q; v]``, optional stats.

    ``ys`` has shape ``(len(ts), 2*n_free)`` (or with a batch axis after the
    time axis), matching the layout of ``solve_ivp``'s ``sol.y.T``.
    """

    ts: torch.Tensor
    ys: torch.Tensor
    stats: Optional[object] = None

    @property
    def y(self) -> torch.Tensor:
        """Transposed view matching the ``scipy`` convention (state, time)."""
        return torch.movedim(self.ys, 0, -1)


def _host(x) -> np.ndarray:
    """Host NumPy copy of an array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _affine_power(T: np.ndarray, K: int):
    """``(T^K, S_K = sum_{j<K} T^j)`` for a batch of 3x3 maps, float64 host.

    Binary exponentiation over affine maps ``F_k(s) = T^k s + S_k b``:
    composing ``F_a`` after ``F_b`` gives ``(T^a T^b, T^a S_b + S_a)``.
    O(log K) batched 3x3 matmuls.
    """
    eye = np.broadcast_to(np.eye(3, dtype=T.dtype), T.shape)
    P, S = eye.copy(), np.zeros_like(T)
    bP, bS = T.copy(), eye.copy()
    k = int(K)
    while k:
        if k & 1:
            S = np.einsum("mij,mjk->mik", P, bS) + S
            P = np.einsum("mij,mjk->mik", P, bP)
        k >>= 1
        if k:
            bS = np.einsum("mij,mjk->mik", bP, bS) + bS
            bP = np.einsum("mij,mjk->mik", bP, bP)
    return P, S


def _affine_app(P, b, s):
    """One application of the per-mode affine map (kernel on CUDA state)."""
    return kernels.affine_steps(P, b, *s, apps=1)


@dataclasses.dataclass(frozen=True, eq=False)
class PiecewiseConstant:
    """Piecewise-constant input force: ``values[i]`` holds on
    ``[breaks[i-1], breaks[i])`` (``values[0]`` before ``breaks[0]``,
    ``values[-1]`` from ``breaks[-1]`` on).

    The reference's tip impulse — held for 10 ms, then released — has this
    shape. It is a callable of ``t`` (so it drops into every engine that
    accepts ``u=callable``) that also declares its structure, which lets the
    composed-propagator drive reproduce the stepper exactly with one
    host-composed map per constant-force span.

    ``breaks``: strictly ascending interior breakpoints (k-1 floats for k
    values). ``values``: ``(k, n)`` (or ``(k,)``), one force per span.
    """

    breaks: tuple
    values: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "breaks", tuple(float(b) for b in self.breaks))
        object.__setattr__(self, "values", _host(self.values))
        if self.values.ndim < 1 or (
            self.values.shape[0] != len(self.breaks) + 1
        ):
            raise ValueError(
                f"values needs len(breaks)+1 = {len(self.breaks) + 1} rows "
                f"(one per span), got shape {self.values.shape}"
            )
        if any(b2 <= b1 for b1, b2 in zip(self.breaks, self.breaks[1:])):
            raise ValueError("breaks must be strictly ascending")

    def __call__(self, t):
        """The value at ``t`` (float or 0-d tensor) as a CPU tensor."""
        t = torch.as_tensor(t, dtype=torch.float64).cpu()
        idx = torch.searchsorted(
            torch.tensor(self.breaks, dtype=torch.float64), t, right=True
        )
        return torch.as_tensor(self.values)[idx]

    def value_at(self, t: float) -> np.ndarray:
        """Host-side (float64-classified) value lookup."""
        i = int(np.searchsorted(
            np.asarray(self.breaks, np.float64), float(t), side="right"
        ))
        return self.values[i]

    def map_values(self, fn) -> "PiecewiseConstant":
        """A new schedule with ``fn`` applied to each value (e.g. the modal
        force projection)."""
        return PiecewiseConstant(
            self.breaks, np.stack([_host(fn(v)) for v in self.values])
        )


def _power_a0(lam, cdamp, u0_m, eta, etad):
    """Consistent initial modal acceleration from the t0 force value."""
    return kernels.initial_accel(lam, u0_m, cdamp, eta, etad)


def _power_drive(lam, cdamp, u_m, PK, bK, Pr, br, eta, etad, apps: int,
                 use_pallas: bool):
    """Drive of :meth:`ModalGenAlpha.rollout_power`: consistent initial
    acceleration, ``apps`` applications of the K-step map and the remainder
    map. ``use_pallas`` picks the affine kernel (CUDA state) over the plain
    version for both."""
    app = kernels.affine_steps if use_pallas else kernels.affine_steps_plain
    s = (eta, etad, _power_a0(lam, cdamp, u_m, eta, etad))
    if apps:
        s = app(PK, bK, *s, apps=apps)
    if Pr is not None:
        s = app(Pr, br, *s, apps=1)
    return s


def _power_drive_schedule(lam, cdamp, u0_m, PKs, bKs, Prs, brs, eta, etad,
                          apps: tuple, use_pallas: bool):
    """Multi-segment composed-propagator drive (piecewise-constant force):
    each constant-force segment's applications and remainder in sequence.
    The full affine state ``(eta, etad, etadd)`` carries across force
    switches exactly like the step-by-step recurrence does."""
    app = kernels.affine_steps if use_pallas else kernels.affine_steps_plain
    s = (eta, etad, _power_a0(lam, cdamp, u0_m, eta, etad))
    for i, ap in enumerate(apps):
        if ap:
            s = app(PKs[i], bKs[i], *s, apps=ap)
        if Prs[i] is not None:
            s = app(Prs[i], brs[i], *s, apps=1)
    return s


def _power_frames_drive(lam, cdamp, u_m, P, b, eta, etad, n_frames: int):
    """Frame-collecting composed-propagator rollout: one ``substeps``-step
    map application per frame."""
    return _power_frames_drive_schedule(lam, cdamp, u_m, (P,), (b,), eta,
                                        etad, (int(n_frames),))


def _power_frames_drive_schedule(lam, cdamp, u0_m, Ps, bs, eta, etad,
                                 counts: tuple):
    """Frame-collecting composed-propagator rollout over a schedule of
    per-frame maps: ``counts[i]`` consecutive frames apply ``(Ps[i],
    bs[i])``."""
    s = (eta, etad, _power_a0(lam, cdamp, u0_m, eta, etad))
    qs, vs = [eta], [etad]
    for P, b, c in zip(Ps, bs, counts):
        for _ in range(int(c)):
            s = _affine_app(P, b, s)
            qs.append(s[0])
            vs.append(s[1])
    return torch.stack(qs), torch.stack(vs)


@dataclasses.dataclass(frozen=True)
class ModalGenAlpha:
    """Generalized-alpha stepping in the mass-orthonormal modal basis.

    For an all-linear beam every operator of the implicit step (M, K and
    the effective Jacobian ``(1-am) M + (1-af) beta dt^2 K``) is diagonalized
    by the generalized eigenvectors of ``K phi = lambda M phi``, so the
    identical generalized-α recurrence runs per mode with scalar
    coefficients (8 multiply-adds per element, 10 damped; see
    ``ops.cuda.modal_rollout.mode_coeffs``), with the basis transforms paid
    once per rollout. Rayleigh damping ``C = alpha M + beta K`` diagonalizes
    in the same basis (``cdamp_m = alpha + beta lam_m``).

    Fields are host NumPy float64. Rollouts run on the device and dtype of
    the state tensors they are given; ``device`` and ``dtype`` apply to
    inputs given as NumPy arrays. Device uploads and composed maps are
    memoized per instance (least recently used, at most 16 entries, keyed
    on dtype, device and mode count).
    """

    Phi: np.ndarray  # (n, m) mass-orthonormal mode shapes
    PhiTM: np.ndarray  # (m, n) modal projector Phi^T M
    lam: np.ndarray  # (m,) eigenvalues omega^2
    rho_inf: float
    dt: float
    cdamp: Optional[np.ndarray] = None  # (m,) modal Rayleigh damping, or None
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float64

    def with_dt(self, dt: float) -> "ModalGenAlpha":
        """The same engine at a different step size (fresh memo)."""
        return dataclasses.replace(self, dt=float(dt))

    # -- memo and uploads ------------------------------------------------------

    def _memo(self, key, build):
        cache = self.__dict__.get("_memo_cache")
        if cache is None:
            cache = collections.OrderedDict()
            object.__setattr__(self, "_memo_cache", cache)
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        val = build()
        cache[key] = val
        if len(cache) > _MEMO_SIZE:
            cache.popitem(last=False)
        return val

    @property
    def n_modes(self) -> int:
        return int(np.asarray(self.lam).shape[0])

    def _upload(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """A host field as a tensor on ``like``'s device and dtype (memoized)."""
        return self._memo(
            (name, like.dtype, like.device, self.n_modes),
            lambda: torch.as_tensor(
                np.asarray(getattr(self, name)), dtype=like.dtype,
                device=like.device,
            ),
        )

    def _tensor(self, x) -> torch.Tensor:
        """Tensors pass through; arrays go to the engine's device and dtype."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # -- basis transforms ------------------------------------------------------

    def to_modal(self, q, v):
        """Physical reduced (q, v) -> modal (eta, etadot) via Phi^T M."""
        q, v = self._tensor(q), self._tensor(v)
        PhiTM = self._upload("PhiTM", q)
        return q @ PhiTM.T, v @ PhiTM.T

    def from_modal(self, eta, etad):
        eta, etad = self._tensor(eta), self._tensor(etad)
        Phi = self._upload("Phi", eta)
        return eta @ Phi.T, etad @ Phi.T

    def project_force(self, u):
        """Physical force -> modal force (Phi^T u)."""
        u = self._tensor(u)
        return u @ self._upload("Phi", u)

    def project_force_host(self, u) -> np.ndarray:
        """Host NumPy float64 force projection for setup-time constants."""
        return self.Phi.T @ np.asarray(_host(u), np.float64)

    def winv64(self) -> np.ndarray:
        """Per-mode effective-Jacobian inverses in float64 (host).

        ``J_m = (1-am) + (1-af) gamma dt c_m + (1-af) beta dt^2 lam_m``.
        """
        am = (2.0 * self.rho_inf - 1.0) / (self.rho_inf + 1.0)
        af = self.rho_inf / (self.rho_inf + 1.0)
        beta = 0.25 * (1.0 - am + af) ** 2
        gamma = 0.5 - am + af
        J = (1.0 - am) + (1.0 - af) * beta * self.dt * self.dt * np.asarray(
            self.lam
        )
        if self.cdamp is not None:
            J = J + (1.0 - af) * gamma * self.dt * np.asarray(self.cdamp)
        return 1.0 / J

    def _stepper_consts(self, like):
        """``(lam, winv, cdamp)`` on ``like``'s device and dtype (memoized)."""

        def build():
            def up(x):
                return None if x is None else torch.as_tensor(
                    np.asarray(x), dtype=like.dtype, device=like.device
                )

            return up(self.lam), up(self.winv64()), up(self.cdamp)

        return self._memo(
            ("stepper", like.dtype, like.device, self.n_modes), build
        )

    # -- step-by-step engine ---------------------------------------------------

    @staticmethod
    def _force_at(u_modal, like):
        """Normalize the modal-force spec to a callable of t."""
        if u_modal is None:
            zero = like.new_zeros(())
            return lambda t: zero
        if callable(u_modal):
            return lambda t: torch.as_tensor(
                u_modal(t), dtype=like.dtype, device=like.device
            )
        u_const = torch.as_tensor(u_modal, dtype=like.dtype, device=like.device)
        return lambda t: u_const

    def _step_fn(self, like, u_modal):
        """One generalized-α step in modal coordinates, ``step(carry, t)``.

        Runs the substituted single-Newton update with the coefficients of
        ``mode_coeffs`` and the expression order of
        ``kernels.gen_alpha_step``, so it agrees bit for bit with the step
        kernels.
        """
        lam, winv, cdamp = self._stepper_consts(like)
        cols = kernels.mode_coeffs(lam, winv, self.rho_inf, cdamp)
        sc = kernels.step_scalars(self.dt, self.rho_inf, like.dtype)
        u_at = self._force_at(u_modal, like)
        af = self.rho_inf / (self.rho_inf + 1.0)
        t_af_off = (1.0 - af) * self.dt

        def step(carry, t):
            q, v, a = carry
            return kernels.gen_alpha_step(
                q, v, a, winv * u_at(t + t_af_off), cols, sc
            )

        return step

    def initial_accel(self, eta, u_modal, t0=0.0, etad=None):
        """``a0 = u - lam eta - c etadot`` (modal mass = I)."""
        eta = self._tensor(eta)
        lam, _, cdamp = self._stepper_consts(eta)
        a0 = self._force_at(u_modal, eta)(t0) - lam * eta
        if cdamp is not None and etad is not None:
            a0 = a0 - cdamp * etad
        return a0

    def rollout(self, eta, etad, u_modal, n_steps: int, t0: float = 0.0):
        """``n_steps`` generalized-α steps in modal coordinates (plain torch).

        ``eta``/``etad``: ``(..., m)``; ``u_modal``: constant modal force,
        a callable ``t -> modal force``, or None. Returns final ``(eta,
        etad, etadd)``.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        step = self._step_fn(eta, u_modal)
        s = (eta, etad, self.initial_accel(eta, u_modal, t0, etad))
        for n in range(int(n_steps)):
            s = step(s, t0 + self.dt * n)
        return s

    def rollout_pallas(self, eta, etad, u_modal, n_steps: int, t0: float = 0.0):
        """Kernel rollout: all ``n_steps`` in one launch of the step kernel
        (``ops/cuda/modal_rollout.modal_steps``) on CUDA state, the plain
        version on CPU state. Constant ``u_modal`` only; same arithmetic as
        :meth:`rollout`. Returns final ``(eta, etad, etadd)``.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        lam, winv, cdamp = self._stepper_consts(eta)
        return kernels.modal_steps(
            lam, winv, u_modal, eta, etad, None, steps=n_steps, h=self.dt,
            rho_inf=self.rho_inf, cdamp=cdamp,
        )

    def rollout_frames_pallas(self, eta, etad, u_modal, n_frames: int,
                              substeps: int = 1):
        """Frame-collecting kernel rollout (constant ``u_modal`` only).

        One launch of the frames kernel on CUDA state. Same frame contract
        as :meth:`rollout_frames` (initial state included).
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        lam, winv, cdamp = self._stepper_consts(eta)
        etas, etads = kernels.modal_frames(
            lam, winv, u_modal, eta, etad, n_frames=n_frames,
            substeps=substeps, h=self.dt, rho_inf=self.rho_inf, cdamp=cdamp,
        )
        return self._frame_times(n_frames, substeps, 0.0, eta), etas, etads

    def _frame_times(self, n_frames, substeps, t0, like):
        return t0 + (self.dt * substeps) * torch.arange(
            int(n_frames) + 1, dtype=torch.float64, device=like.device
        )

    def rollout_frames(self, eta, etad, u_modal, n_frames: int,
                       substeps: int = 1, t0: float = 0.0):
        """Frame-collecting rollout: ``substeps`` inner steps per frame.

        Returns ``(ts (F+1,), etas (F+1, ..., m), etads (F+1, ..., m))``
        including the initial state — the ``solve_ivp(t_eval=...)`` contract.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        step = self._step_fn(eta, u_modal)
        s = (eta, etad, self.initial_accel(eta, u_modal, t0, etad))
        h = self.dt
        qs, vs = [eta], [etad]
        for i in range(int(n_frames)):
            t_frame = t0 + (i * substeps) * h
            for j in range(int(substeps)):
                s = step(s, t_frame + j * h)
            qs.append(s[0])
            vs.append(s[1])
        return (self._frame_times(n_frames, substeps, t0, eta),
                torch.stack(qs), torch.stack(vs))

    # -- composed-propagator engine -------------------------------------------

    def _step_affine64(self):
        """The gen-α step as a per-mode affine map, float64 on host.

        ``s' = T s + p4 e`` on ``s = (eta, etad, etadd)`` with ``p4 = winv *
        u`` and ``e = [beta h^2, gamma h, 1]``. Returns ``(T (m, 3, 3),
        bdir (m, 3))`` where the offset is ``bdir * u`` per mode.
        """
        h = float(self.dt)
        am = (2.0 * self.rho_inf - 1.0) / (self.rho_inf + 1.0)
        af = self.rho_inf / (self.rho_inf + 1.0)
        beta = 0.25 * (1.0 - am + af) ** 2
        gamma = 0.5 - am + af
        bh2, gh = beta * h * h, gamma * h
        c_qp, c_vp = (0.5 - beta) * h * h, (1.0 - gamma) * h
        lam = np.asarray(self.lam, np.float64)
        winv = self.winv64()
        cd = None if self.cdamp is None else np.asarray(self.cdamp, np.float64)
        p1, p2, p3, p5, p6 = kernels.mode_coeffs(lam, winv, self.rho_inf, cd)
        if p5 is None:
            p5 = p6 = np.zeros_like(lam)
        # a1 = p4 + Aq q + Av v + Aa a; then q' = q_pred + bh2 a1 etc.
        Aq = -(p2 + p3)
        Av = -(p2 * h + p5 + p6)
        Aa = p1 - p2 * c_qp - p5 * c_vp
        m = lam.shape[0]
        T = np.empty((m, 3, 3), np.float64)
        T[:, 0, 0] = 1.0 + bh2 * Aq
        T[:, 0, 1] = h + bh2 * Av
        T[:, 0, 2] = c_qp + bh2 * Aa
        T[:, 1, 0] = gh * Aq
        T[:, 1, 1] = 1.0 + gh * Av
        T[:, 1, 2] = c_vp + gh * Aa
        T[:, 2, 0] = Aq
        T[:, 2, 1] = Av
        T[:, 2, 2] = Aa
        bdir = winv[:, None] * np.array([bh2, gh, 1.0])[None, :]
        return T, bdir

    def _power_map(self, k: int, u_host):
        """Host-composed ``k``-step map ``(T^k, sum_{j<k} T^j b)``, f64."""
        T, bdir = self._step_affine64()
        b = (
            np.zeros((T.shape[0], 3), np.float64)
            if u_host is None
            else bdir * np.asarray(u_host, np.float64)[:, None]
        )
        P, S = _affine_power(T, k)
        return P, np.einsum("mij,mj->mi", S, b)

    @staticmethod
    def _u_key(u_host):
        return None if u_host is None else np.ascontiguousarray(u_host).tobytes()

    def _power_map_device(self, k: int, u_host, like):
        """Memoized composed map on ``like``'s device and dtype.

        Keyed on ``(k, u bytes, dtype, device, m)``; ``with_dt`` returns a
        fresh instance, so coefficient changes never hit a stale map.
        """

        def build():
            P, b = self._power_map(k, u_host)
            return (
                torch.as_tensor(P, dtype=like.dtype, device=like.device),
                torch.as_tensor(b, dtype=like.dtype, device=like.device),
            )

        return self._memo(
            (int(k), self._u_key(u_host), like.dtype, like.device, self.n_modes),
            build,
        )

    def _power_consts_device(self, u_host, like):
        """Memoized ``(lam, cdamp, modal force)`` uploads for the drive."""

        def build():
            lam, _, cdamp = self._stepper_consts(like)
            u = None if u_host is None else torch.as_tensor(
                u_host, dtype=like.dtype, device=like.device
            )
            return lam, cdamp, u

        return self._memo(
            ("consts", self._u_key(u_host), like.dtype, like.device,
             self.n_modes),
            build,
        )

    def _pwc_segments(self, u_pwc: PiecewiseConstant, n_steps: int,
                      t0: float):
        """Step counts per constant-force span of a piecewise-constant
        modal force, matching the stepper's convention.

        Step ``n`` (starting at ``t0 + n h``) reads the force at its gen-α
        evaluation point ``tau_n = t0 + (n + 1 - af) h``, so the value
        switches at the first step whose ``tau_n`` crosses the break.
        Classification happens in float64 on the host. Returns ``[(count,
        value_f64), ...]`` with zero-count spans dropped.
        """
        af = self.rho_inf / (self.rho_inf + 1.0)
        h = float(self.dt)
        n_steps = int(n_steps)
        vals = np.asarray(u_pwc.values, np.float64)
        edges = [
            int(min(max(np.ceil((b - t0) / h - (1.0 - af)), 0), n_steps))
            for b in u_pwc.breaks
        ]
        bounds = [0] + edges + [n_steps]
        return [
            (bounds[i + 1] - bounds[i], vals[i])
            for i in range(len(bounds) - 1)
            if bounds[i + 1] > bounds[i]
        ]

    def _pwc_frame_runs(self, u_pwc: PiecewiseConstant, n_frames: int,
                        substeps: int, t0: float):
        """Per-frame composed maps for a piecewise-constant force, grouped
        into runs of consecutive frames sharing one map.

        Frames inside one constant-force span share that span's
        ``substeps``-step map; a frame whose substep window crosses a break
        gets its own map, composed from the partial-span pieces in order.
        Returns ``[(P (m,3,3), b (m,3), n_frames_run), ...]`` (float64).
        """
        segs = self._pwc_segments(u_pwc, n_frames * substeps, t0)
        m = self.n_modes
        full_maps = {}
        runs = []  # [key, P, b, count]
        si, rem_seg = 0, (segs[0][0] if segs else 0)
        for _f in range(int(n_frames)):
            pieces = []
            need = int(substeps)
            while need:
                k = min(need, rem_seg)
                pieces.append((k, si))
                need -= k
                rem_seg -= k
                if rem_seg == 0 and si + 1 < len(segs):
                    si += 1
                    rem_seg = segs[si][0]
            if len(pieces) == 1:
                key = pieces[0][1]
                if runs and runs[-1][0] == key:
                    runs[-1][3] += 1
                    continue
                if key not in full_maps:
                    full_maps[key] = self._power_map(
                        int(substeps), segs[key][1]
                    )
                runs.append([key, *full_maps[key], 1])
            else:
                P = np.broadcast_to(
                    np.eye(3), (m, 3, 3)
                ).astype(np.float64).copy()
                b = np.zeros((m, 3), np.float64)
                for k, idx in pieces:
                    Pk, bk = self._power_map(k, segs[idx][1])
                    b = np.einsum("mij,mj->mi", Pk, b) + bk
                    P = np.einsum("mij,mjk->mik", Pk, P)
                # unique key: break-crossing frames never merge into runs
                runs.append([("mix", _f), P, b, 1])
        return [(P, b, c) for _key, P, b, c in runs]

    def rollout_power(self, eta, etad, u_modal, n_steps: int, t0: float = 0.0,
                      K: int = 16, use_pallas: bool = True):
        """Composed-propagator rollout: ``n_steps`` gen-α steps as
        ``n_steps // K`` applications of the host-precomputed K-step map.

        The linear modal gen-α step is an exact affine map per mode
        (:meth:`_step_affine64`), so K steps compose in float64 on the host
        into one map whose application costs 9 multiplies and 9 adds per
        element. It reproduces :meth:`rollout`'s discrete trajectory up to
        the rounding of the composed coefficients (not bit for bit). The
        remainder ``n_steps % K`` runs as one extra composed map.

        ``use_pallas=True`` applies the maps with the affine kernel on CUDA
        state; ``False`` with the plain version. ``u_modal`` is a constant
        modal force, None, or a :class:`PiecewiseConstant` schedule (each
        constant-force span composes its own maps). Returns final ``(eta,
        etad, etadd)``.
        """
        K = int(K)
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        eta, etad = self._tensor(eta), self._tensor(etad)
        if isinstance(u_modal, PiecewiseConstant):
            PKs, bKs, Prs, brs, apps = [], [], [], [], []
            for count, u_host in self._pwc_segments(u_modal, n_steps, t0):
                n_outer, rem = divmod(int(count), K)
                PK, bK = self._power_map_device(K, u_host, eta)
                apps.append(n_outer)
                PKs.append(PK)
                bKs.append(bK)
                Pr, br = (self._power_map_device(rem, u_host, eta)
                          if rem else (None, None))
                Prs.append(Pr)
                brs.append(br)
            lam, _, cdamp = self._stepper_consts(eta)
            u0_m = torch.as_tensor(
                u_modal.value_at(t0), dtype=eta.dtype, device=eta.device
            )
            return _power_drive_schedule(
                lam, cdamp, u0_m, PKs, bKs, Prs, brs, eta, etad,
                apps=tuple(apps), use_pallas=use_pallas,
            )
        if callable(u_modal):
            raise ValueError(
                "rollout_power takes a constant modal force (or a "
                "PiecewiseConstant schedule)"
            )
        n_outer, rem = divmod(int(n_steps), K)
        u_host = None if u_modal is None else np.asarray(_host(u_modal), np.float64)
        PK, bK = self._power_map_device(K, u_host, eta)
        Pr, br = (self._power_map_device(rem, u_host, eta)
                  if rem else (None, None))
        lam, cdamp, u_m = self._power_consts_device(u_host, eta)
        return _power_drive(lam, cdamp, u_m, PK, bK, Pr, br, eta, etad,
                            apps=n_outer, use_pallas=use_pallas)

    def rollout_frames_power(self, eta, etad, u_modal, n_frames: int,
                             substeps: int = 1):
        """Frame-collecting composed-propagator rollout.

        Each output frame advances ``substeps`` steps with one precomputed
        map application. ``u_modal`` is a constant modal force or a
        :class:`PiecewiseConstant` schedule (frames crossing a force break
        get their own host-composed map). Returns ``(ts, etas, etads)``
        including the initial state.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        ts = self._frame_times(n_frames, substeps, 0.0, eta)
        if isinstance(u_modal, PiecewiseConstant):
            runs = self._pwc_frame_runs(
                u_modal, int(n_frames), int(substeps), 0.0
            )
            lam, _, cdamp = self._stepper_consts(eta)
            etas, etads = _power_frames_drive_schedule(
                lam, cdamp,
                torch.as_tensor(u_modal.value_at(0.0), dtype=eta.dtype,
                                device=eta.device),
                [P for P, _b, _c in runs], [b for _P, b, _c in runs],
                eta, etad, counts=tuple(c for _P, _b, c in runs),
            )
            return ts, etas, etads
        if callable(u_modal):
            raise ValueError(
                "rollout_frames_power takes a constant modal force (or a "
                "PiecewiseConstant schedule)"
            )
        u_host = None if u_modal is None else np.asarray(_host(u_modal), np.float64)
        P, b = self._power_map_device(int(substeps), u_host, eta)
        lam, cdamp, u_m = self._power_consts_device(u_host, eta)
        etas, etads = _power_frames_drive(lam, cdamp, u_m, P, b, eta, etad,
                                          n_frames=int(n_frames))
        return ts, etas, etads


def make_modal_genalpha(
    model,
    dt: float,
    rho_inf: float = 0.8,
    n_modes: int = None,
    rayleigh: tuple = None,
    device="cpu",
    dtype: torch.dtype = torch.float64,
) -> ModalGenAlpha:
    """Build the modal generalized-α engine for an all-linear beam.

    Host float64 setup: generalized symmetric eigenproblem of the reduced
    (K, M). Raises for nonlinear beams or registered state-dependent
    forces. ``rayleigh``: optional ``(alpha, beta)`` structural damping
    ``C = alpha M + beta K`` (``cdamp_m = alpha + beta lam_m``).
    ``device``/``dtype``: where inputs given as NumPy arrays go.
    """
    from scipy.linalg import eigh

    arrays = model.beam_model.arrays
    if bool(np.any(np.asarray(arrays.nonlinear_mask))):
        raise ValueError("Modal stepping requires a purely linear beam")
    if len(model.force_registry) > 0:
        raise ValueError(
            "Modal stepping (exact superposition) cannot include "
            "state-dependent registry forces — use make_modal_rom / "
            "simulate(method='modal_rom'): fluid drag and gravity ride "
            "its split fast path as reduced corrections"
        )

    K = np.asarray(model.beam_model.get_stiffness_matrix(), dtype=np.float64)
    M = np.asarray(model.beam_model.get_mass_matrix(), dtype=np.float64)
    lam, Phi = eigh(K, M)
    lam = np.maximum(lam, 0.0)
    if n_modes is not None:
        lam, Phi = lam[:n_modes], Phi[:, :n_modes]
    cdamp = None
    if rayleigh is not None:
        alpha, beta_r = float(rayleigh[0]), float(rayleigh[1])
        if alpha < 0 or beta_r < 0:
            raise ValueError("Rayleigh coefficients must be nonnegative")
        cdamp = alpha + beta_r * lam
    return ModalGenAlpha(
        Phi=Phi, PhiTM=Phi.T @ M, lam=lam, rho_inf=rho_inf, dt=dt,
        cdamp=cdamp, device=torch.device(device), dtype=dtype,
    )


def make_modal_rollout_fn(
    model,
    dt: float,
    n_steps: int,
    substeps: int = 1,
    rho_inf: float = 0.8,
    u=None,
    forces_func=None,
    rayleigh: tuple = None,
    device="cpu",
    dtype: torch.dtype = torch.float64,
):
    """Frame-collecting modal rollout closure ``x0 -> (ts, ys)`` (plain
    torch stepping). Constant inputs project to modal coordinates on the
    host; callables project at every step."""
    if forces_func is not None:
        raise ValueError(
            "method='modal' (exact superposition) cannot include "
            "state-dependent forces; use method='modal_rom' — fluid "
            "drag/gravity ride its split fast path as reduced "
            "corrections — or 'newmark'/'generalized_alpha'"
        )
    ms = make_modal_genalpha(model, dt / substeps, rho_inf=rho_inf,
                             rayleigh=rayleigh, device=device, dtype=dtype)
    if u is None:
        u_modal = None
    elif callable(u):
        u_modal = lambda t: ms.project_force(u(t))  # noqa: E731
    else:
        u_modal = ms.project_force_host(u)

    def rollout(x0):
        n = x0.shape[-1] // 2
        eta, etad = ms.to_modal(x0[..., :n], x0[..., n:])
        ts, etas, etads = ms.rollout_frames(
            eta, etad, u_modal, n_steps, substeps=substeps
        )
        qs, vs = ms.from_modal(etas, etads)
        return ts, torch.cat([qs, vs], dim=-1)

    return rollout


def _frames_result(ms, x0, u_modal, n_steps, substeps, drive):
    """Shared batch/squeeze plumbing of the kernel and power engines."""
    squeeze = x0.ndim == 1
    xb = x0[None, :] if squeeze else x0
    n = xb.shape[-1] // 2
    eta, etad = ms.to_modal(xb[..., :n], xb[..., n:])
    ts, etas, etads = drive(eta, etad, u_modal, n_steps, substeps=substeps)
    qs, vs = ms.from_modal(etas, etads)
    ys = torch.cat([qs, vs], dim=-1)
    if squeeze:
        ys = ys[:, 0, :]
    return SimulationResult(ts=ts, ys=ys, stats=None)


def simulate(
    model,
    x0,
    t_final: float,
    dt: float,
    method: str = "dopri5",
    u=None,
    forces_func: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 1e-10,
    substeps: int = 1,
    n_newton: int = 2,
    linear_solver: str = None,
    rho_inf: float = 0.8,
    n_modes: int = None,
    nl_precision=None,
    static_vectors=None,
    modal_derivatives: int = 0,
    engine: str = "xla",
    jit: bool = True,
    rayleigh: tuple = None,
    chunk: int = None,
    device=None,
    dtype: torch.dtype = None,
) -> SimulationResult:
    """Run a complete rollout.

    The signature is the JAX package's, so one call works in both; only
    ``method="modal"`` is ported (linear beams, exact diagonalized
    recurrence), and every other method raises ``NotImplementedError``.
    The arguments that only other methods read (``rtol``, ``atol``,
    ``n_newton``, ``linear_solver``, ``n_modes``, ``nl_precision``,
    ``static_vectors``, ``modal_derivatives``, ``jit``) are accepted and
    unused.

    Args:
        model: a :class:`DynamicEulerBernoulliBeam` of this package.
        x0: initial reduced state ``[q; v]``, ``(2n,)`` or ``(B, 2n)``; a
            tensor or a NumPy array.
        t_final, dt: horizon and output-frame spacing.
        u: constant input force over position DOFs, a callable ``t ->
            force``, or a :class:`PiecewiseConstant` schedule.
        substeps: generalized-α steps per output frame.
        engine: ``"xla"`` (default) — the plain PyTorch stepper;
            ``"pallas"`` — the hand-written step kernel
            (``ops/cuda/modal_rollout.modal_frames``, constant force only);
            ``"power"`` — one host-composed ``substeps``-step affine map per
            frame, applied by the affine kernel (constant or
            :class:`PiecewiseConstant` force). On CPU tensors the kernels
            run their plain versions.
        rayleigh: optional ``(alpha, beta)`` Rayleigh damping.
        device, dtype: where the rollout runs; default to those of ``x0``
            if it is a tensor, else the CPU and ``x0``'s NumPy dtype.
    """
    x0 = torch.as_tensor(x0, device=device)
    if dtype is not None:
        x0 = x0.to(dtype)
    n_steps = int(round(t_final / dt))

    if rayleigh is not None and method not in (
        "modal", "modal_rom", "modal_rom_adaptive"
    ):
        raise ValueError(
            "rayleigh structural damping is supported by the modal "
            "engines (method='modal'/'modal_rom'/'modal_rom_adaptive')"
        )
    if engine not in ("xla", "pallas", "power"):
        raise ValueError(
            f"Unknown engine: {engine!r} (use 'xla'|'pallas'|'power')"
        )
    if engine == "power":
        if method != "modal":
            raise ValueError(
                "engine='power' applies to method='modal' (exact step "
                "composition exists only for the affine linear recurrence)"
            )
        if callable(u) and not isinstance(u, PiecewiseConstant):
            raise ValueError(
                "engine='power' requires a constant or PiecewiseConstant "
                "input force (the composed maps bake the modal force in); "
                "use engine='xla' for arbitrary time-varying inputs"
            )
    if engine == "pallas":
        if method not in ("modal", "modal_rom"):
            raise ValueError(
                "engine='pallas' applies to method='modal'/'modal_rom'"
            )
        if callable(u):
            raise ValueError(
                "engine='pallas' requires a constant input force (the "
                "fused kernels bake the modal force in); use engine='xla' "
                "for time-varying inputs"
            )
    if method in _NOT_PORTED:
        raise NotImplementedError(f"method={method!r} is not yet ported")
    if method != "modal":
        raise ValueError(f"Unknown method: {method}")
    if chunk is not None:
        raise ValueError(
            "chunk= applies to the adaptive methods "
            "('generalized_alpha_adaptive' / 'sdirk3' / "
            "'modal_rom_adaptive'); fixed-step spans are already one "
            f"bounded device call per frame (got method={method!r})"
        )

    if engine == "xla":
        rollout = make_modal_rollout_fn(
            model, dt, n_steps, substeps=substeps, rho_inf=rho_inf, u=u,
            forces_func=forces_func, rayleigh=rayleigh, device=x0.device,
            dtype=x0.dtype,
        )
        ts, ys = rollout(x0)
        return SimulationResult(ts=ts, ys=ys, stats=None)

    if forces_func is not None:
        raise ValueError("method='modal' cannot include state-dependent forces")
    ms = make_modal_genalpha(model, dt / substeps, rho_inf=rho_inf,
                             rayleigh=rayleigh, device=x0.device,
                             dtype=x0.dtype)
    if u is None:
        u_modal = None
    elif isinstance(u, PiecewiseConstant):
        u_modal = u.map_values(ms.project_force_host)
    else:
        u_modal = ms.project_force_host(u)
    drive = (ms.rollout_frames_power if engine == "power"
             else ms.rollout_frames_pallas)
    return _frames_result(ms, x0, u_modal, n_steps, substeps, drive)

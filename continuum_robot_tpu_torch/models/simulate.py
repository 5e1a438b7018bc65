"""Modal engines and the ``simulate`` entry point (PyTorch).

Counterpart of ``continuum_robot_tpu/models/simulate.py``:

* :class:`ModalGenAlpha` (exact modal superposition of the linear beam's
  generalized-α recurrence), its composed-propagator drive
  (:meth:`ModalGenAlpha.rollout_power`), :class:`PiecewiseConstant`
  forcing, :func:`make_modal_genalpha`, :func:`make_modal_rollout_fn`;
* :class:`ModalROMGenAlpha` (Petrov-Galerkin modal reduction of nonlinear
  and hybrid beams with the von Kármán correction on a restricted window,
  or the general full-transform force path), :func:`make_modal_rom` (with
  reduced fluid drag and gravity, user forces, the consistent element and
  basis augmentation), ECSW hyper-reduction
  (:meth:`ModalROMGenAlpha.hyper_reduce`) with its run-time guard
  (:meth:`ModalROMGenAlpha.ecsw_residual`), the error-controlled
  :meth:`ModalROMGenAlpha.rollout_adaptive`, basis and sample files
  (:func:`load_basis`, :func:`load_ecsw`) and the fused ROM rollout
  (:meth:`ModalROMGenAlpha.make_pallas_rollout`);
* :func:`make_newmark_operator`, the full-order implicit operators
  (block-tridiagonal mass and tangent, the ``btd``/``cr``/``dense_inv``/
  ``pallas`` linear solvers, the last through the CUDA kernel
  ``ops/cuda/btd_solve``);
* :func:`simulate` for every method of the JAX package: the explicit
  ``"rk4"`` and ``"dopri5"`` on the model's RHS, ``"modal"``,
  ``"modal_rom"``, the fixed-step implicit ``"newmark"`` and
  ``"generalized_alpha"``, and the adaptive ``"generalized_alpha_adaptive"``,
  ``"sdirk3"`` and ``"modal_rom_adaptive"`` (with ``chunk=``).

Host setup stays NumPy float64 (eigensolves, map composition, NNLS,
prefactoring);
rollouts run on the device and dtype of the state tensors. Entry points
put NumPy inputs on the card unless the caller asks for another device
(:func:`resolve_device`). The engine names of :func:`simulate` are those
of the JAX package: ``"xla"`` is the plain PyTorch path, ``"pallas"`` the
hand-written kernels of ``ops/cuda``, ``"power"`` the composed maps applied
by the affine kernel. On CPU tensors every kernel wrapper runs its plain
version.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from . import assembly, elements
from ..ops import banded, integrators
from ..ops.cuda import btd_solve as btd_kernel
from ..ops.cuda import modal_rollout as kernels

# Bound of each engine's memo of composed maps and device uploads.
_MEMO_SIZE = 16

_METHODS = (
    "rk4", "dopri5", "newmark", "generalized_alpha", "generalized_alpha_adaptive",
    "implicit_adaptive", "sdirk3", "sdirk3_adaptive", "modal", "modal_rom",
    "modal_rom_adaptive",
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if the caller named
    one, else the current CUDA card. Raises when no card is present and
    the caller asked for nothing: the port never falls back to the CPU
    silently (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class _Uploads:
    """Memoized device uploads of an engine's host NumPy fields.

    Least recently used, at most ``_MEMO_SIZE`` entries per instance;
    ``dataclasses.replace`` returns an instance with a fresh memo.
    """

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


class _SampledBytes(bytes):
    """A force's bytes as a memo key, hashed by its length and every 64th
    byte: a lookup hashes a few hundred bytes, not all of them (a 3000-mode
    force is 24 kB), and still compares keys in full."""

    def __hash__(self):
        return hash((len(self), bytes(self[::64])))


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
        """The value at ``t``, float64: for a float, a CPU tensor; for a
        tensor of times (of any shape, as the adaptive drivers pass them), a
        tensor on its device, one value a time, without a host read."""
        dev = t.device if isinstance(t, torch.Tensor) else torch.device("cpu")
        uploads = self.__dict__.setdefault("_uploads", {})
        if dev not in uploads:
            uploads[dev] = (torch.tensor(self.breaks, dtype=torch.float64, device=dev),
                            torch.as_tensor(self.values, device=dev))
        breaks, values = uploads[dev]
        idx = torch.searchsorted(
            breaks, torch.as_tensor(t, dtype=torch.float64, device=dev), right=True)
        return values[idx]

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
    map. ``use_pallas`` picks the drive kernel (one launch on CUDA state)
    over the plain version."""
    drive = kernels.affine_drive if use_pallas else kernels.affine_drive_plain
    return drive(lam, u_m, cdamp, PK, bK, eta, etad, apps, Pr, br)


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


@dataclasses.dataclass(frozen=True)
class ModalGenAlpha(_Uploads):
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
    inputs given as NumPy arrays (``device=None``: the card, see
    :func:`resolve_device`). Device uploads and composed maps are memoized
    per instance (least recently used, at most 16 entries, keyed on dtype,
    device and mode count).
    """

    Phi: np.ndarray  # (n, m) mass-orthonormal mode shapes
    PhiTM: np.ndarray  # (m, n) modal projector Phi^T M
    lam: np.ndarray  # (m,) eigenvalues omega^2
    rho_inf: float
    dt: float
    cdamp: Optional[np.ndarray] = None  # (m,) modal Rayleigh damping, or None
    device: Optional[torch.device] = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def with_dt(self, dt: float) -> "ModalGenAlpha":
        """The same engine at a different step size (fresh memo)."""
        return dataclasses.replace(self, dt=float(dt))

    @property
    def n_modes(self) -> int:
        return int(np.asarray(self.lam).shape[0])

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

        One launch of the frames kernel on CUDA state (the initial
        acceleration in the launch). For a host force (NumPy, a CPU tensor
        or None) the coefficient rows are memoized per force, so no torch op
        runs before the launch; a force already on the card is not copied
        back to key the memo, and the wrapper builds its rows each call.
        Same frame contract as :meth:`rollout_frames` (initial state
        included).
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        if isinstance(u_modal, torch.Tensor) and u_modal.is_cuda:
            u, coeffs = u_modal, None
            lam, winv, cdamp = self._stepper_consts(eta)
        else:
            u = None if u_modal is None else np.asarray(_host(u_modal), np.float64)
            lam, winv, cdamp, coeffs = self._frames_consts(u, eta)
        etas, etads = kernels.modal_frames(
            lam, winv, u, eta, etad, n_frames=n_frames,
            substeps=substeps, h=self.dt, rho_inf=self.rho_inf, cdamp=cdamp,
            coeffs=coeffs,
        )
        return self._frame_times(n_frames, substeps, 0.0, eta), etas, etads

    def _frames_consts(self, u_host, like):
        """``(lam, winv, cdamp, kernels.FrameCoeffs)`` on ``like``'s device
        and dtype for the force ``u_host``: one memo lookup a call."""

        def build():
            lam, winv, cdamp = self._stepper_consts(like)
            return lam, winv, cdamp, kernels.frame_coeffs(
                lam, winv, u_host, cdamp, self.rho_inf, like)

        return self._memo(
            ("frames", self._u_key(u_host), like.dtype, like.device, self.n_modes),
            build,
        )

    def _frame_times(self, n_frames, substeps, t0, like):
        ts = (self.dt * substeps) * torch.arange(
            int(n_frames) + 1, dtype=torch.float64, device=like.device
        )
        return t0 + ts if t0 else ts  # 0 + ts is ts: one torch op fewer

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
        return (None if u_host is None
                else _SampledBytes(np.ascontiguousarray(u_host).tobytes()))

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

        def build():
            PK, bK = self._power_map_device(K, u_host, eta)
            Pr, br = (self._power_map_device(rem, u_host, eta)
                      if rem else (None, None))
            return (PK, bK, Pr, br, *self._power_consts_device(u_host, eta))

        # One lookup (one hash of the force's bytes) a call: the drive's
        # host time counts in the rollout's.
        PK, bK, Pr, br, lam, cdamp, u_m = self._memo(
            ("drive", K, rem, self._u_key(u_host), eta.dtype, eta.device,
             self.n_modes), build,
        )
        return _power_drive(lam, cdamp, u_m, PK, bK, Pr, br, eta, etad,
                            apps=n_outer, use_pallas=use_pallas)

    def rollout_frames_power(self, eta, etad, u_modal, n_frames: int,
                             substeps: int = 1):
        """Frame-collecting composed-propagator rollout.

        Each output frame advances ``substeps`` steps with one precomputed
        map application. ``u_modal`` is a constant modal force or a
        :class:`PiecewiseConstant` schedule (frames crossing a force break
        get their own host-composed map). On CUDA state the whole drive is
        one ``affine_frames`` launch (the initial acceleration, a map
        application a frame, every frame written), the maps of a schedule
        stacked into one tensor; the maps are memoized per force or
        schedule. Returns ``(ts, etas, etads)`` including the initial state.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        lam, u0, cdamp, P, b, counts = self._frames_power_args(
            u_modal, int(n_frames), int(substeps), eta)
        etas, etads = kernels.affine_frames(lam, u0, cdamp, P, b, eta, etad, counts)
        return self._frame_times(n_frames, substeps, 0.0, eta), etas, etads

    def _frames_power_args(self, u_modal, n_frames: int, substeps: int, like):
        """The arguments of ``kernels.affine_frames`` but the state, on
        ``like``'s device and dtype: ``(lam, u(0), cdamp, P (R, m, 3, 3),
        b (R, m, 3), counts)``; one memo lookup a call."""
        if isinstance(u_modal, PiecewiseConstant):
            return self._memo(
                ("frames_pwc", n_frames, substeps, u_modal.breaks,
                 self._u_key(np.asarray(u_modal.values, np.float64)), like.dtype,
                 like.device, self.n_modes),
                lambda: self._pwc_frames_device(u_modal, n_frames, substeps, like),
            )
        if callable(u_modal):
            raise ValueError(
                "rollout_frames_power takes a constant modal force (or a "
                "PiecewiseConstant schedule)"
            )
        u_host = None if u_modal is None else np.asarray(_host(u_modal), np.float64)

        def build():
            P, b = self._power_map_device(substeps, u_host, like)
            lam, cdamp, u = self._power_consts_device(u_host, like)
            return lam, u, cdamp, P[None], b[None]

        consts = self._memo(
            ("frames_power", substeps, self._u_key(u_host), like.dtype, like.device,
             self.n_modes), build,
        )
        return (*consts, (n_frames,))

    def _pwc_frames_device(self, u_pwc: PiecewiseConstant, n_frames: int,
                           substeps: int, like):
        """:meth:`rollout_frames_power`'s drive arguments for a schedule on
        ``like``'s device and dtype: ``(lam, u(0), cdamp, P (R, m, 3, 3),
        b (R, m, 3), counts)``, the runs of :meth:`_pwc_frame_runs` stacked
        (one identity run of no frames when there are none)."""
        runs = self._pwc_frame_runs(u_pwc, n_frames, substeps, 0.0)
        if not runs:
            m = self.n_modes
            runs = [(np.broadcast_to(np.eye(3), (m, 3, 3)), np.zeros((m, 3)), 0)]
        counts = tuple(c for _P, _b, c in runs)

        def up(x):
            return torch.as_tensor(np.stack(x), dtype=like.dtype, device=like.device)

        lam, _, cdamp = self._stepper_consts(like)
        u0 = torch.as_tensor(u_pwc.value_at(0.0), dtype=like.dtype, device=like.device)
        return (lam, u0, cdamp, up([P for P, _b, _c in runs]),
                up([b for _P, b, _c in runs]), counts)


def make_modal_genalpha(
    model,
    dt: float,
    rho_inf: float = 0.8,
    n_modes: int = None,
    rayleigh: tuple = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ModalGenAlpha:
    """Build the modal generalized-α engine for an all-linear beam.

    Host float64 setup: generalized symmetric eigenproblem of the reduced
    (K, M). Raises for nonlinear beams or registered state-dependent
    forces. ``rayleigh``: optional ``(alpha, beta)`` structural damping
    ``C = alpha M + beta K`` (``cdamp_m = alpha + beta lam_m``).
    ``device``/``dtype``: where inputs given as NumPy arrays go
    (``device=None``: the card).
    """
    from scipy.linalg import eigh

    device = resolve_device(device)
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
        cdamp=cdamp, device=device, dtype=dtype,
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
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Frame-collecting modal rollout closure ``x0 -> (ts, ys)`` (plain
    torch stepping). Constant inputs project to modal coordinates on the
    host; callables project at every step. ``device=None``: the card."""
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


def reduce_matrix_dense(arrays, free_dofs, use_consistent: bool = False) -> np.ndarray:
    """Reduced dense tangent stiffness at q=0 (host float64).

    The zero-state element tangents, assembled and reduced to the free
    DOFs. For the parity element they are exact: the von Kármán correction
    has zero Jacobian at q=0, so a nonlinear element's tangent is its linear
    planes evaluated on the six unit vectors (non-symmetric: ``f1`` has no
    ``-EA*u2/L`` term); a linear element's is its stiffness matrix. The
    consistent element's come from :func:`assembly.element_tangent_stiffness`
    (the forward-mode Jacobian of its force, as in the JAX package).
    """
    L = np.asarray(arrays.length, np.float64)
    E = np.asarray(arrays.elastic_modulus, np.float64)
    I = np.asarray(arrays.moment_inertia, np.float64)
    A = np.asarray(arrays.cross_area, np.float64)
    if use_consistent:
        Ke = assembly.element_tangent_stiffness(
            arrays, np.zeros((L.shape[0], 6)), use_consistent=True
        )
    else:
        eye = np.eye(6)[:, :, None]  # (unit vector j, component, element)
        cols = elements.nonlinear_linear_planes(*eye, L, E * I, E * A)  # 6 x (6, E)
        K_nl = np.moveaxis(np.stack(cols), -1, 0)  # (E, slot i, unit j)
        K_lin = elements.linear_stiffness_matrix(L, E, I, A)
        Ke = np.where(np.asarray(arrays.nonlinear_mask)[:, None, None], K_nl, K_lin)
    n_full = 3 * (Ke.shape[0] + 1)
    K = np.zeros((n_full, n_full))
    for e in range(Ke.shape[0]):
        K[3 * e : 3 * e + 6, 3 * e : 3 * e + 6] += Ke[e]
    free = np.asarray(free_dofs)
    return K[np.ix_(free, free)]


# ---------------------------------------------------------------------------
# Full-order implicit operators (Newmark / generalized-alpha)
# ---------------------------------------------------------------------------

LINEAR_SOLVERS = ("btd", "cr", "dense_inv", "pallas")
# linear_solver=None on the card: the faster of "pallas" and "dense_inv" in
# chip_smoke.py's full-width timing of the implicit main path (PERF.md).
CARD_LINEAR_SOLVER = "pallas"


def _to_like(x, like):
    """Host arrays in a (nested) factor structure as tensors on ``like``'s
    device and dtype; ints and None pass through."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if isinstance(x, tuple):
        return tuple(_to_like(v, like) for v in x)
    if isinstance(x, dict):
        return {k: _to_like(v, like) for k, v in x.items()}
    return x


class _OperatorUploads(_Uploads):
    """An operator's host constants, uploaded once per (device, dtype)."""

    def __init__(self, build):
        self._build = build  # name -> host value, or a callable of ``like``

    def get(self, name, like: torch.Tensor):
        def upload():
            val = self._build[name]
            return val(like) if callable(val) else _to_like(val, like)

        return self._memo((name, like.dtype, like.device), upload)


def make_newmark_operator(
    model,
    forces_func: Optional[Callable] = None,
    dt: float = None,
    beta: float = 0.25,
    use_modified_newton: bool = True,
    linear_solver: str = None,
    extra_systems=None,
    matmul_precision=None,
    device=None,
    dtype: torch.dtype = None,
):
    """Build the implicit-stepper operators for a dynamic beam model.

    All operators act on *reduced* coordinates; internally the Jacobian
    solves run in zero-padded full coordinates, where the system stays
    block-tridiagonal (``ops/banded.py``). All-linear beams and modified
    Newton (the zero-state tangent) prefactor their effective Jacobians
    ``a M + c K`` once on the host in float64: the plain mass system ``(1,
    0)``, Newmark's ``(1, beta dt^2)`` when ``dt`` is given, and
    ``extra_systems`` (generalized-α's ``(1 - am, (1 - af) beta dt^2)``).
    Full Newton (``use_modified_newton=False`` on a nonlinear beam) factors
    at each linearization point, per environment.

    ``linear_solver``: how the prefactored solves run —

    * ``"btd"`` — block-Thomas sweeps in plain PyTorch (a loop over nodes,
      batched over environments);
    * ``"cr"`` — block cyclic reduction, ``ceil(log2(N+1))`` batched levels;
    * ``"dense_inv"`` — host float64 inverses of the reduced systems applied
      with ``torch.matmul``; the mass apply (and, for all-linear beams, the
      internal force) are dense reduced-matrix products too;
    * ``"pallas"`` — the block-Thomas sweeps as the hand-written CUDA kernel
      ``ops/cuda/btd_solve.btd_solve`` (the name of the JAX package's TPU
      kernel mode); CPU tensors run its plain version, ``"btd"``'s sweep.

    ``None`` takes ``"btd"`` on the CPU and :data:`CARD_LINEAR_SOLVER` on
    the card. Solves that are not prefactored (full Newton, and a tensor
    ``c``: the adaptive steppers' trial-dt systems, 0-d or one per
    environment) factor at the call and run the plain sweep of their mode.
    ``matmul_precision`` is accepted for the JAX signature: the dense
    products stay true float32/float64 (TF32 is off from import). The
    factors, mass bands, dense matrices and element arrays go to a
    tensor's device and dtype once, on first use.

    ``forces_func(x, t)``: a torch callable of the state ``x = [q; v]``
    returning a force over the position DOFs; None takes the model's force
    registry (registered fluid drag and gravity evaluate in torch on the
    state's device and dtype; an empty registry adds nothing).
    ``device``/``dtype``: where NumPy inputs of the callables go (None: the
    card, float64); the device also picks the ``linear_solver`` default.
    """
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    if linear_solver is None:
        linear_solver = "btd" if device.type == "cpu" else CARD_LINEAR_SOLVER
    if linear_solver not in LINEAR_SOLVERS:
        raise ValueError(
            f"Unknown linear_solver {linear_solver!r} (use one of {LINEAR_SOLVERS})"
        )
    del matmul_precision  # true float32/float64 products always

    arrays = model.beam_model.arrays
    bc_info = model.beam_model.bc_info
    free = np.asarray(bc_info.free_dofs)
    n_full = bc_info.n_dofs_full
    n_nodes = bc_info.n_nodes
    mask_nodes = bc_info.free_mask.reshape(n_nodes, 3)
    use_consistent = getattr(model, "use_consistent_nonlinear", False)
    all_linear = not bool(np.any(np.asarray(arrays.nonlinear_mask)))
    if forces_func is None and len(model.force_registry) > 0:
        forces_func = model.force_registry.create_aggregated_function()

    # Host float64 set-up.
    m_diag, m_off = assembly.mass_block_tridiagonal(arrays)
    mass_bands = banded.btd_apply_bc(
        np.asarray(m_diag), np.swapaxes(np.asarray(m_off), -1, -2),
        np.asarray(m_off), mask_nodes,
    )
    dense = linear_solver == "dense_inv"
    M_red = np.asarray(model.beam_model.M.toarray(), np.float64) if dense else None
    K_red = reduce_matrix_dense(arrays, free, use_consistent) if dense else None
    tangent0 = None
    if all_linear or use_modified_newton:
        tangent0 = assembly.tangent_block_tridiagonal(
            arrays, np.zeros(n_full), use_consistent=use_consistent
        )

    def factor(mass, tangent, a, c, mask):
        """Factors of ``a M + c K`` with the constraints imposed (host NumPy
        or device tensors)."""
        bands = banded.btd_apply_bc(*(a * m + c * k for m, k in zip(mass, tangent)), mask)
        if linear_solver == "cr":
            return banded.btd_cr_factor(*bands)
        return banded.btd_factor(*bands)

    prefactored, dense_inverses = {}, {}
    if tangent0 is not None:
        systems = [(1.0, 0.0)]
        if dt is not None:
            systems.append((1.0, beta * dt * dt))
        systems.extend(extra_systems or [])
        for a, c in systems:
            key = (float(a), float(c))
            if dense:
                dense_inverses[key] = np.linalg.inv(a * M_red + c * K_red)
            else:
                prefactored[key] = factor(mass_bands, tangent0, a, c, mask_nodes)

    # Free DOFs: a contiguous run (every fixed-base beam) pads and slices;
    # otherwise index tensors.
    lo = int(free[0]) if free.size else 0
    contiguous = np.array_equal(free, np.arange(lo, lo + free.size))

    def factors_upload(fac):
        """Host factors as uploaded; the kernel's are packed once, there."""
        if linear_solver != "pallas":
            return fac
        return lambda like: btd_kernel.pack_factors(_to_like(fac, like))

    up = _OperatorUploads({
        "mass_bands": mass_bands,
        "M_red": M_red,
        "K_red": K_red,
        "tangent0": tangent0,
        "mask_nodes": mask_nodes.astype(np.float64),
        "params": lambda like: assembly.element_params(arrays, like),
        "free": lambda like: torch.as_tensor(free, device=like.device),
        **{("factors", k): factors_upload(v) for k, v in prefactored.items()},
        **{("inv", k): v for k, v in dense_inverses.items()},
    })

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def pad(r, width=n_full):
        """``r`` in full coordinates, zero at the fixed DOFs, in rows of
        ``width`` elements (the first ``n_full`` of them)."""
        if contiguous:
            return torch.nn.functional.pad(r, (lo, width - lo - free.size))
        out = r.new_zeros(*r.shape[:-1], width)
        out[..., up.get("free", r)] = r
        return out

    def red(v):
        if contiguous:
            return v[..., lo : lo + free.size]
        return v[..., up.get("free", v)]

    def nodes(r, width=n_full):
        return pad(r, width)[..., :n_full].reshape(*r.shape[:-1], n_nodes, 3)

    def full_to_red(x, r):
        return red(x.reshape(*r.shape[:-1], n_full))

    if dense:

        def mass_apply(a_red):
            a_red = tensor(a_red)
            return a_red @ up.get("M_red", a_red).mT

    else:

        def mass_apply(a_red):
            a_red = tensor(a_red)
            out = banded.btd_matvec(*up.get("mass_bands", a_red), nodes(a_red))
            return full_to_red(out, a_red)

    if dense and all_linear:

        def internal_force(q_red):
            q_red = tensor(q_red)
            return q_red @ up.get("K_red", q_red).mT

    else:
        k_planar = assembly.make_planar_internal_force(arrays, use_consistent)

        def internal_force(q_red):
            # Element forces on [u; w; theta] node planes: contiguous planes
            # for the elementwise work, one transpose each way.
            q_red = tensor(q_red)
            q_p = nodes(q_red).transpose(-1, -2).contiguous()
            f = k_planar(q_p).transpose(-1, -2).reshape(*q_red.shape[:-1], n_full)
            return red(f)

    def factors_at(q_full, c, a):
        """Per-environment factors at the linearization point ``q_full``."""
        if tangent0 is not None:
            tangent = up.get("tangent0", q_full)
        else:
            tangent = assembly.tangent_block_tridiagonal(
                arrays, q_full, use_consistent=use_consistent,
                params=up.get("params", q_full),
            )
        return factor(up.get("mass_bands", q_full), tangent, a, c,
                      up.get("mask_nodes", q_full))

    sweep = banded.btd_cr_solve if linear_solver == "cr" else banded.btd_solve
    prefactored_sweep, prefactored_width = sweep, n_full
    if linear_solver == "pallas":
        # The kernel's right-hand sides are rows padded to a 16-byte pitch.
        prefactored_sweep = btd_kernel.btd_solve
        prefactored_width = btd_kernel.padded_width(n_full)

    def solve(q_red, c, a=1.0):
        # The adaptive steppers pass c = f(dt) as a tensor (the trial dt,
        # 0-d or a (B, 1) column under per_env): no prefactor exists for a
        # continuum of dt, so those systems are factored here, once a call.
        traced = isinstance(c, torch.Tensor)
        key = None if traced else (float(a), float(c))
        if key in dense_inverses:

            def do_solve(r_red):
                r_red = tensor(r_red)
                return r_red @ up.get(("inv", key), r_red).mT

            return do_solve

        if key in prefactored:

            def do_solve(r_red):
                r_red = tensor(r_red)
                x = prefactored_sweep(up.get(("factors", key), r_red),
                                      nodes(r_red, prefactored_width))
                return full_to_red(x, r_red)

            return do_solve

        if traced and c.dim() > 0:
            c = c[..., None, None]  # (B, 1) -> (B, 1, 1, 1) against the bands
        factors = factors_at(pad(tensor(q_red)), c, a)

        def do_solve(r_red):
            r_red = tensor(r_red)
            return full_to_red(sweep(factors, nodes(r_red)), r_red)

        return do_solve

    return integrators.NewmarkOperator(
        mass_apply=mass_apply,
        internal_force=internal_force,
        external_force=forces_func,
        solve=solve,
        tangent_frozen=tangent0 is not None,
    )


@dataclasses.dataclass(frozen=True)
class ModalROMGenAlpha(_Uploads):
    """Generalized-alpha stepping in a truncated modal (Petrov-Galerkin) subspace.

    The nonlinear-beam counterpart of :class:`ModalGenAlpha`. The trial
    basis ``Phi`` holds the lowest right eigenvectors of the exact
    zero-state tangent pencil ``(K0, M)``, the test basis ``PhiW`` the left
    ones, biorthonormalized so ``PhiW^T M Phi = I``: the reduced linear
    operator is then exactly ``diag(lam)`` of real eigenvalues, stable
    under any truncation even though the parity element's tangent is
    non-symmetric. The modified-Newton Jacobian is prefactored on the host
    (``Sinv``, or its diagonal ``Sinv_diag`` when the reduced operator is
    diagonal to roundoff).

    Split fast path: the modal internal force is ``lam * eta + W^T g(Phi
    eta)``, where ``g`` is the von Kármán correction
    (``elements.nonlinear_correction_planes``) evaluated on a node window
    that covers every nonlinear element. ``Phi_planar``/``PhiW_planar``
    are the bases restricted to that window in planar row order ``[u; w;
    theta]`` (zero rows for fixed DOFs kept), or, after ECSW
    hyper-reduction, gathered to the sampled elements' six DOF blocks
    ``[u1, w1, t1, u2, w2, t2]`` with the weights folded into the test
    basis.

    External forces: ``ext_modal`` (registered fluid drag and gravity
    projected from restricted basis rows, ``forces.*.make_reduced_modal``)
    rides the split path; ``external_force`` (a user ``forces_func(x, t)``
    on ``[q; v]``, or the registry aggregate of the consistent element)
    takes the general path, ``PhiW^T [k(Phi eta) - F(x, t)]`` through the
    full transforms, as does every engine without ``lam`` (the consistent
    element).

    Fields are host NumPy float64, as in the JAX package. Rollouts run on
    the device and dtype of the state tensors; ``device`` (None: the card)
    and ``dtype`` apply to inputs given as NumPy arrays.
    """

    Phi: np.ndarray  # (n, m) trial basis (right eigenvectors of (K0, M))
    PhiW: np.ndarray  # (n, m) test basis (left eigenvectors), PhiW^T M Phi = I
    PhiTM: np.ndarray  # (m, n) projector PhiW^T M
    Sinv: np.ndarray  # (m, m) inverse of (1-am) I + (1-af) beta dt^2 K0r [+ damping]
    rho_inf: float
    dt: float
    internal_force: Callable  # reduced-coordinate element force k(q_red)
    external_force: Optional[Callable] = None  # (x_red, t) -> force, or None
    ext_modal: Optional[Callable] = None  # (eta, etad, t, precision) -> (..., m)
    lam: Optional[np.ndarray] = None  # (m,) diag of W^T K0 Phi
    Phi_planar: Optional[np.ndarray] = None  # (3 n_sub, m) window, or (6 s, m) sample
    PhiW_planar: Optional[np.ndarray] = None  # same rows, test basis
    planar_correction: Optional[Callable] = None  # (..., 3, n_sub) -> same
    window_params: Optional[dict] = None  # {length, EI, EA, nonlinear_mask}, (n_sub - 1,)
    guard_Phi: Optional[np.ndarray] = None  # window bases kept by hyper_reduce
    guard_PhiW: Optional[np.ndarray] = None
    guard_correction: Optional[Callable] = None
    guard_train_tau: Optional[float] = None
    sampled_params: Optional[dict] = None  # ECSW sample {length, EI, EA, nonlinear_mask, sel, xi}
    Sinv_diag: Optional[np.ndarray] = None  # (m,) when Sinv is diagonal to roundoff
    cdamp: Optional[np.ndarray] = None  # (m,) modal Rayleigh damping alpha + beta lam
    device: Optional[torch.device] = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def n_modes(self) -> int:
        return self.Phi.shape[1]

    def with_dt(self, dt: float) -> "ModalROMGenAlpha":
        """The same engine at a different step size.

        Rebuilds the prefactored effective Jacobian from the diagonal
        reduced operator ``lam``; needs ``Sinv_diag`` (the Petrov-Galerkin
        eigenbasis case). Coupled bases rebuild with :func:`make_modal_rom`.
        """
        if self.Sinv_diag is None or self.lam is None:
            raise ValueError(
                "with_dt requires the diagonal reduced effective Jacobian "
                "(Sinv_diag) — rebuild coupled/augmented engines with "
                "make_modal_rom at the new dt"
            )
        am, af, beta, gamma_ga = self._coeffs()
        d = (1.0 - am) + (1.0 - af) * beta * dt * dt * np.asarray(
            self.lam, np.float64
        )
        if self.cdamp is not None:
            d = d + (1.0 - af) * gamma_ga * dt * np.asarray(
                self.cdamp, np.float64
            )
        return dataclasses.replace(
            self, dt=float(dt), Sinv=np.diag(1.0 / d),
            Sinv_diag=np.ascontiguousarray(1.0 / d),
        )

    # -- basis transforms ------------------------------------------------------

    def to_modal(self, q, v):
        """Physical reduced (q, v) -> modal (eta, etadot) via ``PhiW^T M``."""
        q, v = self._tensor(q), self._tensor(v)
        PhiTM = self._upload("PhiTM", q)
        return q @ PhiTM.T, v @ PhiTM.T

    def from_modal(self, eta, etad):
        eta, etad = self._tensor(eta), self._tensor(etad)
        Phi = self._upload("Phi", eta)
        return eta @ Phi.T, etad @ Phi.T

    def project_force(self, u):
        """Physical force -> modal force (test-basis projection ``PhiW^T u``)."""
        u = self._tensor(u)
        return u @ self._upload("PhiW", u)

    def project_force_host(self, u) -> np.ndarray:
        return self.PhiW.T @ np.asarray(_host(u), np.float64)

    def _coeffs(self):
        am = (2.0 * self.rho_inf - 1.0) / (self.rho_inf + 1.0)
        af = self.rho_inf / (self.rho_inf + 1.0)
        beta = 0.25 * (1.0 - am + af) ** 2
        gamma = 0.5 - am + af
        return am, af, beta, gamma

    # -- plain stepper ---------------------------------------------------------

    def _force_modal(self, eta_af, etad_af, t_af, precision=None,
                     nl_precision=None):
        """Modal residual force ``PhiW^T [k(q) - F_ext(x, t)]`` at the alpha
        point.

        Split fast path (``lam`` set, no ``external_force``): ``lam * eta_af
        + PhiW^T g(Phi eta_af)`` with ``g`` on the restricted window, minus
        ``ext_modal``. Otherwise the general path: ``k`` and the external
        force evaluated on the full reduced state ``[Phi eta; Phi etad]``.
        The basis transforms run as true float32 (or float64)
        ``torch.matmul`` whatever ``precision`` and ``nl_precision`` say
        (see ``ops/cuda/rom_rollout.py``).
        """
        if self.lam is not None and self.external_force is None:
            f_m = self._upload("lam", eta_af) * eta_af
            if self.planar_correction is not None:
                q_p = eta_af @ self._upload("Phi_planar", eta_af).T
                n_sub = q_p.shape[-1] // 3
                g_p = self.planar_correction(q_p.reshape(*q_p.shape[:-1], 3, n_sub))
                g_p = g_p.reshape(*q_p.shape[:-1], 3 * n_sub)
                f_m = f_m + g_p @ self._upload("PhiW_planar", eta_af)
            if self.ext_modal is not None:
                # The same sign as the general path's k(q) - F_ext.
                nl_prec = precision if nl_precision is None else nl_precision
                f_m = f_m - self.ext_modal(eta_af, etad_af, t_af, precision=nl_prec)
            return f_m
        Phi = self._upload("Phi", eta_af)
        q_af = eta_af @ Phi.T
        f = self.internal_force(q_af)
        if self.external_force is not None:
            x_af = torch.cat([q_af, etad_af @ Phi.T], dim=-1)
            f = f - self.external_force(x_af, t_af)
        return f @ self._upload("PhiW", eta_af)

    def _step_fn(self, like, u_modal, n_newton: int, precision=None,
                 nl_precision=None):
        """One modified-Newton generalized-α step, ``step(carry, t)``."""
        am, af, beta, gamma = self._coeffs()
        dt = self.dt
        if self.Sinv_diag is not None:
            sinv_d = self._upload("Sinv_diag", like)

            def solve(r):
                return sinv_d * r

        else:
            Sinv = self._upload("Sinv", like)

            def solve(r):
                return r @ Sinv.T

        u_at = ModalGenAlpha._force_at(u_modal, like)
        t_af_off = (1.0 - af) * dt
        cdamp = None if self.cdamp is None else self._upload("cdamp", like)

        def step(carry, t):
            eta, etad, etadd = carry
            t_af = t + t_af_off
            eta_pred = eta + dt * etad + (0.5 - beta) * dt * dt * etadd
            etad_pred = etad + (1.0 - gamma) * dt * etadd
            a1 = etadd
            for _ in range(int(n_newton)):
                eta1 = eta_pred + beta * dt * dt * a1
                etad1 = etad_pred + gamma * dt * a1
                eta_af = (1.0 - af) * eta1 + af * eta
                etad_af = (1.0 - af) * etad1 + af * etad
                a_am = (1.0 - am) * a1 + am * etadd
                r = a_am + self._force_modal(
                    eta_af, etad_af, t_af, precision, nl_precision
                ) - u_at(t_af)
                if cdamp is not None:
                    r = r + cdamp * etad_af
                a1 = a1 - solve(r)
            eta1 = eta_pred + beta * dt * dt * a1
            etad1 = etad_pred + gamma * dt * a1
            return eta1, etad1, a1

        return step

    def initial_accel(self, eta, etad, u_modal, t0=0.0, precision=None,
                      nl_precision=None):
        """Petrov-Galerkin ``etadd0 = u_modal + PhiW^T (F_ext - k(q0))``
        (minus ``cdamp * etad0`` when structurally damped)."""
        eta, etad = self._tensor(eta), self._tensor(etad)
        r = -self._force_modal(eta, etad, t0, precision, nl_precision)
        if self.cdamp is not None:
            r = r - self._upload("cdamp", eta) * etad
        return r + ModalGenAlpha._force_at(u_modal, eta)(t0)

    def rollout(self, eta, etad, u_modal, n_steps: int, t0: float = 0.0,
                n_newton: int = 1, precision=None, nl_precision=None,
                unroll: int = 1, carry_dtype=None):
        """``n_steps`` ROM generalized-α steps (plain torch, a Python loop);
        returns the final ``(eta, etad, etadd)``.

        ``n_newton`` modified-Newton corrections per step (1: the
        semi-implicit throughput scheme). ``carry_dtype`` (e.g.
        ``torch.bfloat16``) stores the carry between chunks of ``unroll``
        steps in that dtype while every step computes in the input dtype:
        one rounding of the state per chunk, then a remainder tail of
        ``n_steps % unroll`` steps (the JAX package's outer scan). With
        ``carry_dtype=None`` ``unroll`` changes nothing.
        """
        eta, etad = self._tensor(eta), self._tensor(etad)
        step = self._step_fn(eta, u_modal, n_newton, precision, nl_precision)
        s = (eta, etad, self.initial_accel(eta, etad, u_modal, t0, precision,
                                           nl_precision))
        n_steps = int(n_steps)
        if carry_dtype is None:
            for n in range(n_steps):
                s = step(s, t0 + self.dt * n)
            return s
        dtype = eta.dtype
        k = max(1, min(int(unroll), n_steps))
        n_outer = n_steps // k
        carry = tuple(x.to(carry_dtype) for x in s)
        for o in range(n_outer):
            s = tuple(x.to(dtype) for x in carry)
            for n in range(o * k, (o + 1) * k):
                s = step(s, t0 + self.dt * n)
            carry = tuple(x.to(carry_dtype) for x in s)
        s = tuple(x.to(dtype) for x in carry)
        for n in range(n_outer * k, n_steps):
            s = step(s, t0 + self.dt * n)
        return s

    def rollout_adaptive(self, eta, etad, u_modal, t_eval, rtol: float = 1e-6,
                         atol: float = 1e-9, dt0: float = None, n_newton: int = 2,
                         max_steps_per_interval: int = 100_000, safety: float = 0.9,
                         precision=None, nl_precision=None, etadd0=None,
                         return_final: bool = False):
        """Error-controlled ROM stepping: adaptive generalized-α.

        The Zienkiewicz-Xie estimate and controller of
        ``integrate_generalized_alpha_adaptive``, on
        ``integrators.adaptive_drive``. The reduced effective Jacobian is
        diagonal, so a trial dt's "factorization" is the per-mode
        ``jd = (1-am) + (1-af) beta dt^2 lam (+ (1-af) gamma dt cdamp)``: a
        rejected trial costs one force evaluation. Error is measured in
        modal coordinates (``atol`` in modal units); ``rtol``/``atol`` are
        floored at 50 eps of the state's dtype. A batch shares one step
        size. Needs ``Sinv_diag``.

        ``dt0`` defaults to ``(t_eval[1] - t_eval[0]) / 16``; ``etadd0``
        carries an algorithmic acceleration in (else the consistent one at
        ``t_eval[0]``), and ``return_final=True`` appends the final
        ``(eta, etad, etadd)``: the exact continuation of
        ``simulate(chunk=...)``. Returns ``(etas, etads, AdaptiveStats)``,
        frame axis leading, ``etas[0] = eta``.
        """
        if self.Sinv_diag is None:
            raise ValueError(
                "rollout_adaptive requires the diagonal reduced effective "
                "Jacobian (Sinv_diag) — augmented/defective bases with a "
                "genuinely coupled reduced operator need a dense "
                "factorization per trial dt; use the fixed-step rollout"
            )
        am, af, beta, gamma = self._coeffs()
        cdamp64 = None if self.cdamp is None else np.asarray(self.cdamp, np.float64)
        # The reduced operator's diagonal in float64: the split path stores
        # it; otherwise invert the Sinv_diag relation at self.dt.
        if self.lam is not None:
            lam64 = np.asarray(self.lam, np.float64)
        else:
            j0 = 1.0 / np.asarray(self.Sinv_diag, np.float64) - (1.0 - am)
            if cdamp64 is not None:
                j0 = j0 - (1.0 - af) * gamma * self.dt * cdamp64
            lam64 = j0 / ((1.0 - af) * beta * self.dt * self.dt)

        eta, etad = self._tensor(eta), self._tensor(etad)
        if dt0 is None:
            te = integrators._host_times(t_eval)
            dt0 = float(te[1] - te[0]) / 16.0
        dtype = eta.dtype
        t_eval = torch.as_tensor(integrators._host_times(t_eval), dtype=dtype,
                                 device=eta.device)
        lam_j = torch.as_tensor(lam64, dtype=dtype, device=eta.device)
        cdamp_j = (None if cdamp64 is None
                   else torch.as_tensor(cdamp64, dtype=dtype, device=eta.device))
        u_at = ModalGenAlpha._force_at(u_modal, eta)
        zx_coeff = abs(float(beta - 1.0 / 6.0))
        rtol, atol = integrators._floored_tols(rtol, atol, dtype)
        if etadd0 is None:
            etadd0 = self.initial_accel(eta, etad, u_modal, t_eval[0], precision,
                                        nl_precision)

        def trial(t, dt, state):
            q, v, a = state
            jd = (1.0 - am) + ((1.0 - af) * beta) * dt * dt * lam_j
            if cdamp_j is not None:
                jd = jd + ((1.0 - af) * gamma) * dt * cdamp_j
            t_af = t + (1.0 - af) * dt
            eta_pred = q + dt * v + (0.5 - beta) * dt * dt * a
            etad_pred = v + (1.0 - gamma) * dt * a
            a1 = a
            for _ in range(int(n_newton)):
                eta1 = eta_pred + beta * dt * dt * a1
                etad1 = etad_pred + gamma * dt * a1
                eta_af = (1.0 - af) * eta1 + af * q
                etad_af = (1.0 - af) * etad1 + af * v
                a_am = (1.0 - am) * a1 + am * a
                r = a_am + self._force_modal(
                    eta_af, etad_af, t_af, precision, nl_precision
                ) - u_at(t_af)
                if cdamp_j is not None:
                    r = r + cdamp_j * etad_af
                a1 = a1 - r / jd
            q1 = eta_pred + beta * dt * dt * a1
            v1 = etad_pred + gamma * dt * a1
            e = zx_coeff * dt * dt * (a1 - a)
            scale = atol + rtol * torch.maximum(q.abs(), q1.abs())
            return (q1, v1, a1), torch.sqrt(((e / scale) ** 2).mean())

        state_f, (etas, etads), stats = integrators.adaptive_drive(
            trial, (eta, etad, etadd0), t_eval, integrators._controller_dt(dt0, eta),
            -1.0 / 3.0, max_steps_per_interval=max_steps_per_interval, safety=safety,
            frame_out=lambda s: (s[0], s[1]),
        )
        etas = torch.cat([eta[None], etas], dim=0)
        etads = torch.cat([etad[None], etads], dim=0)
        if return_final:
            return etas, etads, stats, state_f
        return etas, etads, stats

    def rollout_frames(self, eta, etad, u_modal, n_frames: int,
                       substeps: int = 1, t0: float = 0.0, n_newton: int = 1,
                       precision=None, nl_precision=None, unroll: int = 1):
        """Frame-collecting ROM rollout, ``solve_ivp(t_eval=...)`` contract:
        ``(ts (F+1,), etas (F+1, ..., m), etads (F+1, ..., m))`` including
        the initial state."""
        eta, etad = self._tensor(eta), self._tensor(etad)
        step = self._step_fn(eta, u_modal, n_newton, precision, nl_precision)
        s = (eta, etad, self.initial_accel(eta, etad, u_modal, t0, precision,
                                           nl_precision))
        h = self.dt
        qs, vs = [eta], [etad]
        for i in range(int(n_frames)):
            t_frame = t0 + (i * substeps) * h
            for j in range(int(substeps)):
                s = step(s, t_frame + j * h)
            qs.append(s[0])
            vs.append(s[1])
        ts = t0 + (h * substeps) * torch.arange(
            int(n_frames) + 1, dtype=torch.float64, device=eta.device
        )
        return ts, torch.stack(qs), torch.stack(vs)

    def make_pallas_rollout(self, tile: int = 256, chunk: int = 100):
        """Fused rollout of the hand-written ROM kernels
        (``ops/cuda/rom_rollout.FusedROMRollout``): the recurrence of
        :meth:`rollout` with constant input and no external force. The name
        is the JAX package's; ``tile`` and ``chunk`` are accepted for
        signature parity and unused. On the card its two basis transforms
        are float32 products for ``nl_precision="highest"`` and 3xTF32
        tensor-core products for the other tiers (about 1e-6 of the
        output's scale against float32; see ``ops/cuda/rom_rollout.py``)."""
        if self.ext_modal is not None:
            raise ValueError(
                "the fused Pallas ROM kernel does not evaluate reduced "
                "external forces (fluid/gravity) in-kernel — run forced "
                "beams on the XLA split path (simulate(engine='xla'), "
                "rollout/rollout_frames/rollout_adaptive)"
            )
        if self.external_force is not None:
            raise ValueError(
                "the fused Pallas ROM kernel supports no external forces"
            )
        from ..ops.cuda.rom_rollout import FusedROMRollout

        return FusedROMRollout(self, tile=tile, chunk=chunk)

    # -- ECSW hyper-reduction (host float64) -----------------------------------

    def _split_window(self, what: str, why: str = ""):
        if self.lam is None or self.planar_correction is None:
            raise ValueError(
                f"{what} requires the split planar fast path "
                "(parity nonlinear/hybrid beam, no external forces)"
            )
        if self.external_force is not None:
            # The general path never evaluates the sample.
            raise ValueError(f"{what} does not support engines with external forces{why}")
        if self.window_params is None:
            raise ValueError("engine is already hyper-reduced")

    def hyper_reduce(self, snapshots, tau: float = 1e-3,
                     return_info: bool = False):
        """ECSW hyper-reduction: evaluate the correction on a trained sample.

        Energy-Conserving Sampling and Weighting: a sparse set of window
        elements with nonnegative weights such that the weighted sampled
        reduced correction reproduces the full one over the training
        ``snapshots`` (modal states ``(S, m)``) to relative tolerance
        ``tau``, by early-stopped Lawson-Hanson NNLS (:func:`_ecsw_nnls`).
        Returns the gathered engine (:meth:`apply_ecsw`), and with
        ``return_info`` also ``{n_sampled, weights, train_residual,
        snapshot_residuals, snapshot_residual_max}``. Host float64.
        """
        self._split_window("hyper_reduce", " (registry or forces_func): the correction "
                           "sample is only evaluated on the split fast path")
        wp = self.window_params
        L = np.asarray(wp["length"], np.float64)
        D = np.asarray(wp["EI"], np.float64)
        A = np.asarray(wp["EA"], np.float64)
        nl_mask = np.asarray(wp["nonlinear_mask"], bool)
        Phi_p = np.asarray(self.Phi_planar, np.float64)  # (3 n_sub, m)
        W_p = np.asarray(self.PhiW_planar, np.float64)
        m = Phi_p.shape[1]
        n_sub = Phi_p.shape[0] // 3
        E = n_sub - 1

        def plane_rows(c):  # rows of DOF plane c (u/w/theta)
            return slice(c * n_sub, (c + 1) * n_sub)

        S = np.asarray(_host(snapshots), np.float64)
        if S.ndim == 1:
            S = S[None, :]
        if not np.isfinite(S).all():
            raise ValueError(
                "snapshots contain non-finite values — the training "
                "rollout diverged; rerun it with a stable configuration "
                "before hyper-reducing"
            )
        q_p = S @ Phi_p.T  # (S, 3 n_sub)
        u_pl = q_p[:, plane_rows(0)]
        w_pl = q_p[:, plane_rows(1)]
        t_pl = q_p[:, plane_rows(2)]
        planes = elements.nonlinear_correction_planes(
            u_pl[:, :-1], w_pl[:, :-1], t_pl[:, :-1],
            u_pl[:, 1:], w_pl[:, 1:], t_pl[:, 1:],
            L, D, A,
        )
        planes = tuple(np.where(nl_mask, p, 0.0) for p in planes)
        ga1, gt1, gm1, ga2, gt2, gm2 = planes  # (S, E) each, slot order
        # Test-basis rows per element slot: node-1 rows e, node-2 rows e+1.
        Wu, Ww, Wt = (W_p[plane_rows(c)] for c in range(3))
        C = (
            np.einsum("se,em->sem", ga1, Wu[:-1])
            + np.einsum("se,em->sem", gt1, Ww[:-1])
            + np.einsum("se,em->sem", gm1, Wt[:-1])
            + np.einsum("se,em->sem", ga2, Wu[1:])
            + np.einsum("se,em->sem", gt2, Ww[1:])
            + np.einsum("se,em->sem", gm2, Wt[1:])
        )  # (S, E, m)
        n_snap = C.shape[0]
        G = np.moveaxis(C, 1, 2).reshape(n_snap * m, E)
        d = G.sum(axis=1)
        xi = _ecsw_nnls(G, d, tau)
        sel = np.flatnonzero(xi > 0)
        if sel.size == 0:
            raise ValueError(
                "ECSW training selected no elements — the snapshots carry "
                "no correction-force content (all-linear window or zero "
                "states); hyper-reduction is meaningless here"
            )

        reduced = self.apply_ecsw(sel, xi[sel], train_tau=tau)
        if return_info:
            resid = G @ xi - d
            res = float(np.linalg.norm(resid) / np.linalg.norm(d))
            r2 = np.linalg.norm(resid.reshape(n_snap, m), axis=1)
            d2 = np.linalg.norm(d.reshape(n_snap, m), axis=1)
            snap_res = r2 / np.maximum(d2, 1e-300)
            return reduced, {
                "n_sampled": int(sel.size),
                "weights": xi,
                "train_residual": res,
                "snapshot_residuals": snap_res,
                "snapshot_residual_max": float(snap_res.max()),
            }
        return reduced

    def apply_ecsw(self, sel, xi_sel, train_tau: float = None):
        """Apply a trained ECSW sample: gather the bases to ``sel``.

        ``sel``: element indices into the window; ``xi_sel``: their
        positive weights. The returned engine's planar bases are the six
        blocks ``[u1, w1, t1, u2, w2, t2]`` of width ``s = len(sel)`` (the
        test blocks scaled by the weights), its correction evaluates only
        the sample, and ``sampled_params`` holds the sample's element
        parameters for the fused kernel.
        """
        self._split_window("apply_ecsw")
        wp = self.window_params
        L = np.asarray(wp["length"], np.float64)
        D = np.asarray(wp["EI"], np.float64)
        A = np.asarray(wp["EA"], np.float64)
        nl_mask = np.asarray(wp["nonlinear_mask"], bool)
        Phi_p = np.asarray(self.Phi_planar, np.float64)  # (3 n_sub, m)
        W_p = np.asarray(self.PhiW_planar, np.float64)
        n_sub = Phi_p.shape[0] // 3
        E = n_sub - 1

        sel = np.asarray(sel, np.int64)
        xi_sel = np.asarray(xi_sel, np.float64)
        if sel.ndim != 1 or xi_sel.shape != sel.shape:
            raise ValueError("sel and xi_sel must be matching 1-D arrays")
        if sel.size == 0 or np.any(sel < 0) or np.any(sel >= E):
            raise ValueError(
                f"sample indices must be a nonempty subset of [0, {E})"
            )
        if np.any(xi_sel <= 0):
            raise ValueError("ECSW weights must be positive")

        def gather(B, weights=None):
            rows = [B[c * n_sub:(c + 1) * n_sub][sel + node_off]
                    for node_off in (0, 1) for c in range(3)]
            out = np.concatenate(rows, axis=0)  # (6 s, m) in plane blocks
            if weights is not None:
                out = out * np.tile(weights, 6)[:, None]
            return np.ascontiguousarray(out)

        Phi6 = gather(Phi_p)
        W6 = gather(W_p, weights=xi_sel)
        s = sel.size
        L_s, D_s, A_s = L[sel], D[sel], A[sel]
        mask_s = nl_mask[sel]

        def g_sampled(q_pseudo):
            # The flat 6 s layout read as six gathered width-s blocks.
            q6 = q_pseudo.reshape(*q_pseudo.shape[:-2], 6, s)
            par = [torch.as_tensor(x, dtype=q6.dtype, device=q6.device)
                   for x in (L_s, D_s, A_s)]
            pl = elements.nonlinear_correction_planes(
                *(q6[..., k, :] for k in range(6)), *par
            )
            if not bool(mask_s.all()):
                mj = torch.as_tensor(mask_s, device=q6.device)
                pl = tuple(torch.where(mj, p, 0.0) for p in pl)
            return torch.stack(pl, dim=-2).reshape(q_pseudo.shape)

        return dataclasses.replace(
            self,
            Phi_planar=Phi6,
            PhiW_planar=W6,
            planar_correction=g_sampled,
            window_params=None,  # marks the gathered layout
            guard_Phi=self.Phi_planar,
            guard_PhiW=self.PhiW_planar,
            guard_correction=self.planar_correction,
            guard_train_tau=None if train_tau is None else float(train_tau),
            sampled_params={
                "length": L_s, "EI": D_s, "EA": A_s,
                "nonlinear_mask": mask_s, "sel": sel, "xi": xi_sel,
            },
        )

    # -- the ECSW guard --------------------------------------------------------

    def ecsw_residual(self, eta):
        """Per-env relative residual of the trained sample against the full
        correction: ``|f_sampled(eta) - f_full(eta)| / |f_full(eta)|`` in the
        modal force norm, the quantity ECSW training bounded by ``tau`` over
        its snapshots. States outside the trained envelope read ``>> tau``.
        Costs one full correction evaluation; a hyper-reduced engine only.
        """
        if self.guard_Phi is None:
            raise ValueError(
                "ecsw_residual requires a hyper-reduced engine "
                "(call hyper_reduce first)"
            )
        eta = self._tensor(eta)

        def reduced_correction(phi_name, w_name, g_fn):
            q_p = eta @ self._upload(phi_name, eta).T
            n3 = q_p.shape[-1]
            g = g_fn(q_p.reshape(*q_p.shape[:-1], 3, n3 // 3)).reshape(q_p.shape)
            return g @ self._upload(w_name, eta)

        f_s = reduced_correction("Phi_planar", "PhiW_planar", self.planar_correction)
        f_full = reduced_correction("guard_Phi", "guard_PhiW", self.guard_correction)
        num = torch.linalg.vector_norm(f_s - f_full, dim=-1)
        den = torch.linalg.vector_norm(f_full, dim=-1)
        return num / torch.clamp_min(den, 1e-30)

    def rollout_frames_guarded(self, eta, etad, u_modal, n_frames: int,
                               substeps: int = 1, t0: float = 0.0, n_newton: int = 1,
                               precision=None, nl_precision=None,
                               guard_tol: float = None):
        """:meth:`rollout_frames` with an ECSW envelope audit at every frame
        (:meth:`ecsw_residual` of the frame's ``eta``; about ``1/substeps``
        of an unreduced rollout's work). Returns ``(ts, etas, etads,
        guard)``, ``guard`` a dict: ``max_residual`` (per env, the running
        max), ``flagged`` (``max_residual > guard_tol``) and ``guard_tol``
        (default 10 x the training tau, 1e-3 when none was recorded).
        """
        if self.guard_Phi is None:
            raise ValueError(
                "rollout_frames_guarded requires a hyper-reduced engine"
            )
        if guard_tol is None:
            guard_tol = 10.0 * (self.guard_train_tau or 1e-3)
        eta, etad = self._tensor(eta), self._tensor(etad)
        step = self._step_fn(eta, u_modal, n_newton, precision, nl_precision)
        s = (eta, etad, self.initial_accel(eta, etad, u_modal, t0, precision,
                                           nl_precision))
        h = self.dt
        res_max = eta.new_zeros(eta.shape[:-1])
        qs, vs = [eta], [etad]
        for i in range(int(n_frames)):
            t_frame = t0 + (i * substeps) * h
            for j in range(int(substeps)):
                s = step(s, t_frame + j * h)
            res_max = torch.maximum(res_max, self.ecsw_residual(s[0]))
            qs.append(s[0])
            vs.append(s[1])
        ts = t0 + (h * substeps) * torch.arange(
            int(n_frames) + 1, dtype=torch.float64, device=eta.device
        )
        guard = {"max_residual": res_max, "flagged": res_max > guard_tol,
                 "guard_tol": guard_tol}
        return ts, torch.stack(qs), torch.stack(vs), guard

    # -- basis and sample files ------------------------------------------------

    def save_basis(self, path: str) -> str:
        """Write the Petrov-Galerkin basis as ``.npz`` (keys ``V``, ``W``, the
        JAX package's): ``make_modal_rom(model, dt, ...,
        basis=load_basis(path))`` rebuilds the engine without the
        eigensolve. Augmented bases are written as they are."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(path, V=self.Phi, W=self.PhiW)
        return path

    def save_ecsw(self, path: str) -> str:
        """Write the trained ECSW sample as ``.npz`` (keys ``sel``, ``xi``,
        ``train_tau`` (-1 for none), ``n_modes``, the JAX package's):
        deploy it with ``ms.apply_ecsw(*load_ecsw(path))`` on an engine
        rebuilt with the same configuration."""
        if self.sampled_params is None or "sel" not in self.sampled_params:
            raise ValueError(
                "save_ecsw requires a hyper-reduced engine (hyper_reduce "
                "or apply_ecsw)"
            )
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(
            path,
            sel=self.sampled_params["sel"],
            xi=self.sampled_params["xi"],
            train_tau=np.float64(
                -1.0 if self.guard_train_tau is None else self.guard_train_tau
            ),
            n_modes=np.int64(self.n_modes),
        )
        return path


def load_basis(path: str):
    """``(V, W)`` float64 from a file of :meth:`ModalROMGenAlpha.save_basis`
    (either package's); pass as ``make_modal_rom(..., basis=...)``."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return np.asarray(data["V"], np.float64), np.asarray(data["W"], np.float64)


def load_ecsw(path: str):
    """``(sel, xi_sel, train_tau)`` from a file of
    :meth:`ModalROMGenAlpha.save_ecsw` (either package's); pass to
    :meth:`ModalROMGenAlpha.apply_ecsw` on an engine rebuilt with the same
    configuration."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    tau = float(data["train_tau"])
    return (
        np.asarray(data["sel"], np.int64),
        np.asarray(data["xi"], np.float64),
        None if tau < 0 else tau,
    )


def _ecsw_nnls(G, d, tau: float) -> np.ndarray:
    """Sparse nonnegative weights by early-stopped Lawson-Hanson NNLS.

    Solves ``min ||G xi - d||, xi >= 0`` but stops as soon as the residual
    drops to ``tau * ||d||``: each outer iteration admits one column
    (element), so early stopping is the sparsification. Degenerate
    admissions (a new column whose least-squares coefficient is already
    nonpositive) are banned rather than looped on; if the iteration budget
    runs out first, a warning reports the residual reached.
    """
    n_rows, E = G.shape
    xi = np.zeros(E)
    passive: list = []
    banned: set = set()
    r = d.copy()
    dn = np.linalg.norm(d)
    if dn == 0:
        return xi
    # The inner loop can eject admitted columns, so the outer budget must
    # exceed one admission per column.
    budget = 3 * min(E, n_rows) + 1
    for _ in range(budget):
        if np.linalg.norm(r) <= tau * dn:
            break
        grad = G.T @ r
        if passive:
            grad[passive] = -np.inf
        if banned:
            grad[list(banned)] = -np.inf
        j = int(np.argmax(grad))
        if not np.isfinite(grad[j]) or grad[j] <= 0:
            break
        passive.append(j)
        while True:  # inner feasibility loop (standard Lawson-Hanson)
            z = np.zeros(E)
            sol, *_ = np.linalg.lstsq(G[:, passive], d, rcond=None)
            z[np.asarray(passive)] = sol
            if all(z[p] > 0 for p in passive):
                xi = z
                break
            neg = [p for p in passive if z[p] <= 0]
            movable = [p for p in neg if xi[p] - z[p] > 0]
            if not movable:
                # 0/0 step: revert the admission and never retry it.
                if j in passive:
                    passive.remove(j)
                banned.add(j)
                break
            alpha = min(xi[p] / (xi[p] - z[p]) for p in movable)
            xi = xi + alpha * (z - xi)
            passive = [p for p in passive if xi[p] > 1e-12]
            if not passive:
                xi = np.zeros(E)
                break
        r = d - G @ xi
    else:
        res = np.linalg.norm(r) / dn
        if res > tau:
            warnings.warn(
                f"ECSW NNLS iteration budget exhausted at relative "
                f"residual {res:.2e} (target {tau:.2e}); the returned "
                f"sample under-fits the snapshots",
                stacklevel=2,
            )
    return xi


def _check_real_spectrum(w, m_keep: int) -> None:
    """Require reality of the retained modes only (the upper part of a
    large parity pencil's spectrum comes in complex pairs)."""
    im = np.abs(np.imag(w))
    cplx = im > 1e-8 * np.abs(np.real(w)).max()
    if cplx.any():
        n_real = int(np.argmax(cplx))  # first complex mode index
        raise ValueError(
            f"retained modal range contains complex eigenvalue pairs; "
            f"reduce n_modes to <= {n_real} for a real stable basis"
        )


def _canonical_signs(V, W):
    """Flip each (right, left) column pair so the right vector's
    largest-magnitude entry is positive: eigensolvers return vectors up to
    sign, and a same flip of both keeps ``W^T M V = I``."""
    idx = np.argmax(np.abs(V), axis=0)
    s = np.sign(V[idx, np.arange(V.shape[1])])
    s = np.where(s == 0, 1.0, s)
    return V * s, W * s


def _lowest_modes_sparse(K, M, k: int):
    """Lowest-``k`` eigenpairs of the non-symmetric pencil ``(K, M)``.

    Shift-invert Arnoldi at ``sigma = 0`` on the sparse operators, with a
    deterministic start vector (ARPACK's default is random, which would
    flip signs and perturb roundoff between identical builds); dense
    ``eig`` if ARPACK fails to converge. Returns ``(w, V)`` sorted
    ascending by real part (complex; the caller checks reality).
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigs

    try:
        v0 = np.full(K.shape[0], 1.0 / np.sqrt(K.shape[0]))
        w, V = eigs(
            sp.csc_matrix(K), k=k, M=sp.csc_matrix(M), sigma=0.0,
            which="LM", v0=v0,
        )
    except (ArpackError, ArpackNoConvergence):
        from scipy.linalg import eig as dense_eig

        w, V = dense_eig(K, M)
    order = np.argsort(w.real)[:k]
    return w[order], V[:, order]


def _augment_static(K0, M, V, W, static_vectors, max_extra=None,
                    dense_threshold: int = 2000):
    """Augment a truncated basis for static load patterns, participation
    selected (host float64, the JAX package's algorithm).

    ``K0^{-1} b`` itself is not added (the parity tangent is non-symmetric:
    the augmented subspace would give the reduced operator complex Ritz
    pairs); instead the true real eigenpairs of ``(K0, M)`` that dominate
    each static response join the basis, so the reduced operator stays
    diagonal and real. Candidates come from a dense two-sided ``eig`` up to
    ``dense_threshold`` DOFs, else from shift-invert Arnoldi at each
    response's deflated Rayleigh quotient. Near-defective candidates (the
    complex-adjacent band of a large parity mesh) are filtered out; when
    nothing is left the basis is returned as it was, with a warning.
    ``static_vectors``: ``(n,)`` or ``(n, k)`` reduced-coordinate loads;
    ``max_extra`` caps the added modes (default ``4 k``).
    """
    n = K0.shape[0]
    Bv = np.asarray(static_vectors, np.float64)
    if Bv.ndim == 1:
        Bv = Bv[:, None]
    if Bv.shape[0] != n:
        raise ValueError(
            f"static_vectors must have leading dimension {n} "
            f"(got {Bv.shape})"
        )
    m0 = V.shape[1]
    if max_extra is None:
        max_extra = 4 * Bv.shape[1]
    max_extra = min(max_extra, n - m0)
    if max_extra <= 0:
        return V, W

    def _noop(reason):
        warnings.warn(
            "ROM basis augmentation added no modes: " + reason + ". If the "
            "static content lives in a complex band of the parity "
            "tangent's spectrum (large meshes), no real-stable "
            "eigen-augmentation exists; consider "
            "use_consistent_nonlinear=True (symmetric tangent, all bands "
            "real).",
            stacklevel=3,
        )
        return V, W

    X = np.linalg.solve(K0, Bv)  # (n, k) static responses
    if n <= dense_threshold:
        vr_c, wl_c = _candidate_pairs_dense(K0, M, m0)
    else:
        vr_c, wl_c = _candidate_pairs_sparse(K0, M, V, W, X)
    if vr_c.shape[1] == 0:
        return _noop("no real candidate eigenpairs found")
    Mv = M @ vr_c
    denom = np.einsum("ij,ij->j", wl_c, Mv)
    # Conditioning filter: the cosine of the left / M-right angle.
    # Near-defective pairs scaled by 1/denom would send the ROM to NaN.
    cos = np.abs(denom) / (
        np.linalg.norm(wl_c, axis=0) * np.linalg.norm(Mv, axis=0) + 1e-300
    )
    ok = cos > 1e-3
    vr_c, wl_c, denom = vr_c[:, ok], wl_c[:, ok], denom[ok]
    if vr_c.shape[1] == 0:
        return _noop("all candidate eigenpairs are near-defective")
    # Each candidate's expansion coefficient in each normalized static
    # response (biorthogonality); score = the worst case over the loads.
    coeff = (wl_c.T @ (M @ X)) / denom[:, None]  # (n_cand, k)
    resp_scale = np.abs(coeff).max(axis=0) + 1e-300
    score = np.abs(coeff / resp_scale[None, :]).max(axis=1)
    top = np.argsort(score)[::-1][:max_extra]
    top = top[score[top] > 1e-6]
    if top.size == 0:
        return _noop("no candidate participates in the static responses")
    V2 = np.concatenate([V, vr_c[:, top]], axis=1)
    W2 = np.concatenate([W, wl_c[:, top] / denom[top][None, :]], axis=1)
    # Joint biorthonormalization removes roundoff-level cross terms.
    D = W2.T @ M @ V2
    W2 = W2 @ np.linalg.inv(D).T
    return V2, W2


def _candidate_pairs_dense(K0, M, m0):
    """Every real eigenpair of ``(K0, M)`` above the lowest ``m0`` real
    ones, by dense two-sided ``eig``; near-real conjugate duplicates are
    dropped (their equal columns would make the joint Gram singular)."""
    from scipy.linalg import eig

    w_all, Wl, Vr = eig(K0, M, left=True, right=True)
    order = np.argsort(w_all.real)
    w_all, Vr, Wl = w_all[order], Vr[:, order], Wl[:, order]
    real_idx = np.flatnonzero(
        np.abs(w_all.imag) <= 1e-8 * np.abs(w_all.real).max()
    )
    cand = real_idx[m0:]
    keep, seen = [], []
    for i in cand:
        li = w_all[i].real
        if any(abs(li - l0) <= 1e-9 * abs(l0) for l0 in seen):
            continue
        seen.append(li)
        keep.append(i)
    cand = np.asarray(keep, dtype=int)
    return Vr[:, cand].real, Wl[:, cand].real


def _candidate_pairs_sparse(K0, M, V, W, X, k_per_shift: int = 16):
    """Candidate eigenpairs near each static response's band: shift-invert
    Arnoldi on ``(K0, M)`` at the Rayleigh quotient of the response with
    the retained band projected out, each real hit's left vector by
    shifted inverse iteration on ``K0^T`` at its eigenvalue (the best of
    three iterates). Complex, retained-band, duplicate and unconverged hits
    are dropped; failed shifts are skipped."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigs, splu

    Ks = sp.csc_matrix(K0)
    Ms = sp.csc_matrix(M)
    lam_ret = np.einsum("ij,ij->j", W, K0 @ V)
    lam_floor = lam_ret.max() * (1.0 + 1e-6)
    n = K0.shape[0]

    def left_vector(lam):
        try:
            lu = splu(sp.csc_matrix(K0.T - lam * (1.0 + 1e-7) * M))
        except RuntimeError:
            return None
        y = np.full(n, 1.0 / np.sqrt(n))
        best, best_res = None, np.inf
        for _ in range(3):
            y = lu.solve(np.asarray(M @ y))
            y = y / np.linalg.norm(y)
            res = np.linalg.norm(K0.T @ y - lam * (M @ y)) / abs(lam)
            if res < best_res:
                best, best_res = y, res
            if res < 1e-9:
                break
        return best if best_res < 1e-6 else None

    vr_list, wl_list, lam_list = [], [], []
    for col in range(X.shape[1]):
        x = X[:, col]
        x_perp = x - V @ (W.T @ (M @ x))
        denom = float(x_perp @ (M @ x_perp))
        if denom <= 0:
            continue
        sigma = float(x_perp @ (K0 @ x_perp)) / denom
        try:
            wr, Vr = eigs(Ks, k=k_per_shift, M=Ms, sigma=sigma, which="LM")
        except (ArpackError, ArpackNoConvergence):
            continue
        scale_w = max(np.abs(wr.real).max(), 1e-300)
        for i in range(wr.size):
            li = wr[i]
            if abs(li.imag) > 1e-8 * scale_w or li.real <= lam_floor:
                continue
            # ARPACK re-finds a mode across shifts with ~1e-8 scatter.
            if any(abs(li.real - l0) <= 1e-6 * abs(l0) for l0 in lam_list):
                continue
            y = left_vector(li.real)
            if y is None:
                continue
            lam_list.append(li.real)
            vr_list.append(Vr[:, i].real)
            wl_list.append(y)
    if not vr_list:
        return np.zeros((n, 0)), np.zeros((n, 0))
    return np.stack(vr_list, axis=1), np.stack(wl_list, axis=1)


def _modal_derivative_loads(k_red_np, K0, V, md: int) -> np.ndarray:
    """The quadratic-coupling loads ``G2(phi_i, phi_j)``, ``i <= j < md``,
    as columns ``(n, md (md + 1) / 2)``, extracted exactly from ``F(q) =
    k(q) - K0 q``: ``G2(a, a) = (F(a) + F(-a)) / 2`` (the cubic cancels)
    and ``G2(a, b)`` by polarization. ``k_red_np`` is a host float64
    reduced internal force."""

    def F(q):
        return k_red_np(q) - K0 @ q

    def G2_aa(a):
        return 0.5 * (F(a) + F(-a))

    cols = []
    base = [G2_aa(V[:, i]) for i in range(md)]
    for i in range(md):
        cols.append(base[i])
        for j in range(i + 1, md):
            mixed = G2_aa(V[:, i] + V[:, j])
            cols.append(0.5 * (mixed - base[i] - base[j]))
    return np.stack(cols, axis=1)


def _make_ext_modal(forces, Phi, PhiW):
    """The sum of the registry forces' reduced closures
    (``make_reduced_modal``), ``(eta_af, etad_af, t_af, precision) -> (...,
    m)``, or None when any force has none (the caller then takes the
    general path)."""
    closures = []
    for force in forces:
        maker = getattr(force, "make_reduced_modal", None)
        cl = None if maker is None else maker(Phi, PhiW)
        if cl is None:
            return None
        closures.append(cl)
    if not closures:
        return None
    if len(closures) == 1:
        return closures[0]

    def ext_modal(eta_af, etad_af, t_af, precision=None):
        total = closures[0](eta_af, etad_af, t_af, precision=precision)
        for cl in closures[1:]:
            total = total + cl(eta_af, etad_af, t_af, precision=precision)
        return total

    return ext_modal


def make_modal_rom(
    model,
    dt: float,
    rho_inf: float = 0.8,
    n_modes: int = None,
    forces_func: Optional[Callable] = None,
    static_vectors=None,
    modal_derivatives: int = 0,
    rayleigh: tuple = None,
    basis=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ModalROMGenAlpha:
    """Build the nonlinear modal-reduction generalized-α engine (host f64).

    Right/left eigenvectors of the pencil ``(K0, M)`` with K0 the exact
    zero-state tangent (:func:`reduce_matrix_dense`), biorthonormalized to
    ``W^T M V = I``. Three branches, as in the JAX package: symmetric K0
    (all-linear beams, the consistent element) takes ``eigh`` with ``W =
    V``; a truncated basis with ``n_modes <= n / 4`` two shift-invert
    Arnoldi runs (right and left); otherwise the dense two-sided ``eig``.
    ``n_modes=None`` keeps the full basis.

    Forces: registered fluid drag and gravity take their reduced closures
    on the split path (``ext_modal``) unless the element is the consistent
    one or a force has no closure; then the registry aggregate takes the
    general path, as does an explicit ``forces_func(x, t)`` always. The
    consistent element (``use_consistent_nonlinear``) has no split path
    (``lam`` is None).

    ``static_vectors`` (``(n,)`` or ``(n, k)`` reduced loads) and
    ``modal_derivatives=md`` (the quadratic loads of the first ``md``
    modes) augment a truncated basis with the real eigenpairs that carry
    their static responses (:func:`_augment_static`); a coupled augmented
    operator leaves ``Sinv_diag`` None. The consistent element's loads are
    evaluated with the port's torch force on CPU float64 tensors.

    ``rayleigh``: ``(alpha, beta)`` structural damping ``C = alpha M +
    beta K0``, diagonal in this basis (``cdamp = alpha + beta lam``) and
    exact in the residual and the effective Jacobian. ``basis``: a
    precomputed biorthonormal ``(V, W)`` pair (:func:`load_basis`); skips
    the eigensolve, and ``n_modes``, ``static_vectors`` and
    ``modal_derivatives`` are then ignored. ``device``/``dtype``: where
    inputs given as NumPy arrays go (None: the card).
    """
    from scipy.linalg import eig, eigh

    device = resolve_device(device)
    arrays = model.beam_model.arrays
    bc_info = model.beam_model.bc_info
    free = bc_info.free_dofs
    n_full = bc_info.n_dofs_full
    use_consistent = getattr(model, "use_consistent_nonlinear", False)

    # Registry forces prefer their reduced closures (built after the basis);
    # an explicit forces_func always takes the general path.
    registry_forces = None
    if forces_func is None and len(model.force_registry) > 0:
        registry_forces = model.force_registry.get_registered_forces()

    M = np.asarray(model.beam_model.M.toarray(), dtype=np.float64)
    K0 = reduce_matrix_dense(arrays, free, use_consistent=use_consistent)

    sym_scale = np.abs(K0).max()
    if basis is not None:
        V = np.asarray(basis[0], np.float64)
        W = np.asarray(basis[1], np.float64)
        if V.shape != W.shape or V.shape[0] != K0.shape[0]:
            raise ValueError(
                f"basis shapes {V.shape}/{W.shape} do not match the "
                f"{K0.shape[0]}-DOF reduced system"
            )
        bi_err = float(np.abs(W.T @ M @ V - np.eye(V.shape[1])).max())
        if bi_err > 1e-6:
            raise ValueError(
                f"basis is not biorthonormal (|W^T M V - I| = {bi_err:.2e})"
                " — was it built for this beam configuration?"
            )
        static_vectors = None
        modal_derivatives = 0
    elif np.abs(K0 - K0.T).max() <= 1e-9 * sym_scale:
        lam, V = eigh(K0, M)  # symmetric: M-orthonormal already
        W = V
        if n_modes is not None:
            V, W = V[:, :n_modes], W[:, :n_modes]
        V, W = _canonical_signs(V, W)
    elif n_modes is not None and n_modes <= K0.shape[0] // 4:
        # Two shift-invert Arnoldi runs (right: (K0, M); left: (K0^T, M)),
        # then biorthonormalize.
        w, V = _lowest_modes_sparse(K0, M, n_modes)
        _wl, W = _lowest_modes_sparse(K0.T, M, n_modes)
        _check_real_spectrum(w, n_modes)
        V, W = V.real, W.real
        V, W = _canonical_signs(V, W)
        D = W.T @ M @ V
        W = W @ np.linalg.inv(D).T
    else:
        w, W, V = eig(K0, M, left=True, right=True)
        order = np.argsort(w.real)
        w, V, W = w[order], V[:, order], W[:, order]
        m_keep = n_modes if n_modes is not None else V.shape[1]
        _check_real_spectrum(w[:m_keep], m_keep)
        V, W = V[:, :m_keep].real, W[:, :m_keep].real
        V, W = _canonical_signs(V, W)
        # W <- W inv(D)^T with D = W^T M V, so W^T M V = I exactly even
        # under near-degenerate eigenvalue pairing.
        D = W.T @ M @ V
        W = W @ np.linalg.inv(D).T

    if modal_derivatives > 0:
        md = min(int(modal_derivatives), V.shape[1])
        if use_consistent:
            # The set-up is host-side: the port's torch force on CPU
            # float64 tensors, whatever the engine's device.
            k_cons = assembly.make_reduced_internal_force(arrays, free, n_full,
                                                          use_consistent=True)

            def k_red_eval(q):
                return k_cons(torch.as_tensor(q, dtype=torch.float64)).numpy()

        else:
            k_red_eval = assembly.make_reduced_internal_force_np(arrays, free, n_full)
        md_loads = _modal_derivative_loads(k_red_eval, K0, V, md)
        if static_vectors is None:
            static_vectors = md_loads
        else:
            sv = np.asarray(static_vectors, np.float64)
            if sv.ndim == 1:
                sv = sv[:, None]
            static_vectors = np.concatenate([sv, md_loads], axis=1)
    if static_vectors is not None and V.shape[1] < K0.shape[0]:
        V, W = _augment_static(K0, M, V, W, static_vectors)

    ext_modal = None
    if registry_forces is not None:
        if not use_consistent:  # the consistent element has no split path
            ext_modal = _make_ext_modal(registry_forces, V, W)
        if ext_modal is None:
            forces_func = model.force_registry.create_aggregated_function()

    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma_ga = 0.5 - am + af
    K0r = W.T @ K0 @ V  # = diag(eigenvalues) up to roundoff
    m = V.shape[1]
    S = (1.0 - am) * np.eye(m) + (1.0 - af) * beta * dt * dt * K0r
    cdamp = None
    if rayleigh is not None:
        al_r, be_r = float(rayleigh[0]), float(rayleigh[1])
        # Keep the exactly diagonal part of K0r (its off-diagonal is
        # eigensolver roundoff).
        cdamp = al_r + be_r * np.ascontiguousarray(np.diag(K0r))
        S = S + (1.0 - af) * gamma_ga * dt * np.diag(cdamp)
    Sinv = np.linalg.inv(S)
    # A diagonal-to-roundoff effective Jacobian makes the Newton solve a
    # per-mode multiply; the dense Sinv stays for genuinely coupled bases.
    Sd = np.abs(np.diag(S))
    offdiag = float(np.abs(S - np.diag(np.diag(S))).max())
    Sinv_diag = None
    if offdiag <= 1e-9 * float(Sd.max()):
        Sinv_diag = np.ascontiguousarray(1.0 / np.diag(S))

    internal_force = assembly.make_reduced_internal_force(
        arrays, free, n_full, use_consistent=use_consistent
    )
    lam = Phi_p = W_p = planar_correction = window_params = None
    if not use_consistent:
        # Split fast path: the reduced linear operator is diag(W^T K0 V);
        # only the element correction flows through the basis transforms.
        lam = np.ascontiguousarray(np.diag(K0r))
        elem_sl, node_sl = assembly.nonlinear_support(arrays)
        if elem_sl is not None:
            # Fold the zero rows of constrained DOFs and the planar
            # permutation into the bases once, restricted to the nonlinear
            # node window.
            Phi_p, W_p, planar_correction, window_params = _planar_window(
                arrays, bc_info, V, W, elem_sl, node_sl
            )
    return ModalROMGenAlpha(
        Phi=V,
        PhiW=W,
        PhiTM=W.T @ M,
        Sinv=Sinv,
        rho_inf=rho_inf,
        dt=dt,
        internal_force=internal_force,
        external_force=forces_func,
        ext_modal=ext_modal,
        lam=lam,
        Phi_planar=Phi_p,
        PhiW_planar=W_p,
        planar_correction=planar_correction,
        window_params=window_params,
        Sinv_diag=Sinv_diag,
        cdamp=cdamp,
        device=device,
        dtype=dtype,
    )


def _planar_window(arrays, bc_info, V, W, elem_sl, node_sl):
    """``(Phi_planar, PhiW_planar, planar_correction, window_params)`` of the
    node window ``node_sl``: the reduced bases zero-padded to full
    coordinates, permuted to planar rows ``[u; w; theta]`` and restricted
    to the window (fixed-DOF rows stay, as zeros)."""
    n_nodes = bc_info.n_nodes
    n_full = bc_info.n_dofs_full
    perm = assembly.planar_permutation(n_nodes)
    m_modes = V.shape[1]
    free = np.asarray(bc_info.free_dofs)

    def restrict(B_red):
        B_full = np.zeros((n_full, m_modes))
        B_full[free] = B_red
        planes = B_full[perm].reshape(3, n_nodes, m_modes)
        return np.ascontiguousarray(planes[:, node_sl, :].reshape(-1, m_modes))

    E_mod = np.asarray(arrays.elastic_modulus, np.float64)
    window_params = {
        "length": np.asarray(arrays.length, np.float64)[elem_sl],
        "EI": (E_mod * np.asarray(arrays.moment_inertia, np.float64))[elem_sl],
        "EA": (E_mod * np.asarray(arrays.cross_area, np.float64))[elem_sl],
        "nonlinear_mask": np.asarray(arrays.nonlinear_mask)[elem_sl],
    }
    return (
        restrict(V),
        restrict(W),
        assembly.make_planar_correction_force(arrays, element_slice=elem_sl),
        window_params,
    )


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


def _rom_force(ms, u):
    """The modal input of ``simulate``'s ROM methods: None, a callable of
    t, or the host projection of a constant force."""
    if u is None:
        return None
    if callable(u):
        return lambda t: ms.project_force(u(t))
    return ms.project_force_host(u)


def _simulate_modal_rom(ms, x0, n_steps, u, substeps, n_newton, nl_precision, engine):
    """``simulate(method="modal_rom")`` on the engine ``ms``: the plain
    stepper (``"xla"``) or the fused ROM kernels (``"pallas"``, float32 as
    in the JAX package, which refuse external forces)."""
    if engine == "xla":
        u_modal = _rom_force(ms, u)
        n = x0.shape[-1] // 2
        eta, etad = ms.to_modal(x0[..., :n], x0[..., n:])
        ts, etas, etads = ms.rollout_frames(
            eta, etad, u_modal, n_steps, substeps=substeps,
            n_newton=n_newton, nl_precision=nl_precision,
        )
        qs, vs = ms.from_modal(etas, etads)
        return SimulationResult(ts=ts, ys=torch.cat([qs, vs], dim=-1))

    fused = ms.make_pallas_rollout()
    u_modal = None if u is None else ms.project_force_host(u).astype(np.float32)

    def drive(eta, etad, u_m, n_frames, substeps):
        # The fused ROM rollout is float32, as in the JAX package.
        return fused.frames(eta.float(), etad.float(), u_m, n_frames,
                            substeps=substeps, n_newton=n_newton,
                            nl_precision=nl_precision)

    return _frames_result(ms, x0, u_modal, n_steps, substeps, drive)


def make_implicit_rollout_fn(model, dt: float, n_steps: int, method: str, u=None,
                             forces_func: Optional[Callable] = None, substeps: int = 1,
                             n_newton: int = 2, linear_solver: str = None,
                             rho_inf: float = 0.8, device=None,
                             dtype: torch.dtype = None):
    """Full-order implicit rollout closure ``x0 -> (ts, ys)`` for
    ``method="newmark"|"generalized_alpha"`` on the operators of
    :func:`make_newmark_operator` (``device``/``dtype`` as there)."""
    h = dt / substeps
    kw = dict(forces_func=forces_func, linear_solver=linear_solver, device=device,
              dtype=dtype)
    if method == "newmark":
        op = make_newmark_operator(model, dt=h, **kw)
        integrate = integrators.integrate_newmark
        extra = {}
    else:
        am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
        af = rho_inf / (rho_inf + 1.0)
        beta_ga = 0.25 * (1.0 - am + af) ** 2
        op = make_newmark_operator(
            model, dt=None, extra_systems=[(1.0 - am, (1.0 - af) * beta_ga * h * h)],
            **kw,
        )
        integrate = integrators.integrate_generalized_alpha
        extra = dict(rho_inf=rho_inf)

    def rollout(x0):
        n = x0.shape[-1] // 2
        ts, qs, vs = integrate(op, x0[..., :n], x0[..., n:], 0.0, dt, n_steps, u=u,
                               n_newton=n_newton, substeps=substeps, **extra)
        return ts, torch.cat([qs, vs], dim=-1)

    return rollout


def _simulate_modal_rom_adaptive(ms, x0, n_steps, dt, u, rtol, atol, n_newton,
                                 nl_precision, chunk):
    """``simulate(method="modal_rom_adaptive")``: :meth:`rollout_adaptive`
    over the output grid, in one call or one per ``chunk`` intervals."""
    u_modal = _rom_force(ms, u)
    t_eval = np.arange(n_steps + 1) * dt

    def chunk_fn(state, t_grid, dt0):
        # (x,) on the first chunk, then the modal (eta, etad, etadd).
        if len(state) == 1:
            nx = state[0].shape[-1] // 2
            eta, etad = ms.to_modal(state[0][..., :nx], state[0][..., nx:])
            etadd = None
        else:
            eta, etad, etadd = state
        etas, etads, stats, fin = ms.rollout_adaptive(
            eta, etad, u_modal, t_grid, rtol=rtol, atol=atol, dt0=dt0,
            n_newton=n_newton, nl_precision=nl_precision, etadd0=etadd,
            return_final=True,
        )
        qs, vs = ms.from_modal(etas, etads)
        return torch.cat([qs, vs], dim=-1), stats, fin

    # Every engine's monolithic default first step, (te[1] - te[0]) / 16.
    if chunk is None:
        ys, stats, _ = chunk_fn((x0,), t_eval, dt / 16.0)
    else:
        ys, stats = _run_chunked(chunk_fn, (x0,), t_eval, chunk, dt / 16.0)
    return SimulationResult(ts=_times(t_eval, x0), ys=ys, stats=stats)


_IMPLICIT_ADAPTIVE = ("generalized_alpha_adaptive", "implicit_adaptive", "sdirk3",
                      "sdirk3_adaptive")
_CHUNKED = _IMPLICIT_ADAPTIVE + ("modal_rom_adaptive",)


def _times(t_eval: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t_eval, dtype=torch.float64, device=like.device)


def _run_chunked(chunk_fn, state0, t_eval, chunk: int, dt0: float):
    """Chunked adaptive driving: one call of ``chunk_fn`` per ``chunk``
    output intervals, each warm-restarted from the controller's own
    proposal (``stats.dt_next``) and the engine's full carry, so the
    trajectory and step sequence are bit for bit the monolithic drive's.

    ``chunk_fn(state, t_grid, dt0) -> (ys, stats, state_next)`` runs one
    chunk, frames leading, ``ys[0]`` the chunk's initial frame. Returns the
    frames and the aggregated :class:`AdaptiveStats` (``dt_next`` ready to
    seed a continuation).
    """
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_iv = len(t_eval) - 1
    dt_prop = dt0
    ys_parts, totals, reads, runs = [], None, 0, 0
    state = state0
    i = 0
    while i < n_iv:
        j = min(i + chunk, n_iv)
        ys, stats, state = chunk_fn(state, t_eval[i : j + 1], dt_prop)
        ys_parts.append(ys if i == 0 else ys[1:])
        dt_prop = stats.dt_next
        counts = stats[:4]
        totals = counts if totals is None else tuple(a + b for a, b in zip(totals, counts))
        reads += stats.host_reads
        runs += stats.trials_run
        i = j
    stats = integrators.AdaptiveStats(*totals, dt_next=dt_prop, host_reads=reads,
                                      trials_run=runs)
    return torch.cat(ys_parts, dim=0), stats


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

    The signature is the JAX package's, so one call works in both. Methods:
    ``"rk4"`` (classic fixed-step on :meth:`DynamicEulerBernoulliBeam.build_rhs`,
    ``substeps`` steps a frame) and ``"dopri5"`` (adaptive Dormand-Prince
    at ``rtol``/``atol``, first step ``dt/10``), the reference-parity
    engines; ``"modal"`` (linear beams, exact diagonalized recurrence);
    ``"modal_rom"`` (nonlinear/hybrid Petrov-Galerkin reduction; ``n_modes``
    truncates the basis, ``n_newton`` sets the modified-Newton iterations);
    the full-order implicit ``"newmark"`` and ``"generalized_alpha"`` (any
    beam; ``n_newton`` modified-Newton iterations per step,
    ``linear_solver`` as in :func:`make_newmark_operator`, a torch
    ``forces_func(x, t)``); and the error-controlled implicit
    ``"generalized_alpha_adaptive"`` (alias ``"implicit_adaptive"``;
    Zienkiewicz-Xie estimate, ``rho_inf``) and ``"sdirk3"`` (alias
    ``"sdirk3_adaptive"``; L-stable SDIRK3), whose ``rtol``/``atol`` pick
    every step (first step ``dt/16``) and whose trial systems are factored
    at the trial dt; ``"modal_rom_adaptive"`` (the same controller on the
    ROM, :meth:`ModalROMGenAlpha.rollout_adaptive`: a trial dt's
    factorization is a per-mode reciprocal). The adaptive methods return
    :class:`AdaptiveStats` in ``stats``; a batched ``x0`` shares one
    step-size controller (for per-environment control call the implicit
    integrators with ``per_env=True``). ``forces_func`` and the model's
    registered forces reach every method but ``"modal"``. ``jit`` is
    accepted and unused. ``nl_precision``
    picks the ROM transforms' tier on the card with ``engine="pallas"``:
    "highest" is float32, the other tiers 3xTF32 tensor-core products
    (about 1e-6 of the output's scale against float32); on the CPU and
    with ``engine="xla"`` they are true float32/float64 for every tier.

    Args:
        model: a :class:`DynamicEulerBernoulliBeam` of this package.
        x0: initial reduced state ``[q; v]``, ``(2n,)`` or ``(B, 2n)``; a
            tensor or a NumPy array.
        t_final, dt: horizon and output-frame spacing.
        u: constant input force over position DOFs, a callable ``t ->
            force``, or a :class:`PiecewiseConstant` schedule.
        substeps: generalized-α steps per output frame.
        engine: ``"xla"`` (default) — the plain PyTorch stepper;
            ``"pallas"`` — the hand-written kernels (``method="modal"``:
            ``ops/cuda/modal_rollout.modal_frames``; ``method="modal_rom"``:
            the fused ROM kernels of ``ops/cuda/rom_rollout``, float32),
            constant force only; ``"power"`` — one host-composed
            ``substeps``-step affine map per frame, applied by the affine
            kernel (``method="modal"``, constant or
            :class:`PiecewiseConstant` force). On CPU tensors the kernels
            run their plain versions.
        rayleigh: optional ``(alpha, beta)`` Rayleigh damping.
        static_vectors, modal_derivatives: the ROM methods only — basis
            augmentation (:func:`make_modal_rom`).
        chunk: the adaptive methods only — drive the span one
            call per ``chunk`` output intervals, each warm-restarted from
            the controller's proposal (``stats.dt_next``) and the engine's
            carry: the same trajectory and step sequence, bit for bit, as
            one call over the horizon, with aggregated stats.
        device, dtype: where the rollout runs. A tensor ``x0`` keeps its
            device unless ``device`` is given; a NumPy ``x0`` goes to
            ``device``, by default the card (raises when there is none:
            pass ``device="cpu"`` for the CPU). ``dtype`` defaults to
            ``x0``'s.
    """
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
    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    if chunk is not None and method not in _CHUNKED:
        raise ValueError(
            "chunk= applies to the adaptive methods "
            "('generalized_alpha_adaptive' / 'sdirk3' / "
            "'modal_rom_adaptive'); fixed-step spans are already one "
            f"bounded device call per frame (got method={method!r})"
        )

    if isinstance(x0, torch.Tensor):
        x0 = x0 if device is None else x0.to(device)
    else:
        x0 = torch.as_tensor(np.asarray(x0), device=resolve_device(device))
    if dtype is not None:
        x0 = x0.to(dtype)

    if method in ("rk4", "dopri5"):
        rhs = model.build_rhs(forces_func)
        if method == "rk4":
            ts, xs = integrators.integrate_fixed(rhs, x0, 0.0, dt, n_steps, u=u,
                                                 substeps=substeps)
            return SimulationResult(ts=ts, ys=xs)
        t_eval = np.arange(n_steps + 1) * dt
        xs, stats = integrators.integrate_adaptive(rhs, x0, t_eval, u=u, rtol=rtol,
                                                   atol=atol, dt0=dt / 10.0)
        return SimulationResult(ts=_times(t_eval, x0), ys=xs, stats=stats)

    if method in ("modal_rom", "modal_rom_adaptive"):
        ms = make_modal_rom(
            model, dt / substeps, rho_inf=rho_inf, n_modes=n_modes,
            forces_func=forces_func, static_vectors=static_vectors,
            modal_derivatives=modal_derivatives, rayleigh=rayleigh,
            device=x0.device, dtype=x0.dtype,
        )
        if method == "modal_rom":
            return _simulate_modal_rom(ms, x0, n_steps, u, substeps, n_newton,
                                       nl_precision, engine)
        return _simulate_modal_rom_adaptive(ms, x0, n_steps, dt, u, rtol, atol, n_newton,
                                            nl_precision, chunk)

    if method in _IMPLICIT_ADAPTIVE:
        # Error-controlled implicit stepping: trial-dt factorizations of the
        # operator's not-prefactored systems.
        op = make_newmark_operator(model, forces_func=forces_func, dt=None,
                                   linear_solver=linear_solver, device=x0.device,
                                   dtype=x0.dtype)
        n = x0.shape[-1] // 2
        t_eval = np.arange(n_steps + 1) * dt
        kw = dict(u=u, rtol=rtol, atol=atol, n_newton=n_newton)
        if method in ("generalized_alpha_adaptive", "implicit_adaptive"):
            kw["rho_inf"] = rho_inf

            def chunk_fn(state, t_grid, dt0):
                # (q, v) on the first chunk (the consistent initial
                # acceleration, as the monolithic drive), then (q, v, a):
                # the exact continuation of the algorithmic acceleration.
                a0 = state[2] if len(state) == 3 else None
                qs, vs, stats, fin = integrators.integrate_generalized_alpha_adaptive(
                    op, state[0], state[1], t_grid, dt0=dt0, a0=a0,
                    return_final=True, **kw)
                return torch.cat([qs, vs], dim=-1), stats, fin
        else:

            def chunk_fn(state, t_grid, dt0):
                # SDIRK3's trial state is (q, v): the restart is exact.
                qs, vs, stats = integrators.integrate_sdirk3_adaptive(
                    op, state[0], state[1], t_grid, dt0=dt0, **kw)
                return torch.cat([qs, vs], dim=-1), stats, (qs[-1], vs[-1])

        state0 = (x0[..., :n], x0[..., n:])
        # Every engine's monolithic default first step, (te[1] - te[0]) / 16.
        if chunk is None:
            ys, stats, _ = chunk_fn(state0, t_eval, dt / 16.0)
        else:
            ys, stats = _run_chunked(chunk_fn, state0, t_eval, chunk, dt / 16.0)
        return SimulationResult(ts=_times(t_eval, x0), ys=ys, stats=stats)

    if method in ("newmark", "generalized_alpha"):
        ts, ys = make_implicit_rollout_fn(
            model, dt, n_steps, method, u=u, forces_func=forces_func,
            substeps=substeps, n_newton=n_newton, linear_solver=linear_solver,
            rho_inf=rho_inf, device=x0.device, dtype=x0.dtype,
        )(x0)
        return SimulationResult(ts=ts, ys=ys, stats=None)

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

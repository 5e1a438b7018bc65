"""Modal generalized-alpha kernels: CUDA on the card, plain PyTorch twins.

Counterpart of ``continuum_robot_tpu/ops/pallas/modal_rollout.py``. Each
TPU kernel there becomes a hand-written CUDA kernel in
``csrc/modal_rollout.cu`` with a plain PyTorch version of the same
arithmetic beside it:

=====================  ==============================  =======================
wrapper                replaces                        plain version
=====================  ==============================  =======================
:func:`modal_steps`    ``fused_modal_steps``           :func:`modal_steps_plain`
:func:`modal_frames`   ``fused_modal_frames``          :func:`modal_frames_plain`
:func:`affine_steps`   ``fused_affine_steps``          :func:`affine_steps_plain`
:func:`affine_drive`   ``fused_affine_steps`` (the     :func:`affine_drive_plain`
                       whole ``rollout_power`` drive)
:func:`affine_frames`  ``fused_affine_steps`` (the     :func:`affine_frames_plain`
                       whole ``rollout_frames_power``
                       drive)
=====================  ==============================  =======================

Dispatch goes by the device of the state tensor: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (building it on first use) or
raises. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
The kernels have no derivative: on the card a wrapper raises when an input
requires grad (with grad mode on) or carries a tangent
(``_build.refuse_grad``).

Rounding: every step and every affine application is a chain of
:func:`madd` in the order the plain versions state (:func:`fma_step`,
:func:`affine_app`). In float32 ``madd`` rounds ``x * y + z`` once, as the
kernels' ``__fmaf_rn`` does; in float64 it rounds the product and the sum
each, as the kernels' ``_rn`` intrinsics do. Kernel and plain version
therefore agree bit for bit in both dtypes. Scalars are rounded to the state
dtype once on the host (:func:`step_scalars`) and the same values go to
both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def mode_coeffs(lam, winv, rho_inf: float, cdamp=None):
    """Per-mode coefficients of the substituted gen-α Newton update.

    Substituting the single Newton correction ``a1 = a - winv * r`` (exact
    for the linear modal system) into the residual ``r = a + lam * q_af
    [+ c * v_af] - u`` gives

        ``a1 = winv*u + p1*a - p2*q_pred - p3*q [- p5*v_pred - p6*v]``

    with ``p1 = -am * winv``, ``p2 = winv*lam*(1-af)``, ``p3 = winv*lam*af``,
    ``p5 = winv*c*(1-af)``, ``p6 = winv*c*af``. Works on NumPy arrays or
    tensors of any dtype (the products round in that dtype), in the same
    expression order as the JAX package.
    """
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    wl = winv * lam
    p1 = winv * (-am)
    p2 = wl * (1.0 - af)
    p3 = wl * af
    if cdamp is None:
        return p1, p2, p3, None, None
    wc = winv * cdamp
    return p1, p2, p3, wc * (1.0 - af), wc * af


@functools.lru_cache(maxsize=64)
def step_scalars(h: float, rho_inf: float, dtype: torch.dtype):
    """``(h, c_qp, c_vp, bh2, gh)`` of the gen-α step, rounded to ``dtype``.

    Python floats that are exact in ``dtype``, so a tensor product with them
    and the kernel's product with the same value cast to ``dtype`` agree.
    Memoized: a launch pays no torch op for them.
    """
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma = 0.5 - am + af
    vals = (h, (0.5 - beta) * h * h, (1.0 - gamma) * h, beta * h * h, gamma * h)
    rounded = torch.tensor(vals, dtype=torch.float64).to(dtype)
    return tuple(float(x) for x in rounded.tolist())


def gen_alpha_step(q, v, a, p4, cols, sc):
    """One substituted gen-α step; the expression order the kernels follow.

    ``cols = (p1, p2, p3, p5, p6)`` (``p5 = p6 = None`` undamped), ``p4 =
    winv * u``, ``sc`` from :func:`step_scalars`.
    """
    p1, p2, p3, p5, p6 = cols
    h, c_qp, c_vp, bh2, gh = sc
    q_pred = q + h * v + c_qp * a
    v_pred = v + c_vp * a
    a1 = p4 + p1 * a - p2 * q_pred - p3 * q
    if p5 is not None:
        a1 = a1 - p5 * v_pred - p6 * v
    return q_pred + bh2 * a1, v_pred + gh * a1, a1


def madd(x, y, z):
    """``x * y + z`` as the kernels compute it, in ``z``'s dtype.

    float32: rounded once, as a fused multiply-add (``__fmaf_rn``) rounds.
    The float64 product of two float32 values is exact; TwoSum gives the
    exact error ``e`` of the float64 sum ``s``; rounding ``s`` to odd (a
    step to the neighbour towards ``e`` when ``e != 0`` and ``s``'s last bit
    is even) and then to float32 is the correctly rounded result, since 53
    >= 24 + 2 bits (Boldo and Melquiond, "Emulation of FMA and correctly
    rounded sums: proved algorithms using rounding to odd", IEEE Trans.
    Computers 57(4), 2008). The direction comes from ``e``'s sign: ``s + e``
    rounds back to ``s``.

    float64: ``x * y + z``, the product and the sum each rounded (the
    kernels' ``__dmul_rn``, ``__dadd_rn``).

    ``x`` and ``y`` are tensors or Python floats exact in ``z``'s dtype.
    """
    if z.dtype != torch.float32:
        return x * y + z
    x, y, z = (torch.as_tensor(t, dtype=torch.float64, device=z.device)
               for t in (x, y, z))
    p = x * y
    s = p + z
    zv = s - p
    e = (p - (s - zv)) + (z - zv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")), e))
    return torch.where((e != 0) & even, toward, s).to(torch.float32)


def fma_step(q, v, a, p4, cols, sc):
    """One substituted gen-α step as a chain of :func:`madd`; the order the
    step kernels follow in both dtypes:

        q_pred = madd(c_qp, a, madd(h, v, q));  v_pred = madd(c_vp, a, v)
        a1 = madd(-p3, q, madd(-p2, q_pred, madd(p1, a, p4)))
        damped: a1 = madd(-p6, v, madd(-p5, v_pred, a1))
        q' = madd(bh2, a1, q_pred);  v' = madd(gh, a1, v_pred);  a' = a1

    8 multiply-adds an element (10 damped). In float64 each madd rounds its
    product and its sum, and the result equals :func:`gen_alpha_step`'s bit
    for bit (``x - y`` is ``-y + x``; negation is exact). Arguments as for
    :func:`gen_alpha_step`.
    """
    p1, p2, p3, p5, p6 = cols
    h, c_qp, c_vp, bh2, gh = sc
    q_pred = madd(c_qp, a, madd(h, v, q))
    v_pred = madd(c_vp, a, v)
    a1 = madd(-p3, q, madd(-p2, q_pred, madd(p1, a, p4)))
    if p5 is not None:
        a1 = madd(-p6, v, madd(-p5, v_pred, a1))
    return madd(bh2, a1, q_pred), madd(gh, a1, v_pred), a1


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, ref):
    """``(p1, p2, p3, p5, p6)`` and ``p4 = winv * u`` in ``ref``'s dtype."""
    lam, winv = _like(lam, ref), _like(winv, ref)
    cols = mode_coeffs(
        lam, winv, rho_inf, None if cdamp is None else _like(cdamp, ref)
    )
    p4 = torch.zeros_like(lam) if u_modal is None else winv * _like(u_modal, ref)
    return cols, p4


def initial_accel(lam, u_modal, cdamp, eta, etad):
    """Consistent initial modal acceleration ``u - lam eta [- c etad]``."""
    a0 = -_like(lam, eta) * eta
    if u_modal is not None:
        a0 = a0 + _like(u_modal, eta)
    if cdamp is not None:
        a0 = a0 - _like(cdamp, eta) * etad
    return a0


def _on_cuda(*tensors) -> bool:
    """True for CUDA state, False for CPU; raises for anything else."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"modal kernels take CPU or CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev or t.dtype != tensors[0].dtype or t.shape != tensors[0].shape:
            raise ValueError(
                "state tensors must share device, dtype and shape, got "
                f"{[(str(x.device), x.dtype, tuple(x.shape)) for x in tensors]}"
            )
    if dev.type == "cuda" and tensors[0].dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA modal kernels take float32/float64, got {tensors[0].dtype}")
    return dev.type == "cuda"


def _triple_out(ref):
    """``(q1, v1, a1)`` shaped like ``ref``, contiguous, from one allocation."""
    return torch.empty((3, *ref.shape), dtype=ref.dtype, device=ref.device).unbind(0)


def _ptr(t):
    return t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# fused_modal_steps -> modal_steps
# ---------------------------------------------------------------------------


def modal_steps_plain(lam, winv, u_modal, eta, etad, etadd=None, steps: int = 1,
                      h: float = 1e-4, rho_inf: float = 0.8, cdamp=None):
    """Plain PyTorch version of :func:`modal_steps` (same arithmetic)."""
    if etadd is None:
        etadd = initial_accel(lam, u_modal, cdamp, eta, etad)
    cols, p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, eta)
    sc = step_scalars(h, rho_inf, eta.dtype)
    q, v, a = eta, etad, etadd
    for _ in range(int(steps)):
        q, v, a = fma_step(q, v, a, p4, cols, sc)
    return q, v, a


def modal_steps(lam, winv, u_modal, eta, etad, etadd=None, steps: int = 1,
                h: float = 1e-4, rho_inf: float = 0.8, cdamp=None):
    """Advance modal ``(eta, etad, etadd)`` by ``steps`` gen-α steps.

    Args:
      lam: ``(m,)`` modal eigenvalues.
      winv: ``(m,)`` effective-Jacobian inverses (compute in float64 on the
        host, see ``ModalGenAlpha.winv64``); cast to the state dtype.
      u_modal: ``(m,)`` constant modal force, or None.
      eta, etad, etadd: ``(..., m)`` modal states; ``etadd=None`` computes
        the consistent initial acceleration.
      steps, h, rho_inf: stepper configuration; cdamp: ``(m,)`` modal
        Rayleigh damping or None.

    Returns the advanced state triple. CPU tensors run
    :func:`modal_steps_plain`; CUDA tensors run the CUDA kernel (one
    launch, all steps in registers).
    """
    if etadd is None:
        etadd = initial_accel(lam, u_modal, cdamp, eta, etad)
    if not _on_cuda(eta, etad, etadd):
        return modal_steps_plain(lam, winv, u_modal, eta, etad, etadd, steps,
                                 h, rho_inf, cdamp)
    _build.refuse_grad("modal_steps", lam, winv, u_modal, eta, etad, etadd, cdamp)
    (p1, p2, p3, p5, p6), p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, eta)
    damped = p5 is not None
    cols = torch.stack([p1, p2, p3, p4] + ([p5, p6] if damped else []))
    q0, v0, a0 = eta.contiguous(), etad.contiguous(), etadd.contiguous()
    n, m = q0.numel(), q0.shape[-1]
    q1, v1, a1 = _triple_out(q0)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.modal_steps_launch(
                _DTYPE_CODES[eta.dtype], int(damped), n, m, int(steps),
                _ptr(cols), _ptr(q0), _ptr(v0), _ptr(a0), _ptr(q1), _ptr(v1),
                _ptr(a1), *step_scalars(h, rho_inf, eta.dtype), _stream(eta.device),
            )
        _build.check(lib, rc, "modal_steps")
        modal_steps.launches += 1
    return q1, v1, a1


modal_steps.launches = 0


# ---------------------------------------------------------------------------
# fused_modal_frames -> modal_frames
# ---------------------------------------------------------------------------


def modal_frames_plain(lam, winv, u_modal, eta, etad, n_frames: int = 1,
                       substeps: int = 1, h: float = 1e-4, rho_inf: float = 0.8,
                       cdamp=None):
    """Plain PyTorch version of :func:`modal_frames` (same arithmetic)."""
    a = initial_accel(lam, u_modal, cdamp, eta, etad)
    cols, p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, eta)
    sc = step_scalars(h, rho_inf, eta.dtype)
    q, v = eta, etad
    qs, vs = [q], [v]
    for _ in range(int(n_frames)):
        for _ in range(int(substeps)):
            q, v, a = fma_step(q, v, a, p4, cols, sc)
        qs.append(q)
        vs.append(v)
    return torch.stack(qs), torch.stack(vs)


class FrameCoeffs(NamedTuple):
    """The per-mode rows :func:`modal_frames` reads on the card, views of one
    ``(rows, m)`` tensor in the state dtype on the state's device:
    ``cols`` = ``(p1, p2, p3, p4[, p5, p6])`` (:func:`mode_coeffs`, ``p4 =
    winv * u``), and ``lam``, ``u``, ``cdamp`` for the initial acceleration
    (``u``, ``cdamp`` None when absent)."""

    cols: torch.Tensor
    lam: torch.Tensor
    u: Optional[torch.Tensor]
    cdamp: Optional[torch.Tensor]


def frame_coeffs(lam, winv, u_modal, cdamp, rho_inf: float, ref) -> FrameCoeffs:
    """:class:`FrameCoeffs` in ``ref``'s dtype and device, with the
    arithmetic of :func:`_coeff_cols` and :func:`initial_accel`'s casts, so
    the kernel reads the values its plain version computes. Build once and
    pass to every :func:`modal_frames` call of the same engine and force
    (``ModalGenAlpha`` memoizes it)."""
    (p1, p2, p3, p5, p6), p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, ref)
    damped = p5 is not None
    rows = [p1, p2, p3, p4] + ([p5, p6] if damped else []) + [_like(lam, ref)]
    extra = [x for x in (u_modal, cdamp) if x is not None]
    block = torch.stack(rows + [_like(x, ref) for x in extra])
    n = len(rows) - 1
    u_row = block[n + 1] if u_modal is not None else None
    return FrameCoeffs(block[:n], block[n], u_row, block[-1] if damped else None)


def modal_frames(lam, winv, u_modal, eta, etad, n_frames: int = 1,
                 substeps: int = 1, h: float = 1e-4, rho_inf: float = 0.8,
                 cdamp=None, coeffs: FrameCoeffs = None, envs: int = 0):
    """Frame-collecting rollout: ``n_frames`` frames of ``substeps`` steps.

    Returns ``(etas, etads)`` of shape ``(n_frames + 1, ..., m)`` including
    the initial state. On CUDA one launch computes the consistent initial
    acceleration, carries the state in registers across all frames and
    writes each frame into one preallocated output; with ``coeffs`` (from
    :func:`frame_coeffs` for the same arguments) no torch op runs before it.
    ``envs``: the envs a thread carries (1, 2 or 4); 0 lets the kernel's
    launcher choose by the batch (``modal_frames_envs`` in the source).
    """
    if not _on_cuda(eta, etad):
        return modal_frames_plain(lam, winv, u_modal, eta, etad, n_frames,
                                  substeps, h, rho_inf, cdamp)
    _build.refuse_grad("modal_frames", lam, winv, u_modal, eta, etad, cdamp)
    if coeffs is None:
        coeffs = frame_coeffs(lam, winv, u_modal, cdamp, rho_inf, eta)
    q0, v0 = eta.contiguous(), etad.contiguous()
    n, m = q0.numel(), q0.shape[-1]
    if (coeffs.cols.dtype != eta.dtype or coeffs.cols.device != eta.device
            or coeffs.cols.shape != (4 if coeffs.cdamp is None else 6, m)):
        raise ValueError(f"coeffs do not fit {m} modes of {eta.dtype} on {eta.device}: "
                         f"cols {tuple(coeffs.cols.shape)} {coeffs.cols.dtype} on "
                         f"{coeffs.cols.device}")
    F = int(n_frames)
    out = torch.empty((2, F + 1, *eta.shape), dtype=eta.dtype, device=eta.device)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.modal_frames_launch(
                _DTYPE_CODES[eta.dtype], int(coeffs.cdamp is not None), int(envs), n // m,
                m, F, int(substeps), _ptr(coeffs.cols), _ptr(coeffs.lam),
                *(0 if x is None else _ptr(x) for x in (coeffs.u, coeffs.cdamp)),
                _ptr(q0), _ptr(v0), _ptr(out[0]), _ptr(out[1]),
                *step_scalars(h, rho_inf, eta.dtype), _stream(eta.device),
            )
        _build.check(lib, rc, "modal_frames")
        modal_frames.launches += 1
    return out[0], out[1]


modal_frames.launches = 0


# ---------------------------------------------------------------------------
# fused_affine_steps -> affine_steps
# ---------------------------------------------------------------------------


def _affine_map(tmat, bvec, ref, runs: int = None):
    """``(P, b)`` in ``ref``'s dtype and device, contiguous, shapes checked:
    ``(m, 3, 3)`` and ``(m, 3)``, or with a leading axis of ``runs`` maps."""
    m = ref.shape[-1]
    lead = () if runs is None else (runs,)
    P = _like(tmat, ref).contiguous()
    b = _like(bvec, ref).contiguous()
    if P.shape != (*lead, m, 3, 3) or b.shape != (*lead, m, 3):
        raise ValueError(
            f"affine map needs tmat {(*lead, 'm', 3, 3)} and bvec {(*lead, 'm', 3)} "
            f"for m={m}, got {tuple(P.shape)} and {tuple(b.shape)}"
        )
    return P, b


def affine_app(P, b, q, v, a):
    """One application of the per-mode map ``s -> P s + b``, row ``i`` in
    the order the affine kernels follow:

        float32: madd(P[i,2], a, madd(P[i,1], v, madd(P[i,0], q, b[i])))
        float64: ((P[i,0] q + P[i,1] v) + P[i,2] a) + b[i]

    float32 starts each row from its offset, 9 fused multiply-adds an
    element; float64 keeps the first port's order, each operation rounded.
    ``P`` ``(m, 3, 3)`` and ``b`` ``(m, 3)`` in the state dtype.
    """
    if q.dtype == torch.float32:
        return tuple(madd(P[:, i, 2], a, madd(P[:, i, 1], v, madd(P[:, i, 0], q, b[:, i])))
                     for i in range(3))
    return tuple(P[:, i, 0] * q + P[:, i, 1] * v + P[:, i, 2] * a + b[:, i]
                 for i in range(3))


def affine_steps_plain(tmat, bvec, eta, etad, etadd, apps: int = 1):
    """Plain PyTorch version of :func:`affine_steps` (same arithmetic)."""
    P, b = _like(tmat, eta), _like(bvec, eta)
    q, v, a = eta, etad, etadd
    for _ in range(int(apps)):
        q, v, a = affine_app(P, b, q, v, a)
    return q, v, a


def affine_steps(tmat, bvec, eta, etad, etadd, apps: int = 1):
    """Apply the per-mode affine map ``s -> T s + b`` ``apps`` times.

    ``tmat``: ``(m, 3, 3)`` per-mode map, ``bvec``: ``(m, 3)`` offset (cast
    to the state dtype); ``eta, etad, etadd``: ``(..., m)`` state triple.
    Returns the advanced triple; on CUDA one launch runs every application
    in registers.
    """
    if not _on_cuda(eta, etad, etadd):
        return affine_steps_plain(tmat, bvec, eta, etad, etadd, apps)
    _build.refuse_grad("affine_steps", tmat, bvec, eta, etad, etadd)
    P, b = _affine_map(tmat, bvec, eta)
    q0, v0, a0 = eta.contiguous(), etad.contiguous(), etadd.contiguous()
    n, m = q0.numel(), q0.shape[-1]
    q1, v1, a1 = _triple_out(q0)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.affine_steps_launch(
                _DTYPE_CODES[eta.dtype], n // m, m, int(apps), _ptr(P), _ptr(b),
                _ptr(q0), _ptr(v0), _ptr(a0), _ptr(q1), _ptr(v1), _ptr(a1),
                _stream(eta.device),
            )
        _build.check(lib, rc, "affine_steps")
        affine_steps.launches += 1
    return q1, v1, a1


affine_steps.launches = 0


# ---------------------------------------------------------------------------
# rollout_power's whole drive -> affine_drive
# ---------------------------------------------------------------------------


def affine_drive_plain(lam, u_modal, cdamp, tmat, bvec, eta, etad, apps: int,
                       rem_tmat=None, rem_bvec=None):
    """Plain PyTorch version of :func:`affine_drive` (same arithmetic)."""
    s = (eta, etad, initial_accel(lam, u_modal, cdamp, eta, etad))
    if apps:
        s = affine_steps_plain(tmat, bvec, *s, apps=apps)
    if rem_tmat is not None:
        s = affine_steps_plain(rem_tmat, rem_bvec, *s, apps=1)
    return s


def affine_drive(lam, u_modal, cdamp, tmat, bvec, eta, etad, apps: int,
                 rem_tmat=None, rem_bvec=None):
    """The composed-propagator drive of ``ModalGenAlpha.rollout_power``.

    From ``(eta, etad)``: the consistent initial acceleration
    (:func:`initial_accel`, its order and rounding), ``apps`` applications
    of the map ``(tmat, bvec)``, then one of ``(rem_tmat, rem_bvec)`` if
    given. ``lam``, ``u_modal`` (or None), ``cdamp`` (or None): ``(m,)``;
    maps as for :func:`affine_steps`. Returns the advanced state triple; on
    CUDA one launch reads ``eta`` and ``etad`` and writes the triple.
    """
    if not _on_cuda(eta, etad):
        return affine_drive_plain(lam, u_modal, cdamp, tmat, bvec, eta, etad, apps,
                                  rem_tmat, rem_bvec)
    _build.refuse_grad("affine_drive", lam, u_modal, cdamp, tmat, bvec, eta, etad,
                       rem_tmat, rem_bvec)
    P, b = _affine_map(tmat, bvec, eta)
    Pr, br = (None, None) if rem_tmat is None else _affine_map(rem_tmat, rem_bvec, eta)
    cols = [_like(x, eta).contiguous() if x is not None else None
            for x in (lam, u_modal, cdamp)]
    q0, v0 = eta.contiguous(), etad.contiguous()
    n, m = q0.numel(), q0.shape[-1]
    q1, v1, a1 = _triple_out(q0)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.affine_drive_launch(
                _DTYPE_CODES[eta.dtype], n // m, m, int(apps),
                *(0 if x is None else _ptr(x) for x in (*cols, P, b, Pr, br)),
                _ptr(q0), _ptr(v0), _ptr(q1), _ptr(v1), _ptr(a1), _stream(eta.device),
            )
        _build.check(lib, rc, "affine_drive")
        affine_drive.launches += 1
    return q1, v1, a1


affine_drive.launches = 0


# ---------------------------------------------------------------------------
# rollout_frames_power's whole drive -> affine_frames
# ---------------------------------------------------------------------------


def affine_frames_plain(lam, u_modal, cdamp, tmat, bvec, eta, etad, counts):
    """Plain PyTorch version of :func:`affine_frames` (same arithmetic)."""
    s = (eta, etad, initial_accel(lam, u_modal, cdamp, eta, etad))
    qs, vs = [eta], [etad]
    for P, b, c in zip(tmat, bvec, counts):
        for _ in range(int(c)):
            s = affine_steps_plain(P, b, *s, apps=1)
            qs.append(s[0])
            vs.append(s[1])
    return torch.stack(qs), torch.stack(vs)


@functools.lru_cache(maxsize=16)
def _frame_runs(counts: tuple, device: torch.device) -> torch.Tensor:
    """The run of each frame, ``int32`` on ``device``, for runs of ``counts``
    frames. Memoized: a schedule's launches copy nothing to the card."""
    idx = torch.repeat_interleave(torch.arange(len(counts), dtype=torch.int32),
                                  torch.tensor(counts))
    return idx.to(device)


def affine_frames(lam, u_modal, cdamp, tmat, bvec, eta, etad, counts):
    """The frame-collecting drive of ``ModalGenAlpha.rollout_frames_power``.

    From ``(eta, etad)`` and the consistent initial acceleration
    (:func:`initial_accel`, its order and rounding), runs ``r`` of
    ``counts[r]`` frames, each frame one application of run ``r``'s map
    ``(tmat[r], bvec[r])``. ``lam``, ``u_modal`` (or None), ``cdamp`` (or
    None): ``(m,)``; ``tmat`` ``(R, m, 3, 3)``, ``bvec`` ``(R, m, 3)``, one
    map a run. Returns ``(etas, etads)`` of shape ``(sum(counts) + 1, ...,
    m)``, the initial state first. On CUDA one launch reads ``eta`` and
    ``etad`` and writes every frame into one preallocated output.
    """
    if not _on_cuda(eta, etad):
        return affine_frames_plain(lam, u_modal, cdamp, tmat, bvec, eta, etad, counts)
    _build.refuse_grad("affine_frames", lam, u_modal, cdamp, tmat, bvec, eta, etad)
    counts = tuple(int(c) for c in counts)
    if any(c < 0 for c in counts):
        raise ValueError(f"frame counts must be >= 0, got {counts}")
    F = sum(counts)
    P, b = _affine_map(tmat, bvec, eta, runs=len(counts))
    frame_run = _frame_runs(counts, eta.device) if len(counts) > 1 else None
    consts = [_like(x, eta).contiguous() if x is not None else None
              for x in (lam, u_modal, cdamp)]
    q0, v0 = eta.contiguous(), etad.contiguous()
    n, m = q0.numel(), q0.shape[-1]
    out = torch.empty((2, F + 1, *eta.shape), dtype=eta.dtype, device=eta.device)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.affine_frames_launch(
                _DTYPE_CODES[eta.dtype], n // m, m, F,
                *(0 if x is None else _ptr(x) for x in (frame_run, *consts, P, b)),
                _ptr(q0), _ptr(v0), _ptr(out[0]), _ptr(out[1]), _stream(eta.device),
            )
        _build.check(lib, rc, "affine_frames")
        affine_frames.launches += 1
    return out[0], out[1]


affine_frames.launches = 0


KERNELS = (modal_steps, modal_frames, affine_steps, affine_drive, affine_frames)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0

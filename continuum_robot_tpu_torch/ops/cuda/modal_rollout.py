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
=====================  ==============================  =======================

Dispatch goes by the device of the state tensor: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (building it on first use) or
raises. Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernels round every multiply and add separately, in the plain version's
order (see the ``.cu`` file), so kernel and plain version agree bit for bit.
Scalars are rounded to the state dtype once on the host
(:func:`step_scalars`) and the same values go to both.
"""

from __future__ import annotations

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


def step_scalars(h: float, rho_inf: float, dtype: torch.dtype):
    """``(h, c_qp, c_vp, bh2, gh)`` of the gen-α step, rounded to ``dtype``.

    Python floats that are exact in ``dtype``, so a tensor product with them
    and the kernel's product with the same value cast to ``dtype`` agree.
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


def _flat(x):
    return x.contiguous().reshape(-1, x.shape[-1])


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
        q, v, a = gen_alpha_step(q, v, a, p4, cols, sc)
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
    (p1, p2, p3, p5, p6), p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, eta)
    damped = p5 is not None
    cols = torch.stack([p1, p2, p3, p4] + ([p5, p6] if damped else []))
    q0, v0, a0 = _flat(eta), _flat(etad), _flat(etadd)
    n, m = q0.numel(), q0.shape[-1]
    q1, v1, a1 = torch.empty_like(q0), torch.empty_like(q0), torch.empty_like(q0)
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
    shape = eta.shape
    return q1.reshape(shape), v1.reshape(shape), a1.reshape(shape)


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
            q, v, a = gen_alpha_step(q, v, a, p4, cols, sc)
        qs.append(q)
        vs.append(v)
    return torch.stack(qs), torch.stack(vs)


def modal_frames(lam, winv, u_modal, eta, etad, n_frames: int = 1,
                 substeps: int = 1, h: float = 1e-4, rho_inf: float = 0.8,
                 cdamp=None):
    """Frame-collecting rollout: ``n_frames`` frames of ``substeps`` steps.

    Returns ``(etas, etads)`` of shape ``(n_frames + 1, ..., m)`` including
    the initial state. On CUDA one launch carries the state in registers
    across all frames and writes each frame into the preallocated output.
    """
    a0 = initial_accel(lam, u_modal, cdamp, eta, etad)
    if not _on_cuda(eta, etad):
        return modal_frames_plain(lam, winv, u_modal, eta, etad, n_frames,
                                  substeps, h, rho_inf, cdamp)
    (p1, p2, p3, p5, p6), p4 = _coeff_cols(lam, winv, u_modal, cdamp, rho_inf, eta)
    damped = p5 is not None
    cols = torch.stack([p1, p2, p3, p4] + ([p5, p6] if damped else []))
    q0, v0, a0 = _flat(eta), _flat(etad), _flat(a0)
    n, m = q0.numel(), q0.shape[-1]
    F = int(n_frames)
    qs = torch.empty((F + 1, *eta.shape), dtype=eta.dtype, device=eta.device)
    vs = torch.empty_like(qs)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.modal_frames_launch(
                _DTYPE_CODES[eta.dtype], int(damped), n, m, F, int(substeps),
                _ptr(cols), _ptr(q0), _ptr(v0), _ptr(a0), _ptr(qs), _ptr(vs),
                *step_scalars(h, rho_inf, eta.dtype), _stream(eta.device),
            )
        _build.check(lib, rc, "modal_frames")
        modal_frames.launches += 1
    return qs, vs


modal_frames.launches = 0


# ---------------------------------------------------------------------------
# fused_affine_steps -> affine_steps
# ---------------------------------------------------------------------------


def affine_steps_plain(tmat, bvec, eta, etad, etadd, apps: int = 1):
    """Plain PyTorch version of :func:`affine_steps` (same arithmetic)."""
    P, b = _like(tmat, eta), _like(bvec, eta)
    q, v, a = eta, etad, etadd
    for _ in range(int(apps)):
        q, v, a = (
            P[:, 0, 0] * q + P[:, 0, 1] * v + P[:, 0, 2] * a + b[:, 0],
            P[:, 1, 0] * q + P[:, 1, 1] * v + P[:, 1, 2] * a + b[:, 1],
            P[:, 2, 0] * q + P[:, 2, 1] * v + P[:, 2, 2] * a + b[:, 2],
        )
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
    m = eta.shape[-1]
    P = _like(tmat, eta).contiguous()
    b = _like(bvec, eta).contiguous()
    if P.shape != (m, 3, 3) or b.shape != (m, 3):
        raise ValueError(
            f"affine map needs tmat (m, 3, 3) and bvec (m, 3) for m={m}, "
            f"got {tuple(P.shape)} and {tuple(b.shape)}"
        )
    q0, v0, a0 = _flat(eta), _flat(etad), _flat(etadd)
    n = q0.numel()
    q1, v1, a1 = torch.empty_like(q0), torch.empty_like(q0), torch.empty_like(q0)
    if n:
        lib = _build.library("modal_rollout")
        with torch.cuda.device(eta.device):
            rc = lib.affine_steps_launch(
                _DTYPE_CODES[eta.dtype], n, m, int(apps), _ptr(P), _ptr(b),
                _ptr(q0), _ptr(v0), _ptr(a0), _ptr(q1), _ptr(v1), _ptr(a1),
                _stream(eta.device),
            )
        _build.check(lib, rc, "affine_steps")
        affine_steps.launches += 1
    shape = eta.shape
    return q1.reshape(shape), v1.reshape(shape), a1.reshape(shape)


affine_steps.launches = 0


KERNELS = (modal_steps, modal_frames, affine_steps)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0

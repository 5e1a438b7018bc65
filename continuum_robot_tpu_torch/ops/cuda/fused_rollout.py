"""Fused small-beam generalized-α rollout: CUDA on the card, a plain twin elsewhere.

Counterpart of ``continuum_robot_tpu/ops/pallas/fused_rollout.py``. For a
purely linear beam with quadratic fluid drag and a constant input force, a
batched implicit step is three small dense matrix products and a handful of
elementwise updates; the TPU kernel ``fused_gen_alpha_steps`` runs ``steps``
of them per launch with the state on chip, and the JAX ``fused_rollout``
scans it over the frames. Here both are the hand-written CUDA kernel of
``csrc/fused_rollout.cu``: :func:`fused_gen_alpha_steps` is one launch of
``steps`` steps, :func:`fused_gen_alpha_frames` one launch of a whole
rollout that writes every frame. Their plain PyTorch twins
(:func:`fused_gen_alpha_steps_plain`, :func:`fused_gen_alpha_frames_plain`)
sum every matrix product over columns from ``j = 0`` upward with one
rounding per product and per sum, the kernel's order, so the two agree bit
for bit.

The wrappers dispatch by the device of the states: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel (building it on first use) or
raises; on the card it raises too when an input requires grad or carries
a tangent (the kernel has no derivative: ``_build.refuse_grad``). Each
wrapper's ``launches`` counts its launches.
:func:`launch_geometry` reads the kernel's thread map for a size and dtype
(which instance, how many environments a thread and a block) from the
kernel's own C query.
:func:`fused_rollout` is the full rollout: host float64 set-up, the
consistent initial acceleration, one launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .modal_rollout import step_scalars

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_GEOMETRY = ("instance", "envs", "groups", "threads", "blocks", "rows", "np", "smem")


def launch_geometry(n: int, dtype: torch.dtype, B: int, lib=None) -> dict:
    """How the kernel covers ``B`` environments of ``n`` DOFs in ``dtype``,
    as its C query ``fused_gen_alpha_geometry`` (``csrc/fused_geometry.h``)
    states it: ``instance`` ("rows" or "lanes"), ``envs`` a thread,
    ``groups`` (env groups of n threads, or warps) a block, ``threads``,
    ``blocks``, ``rows`` a lane (lanes), ``np`` (the rows instance's n
    rounded up to a multiple of 3) and ``smem`` bytes. ``lib``: a library
    that exports the query, by default the kernel's. Raises ``ValueError``
    for an ``n`` that neither instance serves."""
    lib = _build.library("fused_rollout") if lib is None else lib
    out = (ctypes.c_int * len(_GEOMETRY))()
    if lib.fused_gen_alpha_geometry(_DTYPE_CODES[dtype], int(n), int(B), out) != 0:
        raise ValueError(
            f"fused_gen_alpha_steps: no instance of the kernel serves n={n} in {dtype} "
            "(the lanes instance's three matrices must fit in one block's shared memory)"
        )
    geo = dict(zip(_GEOMETRY, out))
    geo["instance"] = ("rows", "lanes")[geo["instance"]]
    return geo


def gen_alpha_params(rho_inf: float):
    """``(am, af, beta)`` of the Chung-Hulbert generalized-α scheme."""
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    return am, af, 0.25 * (1.0 - am + af) ** 2


def step_coeffs(h: float, rho_inf: float, dtype: torch.dtype):
    """``(h, c_qp, c_vp, bh2, gh, 1-af, af, 1-am, am)``: the step's nine
    scalars as Python floats exact in ``dtype``, the same values the kernel
    casts to ``dtype`` (the first five are :func:`step_scalars`)."""
    am, af, _ = gen_alpha_params(rho_inf)
    weights = torch.tensor((1.0 - af, af, 1.0 - am, am), dtype=torch.float64).to(dtype)
    return step_scalars(h, rho_inf, dtype) + tuple(float(w) for w in weights.tolist())


def _operands(mats, drag_coeffs, u, like: torch.Tensor):
    """``(M, K, Jinv, drag, u)`` as contiguous tensors on ``like``'s device
    and dtype (tensors already there pass through)."""
    def to(a):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device).contiguous()

    return (*(to(A) for A in mats), to(drag_coeffs), to(u))


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ A.T`` for a batch ``x (B, n)``, summed over the columns of ``A``
    from ``j = 0`` upward, one rounding per product and per sum."""
    acc = x[:, 0:1] * A[:, 0]
    for j in range(1, A.shape[1]):
        acc = acc + x[:, j : j + 1] * A[:, j]
    return acc


def fused_gen_alpha_steps_plain(mats, drag_coeffs, u, x: torch.Tensor, steps: int,
                                h: float, rho_inf: float = 0.8,
                                n_newton: int = 2) -> torch.Tensor:
    """The plain PyTorch twin of the kernel: the JAX kernel body's
    expressions in its order, with the kernel's summation order for the
    matrix products. Arguments as in :func:`fused_gen_alpha_steps`."""
    M, K, Jinv, c_drag, u = _operands(mats, drag_coeffs, u, x)
    n = x.shape[-1] // 3
    hh, c_qp, c_vp, bh2, gh, w_af1, w_af, w_am1, w_am = step_coeffs(h, rho_inf, x.dtype)
    neg_c = -c_drag
    q, v, a = x[:, :n], x[:, n : 2 * n], x[:, 2 * n :]
    for _ in range(int(steps)):
        q_pred = q + hh * v + c_qp * a
        v_pred = v + c_vp * a
        a1 = a
        for _ in range(int(n_newton)):
            q1 = q_pred + bh2 * a1
            v1 = v_pred + gh * a1
            q_af = w_af1 * q1 + w_af * q
            v_af = w_af1 * v1 + w_af * v
            a_am = w_am1 * a1 + w_am * a
            f_drag = neg_c * v_af * v_af.abs()
            r = _matvec(M, a_am) + _matvec(K, q_af) - f_drag - u
            a1 = a1 - _matvec(Jinv, r)
        q, v, a = q_pred + bh2 * a1, v_pred + gh * a1, a1
    return torch.cat([q, v, a], dim=-1)


def fused_gen_alpha_frames_plain(mats, drag_coeffs, u, x: torch.Tensor, n_frames: int,
                                 substeps: int, h: float, rho_inf: float = 0.8,
                                 n_newton: int = 2) -> torch.Tensor:
    """The plain twin of :func:`fused_gen_alpha_frames`: the per-frame loop of
    :func:`fused_gen_alpha_steps_plain`."""
    n = x.shape[-1] // 3
    frames = [x[:, : 2 * n]]
    for _ in range(int(n_frames)):
        x = fused_gen_alpha_steps_plain(mats, drag_coeffs, u, x, substeps, h, rho_inf,
                                        n_newton)
        frames.append(x[:, : 2 * n])
    return torch.stack(frames)


def _checked(name: str, mats, drag_coeffs, u, x: torch.Tensor):
    """``(M, K, Jinv, drag, u, x)`` on ``x``'s CUDA device, checked for the
    kernel; raises on a device, dtype or shape it does not take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA {name} takes float32/float64, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] % 3 or x.shape[1] == 0:
        raise ValueError(f"{name} needs x (B, 3n), got {tuple(x.shape)}")
    n = x.shape[1] // 3
    M, K, Jinv, c_drag, u = _operands(mats, drag_coeffs, u, x)
    if any(A.shape != (n, n) for A in (M, K, Jinv)) or c_drag.shape != (n,) or u.shape != (n,):
        raise ValueError(
            f"{name} needs (n, n) operators and (n,) drag and u for n={n}, "
            f"got {[tuple(t.shape) for t in (M, K, Jinv, c_drag, u)]}"
        )
    launch_geometry(n, x.dtype, x.shape[0])  # raises for an n no instance serves
    return M, K, Jinv, c_drag, u, x.contiguous()


def _launch(name, operands, n_frames: int, substeps: int, h: float, rho_inf: float,
            n_newton: int, out, frames) -> None:
    """One launch of ``n_frames`` frames of ``substeps`` steps, writing the
    final states into ``out`` and the frames into ``frames`` (None: not
    written)."""
    M, K, Jinv, c_drag, u, x = operands
    B, n = x.shape[0], x.shape[1] // 3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library("fused_rollout")
    with torch.cuda.device(x.device):
        rc = lib.fused_gen_alpha_launch(
            _DTYPE_CODES[x.dtype], B, n, int(n_frames), int(substeps), int(n_newton),
            *step_coeffs(h, rho_inf, x.dtype), M.data_ptr(), K.data_ptr(), Jinv.data_ptr(),
            c_drag.data_ptr(), u.data_ptr(), x.data_ptr(), ptr(out), ptr(frames),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, name)


def fused_gen_alpha_steps(mats, drag_coeffs, u, x: torch.Tensor, steps: int, h: float,
                          rho_inf: float = 0.8, n_newton: int = 2, tile: int = None,
                          interpret: bool = None) -> torch.Tensor:
    """Advance ``(q, v, a)`` by ``steps`` fused generalized-α steps.

    Args:
      mats: ``(M, K, Jinv)`` dense reduced operators, each ``(n, n)``; Jinv
        is the inverse of ``(1-am) M + (1-af) beta h^2 K``.
      drag_coeffs: ``(n,)`` per-DOF quadratic drag coefficients (zeros where
        no drag acts).
      u: ``(n,)`` constant input force over this span.
      x: ``(B, 3n)`` stacked ``[q; v; a]`` states; float32 or float64 on
        the card.
      steps, h, rho_inf, n_newton: stepper configuration.
      tile, interpret: the JAX signature's TPU tiling and interpreter
        switch; accepted and unused.

    Returns the advanced ``(B, 3n)`` states. The operators may be tensors on
    ``x``'s device in its dtype or host arrays (uploaded on each call).
    CPU tensors run the plain twin; CUDA tensors one kernel launch.
    """
    del tile, interpret
    if x.device.type == "cpu":
        return fused_gen_alpha_steps_plain(mats, drag_coeffs, u, x, steps, h,
                                           rho_inf, n_newton)
    _build.refuse_grad("fused_gen_alpha_steps", *mats, drag_coeffs, u, x)
    operands = _checked("fused_gen_alpha_steps", mats, drag_coeffs, u, x)
    x = operands[-1]
    out = torch.empty_like(x)
    if x.shape[0] == 0 or steps <= 0:
        return out.copy_(x)
    _launch("fused_gen_alpha_steps", operands, 1, steps, h, rho_inf, n_newton, out, None)
    fused_gen_alpha_steps.launches += 1
    return out


def fused_gen_alpha_frames(mats, drag_coeffs, u, x: torch.Tensor, n_frames: int,
                           substeps: int, h: float, rho_inf: float = 0.8,
                           n_newton: int = 2) -> torch.Tensor:
    """``n_frames`` frames of ``substeps`` fused generalized-α steps in one
    launch; returns every frame's ``[q; v]``, ``(n_frames + 1, B, 2n)``,
    frame 0 being ``x``'s. Arguments as in :func:`fused_gen_alpha_steps`;
    the state stays on chip from the first step to the last, as the JAX
    package's ``lax.scan`` over its kernel keeps it on the TPU. CPU tensors
    run the plain twin."""
    if x.device.type == "cpu":
        return fused_gen_alpha_frames_plain(mats, drag_coeffs, u, x, n_frames, substeps, h,
                                            rho_inf, n_newton)
    _build.refuse_grad("fused_gen_alpha_frames", *mats, drag_coeffs, u, x)
    operands = _checked("fused_gen_alpha_frames", mats, drag_coeffs, u, x)
    x = operands[-1]
    B, n = x.shape[0], x.shape[1] // 3
    n_frames = max(int(n_frames), 0)  # as the twin's loop reads a negative count
    frames = torch.empty((n_frames + 1, B, 2 * n), dtype=x.dtype, device=x.device)
    if B == 0:
        return frames
    _launch("fused_gen_alpha_frames", operands, n_frames, max(int(substeps), 0), h,
            rho_inf, n_newton, None, frames)
    fused_gen_alpha_frames.launches += 1
    return frames


fused_gen_alpha_steps.launches = 0
fused_gen_alpha_frames.launches = 0

KERNELS = (fused_gen_alpha_steps, fused_gen_alpha_frames)


def reset_launch_counts() -> None:
    """Set the kernel wrappers' launch counts to 0."""
    for fn in KERNELS:
        fn.launches = 0


def fused_host_operators(model, h: float, rho_inf: float = 0.8):
    """Host float64 ``(M, K, Jinv, Minv)`` of a purely linear beam: the
    dense reduced mass and zero-state stiffness, the inverse generalized-α
    Jacobian at step ``h`` and the inverse mass. Raises ``ValueError`` for
    a beam with any nonlinear element."""
    from ...models.simulate import reduce_matrix_dense  # local import, avoid cycle

    arrays = model.beam_model.arrays
    if bool(np.any(np.asarray(arrays.nonlinear_mask))):
        raise ValueError("fused_rollout requires a purely linear beam")
    am, af, beta = gen_alpha_params(rho_inf)
    M = np.asarray(model.beam_model.M.toarray(), np.float64)
    K = reduce_matrix_dense(arrays, model.beam_model.bc_info.free_dofs, False)
    Jinv = np.linalg.inv((1.0 - am) * M + (1.0 - af) * beta * h * h * K)
    return M, K, Jinv, np.linalg.inv(M)


def fused_rollout(model, x0, t_final: float, dt: float, u=None, substeps: int = 20,
                  rho_inf: float = 0.8, n_newton: int = 2, tile: int = 512,
                  interpret: bool = False, device=None):
    """Full fused-kernel rollout of a linear(+drag) beam model.

    ``x0``: ``(B, 2n)`` reduced states ``[q; v]``, a tensor (kept on its
    device unless ``device`` is given) or a NumPy array (put on ``device``,
    by default the card: raises when there is none; pass ``device="cpu"``
    for the plain twin); its dtype is the rollout's. ``u``: constant force
    ``(n,)`` or None. Host float64 set-up (dense M, K, J^-1, M^-1), the
    consistent initial acceleration ``a0 = M^-1 (u - K q0 - c v0 |v0|)``,
    then one :func:`fused_gen_alpha_frames` launch for every frame
    (``substeps`` steps each). ``tile``/``interpret`` are accepted and
    unused. Returns ``(ts (frames+1,), ys (frames+1, B, 2n))``.
    """
    from ...models.simulate import resolve_device  # local import, avoid cycle

    del tile, interpret
    h = dt / substeps
    M, K, Jinv, Minv = fused_host_operators(model, h, rho_inf)
    if isinstance(x0, torch.Tensor):
        x0 = x0 if device is None else x0.to(device)
    else:
        x0 = torch.as_tensor(np.asarray(x0), device=resolve_device(device))
    B, two_n = x0.shape
    n = two_n // 2
    u_vec = np.zeros(n) if u is None else u
    M_t, K_t, J_t, c_t, u_t = _operands((M, K, Jinv), drag_coefficient_vector(model),
                                        u_vec, x0)
    Minv_t = torch.as_tensor(Minv, dtype=x0.dtype, device=x0.device)

    q0, v0 = x0[:, :n], x0[:, n:]
    f0 = u_t - q0 @ K_t.mT - c_t * v0 * v0.abs()
    x = torch.cat([q0, v0, f0 @ Minv_t.mT], dim=-1)
    n_frames = int(round(t_final / dt))
    ys = fused_gen_alpha_frames((M_t, K_t, J_t), c_t, u_t, x, n_frames, substeps, h,
                                rho_inf=rho_inf, n_newton=n_newton)
    ts = dt * torch.arange(n_frames + 1, dtype=torch.float64, device=x0.device)
    return ts, ys


def drag_coefficient_vector(model) -> np.ndarray:
    """Per-reduced-DOF quadratic drag coefficients for the fused kernel.

    In reduced coordinates the fluid force lands at the same index the
    transverse velocity is read from (``forces.FluidDragForce``), so the
    whole force is ``f_i = -c_i v_i |v_i|`` with ``c_i`` nonzero at 'w' DOFs.
    Returns zeros when no fluid force is registered.
    """
    from ...models.forces import FluidDragForce  # local import, avoid cycle

    c = np.zeros(model.n_pos_states)
    for f in model.force_registry.get_registered_forces():
        if isinstance(f, FluidDragForce) and f.is_enabled() and f.fluid_coefficients:
            fc = f.fluid_coefficients
            c[np.asarray(fc["w_pos_indices"])] += np.asarray(fc["drag_factors"])
    return c

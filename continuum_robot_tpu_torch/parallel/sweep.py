"""Parameter sweeps: batched beam configurations as tensors, differentiable.

Counterpart of ``continuum_robot_tpu/parallel/sweep.py``. The reference
sweeps configurations by writing one CSV per variant and farming separate
processes. Here a :class:`~continuum_robot_tpu_torch.models.config.BeamArrays`
whose fields are tensors with a leading axis ``(n_envs, E)`` is a *batch of
beams*, rolled out as one program over both the configuration and the
initial state (the JAX package's ``jax.vmap`` becomes that leading batch
axis, which the banded ops and the element functions broadcast over).
Every operator is built from the tensors with torch ops, so the rollouts
are **differentiable in the physical parameters**:

* reverse mode is torch's autograd: ``loss.backward()`` (or
  ``torch.autograd.grad``) through a rollout reaches elastic modulus,
  lengths, densities, drag coefficients... (``remat=True`` checkpoints a
  step or a frame: ``torch.utils.checkpoint``);
* forward mode is ``torch.func.jvp`` of the rollout in the parameters. It
  composes with the tangent stiffness's own ``torch.func.jvp`` and with the
  adaptive drivers' host reads of their loop flag (a read sees the
  primal), which ``torch.autograd.forward_ad`` dual tensors do not (forward
  AD does not nest).

The mass (and for the implicit paths the effective Jacobian) depends on the
swept parameters, so each environment factors its own block-tridiagonal
system on the device with the plain sweeps of ``ops/banded.py``
(``btd_factor``, ``btd_solve``: the JAX package computes these outside any
Pallas kernel too; the CUDA ``btd_solve`` kernel takes one ``T`` shared by
the batch). There is no host-side precomputation in this path.

Devices: tensors stay where they are; host arrays go to ``device`` (None:
the card, which raises without one; pass ``device="cpu"`` for the CPU),
in float64 unless a tensor input says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models import assembly, elements
from ..models.config import BeamArrays
from ..models.simulate import resolve_device
from ..ops import banded, integrators

_FIELDS = tuple(f.name for f in dataclasses.fields(BeamArrays))


def _mm(a, b):
    """``a @ b`` in true float32/float64: the JAX package's
    ``precision=HIGHEST`` (TF32 is off from the package's import)."""
    return torch.matmul(a, b)


def _placement(device, dtype, *objs):
    """``(device, dtype)`` for host inputs: those of the first floating
    tensor among ``objs`` (a tensor, or a :class:`BeamArrays` with tensor
    fields), else ``device`` (None: the card) and ``dtype`` (None:
    float64)."""
    for obj in objs:
        fields = ([getattr(obj, f) for f in _FIELDS] if isinstance(obj, BeamArrays)
                  else [obj])
        for x in fields:
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return (x.device if device is None else torch.device(device),
                        x.dtype if dtype is None else dtype)
    return resolve_device(device), (torch.float64 if dtype is None else dtype)


def _mask(x, device):
    """The element-type mask: a host array stays on the host (the element
    force then skips a branch no element takes), a tensor goes to
    ``device`` as bool."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return np.asarray(x, dtype=bool)


def _tensor_arrays(arrays: BeamArrays, device, dtype) -> BeamArrays:
    """``arrays`` with every float field a tensor on ``device`` in
    ``dtype`` (tensors keep their graph); the mask as :func:`_mask`."""
    return BeamArrays(**{
        f: (_mask(getattr(arrays, f), device) if f == "nonlinear_mask"
            else assembly._field_like(getattr(arrays, f), dtype, device))
        for f in _FIELDS})


def _params(arrays: BeamArrays):
    """The element functions' ``(L, E, I, A, nonlinear_mask)``."""
    return (arrays.length, arrays.elastic_modulus, arrays.moment_inertia,
            arrays.cross_area, arrays.nonlinear_mask)


def tile_arrays(arrays: BeamArrays, n: int, device=None, dtype=None) -> BeamArrays:
    """Replicate a configuration into an ``(n, E)`` batched
    :class:`BeamArrays` (broadcast views): float fields as tensors (tensor
    fields keep their graph; host arrays go to ``device`` in ``dtype``, see
    the module), the element-type mask where it was (:func:`_mask`)."""
    device, dtype = _placement(device, dtype, arrays)
    t = _tensor_arrays(arrays, device, dtype)

    def tile(x):
        xp = torch if isinstance(x, torch.Tensor) else np
        return xp.broadcast_to(x, (int(n), *x.shape))

    return BeamArrays(**{f: tile(getattr(t, f)) for f in _FIELDS})


def override_arrays(arrays: BeamArrays, *, device=None, dtype=None, **columns) -> BeamArrays:
    """Batched copies of ``arrays`` with some fields replaced.

    Each keyword maps a field name to an array or tensor of shape
    ``(n_envs, E)`` or ``(n_envs, 1)`` (broadcast over elements). Tensor
    columns keep their graph, so a loss differentiates through them.
    Example::

        sweep = override_arrays(model.beam_model.arrays,
                                elastic_modulus=E_samples[:, None])

    ``device`` / ``dtype`` place host inputs when no column is a tensor.
    """
    if not columns:
        raise ValueError("provide at least one override column")
    for k in columns:
        if k not in _FIELDS:
            raise ValueError(f"BeamArrays has no field {k!r}")
    n = next(iter(columns.values())).shape[0]
    device, dtype = _placement(device, dtype, *columns.values(), arrays)
    batched = tile_arrays(arrays, n, device, dtype)
    updates = {}
    for k, v in columns.items():
        shape = getattr(batched, k).shape
        if k == "nonlinear_mask":
            v = _mask(v, device)
            updates[k] = (torch if isinstance(v, torch.Tensor) else np).broadcast_to(v, shape)
        else:
            updates[k] = torch.broadcast_to(assembly._field_like(v, dtype, device), shape)
    return dataclasses.replace(batched, **updates)


def _free_bookkeeping(bc_info):
    free = np.asarray(bc_info.free_dofs)
    n_nodes = bc_info.n_nodes
    return free, bc_info.n_dofs_full, n_nodes, bc_info.free_mask.reshape(n_nodes, 3)


def make_parametric_rhs(
    bc_info,
    forces_func: Optional[Callable] = None,
    use_consistent: bool = False,
) -> Callable:
    """Pure ``rhs(t, x_red, u, arrays)``: beam parameters are an argument.

    Unlike ``DynamicEulerBernoulliBeam.build_rhs`` (which closes over one
    fixed configuration with a prefactored mass inverse), this factors the
    block-tridiagonal mass of the given ``arrays`` on the device every call
    (plain ``banded.btd_factor`` / ``btd_solve``), so ``arrays`` may be a
    batch ``(n_envs, E)`` against states ``(n_envs, 2n)`` and every
    physical parameter is differentiable. Fields that are host arrays go to
    ``x``'s device and dtype, tensors are cast to them (keeping their graph).
    ``forces_func(x, t, arrays)`` adds a force over the position DOFs; ``u``
    is None, a constant or a callable of ``t``.
    """
    free, n_full, n_nodes, mask_nodes = _free_bookkeeping(bc_info)

    def rhs(t, x, u, arrays: BeamArrays):
        arrays = _tensor_arrays(arrays, x.device, x.dtype)
        n = x.shape[-1] // 2
        q, v = x[..., :n], x[..., n:]

        q_full = assembly.pad_to_full(q, free, n_full)
        k_full = assembly.internal_force_full(arrays, q_full, use_consistent=use_consistent)
        f = -assembly.reduce_from_full(k_full, free)
        if forces_func is not None:
            f = f + forces_func(x, t, arrays)
        if u is not None:
            f = f + torch.as_tensor(u(t) if callable(u) else u, dtype=x.dtype,
                                    device=x.device)

        diag, off = assembly.mass_block_tridiagonal(arrays)
        factors = banded.btd_factor(*banded.btd_apply_bc(diag, off.transpose(-1, -2), off,
                                                         mask_nodes))
        f_nodes = assembly.pad_to_full(f, free, n_full).reshape(*f.shape[:-1], n_nodes, 3)
        acc_full = banded.btd_solve(factors, f_nodes).reshape(*f.shape[:-1], n_full)
        acc = assembly.reduce_from_full(acc_full, free)
        return torch.cat([v, acc], dim=-1)

    return rhs


def _state(x0, arrays, device):
    """``x0`` as a tensor: a tensor as it is, a host array on the arrays'
    (or ``device``'s) device in their dtype (float64 by default)."""
    if isinstance(x0, torch.Tensor):
        return x0
    dev, dtype = _placement(device, None, arrays)
    return torch.as_tensor(np.asarray(x0), dtype=dtype, device=dev)


def parametric_rollout(
    bc_info,
    arrays_batch: BeamArrays,
    x0_batch,
    t_final: float,
    dt: float,
    u=None,
    forces_func: Optional[Callable] = None,
    substeps: int = 1,
    use_consistent: bool = False,
    device=None,
):
    """Batched RK4 rollout over ``(configuration, initial state)`` pairs.

    ``arrays_batch``: fields ``(n_envs, E)`` (or unbatched, shared);
    ``x0_batch``: ``(n_envs, 2n)``. Returns ``(ts, ys (frames, envs,
    state))``, differentiable in ``arrays_batch`` and ``x0_batch``.
    """
    rhs = make_parametric_rhs(bc_info, forces_func, use_consistent)
    n_steps = int(round(t_final / dt))
    x0 = _state(x0_batch, arrays_batch, device)
    arrays = _tensor_arrays(arrays_batch, x0.device, x0.dtype)

    def rhs_fixed(t, x, uu):
        return rhs(t, x, uu, arrays)

    return integrators.integrate_fixed(rhs_fixed, x0, 0.0, dt, n_steps, u=u,
                                       substeps=substeps)


def _ga_params(rho_inf: float):
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma = 0.5 - am + af
    return am, af, beta, gamma


def make_traced_genalpha_operator(
    bc_info,
    arrays: BeamArrays,
    dt: float,
    rho_inf: float = 0.8,
    use_consistent: bool = False,
    modified_newton: bool = True,
    forces_func: Optional[Callable] = None,
    device=None,
    dtype=None,
):
    """Implicit-stepper operators built only from tensor ops on ``arrays``.

    ``models/simulate.make_newmark_operator`` prefactors on the host in
    float64: the fast path for a fixed configuration, but opaque to
    derivatives in the physical parameters. This variant assembles, masks
    and factors the operators with torch ops (``ops/banded.py``'s plain
    factorization and sweeps), so a generalized-alpha rollout on it is
    differentiable in every ``BeamArrays`` field and runs a configuration
    batch (fields ``(n_envs, E)`` against states ``(n_envs, n)``).

    ``solve(q, c, a=1.0)`` keeps the operator contract: for host numbers
    ``(a, c)`` it returns the prefactored pairs (the mass ``(1, 0)`` and the
    generalized-alpha Jacobian at ``dt`` under modified Newton), otherwise
    it factors ``a M + c K_tan(q)`` at the call: a tensor ``c`` (the adaptive
    steppers' trial ``dt``, 0-d or a ``(B, 1)`` column) has no prefactor.
    ``tangent_frozen`` is ``modified_newton`` or an all-linear element mask
    (the JAX package's rule; the mask is always concrete here). Host
    arrays go to ``device`` in ``dtype`` (module docs); ``forces_func(x, t,
    arrays)`` may read the parameters too.
    """
    free, n_full, n_nodes, mask_nodes = _free_bookkeeping(bc_info)
    device, dtype = _placement(device, dtype, arrays)
    arrays = _tensor_arrays(arrays, device, dtype)

    am, af, beta, _ = _ga_params(rho_inf)
    c_eff = (1.0 - af) * beta * dt * dt
    a_eff = 1.0 - am

    m_diag, m_off = assembly.mass_block_tridiagonal(arrays)
    mm_diag, mm_lower, mm_upper = banded.btd_apply_bc(
        m_diag, m_off.transpose(-1, -2), m_off, mask_nodes)

    def pad(r):
        return assembly.pad_to_full(r, free, n_full)

    def red(v):
        return assembly.reduce_from_full(v, free)

    def mass_apply(a_red):
        a_nodes = pad(a_red).reshape(*a_red.shape[:-1], n_nodes, 3)
        out = banded.btd_matvec(mm_diag, mm_lower, mm_upper, a_nodes)
        return red(out.reshape(*out.shape[:-2], n_full))

    mask = arrays.nonlinear_mask
    all_linear = not bool(mask.any())
    Ke = k_bands = None
    if isinstance(mask, np.ndarray) and not mask.any():
        # Linear elements only: the element stiffness is the tangent at every
        # state; built once (the element force and its tangent would
        # rebuild it every call, with the same values).
        Ke = elements.linear_stiffness_matrix(*_params(arrays)[:4])
        k_bands = (assembly._sum_node_blocks(Ke), Ke[..., 3:6, 0:3], Ke[..., 0:3, 3:6])

    def internal_force(q_red):
        if Ke is not None:
            q6 = assembly.gather_element_states(pad(q_red))
            return red(assembly.scatter_add_element_forces(
                torch.einsum("...ij,...j->...i", Ke, q6)))
        return red(assembly.internal_force_full(arrays, pad(q_red),
                                                use_consistent=use_consistent))

    def factors_at(q_full, c, a):
        kd, kl, ku = k_bands or assembly.tangent_block_tridiagonal(
            arrays, q_full, use_consistent=use_consistent, params=_params(arrays))
        jd, jl, ju = banded.btd_apply_bc(a * mm_diag + c * kd, a * mm_lower + c * kl,
                                         a * mm_upper + c * ku, mask_nodes)
        return banded.btd_factor(jd, jl, ju)

    prefactored = {}
    if modified_newton:
        q_zero = m_diag.new_zeros(m_diag.shape[:-3] + (n_full,))
        prefactored = {(1.0, 0.0): factors_at(q_zero, 0.0, 1.0),
                       (a_eff, c_eff): factors_at(q_zero, c_eff, a_eff)}

    def solve(q_red, c, a=1.0):
        # The factorization happens here: a held closure reuses one factored
        # system across applications (make_newmark_operator's contract).
        traced = isinstance(c, torch.Tensor) or isinstance(a, torch.Tensor)
        key = None if traced else (float(a), float(c))
        if key in prefactored:
            factors = prefactored[key]
        else:
            if isinstance(c, torch.Tensor) and c.dim() > 0:
                c = c[..., None, None]  # (B, 1) -> (B, 1, 1, 1) against the bands
            factors = factors_at(pad(q_red), c, a)

        def do_solve(r_red):
            r_nodes = pad(r_red).reshape(*r_red.shape[:-1], n_nodes, 3)
            x = banded.btd_solve(factors, r_nodes)
            return red(x.reshape(*x.shape[:-2], n_full))

        return do_solve

    external_force = None
    if forces_func is not None:
        def external_force(x, t):
            return forces_func(x, t, arrays)

    return integrators.NewmarkOperator(
        mass_apply=mass_apply,
        internal_force=internal_force,
        external_force=external_force,
        solve=solve,
        tangent_frozen=bool(modified_newton or all_linear),
    )


def parametric_modal_rom_rollout(
    ms,
    bc_info,
    arrays_batch: BeamArrays,
    eta0_batch,
    etad0_batch,
    u_modal=None,
    n_steps: int = 100,
    rho_inf: float = 0.5,
    n_newton: int = 1,
    use_consistent: bool = False,
    remat: bool = False,
    save_every: int = 0,
    device=None,
):
    """Differentiable modal-ROM rollout: gradients at ROM speed.

    The Petrov-Galerkin ROM recurrence with the beam parameters as tensor
    inputs and the bases ``ms.Phi`` / ``ms.PhiW`` (a
    :class:`~continuum_robot_tpu_torch.models.simulate.ModalROMGenAlpha`)
    **frozen** at their trained configuration, so system identification
    runs at 1000-element scale at ROM cost a step: two ``(n x m)`` basis
    products, the exact element force and ``m x m`` reduced solves.

    Frozen-basis caveat: the gradient is the exact derivative of the ROM
    whose basis was trained at the nominal parameters, not of a re-trained
    ROM (valid where the trained basis still spans the response; re-train
    and re-linearize for large parameter steps). The reduced operators are
    rebuilt from the parameters: ``Mr = W^T M(theta) Phi``, ``K0r = W^T
    K0(theta) Phi`` and the effective inverse by ``torch.linalg.inv`` (m x
    m, differentiable), so biorthonormality is not assumed away from the
    nominal configuration.

    ``arrays_batch``: fields ``(n_envs, E)``; ``eta0_batch``,
    ``etad0_batch``: ``(n_envs, m)`` (their dtype and device are the
    rollout's); ``u_modal``: ``(m,)`` shared, or None. Returns ``(etas,
    etads)``: the final states ``(n_envs, m)``, or with ``save_every > 0``
    every ``save_every``-th step's, ``(n_envs, n_steps // save_every, m)``
    (the JAX package's vmapped layout). ``remat`` checkpoints each step
    under reverse mode (``torch.utils.checkpoint``). Products are true
    float32/float64 (the JAX package's ``precision=HIGHEST``).
    """
    free, n_full, n_nodes, mask_nodes = _free_bookkeeping(bc_info)
    am, af, beta, gamma = _ga_params(rho_inf)
    dt = ms.dt
    c_eff = (1.0 - af) * beta * dt * dt
    a_eff = 1.0 - am

    eta0 = _state(eta0_batch, arrays_batch, device)
    dtype, dev = eta0.dtype, eta0.device
    etad0 = torch.as_tensor(etad0_batch, dtype=dtype, device=dev)
    arrays = _tensor_arrays(arrays_batch, dev, dtype)
    Phi = torch.as_tensor(np.asarray(ms.Phi), dtype=dtype, device=dev)  # (n_red, m) frozen
    W = torch.as_tensor(np.asarray(ms.PhiW), dtype=dtype, device=dev)
    m = Phi.shape[1]

    def pad(r):
        return assembly.pad_to_full(r, free, n_full)

    def red(v):
        return assembly.reduce_from_full(v, free)

    def bvec(M, v):  # per-environment matrix-vector products
        return (M @ v[..., None])[..., 0]

    # Reduced operators from the parameters, frozen bases.
    Phi_nodes = pad(Phi.T).reshape(m, n_nodes, 3)

    def reduced(diag, lower, upper):
        bands = banded.btd_apply_bc(diag, lower, upper, mask_nodes)
        TPhi = banded.btd_matvec(*(b.unsqueeze(-4) for b in bands), Phi_nodes)
        return _mm(W.T, red(TPhi.reshape(*TPhi.shape[:-2], n_full)).transpose(-1, -2))

    m_diag, m_off = assembly.mass_block_tridiagonal(arrays)
    Mr = reduced(m_diag, m_off.transpose(-1, -2), m_off)
    q_zero = m_diag.new_zeros(m_diag.shape[:-3] + (n_full,))
    K0r = reduced(*assembly.tangent_block_tridiagonal(arrays, q_zero,
                                                      use_consistent=use_consistent,
                                                      params=_params(arrays)))
    Sinv = torch.linalg.inv(a_eff * Mr + c_eff * K0r)
    Mr_inv = torch.linalg.inv(Mr)

    def force_modal(eta_af):
        q = _mm(eta_af, Phi.T)
        k_full = assembly.internal_force_full(arrays, pad(q), use_consistent=use_consistent)
        return _mm(red(k_full), W)

    u_m = (eta0.new_zeros(m) if u_modal is None
           else torch.as_tensor(u_modal, dtype=dtype, device=dev))
    etadd0 = bvec(Mr_inv, u_m - force_modal(eta0))

    def step(eta, etad, etadd):
        eta_pred = eta + dt * etad + (0.5 - beta) * dt * dt * etadd
        etad_pred = etad + (1.0 - gamma) * dt * etadd
        a1 = etadd
        for _ in range(int(n_newton)):
            eta1 = eta_pred + beta * dt * dt * a1
            eta_af = (1.0 - af) * eta1 + af * eta
            a_am = (1.0 - am) * a1 + am * etadd
            r = bvec(Mr, a_am) + force_modal(eta_af) - u_m
            a1 = a1 - bvec(Sinv, r)
        return eta_pred + beta * dt * dt * a1, etad_pred + gamma * dt * a1, a1

    def advance(carry):
        if remat:
            return torch.utils.checkpoint.checkpoint(step, *carry, use_reentrant=False)
        return step(*carry)

    carry = (eta0, etad0, etadd0)
    if save_every > 0:
        etas, etads = [], []
        for _ in range(int(n_steps) // int(save_every)):
            for _ in range(int(save_every)):
                carry = advance(carry)
            etas.append(carry[0])
            etads.append(carry[1])
        return torch.stack(etas, dim=-2), torch.stack(etads, dim=-2)
    for _ in range(int(n_steps)):
        carry = advance(carry)
    return carry[0], carry[1]


def parametric_genalpha_rollout(
    bc_info,
    arrays_batch: BeamArrays,
    x0_batch,
    t_final: float,
    dt: float,
    u=None,
    forces_func: Optional[Callable] = None,
    substeps: int = 1,
    rho_inf: float = 0.8,
    n_newton: int = 2,
    use_consistent: bool = False,
    modified_newton: bool = True,
    remat: bool = False,
    device=None,
):
    """Batched implicit rollout, differentiable in the beam parameters.

    The stiff-configuration counterpart of :func:`parametric_rollout`:
    unconditionally stable generalized-alpha stepping whose whole pipeline
    (assembly, BC masking, factorization, solves) is torch ops on the
    parameters (:func:`make_traced_genalpha_operator` on the batch), so
    gradients reach every ``BeamArrays`` field. ``remat`` stores one state
    per frame under reverse mode (``integrate_generalized_alpha(remat=True)``).
    Returns ``(ts, ys (frames, envs, state))``.
    """
    n_steps = int(round(t_final / dt))
    x0 = _state(x0_batch, arrays_batch, device)
    op = make_traced_genalpha_operator(
        bc_info, arrays_batch, dt / substeps, rho_inf=rho_inf,
        use_consistent=use_consistent, modified_newton=modified_newton,
        forces_func=forces_func, device=x0.device, dtype=x0.dtype,
    )
    n = x0.shape[-1] // 2
    ts, qs, vs = integrators.integrate_generalized_alpha(
        op, x0[..., :n], x0[..., n:], 0.0, dt, n_steps, u=u, rho_inf=rho_inf,
        n_newton=n_newton, substeps=substeps, remat=remat,
    )
    return ts, torch.cat([qs, vs], dim=-1)

"""Spatially-sharded implicit stepping: distributed SPIKE solves + gen-α.

Counterpart of ``continuum_robot_tpu/parallel/spatial_implicit.py``: the
implicit engines on the ``sp`` mesh axis, with an exact distributed
block-tridiagonal solve (SPIKE) of ``T x = r`` for ``T`` split by node runs
(S shards of m nodes; shard k's first node couples to its left neighbour's
last by ``L_k``, its last node to its right neighbour's first by ``U_k``):

1. a local factorization of each shard's m-node chain, once per tangent
   (once in all for the modified Newton of these engines);
2. the local spike columns ``V = A_k^{-1} e_0 L_k`` and ``W = A_k^{-1}
   e_last U_k`` (two 3-column solves, kept with the factors);
3. a solve: one local substitution ``y = A_k^{-1} r``, one ``all_gather``
   of 6 values a shard (the interface values of ``y``), the replicated
   ``(6S, 6S)`` interface system (its inverse kept) and a local update.

The local solve is ``"thomas"`` (block Thomas: on a CUDA tensor with
factors shared by every environment the hand-written kernel
``ops/cuda/btd_solve``, otherwise the plain sweep of ``ops/banded``),
``"cr"`` (block cyclic reduction) or ``"dense"`` (the ``(3m, 3m)`` inverse
as one matrix product). The default is ``"thomas"`` (the JAX package's
TPU default ``"dense"`` is a TPU workaround; on the H100 the kernel route
is the fastest of the three at the full width of the sharded gen-alpha
row, 1000 elements x 4096 envs float32, as chip_smoke.py's SPIKE phase
measures and checks).

Every rank runs the same program on its node block, environments on
leading axes (split over ``dp``); the engines' rollouts take and return
global node-layout arrays. Adaptive rollouts of a batch control each
environment's step (``per_env`` of ``integrators.adaptive_drive``, the
JAX package's ``vmap``); their error norms are ``psum``-contracted, so
every shard takes the same accept/reject decision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models import assembly
from ..models.config import BeamArrays
from ..ops import banded, integrators
from ..ops.cuda import btd_solve as btd_kernel
from .collectives import (
    MeshAxis,
    all_gather,
    env_block,
    gather_env_blocks,
    left_perm,
    ppermute,
    psum,
    replicated_in,
    right_perm,
)
from .spatial import (
    SpatialBeam,
    _aligned_mass_bands,
    _Consts,
    _gravity_params,
    _local_params,
    element_gravity_masses,
    node_drag_factors,
    spatial_gravity_force_local,
    spatial_internal_force_local,
    spatial_mass_matvec_local,
)

LOCAL_SOLVERS = ("thomas", "cr", "dense")


# ---------------------------------------------------------------------------
# Local (per-shard) operator assembly
# ---------------------------------------------------------------------------


def spatial_tangent_aligned(q_local, params, axis: MeshAxis, use_consistent: bool = False):
    """Shard-aligned tangent-stiffness blocks with the halo exchange.

    Returns ``(kd, klow, kup)``, each ``(..., m, 3, 3)``, in the aligned
    convention of the mass bands: ``klow[0]`` couples the first local node
    to the left neighbour's last node, ``kup[m-1]`` the last local node to
    the right neighbour's first. Two ``ppermute``: pull the right halo node,
    push the bridging element's (K22, K21) to their owner.
    """
    S = axis.size
    halo = ppermute(q_local[..., :1, :], axis, left_perm(S))
    q_ext = torch.cat([q_local, halo], dim=-2)
    q6 = torch.cat([q_ext[..., :-1, :], q_ext[..., 1:, :]], dim=-1)
    Kt = assembly.element_tangent_stiffness(None, q6, use_consistent=use_consistent,
                                            params=params)  # (..., m, 6, 6)
    kd = Kt[..., :, 0:3, 0:3].clone()  # K11 of element j -> node j
    kd[..., 1:, :, :] += Kt[..., :-1, 3:6, 3:6]  # K22 of element j -> node j+1
    kup = Kt[..., :, 0:3, 3:6].clone()  # entry m-1: U_k, last node -> right halo
    klow = torch.zeros_like(kd)
    klow[..., 1:, :, :] = Kt[..., :-1, 3:6, 0:3]
    # The bridging element's far-node blocks belong to the right neighbour:
    # K22 joins its diagonal node 0, K21 becomes its L_k.
    send = torch.stack([Kt[..., -1, 3:6, 3:6], Kt[..., -1, 3:6, 0:3]], dim=-3)
    recv = ppermute(send, axis, right_perm(S))
    kd[..., 0, :, :] += recv[..., 0, :, :]
    klow[..., 0, :, :] = recv[..., 1, :, :]
    return kd, klow, kup


def mask_aligned_blocks(jd, jlow, jup, mask_local, left_last_mask, right_first_mask):
    """BC-mask shard-aligned blocks; unit pivots on constrained diagonals.

    ``mask_local``: ``(m, 3)``; ``left_last_mask`` / ``right_first_mask``:
    ``(3,)``, the host-side free masks of the neighbour nodes the halo
    entries couple to (padding nodes are constrained, which also zeroes the
    ring's wraparound couplings exactly).
    """
    m3 = mask_local
    eye = torch.eye(3, dtype=jd.dtype, device=jd.device)
    jd = jd * m3[:, :, None] * m3[:, None, :] + (1.0 - m3)[:, :, None] * eye
    col_low = torch.cat([left_last_mask[None], m3[:-1]], dim=0)
    jlow = jlow * m3[:, :, None] * col_low[:, None, :]
    col_up = torch.cat([m3[1:], right_first_mask[None]], dim=0)
    jup = jup * m3[:, :, None] * col_up[:, None, :]
    return jd, jlow, jup


# ---------------------------------------------------------------------------
# Distributed SPIKE solve
# ---------------------------------------------------------------------------


def _spike_local_solve(prep, rhs):
    """The factored within-shard solve; ``rhs``: ``(..., m, 3)``."""
    solver = prep["local_solver"]
    if solver == "thomas":
        factors = prep["factors"]
        if factors[0].dim() == 3:  # shared by every environment: the kernel's contract
            return btd_kernel.btd_solve(factors, rhs)
        return banded.btd_solve(factors, rhs)
    if solver == "cr":
        return banded.btd_cr_solve(prep["factors"], rhs)
    flat = rhs.reshape(*rhs.shape[:-2], -1)
    Ainv = prep["Ainv"]
    if Ainv.dim() == 2:
        out = flat @ Ainv.T
    else:
        out = torch.einsum("...ij,...j->...i", Ainv, flat)
    return out.reshape(rhs.shape)


def resolve_local_solver(local_solver) -> str:
    """The within-shard solve: ``local_solver``, by default ``"thomas"``."""
    if local_solver is None:
        return "thomas"
    if local_solver not in LOCAL_SOLVERS:
        raise ValueError(
            f"local_solver must be 'thomas', 'cr' or 'dense', got {local_solver!r}"
        )
    return local_solver


def spike_prepare(jd, jlow, jup, axis: MeshAxis, local_solver: str = "thomas"):
    """Factor a shard-aligned block-tridiagonal operator for SPIKE solves.

    ``jlow[..., 0]`` is ``L_k`` (left inter-shard coupling), ``jup[..., -1]``
    is ``U_k``; blocks ``(..., m, 3, 3)`` (leading axes: one operator an
    environment). Returns the dict :func:`spike_solve` consumes: the local
    factors, the two spike column blocks and the replicated inverse of the
    ``(6S, 6S)`` interface system. The three local solvers are exact
    (algebraically the same result): ``"thomas"`` (O(m) block-Thomas
    sweeps), ``"cr"`` (log-depth block cyclic reduction), ``"dense"`` (the
    ``(3m, 3m)`` local inverse applied as one matrix product).
    """
    if local_solver not in LOCAL_SOLVERS:
        raise ValueError(
            f"local_solver must be 'thomas', 'cr' or 'dense', got {local_solver!r}"
        )
    m = jd.shape[-3]
    batch = tuple(jd.shape[:-3])
    Lk, Uk = jlow[..., 0, :, :], jup[..., -1, :, :]
    jl_in, ju_in = jlow[..., 1:, :, :], jup[..., :-1, :, :]
    if local_solver == "thomas":
        factors = banded.btd_factor(jd, jl_in, ju_in)
        if jd.is_cuda and not batch:
            factors = btd_kernel.pack_factors(factors)
        prep0 = {"local_solver": "thomas", "factors": factors}
    elif local_solver == "cr":
        prep0 = {"local_solver": "cr", "factors": banded.btd_cr_factor(jd, jl_in, ju_in)}
    else:
        A = jd.new_zeros(batch + (m, 3, m, 3))
        idx = torch.arange(m, device=jd.device)
        A[..., idx, :, idx, :] = jd.movedim(-3, 0) if batch else jd
        if m > 1:
            i1 = torch.arange(m - 1, device=jd.device)
            A[..., i1 + 1, :, i1, :] = jl_in.movedim(-3, 0) if batch else jl_in
            A[..., i1, :, i1 + 1, :] = ju_in.movedim(-3, 0) if batch else ju_in
        prep0 = {"local_solver": "dense",
                 "Ainv": torch.linalg.inv(A.reshape(batch + (3 * m, 3 * m)))}

    def solve_cols(rhs_blocks):
        # (..., m, 3, 3) block right-hand side: solve each of its 3 columns.
        x = _spike_local_solve(prep0, rhs_blocks.movedim(-1, 0))
        return x.movedim(0, -1)

    V = jd.new_zeros(jd.shape)
    V[..., 0, :, :] = Lk
    V = solve_cols(V)
    W = jd.new_zeros(jd.shape)
    W[..., m - 1, :, :] = Uk
    W = solve_cols(W)

    S = axis.size
    g = all_gather(torch.stack([V[..., 0, :, :], V[..., -1, :, :],
                                W[..., 0, :, :], W[..., -1, :, :]]), axis)
    gV0, gVl, gW0, gWl = g.unbind(1)  # each (S, ..., 3, 3), by shard
    eye = torch.eye(3, dtype=jd.dtype, device=jd.device)
    Mred = jd.new_zeros(batch + (S, 2, 3, S, 2, 3))
    for k in range(S):
        km1, kp1 = (k - 1) % S, (k + 1) % S
        Mred[..., k, 0, :, k, 0, :] += eye
        Mred[..., k, 1, :, k, 1, :] += eye
        Mred[..., k, 0, :, km1, 1, :] += gV0[k]
        Mred[..., k, 1, :, km1, 1, :] += gVl[k]
        Mred[..., k, 0, :, kp1, 0, :] += gW0[k]
        Mred[..., k, 1, :, kp1, 0, :] += gWl[k]
    Mred_inv = torch.linalg.inv(Mred.reshape(batch + (6 * S, 6 * S)))
    return {**prep0, "V": V, "W": W, "Mred_inv": Mred_inv}


def spike_solve(prep, r_local, axis: MeshAxis):
    """Exact distributed solve ``T x = r`` from :func:`spike_prepare`.

    A call: one local substitution, one ``all_gather`` of the 6 interface
    values a shard, one replicated ``(6S, 6S)`` product, one local rank-2
    correction. ``r_local``: ``(..., m, 3)``.
    """
    S = axis.size
    y = _spike_local_solve(prep, r_local)
    g = all_gather(torch.stack([y[..., 0, :], y[..., -1, :]], dim=-2), axis)  # (S, ..., 2, 3)
    g = g.movedim(0, -3).reshape(*y.shape[:-2], 6 * S)
    Mi = prep["Mred_inv"]
    z = (g @ Mi.T if Mi.dim() == 2 else torch.einsum("...ij,...j->...i", Mi, g))
    z = z.reshape(*y.shape[:-2], S, 2, 3)
    k = axis.index
    l_left = z[..., (k - 1) % S, 1, :]
    f_right = z[..., (k + 1) % S, 0, :]
    return y - _spike_apply(prep["V"], l_left) - _spike_apply(prep["W"], f_right)


def _spike_apply(cols, vec):
    """``cols (..., m, 3, 3) @ vec (..., 3)`` for every node."""
    if cols.dim() == 3:
        return torch.einsum("nij,...j->...ni", cols, vec)
    return torch.einsum("...nij,...j->...ni", cols, vec)


# ---------------------------------------------------------------------------
# The shared setup of the three implicit engines
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Traced parameters (arrays=): the operands rebuilt from tensors
# ---------------------------------------------------------------------------


def _traced_mass_bands(arrays, Np: int, like):
    """Shard-aligned consistent-mass bands ``(Np, 3, 3)`` each from tensor
    parameters (the torch twin of :func:`spatial._aligned_mass_bands`, the
    same truncation and zero rows), cast to ``like``'s dtype."""
    diag, off = assembly.mass_block_tridiagonal(arrays)
    md = diag[:Np].to(like.dtype)
    off = off[: Np - 1].to(like.dtype)
    z33 = like.new_zeros((1, 3, 3))
    return md, torch.cat([z33, off.transpose(-1, -2)]), torch.cat([off, z33])


def _traced_drag_factors(arrays, n_real: int, Np: int, fluid_density: float, like):
    """The torch twin of :func:`spatial.node_drag_factors` (the final-node
    quirk included): ``(Np, 3)``, the factor on the w DOF."""
    w = arrays.wetted_area.to(like.dtype)
    c = arrays.drag_coef.to(like.dtype)
    half_rho = 0.5 * fluid_density
    fac_w = torch.cat([half_rho * w[: n_real - 1] * c[: n_real - 1],
                       (half_rho * w[n_real - 2] * c[n_real - 2])[None],
                       like.new_zeros(Np - n_real)])
    z = like.new_zeros(Np)
    return torch.stack([z, fac_w, z], dim=-1)


def _traced_gravity_masses(arrays, n_real: int, like):
    """The torch twin of :func:`spatial.element_gravity_masses`."""
    m = (arrays.density * arrays.cross_area * arrays.length).to(like.dtype)
    return torch.cat([m[: n_real - 1], like.new_zeros(m.shape[0] - n_real + 1)])


def traced_arrays(beam: SpatialBeam, arrays: BeamArrays, like) -> BeamArrays:
    """``arrays`` for a rollout's ``arrays=``: fields of the padded length
    ``Np`` (like ``beam.arrays``), float fields as tensors on ``like``'s
    device (a tensor keeps its dtype and its graph, a host array becomes
    float64), the mask as bool. Every rank holds them alike: they enter
    through :func:`collectives.replicated_in` on the ``dp`` axis
    (``beam.local`` does the ``sp`` axis)."""
    dev = like.device
    n_el = np.shape(arrays.length)[-1]
    if n_el != beam.n_nodes:
        raise ValueError(f"arrays= has {n_el} elements; the sharded beam takes "
                         f"{beam.n_nodes} (padded, like beam.arrays)")
    out = {}
    for f in dataclasses.fields(BeamArrays):
        x = getattr(arrays, f.name)
        if f.name == "nonlinear_mask":
            out[f.name] = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                          else x, device=dev).to(torch.bool)
        else:
            out[f.name] = replicated_in(assembly._field_like(
                x, x.dtype if isinstance(x, torch.Tensor) else torch.float64, dev), beam.dp)
    return BeamArrays(**out)


def _implicit_setup(beam: SpatialBeam, fluid_density, gravity, use_consistent):
    """Host constants of the implicit engines, a memo of their local
    tensors per device and dtype, and their traced counterpart.

    Shard-aligned mass bands without BC masking (masking is applied on the
    assembled operators and on matvec inputs), the static neighbour seam
    masks (shard k's rows are the free masks of its neighbours' interface
    nodes; the ring's seams get zeros, which zero the wraparound couplings
    exactly), the drag factors and gravity masses. The zero-state tangent
    (the modified Newton of every engine) is environment-independent, so
    its blocks are computed once per device and dtype.

    ``traced(like, arrays)`` builds the same local tensors from tensor
    parameters (a rollout's ``arrays=``: the JAX package's
    ``_operand_arrays``), every call and without the memo: the mass bands,
    element fields, drag factors, gravity masses and the zero-state tangent
    then carry the parameters' graph and tangents.
    """
    S, Np = beam.n_shards, beam.n_nodes
    sp = beam.sp
    mask_nodes = np.asarray(beam.free_mask, dtype=np.float64)
    mdiag, mlow, mup = _aligned_mass_bands(beam)
    m_per = Np // S
    left_last = np.vstack([np.zeros(3), mask_nodes[m_per - 1::m_per][: S - 1]])
    right_first = np.vstack([mask_nodes[m_per::m_per][: S - 1], np.zeros(3)])
    has_fluid = fluid_density is not None
    dfac = node_drag_factors(beam, float(fluid_density)) if has_fluid else np.zeros((Np, 3))
    has_gravity, g_x, g_y = _gravity_params(gravity)
    gmass = element_gravity_masses(beam) if has_gravity else np.zeros(Np)

    def t(a, like, dim=0):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
        return beam.local(a, dim)

    def derived(c, like):
        c["md_bc"], c["ml_bc"], c["mu_bc"] = mask_aligned_blocks(
            c["md"], c["ml"], c["mu"], c["m3"], c["llm3"], c["rfm3"])
        q0 = like.new_zeros((m_per, 3))
        c["kd"], c["klow"], c["kup"] = spatial_tangent_aligned(
            q0, c["params"], sp, use_consistent)
        return c

    def static(like):
        k = sp.index
        return dict(
            m3=t(mask_nodes, like),
            llm3=torch.as_tensor(left_last[k], dtype=like.dtype, device=like.device),
            rfm3=torch.as_tensor(right_first[k], dtype=like.dtype, device=like.device),
        )

    def build(like):
        c = dict(static(like), md=t(mdiag, like), ml=t(mlow, like), mu=t(mup, like),
                 dfac=t(dfac, like), gmass=t(gmass, like), params=_local_params(beam, like))
        return derived(c, like)

    def traced(like, arrays):
        arrays = traced_arrays(beam, arrays, like)
        n_real = beam.n_nodes_real
        md, ml, mu = _traced_mass_bands(arrays, Np, like)
        dfac_t = (_traced_drag_factors(arrays, n_real, Np, float(fluid_density), like)
                  if has_fluid else like.new_zeros((Np, 3)))
        gmass_t = (_traced_gravity_masses(arrays, n_real, like) if has_gravity
                   else like.new_zeros(Np))
        params = tuple(beam.local(p, dim=0) for p in assembly.element_params(arrays, like))
        c = dict(static(like), md=t(md, like), ml=t(ml, like), mu=t(mu, like),
                 dfac=t(dfac_t, like), gmass=t(gmass_t, like), params=params)
        return derived(c, like)

    return dict(consts=_Consts(build), traced=traced, has_fluid=has_fluid,
                has_gravity=has_gravity, g_x=g_x, g_y=g_y)


def _engine_consts(setup, like, arrays):
    """The local tensors of a rollout: the memo's, or traced from
    ``arrays``."""
    if arrays is None:
        return setup["consts"](like)
    return setup["traced"](like, arrays)


class _Forces:
    """The force terms every implicit engine shares, on one shard."""

    def __init__(self, c, sp, setup, node_force, use_consistent):
        self.c, self.sp, self.s = c, sp, setup
        self.node_force, self.use_consistent = node_force, use_consistent

    def internal(self, q):
        m3 = self.c["m3"]
        return spatial_internal_force_local(q * m3, self.c["params"], m3, self.sp,
                                            self.use_consistent)

    def internal_jvp(self, q, dq):
        m3 = self.c["m3"]
        return spatial_internal_force_local(q * m3, self.c["params"], m3, self.sp,
                                            self.use_consistent, dq_local=dq * m3)[1]

    def mass_apply(self, a):
        c = self.c
        m3 = c["m3"]
        return spatial_mass_matvec_local(a * m3, c["md_bc"], c["ml_bc"], c["mu_bc"],
                                         self.sp) * m3

    def drag(self, v_at):
        # Node-local quadratic transverse drag residual term (+fac v|v|:
        # the residual carries minus the external force).
        return self.c["dfac"] * v_at * v_at.abs()

    def grav(self, q_at):
        m3 = self.c["m3"]
        return spatial_gravity_force_local(q_at * m3, self.c["gmass"], self.s["g_x"],
                                           self.s["g_y"], m3, self.sp)

    def nf(self, q_at, v_at, t_at):
        m3 = self.c["m3"]
        return self.node_force(torch.stack([q_at * m3, v_at * m3], dim=-3), t_at) * m3

    def prep(self, a_coef, c_coef, local_solver):
        """SPIKE prep of ``a M + c K0`` (``c`` a float or a per-environment
        tensor), BC-masked."""
        c = self.c
        if isinstance(c_coef, torch.Tensor) and c_coef.dim() > 0:
            c_coef = c_coef[..., None, None, None]
        jd = a_coef * c["md"] + c_coef * c["kd"]
        jl = a_coef * c["ml"] + c_coef * c["klow"]
        ju = a_coef * c["mu"] + c_coef * c["kup"]
        jd, jl, ju = mask_aligned_blocks(jd, jl, ju, c["m3"], c["llm3"], c["rfm3"])
        return spike_prepare(jd, jl, ju, self.sp, local_solver)

    def genalpha_step(self, prep, q, v, a, u_m, h, t, dt, coeffs, n_newton, has_nf):
        """One modified-Newton gen-α step of the node-layout engines: ``h``
        the step (a float, or a column ``(..., 1, 1)`` of per-environment
        steps), ``dt`` the same as a float or ``(...,)``, ``t`` the step's
        start time (only ``node_force`` reads it). Drag and ``node_force``
        enter the residual at the alpha-point velocity; gravity at the
        alpha-point state. Returns ``(q1, v1, a1)``."""
        am, af, beta, gamma = coeffs
        s, m3 = self.s, self.c["m3"]
        q_pred = q + h * v + (0.5 - beta) * h * h * a
        v_pred = v + (1.0 - gamma) * h * a
        a1 = a
        for _ in range(int(n_newton)):
            q1 = q_pred + beta * h * h * a1
            q_af = (1.0 - af) * q1 + af * q
            a_am = (1.0 - am) * a1 + am * a
            r = self.mass_apply(a_am) + self.internal(q_af) - u_m
            if s["has_fluid"] or has_nf:
                v1 = v_pred + gamma * h * a1
                v_af = (1.0 - af) * v1 + af * v
            if s["has_fluid"]:
                r = r + self.drag(v_af)
            if s["has_gravity"]:
                r = r - self.grav(q_af)
            if has_nf:
                r = r - self.nf(q_af, v_af, t + (1.0 - af) * dt)
            a1 = a1 - spike_solve(prep, r * m3, self.sp) * m3
        return q_pred + beta * h * h * a1, v_pred + gamma * h * a1, a1

    def initial_accel(self, q, v, u_m, t_at, prep_mass, has_nf):
        s = self.s
        f0 = u_m - self.internal(q)
        if s["has_fluid"]:
            f0 = f0 - self.drag(v)
        if s["has_gravity"]:
            f0 = f0 + self.grav(q)
        if has_nf:
            f0 = f0 + self.nf(q, v, t_at)
        m3 = self.c["m3"]
        return spike_solve(prep_mass, f0 * m3, self.sp) * m3


def _state_in(beam: SpatialBeam, x0):
    """Global ``x0`` -> (tensor, env count or None, this rank's block)."""
    x0 = beam.tensor(x0, x0.dtype if isinstance(x0, torch.Tensor) else torch.float64)
    n_env = x0.shape[0] if x0.dim() == 4 else None
    x_loc = beam.local(x0 if n_env is None else env_block(x0, beam.dp))
    return x0, n_env, x_loc


def _frames_out(beam: SpatialBeam, frames, n_env, env_dim=1):
    frames = beam.gather(frames)
    return frames if n_env is None else gather_env_blocks(frames, beam.dp, n_env, env_dim)


def _u_local(beam: SpatialBeam, u, like):
    if u is None:
        return like.new_zeros((beam.m_local, 3))
    return beam.local(replicated_in(beam.tensor(u, like.dtype), beam.dp))


def _ga_coeffs(rho_inf):
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma = 0.5 - am + af
    return am, af, beta, gamma


# ---------------------------------------------------------------------------
# Sharded generalized-alpha stepping
# ---------------------------------------------------------------------------


def build_spatial_genalpha(
    beam: SpatialBeam,
    dt: float,
    rho_inf: float = 0.8,
    n_newton: int = 1,
    use_consistent: bool = False,
    fluid_density: float = None,
    gravity=None,
    node_force: Callable = None,
    local_solver: str = None,
) -> Callable:
    """Implicit generalized-alpha rollout over the ``sp`` mesh axis.

    Returns ``rollout(x0, n_frames, u=None, substeps=1, arrays=None,
    return_carry=False, t0=0.0) -> (ts, xs)``: ``x0`` is the global
    ``(2, Np, 3)`` node-layout state (a leading environment batch is split
    over ``dp``), ``u`` a constant ``(Np, 3)`` force, ``xs`` frames leading
    with ``xs[0] = x0``.

    ``fluid_density``: the reference's quadratic transverse drag, node-local,
    in the residual at the alpha-point velocity and lagged in the Jacobian
    (as the single-device engines treat ``external_force``). ``node_force``:
    a nodewise external force ``f(x, t) -> (..., m, 3)`` on this shard's
    block ``x = (..., 2, m, 3)`` (residual-only at the alpha point, lagged in
    the Jacobian; ``t`` a float); constrained DOFs are masked before and
    after the call.

    Modified Newton with the zero-state tangent: the SPIKE preparations of
    the effective Jacobian and of the mass happen once per device and dtype
    (unbatched: on the card the ``"thomas"`` solves are the ``btd_solve``
    kernel, one launch a Newton correction); a step then costs two halo
    ``ppermute`` (internal force), two (mass matvec) and one 6-value
    ``all_gather`` a Newton correction.

    ``return_carry=True`` also returns the final ``(3, Np, 3)`` carry ``[q;
    v; a]`` (batched: ``(envs, 3, Np, 3)``); a 3-plane ``x0`` continues the
    recurrence from it bit for bit (no consistent-acceleration solve), and
    ``t0`` offsets the ``node_force`` times and the frame times.

    ``arrays``: traced parameters, a :class:`BeamArrays` like ``beam.arrays``
    (padded; build it with ``dataclasses.replace(beam.arrays,
    elastic_modulus=...)``, keeping the pad entries at their padded values)
    whose fields may be tensors that require grad or carry forward-mode
    tangents. The mass bands, element fields, drag factors, gravity masses,
    the zero-state tangent and both SPIKE preparations are then rebuilt from
    them every call, so the whole rollout is differentiable in the physical
    parameters: reverse mode (autograd; on the card the ``"thomas"`` solves
    launch ``btd_solve`` forward and ``btd_solve_adjoint`` backward) and
    forward mode (``torch.autograd.forward_ad``). With ``arrays=None`` the
    memoized host constants serve, bit for bit as before. A loss computed
    alike on every rank from the returned frames differentiates to the same
    whole gradient on every rank (``collectives.replicated_in`` /
    ``gather_out``).
    """
    coeffs = _ga_coeffs(rho_inf)
    am, af, beta, gamma = coeffs
    c_jac = (1.0 - af) * beta * dt * dt
    a_jac = 1.0 - am
    setup = _implicit_setup(beam, fluid_density, gravity, use_consistent)
    has_nf = node_force is not None
    solver = resolve_local_solver(local_solver)
    preps = {}

    def prepared(like, forces):
        key = (like.device, like.dtype)
        if key not in preps:
            c = forces.c
            preps[key] = (forces.prep(a_jac, c_jac, solver),
                          spike_prepare(c["md_bc"], c["ml_bc"], c["mu_bc"], beam.sp, solver))
        return preps[key]

    def rollout(x0, n_frames: int, u=None, substeps: int = 1, arrays=None,
                return_carry: bool = False, t0: float = 0.0):
        x0, n_env, x = _state_in(beam, x0)
        c = _engine_consts(setup, x0, arrays)
        F = _Forces(c, beam.sp, setup, node_force, use_consistent)
        if arrays is None:
            prep_jac, prep_mass = prepared(x0, F)
        else:  # factored from the parameters, every call
            prep_jac = F.prep(a_jac, c_jac, solver)
            prep_mass = spike_prepare(c["md_bc"], c["ml_bc"], c["mu_bc"], beam.sp, solver)
        m3 = c["m3"]
        u_m = _u_local(beam, u, x0) * m3
        q, v = x[..., 0, :, :] * m3, x[..., 1, :, :] * m3
        if x.shape[-3] == 3:
            # Exact continuation from a previous chunk's carry: no
            # consistency reset at the chunk boundary.
            a = x[..., 2, :, :] * m3
        else:
            a = F.initial_accel(q, v, u_m, t0, prep_mass, has_nf)

        frames = [torch.stack([q, v], dim=-3)]
        for f in range(int(n_frames)):
            for j in range(int(substeps)):
                t = t0 + (f * substeps + j) * dt
                q, v, a = F.genalpha_step(prep_jac, q, v, a, u_m, dt, t, dt, coeffs, n_newton,
                                          has_nf)
            frames.append(torch.stack([q, v], dim=-3))
        xs = _frames_out(beam, torch.stack(frames), n_env)
        ts = t0 + (dt * substeps) * torch.arange(int(n_frames) + 1, dtype=torch.float64,
                                                 device=x0.device)
        if return_carry:
            carry = _frames_out(beam, torch.stack([q, v, a], dim=-3), n_env, env_dim=0)
            return ts, xs, carry
        return ts, xs

    return rollout


def _adaptive_inputs(beam: SpatialBeam, x0, t_eval, dt0):
    """Shared front of the adaptive rollouts: ``(x0, n_env, x_loc, t_eval
    (host float64), dt0 tensor for this rank, per_env)``."""
    t_eval_np = integrators._host_times(t_eval)
    if dt0 is None:
        dt0 = float(t_eval_np[1] - t_eval_np[0]) / 16.0
    x0, n_env, x = _state_in(beam, x0)
    dt0 = beam.tensor(dt0, x0.dtype)
    if n_env is not None and dt0.dim() > 0:
        dt0 = env_block(dt0, beam.dp)
    return x0, n_env, x, t_eval_np, dt0, n_env is not None


def _stats_out(beam: SpatialBeam, stats, n_env):
    if n_env is None:
        return stats
    g = [gather_env_blocks(s, beam.dp, n_env) for s in stats[:5]]
    return integrators.AdaptiveStats(*g, host_reads=stats.host_reads,
                                     trials_run=stats.trials_run)


def _error_norm(m3, sp, n_free, atol, rtol):
    def err_norm(e, q_old, q_new):
        scale = atol + rtol * torch.maximum(q_old.abs(), q_new.abs())
        s = psum((((e / scale) ** 2) * m3).sum((-2, -1)), sp)
        return torch.sqrt(s / n_free)

    return err_norm


def _col(s):
    """A per-environment scalar ``(...,)`` against node blocks ``(..., m, 3)``."""
    return s[..., None, None] if isinstance(s, torch.Tensor) and s.dim() > 0 else s


def build_spatial_genalpha_adaptive(
    beam: SpatialBeam,
    rho_inf: float = 0.9,
    n_newton: int = 2,
    use_consistent: bool = False,
    max_steps_per_interval: int = 100_000,
    safety: float = 0.9,
    fluid_density: float = None,
    gravity=None,
    node_force: Callable = None,
    local_solver: str = None,
) -> Callable:
    """Error-controlled implicit stepping over the ``sp`` mesh axis.

    The distributed counterpart of
    ``integrators.integrate_generalized_alpha_adaptive``: the
    Zienkiewicz-Xie estimate and the accept/reject controller of
    ``integrators.adaptive_drive``, with the SPIKE preparation redone at each
    trial dt. The error norm is ``psum``-contracted over the shards (free
    DOFs only), so every shard takes the same decision. ``node_force`` is
    evaluated at the alpha point of every trial (``t`` a tensor of the
    controller's shape).

    Returns ``rollout(x0, t_eval, u=None, rtol=1e-6, atol=1e-9, dt0=None,
    arrays=None, return_carry=False) -> (xs, AdaptiveStats)``, ``xs``
    frames leading with ``xs[0] = x0`` (node layout). A batched ``x0``
    ``(envs, 2, Np, 3)`` controls each environment's step (per-environment
    trial dt, so per-environment SPIKE preparations: the plain solves).
    ``return_carry=True`` adds the final ``(3, Np, 3)`` carry ``[q; v; a]``;
    fed back as ``x0`` with ``dt0=stats.dt_next`` (``(envs,)`` when
    batched) it continues the span exactly. ``arrays``: traced parameters,
    as for :func:`build_spatial_genalpha`; forward-mode tangents
    (``torch.autograd.forward_ad``) flow through the error-controlled
    engine (the tangent of the realized step sequence, as the JAX
    package's ``jax.jvp``); autograd records the trials too.
    """
    coeffs = _ga_coeffs(rho_inf)
    am, af, beta, gamma = coeffs
    a_jac = 1.0 - am
    zx_coeff = abs(float(beta - 1.0 / 6.0))
    setup = _implicit_setup(beam, fluid_density, gravity, use_consistent)
    has_nf = node_force is not None
    solver = resolve_local_solver(local_solver)

    def rollout(x0, t_eval, u=None, rtol: float = 1e-6, atol: float = 1e-9,
                dt0: float = None, arrays=None, return_carry: bool = False):
        x0, n_env, x, t_eval_np, dt0, per_env = _adaptive_inputs(beam, x0, t_eval, dt0)
        sp = beam.sp
        c = _engine_consts(setup, x0, arrays)
        F = _Forces(c, sp, setup, node_force, use_consistent)
        m3 = c["m3"]
        prep_mass = spike_prepare(c["md_bc"], c["ml_bc"], c["mu_bc"], sp, solver)
        n_free = psum(m3.sum(), sp)
        u_m = _u_local(beam, u, x0) * m3
        shape = x.shape[:-3] + (beam.m_local, 3)
        q0, v0 = x[..., 0, :, :] * m3, x[..., 1, :, :] * m3
        t_first = torch.as_tensor(t_eval_np[0], dtype=x0.dtype, device=x0.device)
        if x.shape[-3] == 3:
            a0 = x[..., 2, :, :] * m3
        else:
            a0 = F.initial_accel(q0, v0, u_m, t_first, prep_mass, has_nf)
        err_norm = _error_norm(m3, sp, n_free, float(atol), float(rtol))

        def trial(t, dt, state):
            q, v, a = (s.reshape(shape) for s in state)
            prep = F.prep(a_jac, (1.0 - af) * beta * dt * dt, solver)
            h = _col(dt)
            q1, v1, a1 = F.genalpha_step(prep, q, v, a, u_m, h, t, dt, coeffs, n_newton,
                                         has_nf)
            e = zx_coeff * h * h * (a1 - a)
            return tuple(s.flatten(-2) for s in (q1, v1, a1)), err_norm(e, q, q1)

        state0 = tuple(s.flatten(-2) for s in (q0, v0, a0))
        state_f, xs, stats = integrators.adaptive_drive(
            trial, state0, t_eval_np, dt0, -1.0 / 3.0,
            max_steps_per_interval=max_steps_per_interval, safety=safety,
            frame_out=lambda s: torch.stack([s[0].reshape(shape), s[1].reshape(shape)],
                                            dim=-3),
            per_env=per_env,
        )
        xs = torch.cat([torch.stack([q0, v0], dim=-3)[None], xs], dim=0)
        xs = _frames_out(beam, xs, n_env)
        stats = _stats_out(beam, stats, n_env)
        if return_carry:
            carry = torch.stack([s.reshape(shape) for s in state_f], dim=-3)
            return xs, stats, _frames_out(beam, carry, n_env, env_dim=0)
        return xs, stats

    return rollout


def build_spatial_sdirk3(
    beam: SpatialBeam,
    n_newton: int = 2,
    use_consistent: bool = False,
    max_steps_per_interval: int = 10_000,
    safety: float = 0.9,
    fluid_density: float = None,
    gravity=None,
    node_force: Callable = None,
    local_solver: str = None,
):
    """Error-controlled SDIRK3 on the sharded beam axis.

    The L-stable third-order Alexander DIRK with its embedded estimate
    (``integrators.sdirk3_step``) over the ``sp`` axis: SPIKE is the stage
    solver and the error norm is ``psum``-contracted over the free DOFs.
    All three stages share one effective Jacobian ``M + (dt g)^2 K0``, so a
    trial dt costs one SPIKE preparation, reused by ``3 n_newton`` Newton
    solves and the stiff error filter (whose ``K e_q`` is the directional
    derivative of the halo-exchanged internal force, its tangent riding the
    same ``ppermute``). ``node_force`` is evaluated at every stage state
    and time.

    Returns ``rollout(x0, t_eval, u=None, rtol=1e-6, atol=1e-9, dt0=None,
    arrays=None) -> (xs, AdaptiveStats)`` with the contracts of the adaptive
    gen-α engine (``arrays`` too). The trial state is ``(q, v)``:
    restarting from a frame with ``dt0=stats.dt_next`` continues a span
    exactly.
    """
    G, A_, B_, BH, C_ = (integrators._SD_G, integrators._SD_A, integrators._SD_B,
                         integrators._SD_BHAT, integrators._SD_C)
    setup = _implicit_setup(beam, fluid_density, gravity, use_consistent)
    has_fluid, has_gravity = setup["has_fluid"], setup["has_gravity"]
    has_nf = node_force is not None
    solver = resolve_local_solver(local_solver)

    def rollout(x0, t_eval, u=None, rtol: float = 1e-6, atol: float = 1e-9,
                dt0: float = None, arrays=None):
        x0, n_env, x, t_eval_np, dt0, per_env = _adaptive_inputs(beam, x0, t_eval, dt0)
        sp = beam.sp
        c = _engine_consts(setup, x0, arrays)
        F = _Forces(c, sp, setup, node_force, use_consistent)
        m3 = c["m3"]
        n_free = psum(m3.sum(), sp)
        u_m = _u_local(beam, u, x0) * m3
        shape = x.shape[:-3] + (beam.m_local, 3)
        q0, v0 = x[..., 0, :, :] * m3, x[..., 1, :, :] * m3
        err_norm = _error_norm(m3, sp, n_free, float(atol), float(rtol))

        def sdirk_step(dt, q, v, t):
            dt_g = dt * G
            # One SPIKE preparation serves every stage Newton iterate and the
            # stiff error filter (frozen zero-state tangent).
            prep = F.prep(1.0, dt_g * dt_g, solver)
            h, hg = _col(dt), _col(dt_g)
            kqs, kvs = [], []
            for i in range(3):
                bq, bv = q, v
                for j in range(i):
                    bq = bq + h * A_[i][j] * kqs[j]
                    bv = bv + h * A_[i][j] * kvs[j]
                t_s = t + C_[i] * dt
                qi = (bq + hg * v) * m3
                for _ in range(int(n_newton)):
                    f = u_m - F.internal(qi)
                    if has_fluid or has_nf:
                        vi = (qi - bq) / hg
                    if has_fluid:
                        f = f - F.drag(vi)
                    if has_gravity:
                        f = f + F.grav(qi)
                    if has_nf:
                        f = f + F.nf(qi, vi, t_s)
                    r = F.mass_apply((qi - bq) / hg - bv) - hg * f
                    qi = qi - hg * spike_solve(prep, r * m3, sp) * m3
                vi = (qi - bq) / hg * m3
                kqs.append(vi)
                kvs.append((vi - bv) / hg * m3)
            q1 = q + h * sum(b * k for b, k in zip(B_, kqs))
            v1 = v + h * sum(b * k for b, k in zip(B_, kvs))
            eq = h * sum((b - bh) * k for b, bh, k in zip(B_, BH, kqs))
            ev = h * sum((b - bh) * k for b, bh, k in zip(B_, BH, kvs))
            # Stiff error filter: one more reuse of the prepared system; K e_q
            # by the directional derivative of the internal force at q1.
            K_eq = F.internal_jvp(q1, eq)
            rhs_v = F.mass_apply(ev) - hg * K_eq
            ev_f = spike_solve(prep, rhs_v * m3, sp) * m3
            eq_f = eq + hg * ev_f
            return q1 * m3, v1 * m3, eq_f, ev_f

        def trial(t, dt, state):
            q, v = (s.reshape(shape) for s in state)
            q1, v1, eq, ev = sdirk_step(dt, q, v, t)
            # Displacement-unit velocity weighting: e_v enters as dt e_v.
            en = torch.maximum(err_norm(eq, q, q1), err_norm(_col(dt) * ev, q, q1))
            return (q1.flatten(-2), v1.flatten(-2)), en

        _, xs, stats = integrators.adaptive_drive(
            trial, (q0.flatten(-2), v0.flatten(-2)), t_eval_np, dt0, -1.0 / 3.0,
            max_steps_per_interval=max_steps_per_interval, safety=safety,
            frame_out=lambda s: torch.stack([s[0].reshape(shape), s[1].reshape(shape)],
                                            dim=-3),
            per_env=per_env,
        )
        xs = torch.cat([torch.stack([q0, v0], dim=-3)[None], xs], dim=0)
        return _frames_out(beam, xs, n_env), _stats_out(beam, stats, n_env)

    return rollout

"""Spatial (beam-axis) model parallelism: shard nodes across ranks.

Counterpart of ``continuum_robot_tpu/parallel/spatial.py``. The 1-D FEM
chain is the framework's "sequence" axis: the global state is ``[u, w,
phi] x N`` nodes and every element couples two neighbours. For beams too
long for one device the nodes are split over the ``sp`` mesh axis, and each
force evaluation exchanges one 3-DOF halo node with each neighbour
(:func:`collectives.ppermute`).

Decomposition (S shards, ``m = Np/S`` nodes a shard, the node count padded
to a multiple of S with zero-property elements so every shard is uniform):

* shard k owns nodes ``[k m, (k+1) m)`` and elements ``[k m, (k+1) m)``
  (element e joins nodes e and e+1; padded elements have zero EA/EI/rhoA);
* internal force: receive the right neighbour's first node (the halo),
  evaluate the local elements, push the bridging element's far-node force
  back to the right neighbour (a second ``ppermute``) and add it there;
* consistent-mass solve: Jacobi-preconditioned conjugate gradients, every
  iteration one halo matvec and ``psum`` dot products (the exact SPIKE
  solve of ``spatial_implicit.py`` serves the implicit engines).

Every rank runs the same program on its own block: the JAX package's
``shard_map`` bodies are the ``*_local`` functions here, each taking this
rank's block with any leading environment axes (the JAX package's
``vmap``). The public entry points take and return global arrays (node
layout ``(..., 2, Np, 3)``, identical on every rank); an environment batch
is split over the mesh's ``dp`` axis when it has one
(:func:`collectives.env_block`) and gathered back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models import assembly, elements
from ..models.config import BeamArrays
from ..ops import banded, integrators
from .collectives import (
    MeshAxis,
    env_axis,
    env_block,
    gather_env_blocks,
    gather_out,
    left_perm,
    ppermute,
    psum,
    replicated_in,
    right_perm,
)
from .mesh import mesh_device


def pad_arrays_for_shards(arrays: BeamArrays, n_shards: int):
    """Pad to ``Np`` nodes (a multiple of ``n_shards``) with zero elements.

    Returns ``(padded_arrays, n_nodes_padded)``. The element count equals the
    padded node count, so every shard owns as many elements as nodes; the
    element bridging two shards is always present and element ``Np-1`` is
    always padding. Padded lengths are 1 (no 0/0 in the element formulas).
    """
    n_el = arrays.n_elements
    n_nodes = n_el + 1
    n_pad_nodes = -(-n_nodes // n_shards) * n_shards
    pad = n_pad_nodes - n_el

    def pad_field(x, value=0.0):
        x = np.asarray(x)
        return np.concatenate([x, np.full((pad,), value, dtype=x.dtype)], axis=0)

    padded = BeamArrays(
        length=pad_field(arrays.length, 1.0),
        elastic_modulus=pad_field(arrays.elastic_modulus, 0.0),
        moment_inertia=pad_field(arrays.moment_inertia, 0.0),
        density=pad_field(arrays.density, 0.0),
        cross_area=pad_field(arrays.cross_area, 0.0),
        wetted_area=pad_field(arrays.wetted_area, 0.0),
        drag_coef=pad_field(arrays.drag_coef, 0.0),
        nonlinear_mask=np.concatenate(
            [np.asarray(arrays.nonlinear_mask), np.zeros((pad,), dtype=bool)]
        ),
    )
    return padded, n_pad_nodes


class NodeBlocks:
    """This rank's view of a node-sharded object with ``mesh``, ``axis``
    (the node axis) and ``n_nodes`` (padded) fields: its axes, its node
    block and the gather of every shard's block."""

    @property
    def sp(self) -> MeshAxis:
        """The node-sharding axis as seen from this rank."""
        return MeshAxis(self.mesh, self.axis)

    @property
    def dp(self) -> MeshAxis:
        """The axis an environment batch is split over."""
        return env_axis(self.mesh, self.axis)

    @property
    def n_shards(self) -> int:
        return self.sp.size

    @property
    def m_local(self) -> int:
        return self.n_nodes // self.n_shards

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    def local(self, x, dim: int = -2):
        """This rank's node block of ``x`` along ``dim`` (``x`` the same on
        every rank: a gradient with respect to it comes out whole,
        :func:`collectives.replicated_in`)."""
        return replicated_in(x, self.sp).narrow(dim, self.sp.index * self.m_local,
                                                self.m_local)

    def gather(self, y: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """Every shard's node block of ``y`` along ``dim``, concatenated: a
        result every rank returns alike (:func:`collectives.gather_out`)."""
        return gather_out(y, self.sp, dim)

    def tensor(self, x, dtype) -> torch.Tensor:
        """A global array or tensor on this rank's device in ``dtype``."""
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               dtype=dtype, device=self.device)


@dataclasses.dataclass
class SpatialBeam(NodeBlocks):
    """A node-sharded beam bound to a mesh axis (every rank holds one).

    ``arrays``, ``free_mask`` are the padded global host arrays; this rank's
    block is nodes ``[index m, (index+1) m)`` of them.
    """

    arrays: BeamArrays  # padded, length Np
    n_nodes: int  # Np (padded)
    n_nodes_real: int
    free_mask: np.ndarray  # (Np, 3) bool; padding nodes are constrained
    mesh: object
    axis: str = "sp"


def make_spatial_beam(arrays: BeamArrays, free_mask_nodes: np.ndarray, mesh,
                      axis: str = "sp") -> SpatialBeam:
    n_shards = MeshAxis(mesh, axis).size
    padded, n_pad_nodes = pad_arrays_for_shards(arrays, n_shards)
    n_real = arrays.n_elements + 1
    mask = np.zeros((n_pad_nodes, 3), dtype=bool)
    mask[:n_real] = free_mask_nodes
    return SpatialBeam(arrays=padded, n_nodes=n_pad_nodes, n_nodes_real=n_real,
                       free_mask=mask, mesh=mesh, axis=axis)


def node_drag_factors(beam: SpatialBeam, fluid_density: float) -> np.ndarray:
    """Per-node fluid-drag factors ``0.5 rho C_d A_w`` on the w DOF, (Np, 3).

    Node-local (no halo on the sharded axis). Node ``i`` takes element
    ``i``'s wetted area and drag coefficient and the real last node the last
    real element's (the reference's final-node quirk), so zero-padded
    elements never zero the tip factor. Padded nodes get 0.
    """
    arrays = beam.arrays
    w = np.asarray(arrays.wetted_area, np.float64)
    c = np.asarray(arrays.drag_coef, np.float64)
    n_real = beam.n_nodes_real
    fac = np.zeros((beam.n_nodes, 3))
    fac[: n_real - 1, 1] = 0.5 * fluid_density * w[: n_real - 1] * c[: n_real - 1]
    fac[n_real - 1, 1] = 0.5 * fluid_density * w[n_real - 2] * c[n_real - 2]
    return fac


def element_gravity_masses(beam: SpatialBeam) -> np.ndarray:
    """Per-element gravity masses ``rho A L``, (Np,) padded with zeros."""
    arrays = beam.arrays
    m = (np.asarray(arrays.density, np.float64) * np.asarray(arrays.cross_area, np.float64)
         * np.asarray(arrays.length, np.float64))
    m[beam.n_nodes_real - 1:] = 0.0  # padding elements carry no weight
    return m


def _gravity_params(gravity):
    """``(has_gravity, gx, gy)`` of a 3-vector or None."""
    if gravity is None:
        return False, 0.0, 0.0
    g = np.asarray(gravity, dtype=float).ravel()
    if len(g) != 3:
        raise ValueError("gravity must be a 3-vector [gx, gy, gz]")
    return True, float(g[0]), float(g[1])


def _halo_scatter(q_local, axis: MeshAxis, element_fn):
    """The element-local pattern of every halo force: pull the right
    neighbour's first node, evaluate ``element_fn(q_ext (..., m+1, 3)) ->
    (node-i part, node-i+1 part)`` of the ``m`` local elements, assemble,
    and push the bridging element's far-node part to its owner."""
    S = axis.size
    halo = ppermute(q_local[..., :1, :], axis, left_perm(S))
    q_ext = torch.cat([q_local, halo], dim=-2)  # (..., m+1, 3)
    fe1, fe2 = element_fn(q_ext)
    f_ext = torch.zeros_like(q_ext)
    f_ext[..., :-1, :] += fe1
    f_ext[..., 1:, :] += fe2
    bridge = ppermute(f_ext[..., -1:, :], axis, right_perm(S))
    f_local = f_ext[..., :-1, :]
    f_local[..., :1, :] += bridge
    return f_local


def spatial_gravity_force_local(q_local, gmass_local, gx, gy, mask_local, axis: MeshAxis):
    """Deformation-aware distributed gravity, node-sharded (per shard).

    Element ``i`` rotates ``(gx, gy)`` by the mean of its own end nodes'
    rotations and puts half its weight on each end node's (u, w) DOFs: the
    physically consistent form. The single-device registry force keeps the
    reference's reduced-index quirk instead, a BC-dependent index shift with
    no node-layout analogue (PARITY.md). Same halo pattern as the internal
    force.
    """

    def element_fn(q_ext):
        th = q_ext[..., 2]
        phi = 0.5 * (th[..., :-1] + th[..., 1:])
        c, s = torch.cos(phi), torch.sin(phi)
        f_ax = (c * gx + s * gy) * gmass_local * 0.5
        f_tr = (-s * gx + c * gy) * gmass_local * 0.5
        fe = torch.stack([f_ax, f_tr, torch.zeros_like(f_ax)], dim=-1)
        return fe, fe

    return _halo_scatter(q_local, axis, element_fn) * mask_local


def spatial_internal_force_local(q_local, params, mask_local, axis: MeshAxis,
                                 use_consistent: bool = False, dq_local=None):
    """Per-shard internal force with the one-node halo exchange.

    ``q_local``: ``(..., m, 3)`` this shard's nodes (already BC-masked);
    ``params``: the local element fields ``(L, E, I, A, nonlinear_mask)``
    (:func:`assembly.element_params` of this shard's elements). Two
    ``ppermute`` a call. With ``dq_local`` it returns ``(f, df)``: also the
    directional derivative ``K(q) dq`` (the JAX package's ``jax.jvp``
    through the halo exchange: the direction rides the same two
    ``ppermute``, stacked with the state). Every element force (the parity
    polynomials and the consistent energy's gradient) is a cubic polynomial
    of its six DOFs, so ``p(s) = f(q + s h dq)`` has the exact derivative
    ``[8 (p(1) - p(-1)) - (p(2) - p(-2))] / (12 h)``: four force
    evaluations in one batch, each element's step ``h`` scaled so that ``h
    |dq| = max(|q|, |dq|)`` (forward-mode AD of the element formulas costs
    tens of times more in PyTorch).
    """
    L, E, I, A, nl = params

    def force(q6):
        return elements.element_internal_force(q6, L, E, I, A, nl,
                                               use_consistent=use_consistent)

    def q6_of(q_ext):
        return torch.cat([q_ext[..., :-1, :], q_ext[..., 1:, :]], dim=-1)

    if dq_local is None:
        def element_fn(q_ext):
            fe = force(q6_of(q_ext))
            return fe[..., 0:3], fe[..., 3:6]

        return _halo_scatter(q_local, axis, element_fn) * mask_local

    def element_fn_jvp(qd_ext):
        q6, d6 = q6_of(qd_ext[0]), q6_of(qd_ext[1])
        dmax = d6.abs().amax(-1, keepdim=True)
        h = torch.where(dmax > 0, torch.maximum(q6.abs().amax(-1, keepdim=True), dmax)
                        / torch.where(dmax > 0, dmax, 1.0), 1.0)
        s = torch.tensor([1.0, -1.0, 2.0, -2.0], dtype=q6.dtype, device=q6.device)
        s = s.reshape((4,) + (1,) * q6.dim())
        p = force(q6 + s * (h * d6))
        dfe = (8.0 * (p[0] - p[1]) - (p[2] - p[3])) / (12.0 * h)
        fe = force(q6)
        return (torch.stack([fe[..., 0:3], dfe[..., 0:3]]),
                torch.stack([fe[..., 3:6], dfe[..., 3:6]]))

    out = _halo_scatter(torch.stack([q_local, dq_local]), axis, element_fn_jvp)
    return out[0] * mask_local, out[1] * mask_local


def block_apply(blocks, v):
    """``blocks @ v`` node by node: ``(..., n, 3, 3)`` blocks (shared by every
    environment when unbatched) against ``(..., n, 3)`` vectors."""
    if blocks.dim() == 3:
        return torch.einsum("nij,...nj->...ni", blocks, v)
    return torch.einsum("...nij,...nj->...ni", blocks, v)


def spatial_mass_matvec_local(v_local, mdiag_local, mlow_local, mup_local, axis: MeshAxis):
    """Consistent-mass matvec with the halo exchange (per shard).

    Bands are shard-aligned: ``mlow_local[i]`` couples local node i to global
    node ``start+i-1`` (entry 0 reaches into the left halo), ``mup_local[i]``
    to ``start+i+1`` (entry m-1 into the right halo).
    """
    S = axis.size
    left_halo = ppermute(v_local[..., -1:, :], axis, right_perm(S))
    right_halo = ppermute(v_local[..., :1, :], axis, left_perm(S))
    v_ext = torch.cat([left_halo, v_local, right_halo], dim=-2)
    y = block_apply(mdiag_local, v_local)
    y = y + block_apply(mlow_local, v_ext[..., :-2, :])
    y = y + block_apply(mup_local, v_ext[..., 2:, :])
    return y


def _aligned_mass_bands(beam: SpatialBeam):
    """Global shard-aligned consistent-mass bands ``(Np, 3, 3)`` each.

    The padded element list has Np elements, so Np+1 assembled nodes; node Np
    is touched only by zero-property padding, so truncating to Np nodes is
    exact. ``mlow[i]`` couples node i with i-1 (zero at 0), ``mup[i]`` node i
    with i+1 (zero at Np-1).
    """
    Np = beam.n_nodes
    mdiag, moff = assembly.mass_block_tridiagonal(beam.arrays)
    mdiag = np.asarray(mdiag)[:Np]
    moff = np.asarray(moff)[: Np - 1]
    zeros33 = np.zeros((1, 3, 3), dtype=mdiag.dtype)
    mlow = np.concatenate([zeros33, np.swapaxes(moff, -1, -2)], axis=0)
    mup = np.concatenate([moff, zeros33], axis=0)
    return mdiag, mlow, mup


def _local_params(beam: SpatialBeam, like: torch.Tensor):
    """This shard's element fields ``(L, E, I, A, nonlinear_mask)`` on
    ``like``'s device and dtype."""
    return tuple(beam.local(p, dim=0) for p in assembly.element_params(beam.arrays, like))


class _Consts:
    """Per-(device, dtype) memo of an engine's local constants."""

    def __init__(self, build):
        self._build = build
        self._memo = {}

    def __call__(self, like: torch.Tensor):
        key = (like.device, like.dtype)
        if key not in self._memo:
            self._memo[key] = self._build(like)
        return self._memo[key]


def build_spatial_rhs(
    beam: SpatialBeam,
    cg_iters: int = 16,
    use_consistent: bool = False,
    cg_tol: float = 1e-8,
    fluid_density: float = None,
    gravity=None,
    node_force: Callable = None,
    with_info: bool = False,
) -> Callable:
    """Node-sharded ``rhs(t, x, u=None)`` over the ``sp`` axis.

    ``x``: ``(..., 2, Np, 3)`` stacked (positions, velocities) in node
    layout, the same global array on every rank; ``u``: ``(Np, 3)`` force
    layout or None. Returns the global ``dx/dt`` (leading axes split over
    ``dp``, every shard's block gathered). ``rhs.local(t, x, u)`` is the
    per-shard body on this rank's blocks (``(..., 2, m, 3)``), which
    :func:`spatial_rollout` steps without gathering.

    The mass solve is Jacobi-preconditioned CG with halo matvecs and
    ``psum`` reductions, stopped per environment at a relative residual
    ``|r| <= cg_tol |r0|`` with ``cg_iters`` as the cap: a masked loop
    (finished environments frozen) that runs until every environment of
    this rank has stopped, read on the host from the all-reduced residuals,
    so every shard runs the same iterations. ``cg_tol=None`` runs exactly
    ``cg_iters`` iterations. For implicit stepping use the exact SPIKE
    solver (``spatial_implicit.py``).

    ``node_force``: optional nodewise external force ``f(x, t) -> (..., m,
    3)`` on this shard's block ``x = (..., 2, m, 3)`` (node-local), added to
    the assembled force before the mass solve.

    ``with_info``: the rhs also returns ``cg_incomplete``, per environment
    1.0 when the solve stopped on the cap with the residual above
    ``cg_tol``, else 0.0 (identical on every shard); needs a tolerance stop.
    """
    if with_info and cg_tol is None:
        raise ValueError(
            "with_info requires a tolerance stop (cg_tol is not None): "
            "the fixed-iteration scan tracks no residual by design"
        )
    sp = beam.sp
    Np = beam.n_nodes

    mdiag, mlow, mup = _aligned_mass_bands(beam)
    mdiag_bc, mlow_bc, mup_bc = banded.btd_apply_bc(
        mdiag, mlow[1:], mup[:-1], np.asarray(beam.free_mask))
    zeros33 = np.zeros((1, 3, 3))
    mlow = np.concatenate([zeros33, mlow_bc], axis=0)
    mup = np.concatenate([mup_bc, zeros33], axis=0)
    mdiag_inv = banded.inv33(mdiag_bc)  # Jacobi preconditioner

    has_fluid = fluid_density is not None
    dfac_np = (node_drag_factors(beam, float(fluid_density)) if has_fluid
               else np.zeros((Np, 3)))
    has_gravity, g_x, g_y = _gravity_params(gravity)
    gmass_np = element_gravity_masses(beam) if has_gravity else np.zeros(Np)
    has_nf = node_force is not None

    def build(like):
        loc = beam.local
        t = lambda a: loc(torch.as_tensor(a, dtype=like.dtype, device=like.device), 0)  # noqa: E731
        return dict(
            params=_local_params(beam, like), mask=t(beam.free_mask.astype(np.float64)),
            md=t(mdiag_bc), ml=t(mlow), mu=t(mup), mdi=t(mdiag_inv), dfac=t(dfac_np),
            gmass=t(gmass_np),
        )

    consts = _Consts(build)

    def local(t, x, u=None):
        c = consts(x)
        m_mask = c["mask"]
        if callable(u):
            u = u(t)
        q, v = x[..., 0, :, :], x[..., 1, :, :]
        k = spatial_internal_force_local(q * m_mask, c["params"], m_mask, sp, use_consistent)
        f = -k if u is None else u - k
        if has_fluid:
            vm = v * m_mask
            f = f - c["dfac"] * vm * vm.abs()
        if has_gravity:
            f = f + spatial_gravity_force_local(q * m_mask, c["gmass"], g_x, g_y, m_mask, sp)
        if has_nf:
            f = f + node_force(torch.stack([q * m_mask, v * m_mask], dim=-3), t)
        f = f * m_mask
        md, ml, mu, mdi = c["md"], c["ml"], c["mu"], c["mdi"]

        def matvec(z):
            return spatial_mass_matvec_local(z, md, ml, mu, sp)

        def pdot(a, b):
            return psum((a * b).sum((-2, -1)), sp)

        def col(s):
            return s[..., None, None]

        def cg_step(a, r, p, rz):
            Ap = matvec(p)
            alpha = rz / torch.clamp(pdot(p, Ap), min=1e-30)
            a = a + col(alpha) * p
            r = r - col(alpha) * Ap
            z = block_apply(mdi, r)
            rz_new = pdot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + col(beta) * p
            return a, r, p, rz_new

        a = torch.zeros_like(f)
        r = f - matvec(a)
        p = block_apply(mdi, r)
        rz = pdot(r, p)
        if cg_tol is None:
            for _ in range(int(cg_iters)):
                a, r, p, rz = cg_step(a, r, p, rz)
        else:
            tol2 = torch.tensor(cg_tol, dtype=f.dtype, device=f.device) ** 2
            rr0 = pdot(r, r)
            rr = rr0
            i = torch.zeros(rr0.shape, dtype=torch.int64, device=f.device)
            active = (rr > tol2 * rr0) & (i < cg_iters)
            # The flag is built from psum-reduced values: every shard stops
            # on the same iteration.
            while bool(active.any()):
                a1, r1, p1, rz1 = cg_step(a, r, p, rz)
                rr1 = pdot(r1, r1)
                a, r, p = (torch.where(col(active), n, o) for n, o in
                           ((a1, a), (r1, r), (p1, p)))
                rz = torch.where(active, rz1, rz)
                rr = torch.where(active, rr1, rr)
                i = i + active
                active = (rr > tol2 * rr0) & (i < cg_iters)
        out = torch.stack([v * m_mask, a * m_mask], dim=-3)
        if with_info:
            return out, (rr > tol2 * rr0).to(out.dtype)
        return out

    def rhs(t, x, u=None):
        x = beam.tensor(x, x.dtype if isinstance(x, torch.Tensor) else torch.float64)
        dp = beam.dp
        n_env = x.shape[0] if x.dim() > 3 else None
        x_loc = beam.local(x if n_env is None else env_block(x, dp))
        u_loc = None if u is None else beam.local(beam.tensor(u, x.dtype))
        res = local(t, x_loc, u_loc)
        out, info = res if with_info else (res, None)
        out = beam.gather(out)
        if n_env is not None:
            out = gather_env_blocks(out, dp, n_env)
            info = None if info is None else gather_env_blocks(info, dp, n_env)
        return (out, info) if with_info else out

    rhs.local = local
    return rhs


def _node_input(beam: SpatialBeam, u, like):
    """A global ``(Np, 3)`` force (constant or callable of t) as this
    shard's block on ``like``'s device and dtype."""
    if u is None:
        return None
    if callable(u):
        return lambda t: beam.local(beam.tensor(u(t), like.dtype))
    return beam.local(beam.tensor(u, like.dtype))


def spatial_rollout(
    beam: SpatialBeam,
    x0,
    t_final: float,
    dt: float,
    u=None,
    substeps: int = 1,
    cg_iters: int = 16,
    use_consistent: bool = False,
    cg_tol: float = 1e-8,
    fluid_density: float = None,
    gravity=None,
    node_force: Callable = None,
    cg_stats: bool = False,
):
    """RK4 rollout of a node-sharded beam.

    ``x0``: ``(2, Np, 3)`` node-layout state, optionally with a leading
    environment batch (split over ``dp``); ``u``: ``(Np, 3)`` force layout
    or a callable of t returning one. Per step: four RHS evaluations, each
    two halo ``ppermute`` plus CG's (two ``ppermute``, two ``psum``) an
    iteration. ``fluid_density`` / ``gravity`` / ``node_force`` pass
    through to :func:`build_spatial_rhs`. Returns ``(ts, xs (frames+1,
    ..., 2, Np, 3))``, global on every rank.

    ``cg_stats``: also return ``{"cg_incomplete": n, "cg_evals": total}``
    counting the RHS evaluations whose CG stopped on the cap above
    ``cg_tol`` (per environment when batched); needs ``cg_tol``.
    """
    n_steps = int(round(t_final / dt))
    x0 = beam.tensor(x0, x0.dtype if isinstance(x0, torch.Tensor) else torch.float64)
    n_env = x0.shape[0] if x0.dim() == 4 else None
    dp = beam.dp
    x_loc = beam.local(x0 if n_env is None else env_block(x0, dp))
    u_loc = _node_input(beam, u, x0)
    kw = dict(cg_iters=cg_iters, use_consistent=use_consistent, cg_tol=cg_tol,
              fluid_density=fluid_density, gravity=gravity, node_force=node_force)

    def gather(xs):
        xs = beam.gather(xs)
        return xs if n_env is None else gather_env_blocks(xs, dp, n_env, dim=1)

    if not cg_stats:
        rhs = build_spatial_rhs(beam, **kw).local
        ts, xs = integrators.integrate_fixed(rhs, x_loc, 0.0, dt, n_steps, u=u_loc,
                                             substeps=substeps)
        return ts, gather(xs)

    rhs_info = build_spatial_rhs(beam, with_info=True, **kw).local
    h = dt / substeps

    def rk4_counted(t, x, u_t):
        """An RK4 step with the cap-hit flags of its four stages summed."""
        k1, f1 = rhs_info(t, x, u_t)
        k2, f2 = rhs_info(t + 0.5 * h, x + (0.5 * h) * k1, u_t)
        k3, f3 = rhs_info(t + 0.5 * h, x + (0.5 * h) * k2, u_t)
        k4, f4 = rhs_info(t + h, x + h * k3, u_t)
        xn = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return xn, f1 + f2 + f3 + f4

    x = x_loc
    n_inc = x.new_zeros(x.shape[:-3])
    xs = [x]
    for i in range(n_steps):
        t_frame = i * dt
        for j in range(int(substeps)):
            t = t_frame + j * h
            u_t = u_loc(t) if callable(u_loc) else u_loc
            x, inc = rk4_counted(t, x, u_t)
            n_inc = n_inc + inc
        xs.append(x)
    ts = dt * torch.arange(n_steps + 1, dtype=torch.float64, device=x0.device)
    if n_env is not None:
        n_inc = gather_env_blocks(n_inc, dp, n_env)
    stats = {"cg_incomplete": n_inc, "cg_evals": 4 * n_steps * substeps}
    return ts, gather(torch.stack(xs)), stats


def reduced_to_node_layout(model, x_red, n_nodes_padded: int):
    """Reduced ``[q; v]`` states ``(..., 2n)`` -> node layout ``(..., 2, Np, 3)``.

    A tensor keeps its device and dtype; a NumPy array becomes a float64
    tensor on the CPU.
    """
    bc = model.beam_model.bc_info
    free = np.asarray(bc.free_dofs)
    n = len(free)
    n_full = bc.n_dofs_full
    x_red = x_red if isinstance(x_red, torch.Tensor) else torch.as_tensor(np.asarray(x_red))
    lead = tuple(x_red.shape[:-1])
    idx = torch.as_tensor(free, device=x_red.device)
    out = x_red.new_zeros(lead + (2, n_nodes_padded * 3))
    out[..., 0, idx] = x_red[..., :n]
    out[..., 1, idx] = x_red[..., n:]
    return out.reshape(lead + (2, n_nodes_padded, 3))

"""Global assembly: batched element matrices -> global operators.

Counterpart of ``continuum_robot_tpu/models/assembly.py``: the mass and
linear-stiffness operators, the boundary-condition reduction, the
state-dependent internal force (interleaved and planar layouts) and the
planar von Kármán correction the modal-ROM engine evaluates. The mass
operator is kept block-tridiagonal ``(diag (N,3,3), off (E,3,3))``; dense
forms are host NumPy for eigensolves and control design.

The internal-force functions take NumPy arrays (host, returns NumPy) or
torch tensors (returns tensors on their device and dtype) and broadcast
over leading batch axes. A :class:`BeamArrays` whose fields are tensors
(batched ``(n_envs, E)`` or not; ``parallel/sweep.py``) flows through the
mass and tangent bands, the internal force and the padding helpers with
its graph: derivatives in the physical parameters reach its fields. The state-dependent tangent
(:func:`tangent_block_tridiagonal`) feeds the implicit integrators' Newton
solves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from . import elements
from .config import BeamArrays


def _sum_node_blocks(Ke):
    """Diagonal node blocks ``(..., N, 3, 3)`` of element matrices
    ``(..., E, 6, 6)``: node i gets element i's first block and element
    i-1's second."""
    n_nodes = Ke.shape[-3] + 1
    shape = (*Ke.shape[:-3], n_nodes, 3, 3)
    if isinstance(Ke, torch.Tensor):
        diag = Ke.new_zeros(shape)
    else:
        diag = np.zeros(shape, dtype=Ke.dtype)
    diag[..., :-1, :, :] += Ke[..., 0:3, 0:3]
    diag[..., 1:, :, :] += Ke[..., 3:6, 3:6]
    return diag


def mass_block_tridiagonal(arrays: BeamArrays):
    """Global consistent mass as block-tridiagonal ``(diag (N,3,3), off (E,3,3))``.

    ``off[i]`` is the coupling block between node i and node i+1 (upper
    band); the lower band is its transpose by symmetry. NumPy or torch,
    following the type of the parameter arrays.
    """
    Me = elements.consistent_mass_matrix(
        arrays.length, arrays.density, arrays.cross_area
    )  # (E, 6, 6)
    return _sum_node_blocks(Me), Me[..., 0:3, 3:6]


def dense_from_block_tridiagonal(diag, off) -> np.ndarray:
    """Expand block-tridiagonal form to a dense ``(3N, 3N)`` NumPy matrix.

    ``off`` is the upper band; the lower band is its blockwise transpose
    (symmetric operators). Host setup helper.
    """
    diag = np.asarray(diag)
    off = np.asarray(off)
    n_nodes = diag.shape[-3]
    n = 3 * n_nodes
    M = np.zeros((*diag.shape[:-3], n, n), dtype=diag.dtype)
    for i in range(n_nodes):
        M[..., 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = diag[..., i, :, :]
    for i in range(n_nodes - 1):
        M[..., 3 * i : 3 * i + 3, 3 * i + 3 : 3 * i + 6] = off[..., i, :, :]
        M[..., 3 * i + 3 : 3 * i + 6, 3 * i : 3 * i + 3] = np.swapaxes(
            off[..., i, :, :], -1, -2
        )
    return M


def dense_mass_matrix(arrays: BeamArrays) -> np.ndarray:
    """Dense global mass matrix (host)."""
    return dense_from_block_tridiagonal(*mass_block_tridiagonal(arrays))


def dense_linear_stiffness_matrix(arrays: BeamArrays) -> np.ndarray:
    """Dense global stiffness for purely linear beams (host).

    The caller is responsible for the all-linear check (the beam facade
    raises otherwise).
    """
    Ke = np.asarray(
        elements.linear_stiffness_matrix(
            arrays.length,
            arrays.elastic_modulus,
            arrays.moment_inertia,
            arrays.cross_area,
        )
    )  # (E, 6, 6)
    return dense_from_block_tridiagonal(_sum_node_blocks(Ke), Ke[..., 0:3, 3:6])


# ---------------------------------------------------------------------------
# Element <-> global state plumbing, internal force
# ---------------------------------------------------------------------------


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _zeros_like_shape(ref, shape):
    if isinstance(ref, torch.Tensor):
        return ref.new_zeros(shape)
    return np.zeros(shape, dtype=ref.dtype)


def gather_element_states(q_full):
    """``(..., 3N) -> (..., E, 6)``: each element sees its two nodes' DOFs."""
    *batch, n_dofs = q_full.shape
    qn = q_full.reshape(*batch, n_dofs // 3, 3)
    return _cat([qn[..., :-1, :], qn[..., 1:, :]], -1)


def scatter_add_element_forces(fe):
    """``(..., E, 6) -> (..., 3N)``: node i receives element i's first
    triple and element i-1's second triple."""
    *batch, n_el, _ = fe.shape
    out = _zeros_like_shape(fe, (*batch, n_el + 1, 3))
    out[..., :-1, :] += fe[..., :, 0:3]
    out[..., 1:, :] += fe[..., :, 3:6]
    return out.reshape(*batch, 3 * (n_el + 1))


def internal_force_full(arrays: BeamArrays, q_full, use_consistent: bool = False):
    """Global internal (stiffness) force ``k(q)`` in full coordinates."""
    fe = elements.element_internal_force(
        gather_element_states(q_full),
        arrays.length,
        arrays.elastic_modulus,
        arrays.moment_inertia,
        arrays.cross_area,
        arrays.nonlinear_mask,
        use_consistent=use_consistent,
    )
    return scatter_add_element_forces(fe)


def _index(idx, ref):
    idx = np.asarray(idx, np.int64)
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(idx, device=ref.device)
    return idx


def pad_to_full(v_red, free_dofs: np.ndarray, n_dofs_full: int):
    """Zero-pad a reduced vector back to full coordinates."""
    out = _zeros_like_shape(v_red, (*v_red.shape[:-1], n_dofs_full))
    out[..., _index(free_dofs, v_red)] = v_red
    return out


def reduce_from_full(v_full, free_dofs: np.ndarray):
    """Extract the free DOFs from a full-coordinate vector."""
    return v_full[..., _index(free_dofs, v_full)]


def make_reduced_internal_force(
    arrays: BeamArrays,
    free_dofs: np.ndarray,
    n_dofs_full: int,
    use_consistent: bool = False,
):
    """Reduced-coordinate stiffness function ``k_red(q_red)``: zero-pad the
    reduced state into full coordinates, evaluate, extract the free rows."""
    free_dofs = np.asarray(free_dofs)

    def k_red(q_red):
        q_full = pad_to_full(q_red, free_dofs, n_dofs_full)
        f_full = internal_force_full(arrays, q_full, use_consistent=use_consistent)
        return reduce_from_full(f_full, free_dofs)

    return k_red


@functools.lru_cache(maxsize=64)
def _element_taylor(row: tuple, use_consistent: bool):
    """``(J (6, 6), H (6, 6, 6), T (6, 6, 6, 6))``: the first three
    derivatives at 0 of the force of one element with parameters ``row =
    (L, E, I, A, nonlinear)``, host float64 (memoized: beams repeat one
    element)."""
    zero = torch.zeros(6, dtype=torch.float64)
    L, E, I, A = (torch.tensor(x, dtype=torch.float64) for x in row[:4])
    nl = torch.tensor(bool(row[4]))

    def f(q):
        return elements.element_internal_force(q, L, E, I, A, nl,
                                               use_consistent=use_consistent)

    jac = torch.func.jacfwd
    return tuple(d(zero).numpy() for d in (jac(f), jac(jac(f)), jac(jac(jac(f)))))


def polynomial_force_table(arrays: BeamArrays, free_dofs: np.ndarray,
                           use_consistent: bool = False):
    """The reduced internal force as an exact cubic: ``(factors, table)``.

    Every element of the port (linear, the parity von Kármán polynomials,
    the energy-consistent element) has a force that is a polynomial of
    degree at most 3 in its six DOFs ``q6``, so it equals its Taylor
    expansion at 0: ``f_o(q) = J_oi q_i + H_oij q_i q_j / 2 + T_oijk q_i
    q_j q_k / 6``. The derivatives come from ``torch.func.jacfwd`` of
    :func:`elements.element_internal_force` at 0, host float64, once for
    each distinct element. Summed over the elements and written in the
    reduced DOFs (a monomial with a fixed DOF vanishes), ``k_red(q) = W
    m(q)`` for the distinct monomials ``m`` of degree 1 to 3.

    Each monomial is the product of two entries of ``base = [1, q, (q_i
    q_j for i, j < n)]``: ``factors`` is the ``(2, F)`` index pair of each,
    ``table`` the host float64 ``W`` ``(n, F)``.
    """
    rows = np.stack([np.asarray(x, np.float64) for x in (
        arrays.length, arrays.elastic_modulus, arrays.moment_inertia,
        arrays.cross_area, arrays.nonlinear_mask)], -1)
    free = np.asarray(free_dofs)
    n = free.size
    red = -np.ones(3 * (rows.shape[0] + 1), np.int64)
    red[free] = np.arange(n)
    mult = {1: 1.0, 2: 3.0, 3: 6.0}  # distinct permutations of i <= j <= k
    cols, W = {}, {}
    for e, row in enumerate(rows.tolist()):
        J, H, T = _element_taylor(tuple(row), use_consistent)
        r = red[3 * e : 3 * e + 6]
        terms = [((i,), J[:, i]) for i in range(6)]
        terms += [((i, j), H[:, i, j] * (0.5 if i == j else 1.0))
                  for i in range(6) for j in range(i, 6)]
        terms += [((i, j, k), T[:, i, j, k] * (mult[len({i, j, k})] / 6.0))
                  for i in range(6) for j in range(i, 6) for k in range(j, 6)]
        for idx, coef in terms:
            mono = tuple(sorted(int(r[i]) for i in idx))
            if mono[0] < 0:
                continue  # a fixed DOF: the monomial is 0
            for o in range(6):
                if r[o] >= 0 and coef[o] != 0.0:
                    col = cols.setdefault(mono, len(cols))
                    W[(int(r[o]), col)] = W.get((int(r[o]), col), 0.0) + coef[o]
    table = np.zeros((n, len(cols)))
    for (i, c), w in W.items():
        table[i, c] = w

    def factor_pair(mono):
        if len(mono) == 1:
            return 1 + mono[0], 0
        pair = 1 + n + n * mono[0] + mono[1]
        return pair, (0 if len(mono) == 2 else 1 + mono[2])

    factors = np.array([factor_pair(m) for m in cols], np.int64).T
    return factors, table


def make_polynomial_internal_force(
    arrays: BeamArrays,
    free_dofs: np.ndarray,
    use_consistent: bool = False,
):
    """Reduced-coordinate ``k_red(q_red)`` of a small beam as one
    contraction of monomials of the reduced state with the summed element
    force's coefficients (:func:`polynomial_force_table`).

    Eight tensor operations a call, where the elementwise planes take
    about 200: the explicit integrators evaluate it once a stage. The
    contraction is an elementwise product and a last-axis sum, so its bits
    do not depend on the batch. Equal to :func:`make_reduced_internal_force`
    to roundoff; the table goes to a tensor's device and dtype on first use
    there. Its temporaries grow as ``envs x n x monomials``: meant for beams
    of a few elements.
    """
    factors, table = polynomial_force_table(arrays, free_dofs, use_consistent)
    uploads = {}

    def consts(q):
        key = (q.device, q.dtype)
        if key not in uploads:
            uploads[key] = (
                torch.as_tensor(factors[0], device=q.device),
                torch.as_tensor(factors[1], device=q.device),
                torch.as_tensor(table, dtype=q.dtype, device=q.device),
            )
        return uploads[key]

    def k_red(q_red):
        fa, fb, W = consts(q_red)
        outer = (q_red[..., :, None] * q_red[..., None, :]).flatten(-2)
        base = torch.cat([torch.nn.functional.pad(q_red, (1, 0), value=1.0), outer], -1)
        mono = base.index_select(-1, fa) * base.index_select(-1, fb)
        return (mono[..., None, :] * W).sum(-1)

    return k_red


def make_reduced_internal_force_np(
    arrays: BeamArrays, free_dofs: np.ndarray, n_dofs_full: int
):
    """Host NumPy float64 twin of :func:`make_reduced_internal_force`
    (parity element): ``k_red(q_red)`` for a 1-D reduced state."""
    free = np.asarray(free_dofs)
    L = np.asarray(arrays.length, np.float64)
    E = np.asarray(arrays.elastic_modulus, np.float64)
    I = np.asarray(arrays.moment_inertia, np.float64)
    A = np.asarray(arrays.cross_area, np.float64)
    nl = np.asarray(arrays.nonlinear_mask)

    def k_red(q_red: np.ndarray) -> np.ndarray:
        q_full = np.zeros(n_dofs_full)
        q_full[free] = np.asarray(q_red, np.float64)
        qn = q_full.reshape(-1, 3)
        q6 = np.concatenate([qn[:-1], qn[1:]], axis=1)  # (E, 6)
        fe = np.asarray(elements.element_internal_force(q6, L, E, I, A, nl))
        out = np.zeros_like(qn)
        out[:-1] += fe[:, 0:3]
        out[1:] += fe[:, 3:6]
        return out.reshape(-1)[free]

    return k_red


def planar_permutation(n_nodes: int) -> np.ndarray:
    """Row permutation: interleaved full DOFs ``[u0,w0,t0,u1,...]`` ->
    planar ``[u0..uN, w0..wN, t0..tN]``; ``perm[c * n_nodes + i] = 3 i + c``."""
    return np.arange(3 * n_nodes).reshape(n_nodes, 3).T.reshape(-1)


def _param_like(x, q_p):
    if isinstance(q_p, torch.Tensor):
        return torch.tensor(np.asarray(x), dtype=q_p.dtype, device=q_p.device)
    return np.asarray(x, dtype=q_p.dtype)


def _scatter_planes(q_p, planes):
    """Node force planes ``(..., 3, n_nodes)`` from six element slot planes
    ``(..., E)``: node i sums element i's node-1 slot and element i-1's
    node-2 slot."""
    fa1, ft1, fm1, fa2, ft2, fm2 = planes
    out = _zeros_like_shape(q_p, q_p.shape)
    out[..., 0, :-1] += fa1
    out[..., 1, :-1] += ft1
    out[..., 2, :-1] += fm1
    out[..., 0, 1:] += fa2
    out[..., 1, 1:] += ft2
    out[..., 2, 1:] += fm2
    return out


def _element_args(q_p, L, D, A):
    u, w, t = q_p[..., 0, :], q_p[..., 1, :], q_p[..., 2, :]
    return (u[..., :-1], w[..., :-1], t[..., :-1],
            u[..., 1:], w[..., 1:], t[..., 1:], L, D, A)


def _where(mask, a, b):
    if isinstance(a, torch.Tensor):
        return torch.where(torch.as_tensor(mask, device=a.device), a, b)
    return np.where(mask, a, b)


def make_planar_internal_force(arrays: BeamArrays, use_consistent: bool = False):
    """Planar-layout internal force ``k(q_p)`` in full coordinates.

    ``q_p``: ``(..., 3, n_nodes)`` state planes ``[u; w; theta]`` (the
    :func:`planar_permutation` image of the interleaved state); returns
    force planes of the same shape. Linear, nonlinear and hybrid masks; the
    nonlinear element is the parity one, or the energy-consistent one with
    ``use_consistent=True``. The element parameters (and a hybrid beam's
    mask) go to a tensor's device and dtype once.
    """
    nl_mask = np.asarray(arrays.nonlinear_mask)
    all_nl = bool(nl_mask.all())
    all_lin = not bool(nl_mask.any())
    L_h = np.asarray(arrays.length)
    D_h = np.asarray(arrays.elastic_modulus) * np.asarray(arrays.moment_inertia)
    A_h = np.asarray(arrays.elastic_modulus) * np.asarray(arrays.cross_area)
    nl_planes = (elements.consistent_force_planes if use_consistent
                 else elements.nonlinear_force_planes)
    uploads = {}

    def params(q_p):
        if not isinstance(q_p, torch.Tensor):
            return tuple(_param_like(x, q_p) for x in (L_h, D_h, A_h)) + (nl_mask,)
        key = (q_p.device, q_p.dtype)
        if key not in uploads:
            uploads[key] = tuple(_param_like(x, q_p) for x in (L_h, D_h, A_h)) + (
                torch.as_tensor(nl_mask, device=q_p.device),)
        return uploads[key]

    def k_planar(q_p):
        *LDA, mask = params(q_p)
        args = _element_args(q_p, *LDA)
        if all_nl:
            planes = nl_planes(*args)
        elif all_lin:
            planes = elements.linear_force_planes(*args)
        else:
            nl = nl_planes(*args)
            lin = elements.linear_force_planes(*args)
            planes = tuple(_where(mask, a, b) for a, b in zip(nl, lin))
        return _scatter_planes(q_p, planes)

    return k_planar


def make_planar_correction_force(arrays: BeamArrays, element_slice=None):
    """Planar-layout nonlinear correction force ``g(q_p) = k(q_p) - K0 q_p``.

    Zero for linear elements; returns None for all-linear beams.
    ``element_slice`` restricts the evaluation to a contiguous element run:
    the caller then feeds node planes ``(..., 3, stop - start + 1)`` and
    gets force planes of the same shape (the modal-ROM engine's window).
    """
    nl_mask = np.asarray(arrays.nonlinear_mask)
    if not nl_mask.any():
        return None
    sl = element_slice if element_slice is not None else slice(None)
    nl_mask = nl_mask[sl]
    all_nl = bool(nl_mask.all())
    L_h = np.asarray(arrays.length)[sl]
    D_h = (np.asarray(arrays.elastic_modulus) * np.asarray(arrays.moment_inertia))[sl]
    A_h = (np.asarray(arrays.elastic_modulus) * np.asarray(arrays.cross_area))[sl]

    def g_planar(q_p):
        args = _element_args(q_p, *(_param_like(x, q_p) for x in (L_h, D_h, A_h)))
        planes = elements.nonlinear_correction_planes(*args)
        if not all_nl:
            planes = tuple(_where(nl_mask, p, 0.0) for p in planes)
        return _scatter_planes(q_p, planes)

    return g_planar


def nonlinear_support(arrays: BeamArrays):
    """Contiguous element run covering every nonlinear element.

    Returns ``(elem_slice, node_slice)`` (interior linear elements are
    masked by the caller), or ``(None, None)`` for all-linear beams.
    """
    nl = np.flatnonzero(np.asarray(arrays.nonlinear_mask))
    if nl.size == 0:
        return None, None
    i0, i1 = int(nl[0]), int(nl[-1])
    return slice(i0, i1 + 1), slice(i0, i1 + 2)


def reduce_matrix(M, free_dofs: np.ndarray):
    """``M[free][:, free]`` — row/column deletion of the constrained DOFs."""
    if isinstance(M, torch.Tensor):
        free_dofs = torch.as_tensor(
            np.asarray(free_dofs, np.int64), device=M.device
        )
    return M[..., free_dofs, :][..., :, free_dofs]


# ---------------------------------------------------------------------------
# Tangent stiffness (for the implicit integrators)
# ---------------------------------------------------------------------------


def _field_like(x, dtype, device) -> torch.Tensor:
    """A parameter field on ``device`` in ``dtype``: a tensor keeps its graph
    (and its tangent), a host array is uploaded."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def element_params(arrays: BeamArrays, like: torch.Tensor):
    """``(L, E, I, A, nonlinear_mask)`` as tensors on ``like``'s device and
    dtype (the mask as bool): upload once and pass them to the element
    functions, which then copy nothing from the host. Fields that are
    tensors (traced parameters, batched ``(n_envs, E)`` or not) pass
    through with their graph, so derivatives reach them."""
    return tuple(
        _field_like(x, like.dtype, like.device)
        for x in (arrays.length, arrays.elastic_modulus, arrays.moment_inertia,
                  arrays.cross_area)
    ) + (_field_like(arrays.nonlinear_mask, torch.bool, like.device),)


def element_tangent_stiffness(arrays: BeamArrays, q6, use_consistent: bool = False,
                              params=None):
    """Per-element tangent ``df/dq`` blocks ``(..., E, 6, 6)`` at ``q6``
    ``(..., E, 6)``: the forward-mode Jacobian of the element force, as the
    JAX package's ``jacfwd``, taken as one ``torch.func.jvp`` of the whole
    batch for each of the six unit directions (``vmap``-ed over them; each
    element's force depends on its own six DOFs only). The elementwise
    Jacobian keeps the global tangent block-tridiagonal.

    A NumPy ``q6`` is evaluated in float64 on the CPU and returns NumPy;
    a tensor on its device and in its dtype, for both elements. (A
    ``jacfwd`` per element would see 0-dim state components, and under
    ``vmap`` a Python scalar times a 0-dim float32 tensor comes out float64:
    the parity element's tangent used to.) ``params``:
    :func:`element_params` already uploaded for that device and dtype, or
    tensors with a host NumPy mask; an all-linear host mask returns the
    element stiffness (the exact tangent) without forward AD. Inside a
    ``torch.autograd.forward_ad`` level the columns come from
    :func:`_cubic_columns` (forward AD does not nest). Reverse mode reaches
    tensor parameters through the ``jvp`` columns.
    """
    is_np = not isinstance(q6, torch.Tensor)
    q = torch.as_tensor(np.asarray(q6, np.float64)) if is_np else q6
    if params is None:
        params = element_params(arrays, q)

    def force(x):
        return elements.element_internal_force(x, *params, use_consistent=use_consistent)

    mask = params[4]
    units = torch.eye(6, dtype=q.dtype, device=q.device)
    if isinstance(mask, np.ndarray) and not mask.any():
        # Linear elements only (a host mask): the tangent is the element
        # stiffness itself, whatever the state.
        K = elements.linear_stiffness_matrix(*params[:4])
        Kt = torch.broadcast_to(K, torch.broadcast_shapes(q.shape[:-1], K.shape[:-2]) + (6, 6))
    elif fwAD._current_level >= 0:
        Kt = _cubic_columns(force, q, units)
    else:
        units = units.reshape((6,) + (1,) * (q.dim() - 1) + (6,)).expand((6,) + tuple(q.shape))
        cols = torch.func.vmap(lambda d: torch.func.jvp(force, (q,), (d,))[1])(units)
        Kt = cols.movedim(0, -1)  # (..., E, 6 force slots, 6 unit directions)
    return Kt.numpy() if is_np else Kt


def _cubic_columns(force, q, units):
    """The element Jacobian ``(..., E, 6, 6)`` at ``q`` without nested
    forward AD, for callers inside a ``torch.autograd.forward_ad`` level
    (``torch.func.jvp`` cannot open a second one): every element force is a
    polynomial of degree 3 in its six DOFs, so along a unit direction ``p(s)
    = f(q + s h e_j)`` has the exact derivative ``[8 (p(1) - p(-1)) - (p(2)
    - p(-2))] / (12 h)``; one batched force call of the 4 x 6 points. The
    step ``h`` is the element's ``max |q|`` (at least 1e-6), where the
    roundoff of the cancelling terms stays a few ulps of the tangent's
    scale. Plain ops: the outer level's tangents flow through."""
    h = q.detach().abs().amax(-1, keepdim=True).clamp(min=1e-6)  # (..., E, 1)
    s = torch.tensor([1.0, -1.0, 2.0, -2.0], dtype=q.dtype, device=q.device)
    lead = (1,) * (q.dim() - 1)
    steps = s.reshape(4, 1, *lead, 1) * units.reshape(1, 6, *lead, 6)  # (4, 6, ..., 6)
    p = force(q + steps * h)
    cols = (8.0 * (p[0] - p[1]) - (p[2] - p[3])) / (12.0 * h)  # (6, ..., E, 6)
    return cols.movedim(0, -1)


def tangent_block_tridiagonal(arrays: BeamArrays, q_full, use_consistent: bool = False,
                              params=None):
    """Global tangent stiffness in block-tridiagonal form at state ``q_full``.

    Returns ``(diag (..., N, 3, 3), lower (..., E, 3, 3), upper (..., E, 3,
    3))``. The parity element's tangent is not symmetric, so lower and upper
    bands are kept separately. NumPy in, NumPy out (float64, evaluated on
    the CPU); tensors stay on their device.
    """
    Kt = element_tangent_stiffness(
        arrays, gather_element_states(q_full), use_consistent=use_consistent,
        params=params,
    )
    return _sum_node_blocks(Kt), Kt[..., 3:6, 0:3], Kt[..., 0:3, 3:6]

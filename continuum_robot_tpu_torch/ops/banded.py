"""Block-tridiagonal (3x3 blocks) linear algebra for beam operators.

Counterpart of ``continuum_robot_tpu/ops/banded.py``. The global mass and
tangent-stiffness operators of a 1-D FEM chain couple only adjacent nodes,
so they are block-tridiagonal with 3x3 blocks (``models/assembly.py``);
this module factors and solves them in O(N).

Representation: ``(diag, lower, upper)`` with shapes ``(..., N, 3, 3)``,
``(..., N-1, 3, 3)``, ``(..., N-1, 3, 3)``; ``lower[i]`` couples node i+1 to
node i, ``upper[i]`` couples node i to node i+1.

Every function takes NumPy arrays (host setup, returns NumPy; the implicit
operator prefactors in float64 this way) or torch tensors (returns tensors
on their device and dtype), and broadcasts over leading batch axes: a
shared factorization solves a whole environment batch, and a per-env
factorization (full Newton) solves each env against its own. The JAX
package's scans over nodes are Python loops over nodes here, each step one
batched op over the environments.

:func:`btd_solve` is the plain version of the CUDA kernel
``ops/cuda/btd_solve.btd_solve``: each 3x3 product row is summed as ``acc =
m0*v0; acc += m1*v1; acc += m2*v2`` (the order of the Pallas kernel's
``matvec33``), which the kernel repeats with unfused multiplies and adds,
so the two agree bit for bit. :func:`btd_solve_adjoint` is its reverse-mode
derivative, the plain version of the kernel ``btd_solve_adjoint``
(:func:`btd_adjoint_sweeps`, same order), and :func:`btd_solve_tangent_rhs`
the right-hand side of its forward-mode derivative; on tensors every
function here is also differentiable by torch's autograd directly.
"""

from __future__ import annotations

import numpy as np
import torch


def _ns(*args):
    """Pick the array namespace: torch if any argument is a tensor, else NumPy."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return torch
    return np


def _stack(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=axis)
    return np.stack(parts, axis=axis)


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _zeros(ref, shape):
    if isinstance(ref, torch.Tensor):
        return ref.new_zeros(shape)
    return np.zeros(shape, dtype=ref.dtype)


def _eye3(ref):
    if isinstance(ref, torch.Tensor):
        return torch.eye(3, dtype=ref.dtype, device=ref.device)
    return np.eye(3, dtype=ref.dtype)


def inv33(m):
    """Explicit adjugate inverse of 3x3 blocks, batched over leading axes."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d

    det = a * A + b * B + c * C
    adj = _stack(
        [_stack([A, D, G], -1), _stack([B, E, H], -1), _stack([C, F, I], -1)],
        -2,
    )
    return adj / det[..., None, None]


def _mv(m, v):
    """Blockwise ``m @ v``: ``(..., n, 3, 3) x (..., n, 3) -> (..., n, 3)``."""
    return _ns(m, v).einsum("...nij,...nj->...ni", m, v)


def btd_matvec(diag, lower, upper, x):
    """``y = T x`` for block-tridiagonal ``T``; ``x``: ``(..., N, 3)``."""
    y = _mv(diag, x)
    y[..., 1:, :] += _mv(lower, x[..., :-1, :])
    y[..., :-1, :] += _mv(upper, x[..., 1:, :])
    return y


def btd_factor(diag, lower, upper):
    """Block-Thomas forward elimination (no pivoting — SPD/diag-dominant use).

    Returns factors ``(dinv, lw, upper)`` where ``dinv[i]`` is the inverse of
    the i-th Schur-complement pivot ``D_i = A_i - C_{i-1} D_{i-1}^{-1}
    B_{i-1}`` and ``lw[i] = C_i D_i^{-1}`` is the forward-substitution
    multiplier. A loop over nodes; the block algebra broadcasts over leading
    axes.
    """
    n = diag.shape[-3]
    dinvs = [inv33(diag[..., 0, :, :])]
    ws = []
    for i in range(1, n):
        w = lower[..., i - 1, :, :] @ dinvs[-1]  # C D^{-1}
        dinvs.append(inv33(diag[..., i, :, :] - w @ upper[..., i - 1, :, :]))
        ws.append(w)
    dinv = _stack(dinvs, -3)
    lw = _stack(ws, -3) if ws else _zeros(dinv, dinv.shape[:-3] + (0, 3, 3))
    return dinv, lw, upper


def _matvec33(m, v):
    """``m @ v`` for blocks ``(..., 3, 3)`` and vectors ``(..., 3)``, each
    row summed as ``m0*v0 + m1*v1 + m2*v2`` from the left."""
    return m[..., :, 0] * v[..., 0:1] + m[..., :, 1] * v[..., 1:2] + m[..., :, 2] * v[..., 2:3]


def btd_solve(factors, b):
    """Solve ``T x = b`` from :func:`btd_factor` output; ``b``: ``(..., N, 3)``.

    Forward sweep ``y_0 = b_0, y_i = b_i - (C D^{-1})_{i-1} y_{i-1}``, then
    backward sweep ``x_{N-1} = D_{N-1}^{-1} y_{N-1}, x_i = D_i^{-1} (y_i -
    B_i x_{i+1})``. Factors and ``b`` broadcast against each other. The
    plain version of the CUDA kernel (same operations, same order).
    """
    dinv, lw, upper = factors
    n = b.shape[-2]
    ys = [b[..., 0, :]]
    for i in range(1, n):
        ys.append(b[..., i, :] - _matvec33(lw[..., i - 1, :, :], ys[-1]))
    xs = [None] * n
    xs[-1] = _matvec33(dinv[..., n - 1, :, :], ys[-1])
    for i in range(n - 2, -1, -1):
        xs[i] = _matvec33(
            dinv[..., i, :, :], ys[i] - _matvec33(upper[..., i, :, :], xs[i + 1])
        )
    return _stack(xs, -2)


def _matvec33_t(m, v):
    """``m^T @ v`` for blocks ``(..., 3, 3)`` and vectors ``(..., 3)``: entry
    j summed as ``m0j*v0 + m1j*v1 + m2j*v2`` from the left."""
    return m[..., 0, :] * v[..., 0:1] + m[..., 1, :] * v[..., 1:2] + m[..., 2, :] * v[..., 2:3]


def _sum_to(x, shape):
    """``x`` summed over the leading and broadcast axes down to ``shape``."""
    shape = tuple(shape)
    lead = x.dim() - len(shape)
    if lead:
        x = x.sum(tuple(range(lead)))
    axes = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(axes, keepdim=True) if axes else x


def btd_adjoint_sweeps(factors, b, g):
    """The sequential part of :func:`btd_solve_adjoint`: ``(y, s, b_bar)``.

    ``y`` is the forward sweep of :func:`btd_solve` on ``b`` (``y_0 = b_0``,
    ``y_i = b_i - W_{i-1} y_{i-1}``, ``W = lw``); then, for the cotangent
    ``g = dL/dx``, an ascending sweep ``xbar_0 = g_0``, ``xbar_i = g_i -
    U_{i-1}^T s_{i-1}``, ``s_i = Dinv_i^T xbar_i`` and a descending one
    ``b_bar_{N-1} = s_{N-1}``, ``b_bar_i = s_i - W_i^T b_bar_{i+1}``. Every
    3x3 product is summed from the left (:func:`_matvec33`,
    :func:`_matvec33_t`): the plain version of the CUDA kernel
    ``btd_solve_adjoint``, which computes the same three arrays in the same
    order."""
    dinv, lw, upper = factors
    n = b.shape[-2]
    ys = [b[..., 0, :]]
    for i in range(1, n):
        ys.append(b[..., i, :] - _matvec33(lw[..., i - 1, :, :], ys[-1]))
    ss = [_matvec33_t(dinv[..., 0, :, :], g[..., 0, :])]
    for i in range(1, n):
        xbar = g[..., i, :] - _matvec33_t(upper[..., i - 1, :, :], ss[-1])
        ss.append(_matvec33_t(dinv[..., i, :, :], xbar))
    bbar = [None] * n
    bbar[-1] = ss[-1]
    for i in range(n - 2, -1, -1):
        bbar[i] = ss[i] - _matvec33_t(lw[..., i, :, :], bbar[i + 1])
    return _stack(ys, -2), _stack(ss, -2), _stack(bbar, -2)


def btd_adjoint_factors(factors, x, g, y, s, bbar):
    """The factor cotangents of :func:`btd_solve_adjoint` from the sweeps'
    arrays: ``dinv_bar_i = sum xbar_i t_i^T`` (``t_i = y_i - U_i x_{i+1}``,
    ``xbar_i = g_i - U_{i-1}^T s_{i-1}``), ``upper_bar_i = -sum s_i
    x_{i+1}^T`` and ``lw_bar_i = -sum b_bar_{i+1} y_i^T``, each summed over
    the right-hand sides' batch down to the factor's shape (one batched
    product a node for factors shared by the whole batch). Vectorized over
    the nodes: the kernel and the plain sweeps share it."""
    dinv, lw, upper = factors
    xbar = g.clone()
    xbar[..., 1:, :] = g[..., 1:, :] - _matvec33_t(upper, s[..., :-1, :])
    t = y.clone()
    t[..., :-1, :] = y[..., :-1, :] - _matvec33(upper, x[..., 1:, :])

    def outer(a, c, like):
        if like.dim() == 3:  # shared factors: one (3, B) x (B, 3) product a node
            a2 = a.flatten(0, -3) if a.dim() > 2 else a[None]
            c2 = c.flatten(0, -3) if c.dim() > 2 else c[None]
            return torch.einsum("bni,bnj->nij", a2, c2)
        return _sum_to(a[..., :, None] * c[..., None, :], like.shape)

    dinv_bar = outer(xbar, t, dinv)
    upper_bar = -outer(s[..., :-1, :], x[..., 1:, :], upper)
    lw_bar = -outer(bbar[..., 1:, :], y[..., :-1, :], lw)
    return dinv_bar, lw_bar, upper_bar


def btd_solve_adjoint(factors, b, x, g):
    """Reverse-mode derivative of :func:`btd_solve`: ``x = T^{-1} b``.

    ``factors`` ``(dinv, lw, upper)`` from :func:`btd_factor`, ``b`` the
    right-hand sides, ``x`` the solve's result and ``g = dL/dx``, all
    tensors. Returns ``(dinv_bar, lw_bar, upper_bar, b_bar)``: the
    cotangents of the three factors (summed over the batch the factors are
    broadcast over) and of ``b``. With ``T = L R`` (``L`` unit lower with
    subdiagonal ``W = lw``, ``R`` upper with diagonal ``D_i = dinv_i^{-1}``
    and superdiagonal ``U = upper``), the forward is ``y = L^{-1} b``, ``t_i
    = y_i - U_i x_{i+1}``, ``x_i = dinv_i t_i``; the adjoint runs the sweeps
    of :func:`btd_adjoint_sweeps` (the CUDA kernel's plain version, with the
    same order of operations) and the batch reductions of
    :func:`btd_adjoint_factors`.
    """
    y, s, bbar = btd_adjoint_sweeps(factors, b, g)
    dinv_bar, lw_bar, upper_bar = btd_adjoint_factors(factors, x, g, y, s, bbar)
    return dinv_bar, lw_bar, upper_bar, _sum_to(bbar, b.shape)


def btd_solve_tangent_rhs(factors, x, tangents, b_dot):
    """Right-hand side ``c`` of the forward-mode derivative of
    :func:`btd_solve`: ``x_dot = T^{-1} c``, ``c = b_dot - L_dot y - L
    (R_dot x)``.

    ``tangents``: the tangents ``(dinv_dot, lw_dot, upper_dot)`` of the
    factors (None for none), ``b_dot`` that of the right-hand side (or
    None); ``x`` the solve's result. With ``D = dinv^{-1}`` (:func:`inv33`),
    ``t_i = D_i x_i`` and ``y_i = t_i + U_i x_{i+1}``: ``(L_dot y)_i =
    W_dot_{i-1} y_{i-1}``, ``(R_dot x)_i = -D_i dinv_dot_i t_i + U_dot_i
    x_{i+1}`` and ``(L z)_i = z_i + W_{i-1} z_{i-1}``. Vectorized over the
    nodes; one more solve (the forward kernel on the card) gives the
    tangent."""
    dinv, lw, upper = factors
    d_dinv, d_lw, d_up = tangents
    c = torch.zeros_like(x) if b_dot is None else b_dot.expand(x.shape).clone()
    needs_t = d_dinv is not None or d_lw is not None
    if needs_t:
        D = inv33(dinv)
        t = _mv(D, x)
    if d_lw is not None:
        y = t.clone()
        y[..., :-1, :] = t[..., :-1, :] + _mv(upper, x[..., 1:, :])
        c[..., 1:, :] = c[..., 1:, :] - _mv(d_lw, y[..., :-1, :])
    rx = None
    if d_dinv is not None:
        rx = -_mv(D, _mv(d_dinv, t))
    if d_up is not None:
        ux = torch.zeros_like(x)
        ux[..., :-1, :] = _mv(d_up, x[..., 1:, :])
        rx = ux if rx is None else rx + ux
    if rx is not None:
        lrx = rx.clone()
        lrx[..., 1:, :] = rx[..., 1:, :] + _mv(lw, rx[..., :-1, :])
        c = c - lrx
    return c


# ---------------------------------------------------------------------------
# Block cyclic reduction: log-depth solves for latency-bound (small-batch)
# long beams
# ---------------------------------------------------------------------------


def btd_cr_factor(diag, lower, upper):
    """Block cyclic-reduction factorization (log-depth alternative to Thomas).

    Eliminates the even-indexed nodes level by level, halving the system
    ``ceil(log2(N+1))`` times; every level is one batched set of 3x3 block
    ops over the whole remaining chain. The chain is zero-padded to ``2^L -
    1`` nodes with identity pivots (padding decouples exactly). Same input
    convention as :func:`btd_factor`; returns an opaque factor dict for
    :func:`btd_cr_solve`.
    """
    n = diag.shape[-3]
    batch = tuple(diag.shape[:-3])
    L = max(1, int(np.ceil(np.log2(n + 1))))
    m_pad = 2**L - 1

    def zpad(x, k):
        if k == 0:
            return x
        return _cat([x, _zeros(diag, batch + (k, 3, 3))], -3)

    if m_pad > n:
        eye = _ns(diag).broadcast_to(_eye3(diag), batch + (m_pad - n, 3, 3))
        A = _cat([diag, eye], -3)
    else:
        A = diag
    # Full-length couplings: C[i] couples node i to i-1 (C[0] = 0), B[i]
    # couples node i to i+1 (B[M-1] = 0).
    C = zpad(_cat([_zeros(diag, batch + (1, 3, 3)), lower], -3), m_pad - n)
    B = zpad(upper, m_pad - (n - 1))

    levels = []
    for _ in range(L):
        m = A.shape[-3]
        if m == 1:
            levels.append((inv33(A), None, None, None, None))
            break
        Ainv_e = inv33(A[..., 0::2, :, :])
        Ce, Be = C[..., 0::2, :, :], B[..., 0::2, :, :]
        Ao = A[..., 1::2, :, :]
        Co, Bo = C[..., 1::2, :, :], B[..., 1::2, :, :]
        # Odd node j = 2p+1 has even neighbours j-1 (even slot p) and j+1
        # (even slot p+1); eliminate both into j's equation.
        W1 = Co @ Ainv_e[..., :-1, :, :]  # C_j A_{j-1}^{-1}
        W2 = Bo @ Ainv_e[..., 1:, :, :]  # B_j A_{j+1}^{-1}
        A_next = Ao - W1 @ Be[..., :-1, :, :] - W2 @ Ce[..., 1:, :, :]
        C_next = -(W1 @ Ce[..., :-1, :, :])  # boundary: Ce[0]=0 keeps C[0]=0
        B_next = -(W2 @ Be[..., 1:, :, :])  # boundary: Be[-1]=0 keeps B[-1]=0
        levels.append((Ainv_e, Ce, Be, W1, W2))
        A, C, B = A_next, C_next, B_next

    return {"levels": tuple(levels), "n": n, "m_pad": m_pad}


def btd_cr_solve(factors, b):
    """Solve ``T x = b`` from :func:`btd_cr_factor` output; ``b``: ``(..., N, 3)``.

    One downward rhs-reduction sweep and one upward back-substitution sweep,
    each ``ceil(log2(N+1))`` batched levels. Factors and ``b`` broadcast.
    """
    levels = factors["levels"]
    n, m_pad = int(factors["n"]), int(factors["m_pad"])
    if m_pad > n:
        b = _cat([b, _zeros(b, tuple(b.shape[:-2]) + (m_pad - n, 3))], -2)

    # Downward: fold the even-node equations into the odd ones.
    saved = []
    for _, _, _, W1, W2 in levels[:-1]:
        be, bo = b[..., 0::2, :], b[..., 1::2, :]
        saved.append(be)
        b = bo - _mv(W1, be[..., :-1, :]) - _mv(W2, be[..., 1:, :])

    # Root (single node).
    x = _mv(levels[-1][0], b)

    # Upward: recover the even nodes from the now-known odd ones.
    for (Ainv_e, Ce, Be, _, _), be in zip(reversed(levels[:-1]), reversed(saved)):
        zero = _zeros(x, tuple(x.shape[:-2]) + (1, 3))
        x_left = _cat([zero, x], -2)  # x_{i-1}; 0 at i=0
        x_right = _cat([x, zero], -2)  # x_{i+1}; 0 at i=m-1
        xe = _mv(Ainv_e, be - _mv(Ce, x_left) - _mv(Be, x_right))
        # Interleave evens (q+1) and odds (q) -> 2q+1 nodes.
        pair = _stack([xe[..., :-1, :], x], -2)
        merged = pair.reshape(*pair.shape[:-3], -1, 3)
        x = _cat([merged, xe[..., -1:, :]], -2)

    return x[..., :n, :]


def btd_apply_bc(diag, lower, upper, free_mask_nodes):
    """Impose constraints on a block-tridiagonal operator without reshaping.

    ``free_mask_nodes``: ``(N, 3)`` boolean. Constrained rows/cols are zeroed
    and the diagonal gets 1.0 there, so solving ``T~ x = S f`` yields exactly
    the reduced-system solution with zeros at constrained DOFs. Tensors take
    the mask on their device (pass it as a tensor there to avoid a copy).
    """
    if isinstance(diag, torch.Tensor):
        m = torch.as_tensor(free_mask_nodes, device=diag.device).to(diag.dtype)
    else:
        m = np.asarray(free_mask_nodes).astype(diag.dtype)
    diag = diag * m[..., :, :, None] * m[..., :, None, :]
    diag = diag + (1.0 - m)[..., :, :, None] * _eye3(diag)  # unit pivot on constrained DOFs
    lower = lower * m[..., 1:, :, None] * m[..., :-1, None, :]
    upper = upper * m[..., :-1, :, None] * m[..., 1:, None, :]
    return diag, lower, upper

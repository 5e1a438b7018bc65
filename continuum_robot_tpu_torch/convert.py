"""Carry engines and parameters across from the JAX package.

The JAX package's :class:`ModalGenAlpha`, :class:`ModalROMGenAlpha` and
``BeamArrays`` hold host NumPy arrays, so their fields convert directly.
Building the port's engine from the JAX engine's basis holds both packages
to the same modes: eigenvector signs and ARPACK roundoff from two
eigensolves need not agree. Entry points here run on the card unless the
caller names a device (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import assembly
from .models.config import BeamArrays
from .models.simulate import (
    ModalGenAlpha,
    ModalROMGenAlpha,
    _planar_window,
    resolve_device,
)


def _f64(x):
    return None if x is None else np.array(x, dtype=np.float64)


def modal_engine_from_numpy(Phi, PhiTM, lam, rho_inf: float, dt: float,
                            cdamp=None, device=None,
                            dtype: torch.dtype = torch.float64) -> ModalGenAlpha:
    """The port's :class:`ModalGenAlpha` from host arrays (float64).

    ``device``/``dtype``: where inputs given as NumPy arrays go (None: the
    card).
    """
    return ModalGenAlpha(
        Phi=_f64(Phi), PhiTM=_f64(PhiTM), lam=_f64(lam), rho_inf=float(rho_inf),
        dt=float(dt), cdamp=_f64(cdamp), device=resolve_device(device),
        dtype=dtype,
    )


def modal_rom_engine_from_numpy(Phi, PhiW, PhiTM, Sinv, lam, rho_inf: float,
                                dt: float, model, Sinv_diag=None, cdamp=None,
                                device=None,
                                dtype: torch.dtype = torch.float64
                                ) -> ModalROMGenAlpha:
    """The port's :class:`ModalROMGenAlpha` from a ROM engine's host arrays.

    ``Phi``/``PhiW`` ``(n, m)``: trial and test bases of the reduced
    system; ``PhiTM``, ``Sinv`` ``(m, m)``, ``lam``, ``Sinv_diag`` and
    ``cdamp`` as in the engine (``Sinv_diag=None`` keeps the dense Newton
    solve). ``model``: the port's beam, from which the planar window, its
    element parameters and the internal force are rebuilt. A hyper-reduced
    engine converts as its window engine followed by
    ``.apply_ecsw(sel, xi)`` with its sample. ``device``/``dtype``: where
    inputs given as NumPy arrays go (None: the card).
    """
    device = resolve_device(device)
    arrays = model.beam_model.arrays
    bc_info = model.beam_model.bc_info
    V, W = _f64(Phi), _f64(PhiW)
    Phi_p = W_p = planar_correction = window_params = None
    elem_sl, node_sl = assembly.nonlinear_support(arrays)
    if elem_sl is not None:
        Phi_p, W_p, planar_correction, window_params = _planar_window(
            arrays, bc_info, V, W, elem_sl, node_sl
        )
    return ModalROMGenAlpha(
        Phi=V, PhiW=W, PhiTM=_f64(PhiTM), Sinv=_f64(Sinv),
        rho_inf=float(rho_inf), dt=float(dt),
        internal_force=assembly.make_reduced_internal_force(
            arrays, bc_info.free_dofs, bc_info.n_dofs_full
        ),
        lam=_f64(lam), Phi_planar=Phi_p, PhiW_planar=W_p,
        planar_correction=planar_correction, window_params=window_params,
        Sinv_diag=_f64(Sinv_diag), cdamp=_f64(cdamp), device=device,
        dtype=dtype,
    )


def btd_factors_from_numpy(dinv, lw, upper, device=None,
                           dtype: torch.dtype = torch.float64):
    """The port's block-Thomas factors ``(dinv, lw, upper)`` from a
    factorization's host arrays (the JAX package's ``btd_factor`` output
    converted with ``np.asarray``), on ``device`` (None: the card) in
    ``dtype``: one factorization fed to both packages' solves."""
    device = resolve_device(device)
    return tuple(
        torch.as_tensor(np.array(x, dtype=np.float64), device=device).to(dtype)
        for x in (dinv, lw, upper)
    )


def fused_operators_from_numpy(M, K, Jinv, drag_coeffs, u, device=None,
                               dtype: torch.dtype = torch.float64):
    """The fused small-beam kernel's operands ``((M, K, Jinv), drag, u)``
    from host arrays (the JAX package's ``fused_gen_alpha_steps`` inputs
    converted with ``np.asarray``), on ``device`` (None: the card) in
    ``dtype``: one operator set fed to both packages' fused steps."""
    device = resolve_device(device)
    M, K, Jinv, drag_coeffs, u = (
        torch.as_tensor(np.array(x, dtype=np.float64), device=device).to(dtype)
        for x in (M, K, Jinv, drag_coeffs, u)
    )
    return (M, K, Jinv), drag_coeffs, u


def beam_arrays_from_numpy(length, elastic_modulus, moment_inertia, density,
                           cross_area, wetted_area=None, drag_coef=None,
                           nonlinear_mask=None, dtype=np.float64) -> BeamArrays:
    """The port's :class:`BeamArrays` from per-element host arrays.

    Absent fluid columns are zero and an absent mask is all-linear, as in
    ``beam_arrays_from_dataframe``.
    """
    length = np.array(length, dtype=dtype)
    n = length.shape[-1]

    def col(x):
        return np.zeros((n,), dtype) if x is None else np.array(x, dtype=dtype)

    return BeamArrays(
        length=length,
        elastic_modulus=col(elastic_modulus),
        moment_inertia=col(moment_inertia),
        density=col(density),
        cross_area=col(cross_area),
        wetted_area=col(wetted_area),
        drag_coef=col(drag_coef),
        nonlinear_mask=(np.zeros((n,), bool) if nonlinear_mask is None
                        else np.array(nonlinear_mask, dtype=bool)),
    )

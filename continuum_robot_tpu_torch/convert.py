"""Carry engines and parameters across from the JAX package.

The JAX package's :class:`ModalGenAlpha` and ``BeamArrays`` hold host NumPy
arrays, so their fields convert directly. Building the port's engine from
the JAX engine's eigenbasis holds both packages to the same modes:
eigenvector signs from two ``eigh`` calls need not agree.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.config import BeamArrays
from .models.simulate import ModalGenAlpha


def modal_engine_from_numpy(Phi, PhiTM, lam, rho_inf: float, dt: float,
                            cdamp=None, device="cpu",
                            dtype: torch.dtype = torch.float64) -> ModalGenAlpha:
    """The port's :class:`ModalGenAlpha` from host arrays (float64).

    ``device``/``dtype``: where inputs given as NumPy arrays go.
    """

    def f64(x):
        return None if x is None else np.array(x, dtype=np.float64)

    return ModalGenAlpha(
        Phi=f64(Phi), PhiTM=f64(PhiTM), lam=f64(lam), rho_inf=float(rho_inf),
        dt=float(dt), cdamp=f64(cdamp), device=torch.device(device),
        dtype=dtype,
    )


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

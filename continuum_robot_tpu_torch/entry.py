"""Entry point: one forward step of the flagship model on the card.

Counterpart of the JAX package's ``entry()`` (``__graft_entry__.py``):
:func:`entry` returns a forward step and its example arguments. The step is
one RK4 advance (h = 1e-5 s) of the full dynamic system, stiffness, fluid
drag, gravity and the input map, in reduced coordinates, on the flagship
model: a 6-segment hybrid linear / von Kármán Nitinol cantilever in water.

    from continuum_robot_tpu_torch.entry import entry
    step, (x0, u0) = entry()          # on the card
    x1 = step(x0, u0)
    step, args = entry(device="cpu")  # on the CPU
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from .models import DynamicEulerBernoulliBeam, ForceParams
from .models.simulate import resolve_device
from .ops.integrators import rk4_step

STEP = 1e-5  # s


def flagship_model(n_segments: int = 6, forces: bool = True) -> DynamicEulerBernoulliBeam:
    """The hybrid flagship cantilever: 0.25 m of Nitinol (E = 75 GPa, r = 5
    mm, rho = 6450 kg/m^3) in ``n_segments`` elements, the first half linear
    and the rest von Kármán, fixed at the base; with ``forces``, fluid drag
    in water (C_d 0.82) and gravity."""
    L, E, r, rho = 0.25, 75e9, 0.005, 6450.0
    n = n_segments
    df = pd.DataFrame({
        "length": [L / n] * n,
        "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n,
        "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n,
        "type": ["linear"] * (n // 2) + ["nonlinear"] * (n - n // 2),
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [2 * np.pi * r * L / n] * n,
        "drag_coef": [0.82] * n,
    })
    fp = ForceParams(enable_fluid_effects=True, fluid_density=1000.0,
                     enable_gravity_effects=True)
    return DynamicEulerBernoulliBeam(df, fp if forces else None)


def entry(device=None, dtype: torch.dtype = torch.float32):
    """``(forward_step, (x0, u0))``: one RK4 step of ``build_rhs()`` on the
    flagship model, with a 1 mm tip displacement and a 0.1 N tip force.
    The arguments live on ``device`` (None: the card) in ``dtype``."""
    device = resolve_device(device)
    model = flagship_model()
    rhs = model.build_rhs()
    n = model.n_pos_states

    def forward_step(x, u):
        return rk4_step(rhs, 0.0, x, STEP, u)

    x0 = torch.zeros(2 * n, dtype=dtype, device=device)
    x0[n - 2] = 1e-3
    u0 = torch.zeros(n, dtype=dtype, device=device)
    u0[-2] = 0.1
    return forward_step, (x0, u0)

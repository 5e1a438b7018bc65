"""Nonlinear large deflection: implicit integration under a large load.

Counterpart of the JAX package's ``examples/nonlinear_large_deflection.py``.
The nonlinear 6-segment cantilever in water is driven by a tip force ramped
up to the force whose linear static deflection is 10% of the length, then
held. Three engines integrate it:

* implicit generalized-alpha (full Newton on the block-tridiagonal tangent;
  on the card each solve is the ``btd_solve`` kernel);
* adaptive Dopri5 at a tight tolerance, the reference;
* the modal ROM with 9 modes and modal-derivative augmentation.

It also reports geometric stiffening: the nonlinear deflection is smaller
than the linear prediction ``F L^3 / (3 EI)``.

Usage: python -m continuum_robot_tpu_torch.examples.nonlinear_large_deflection
[--device cpu]
"""

from __future__ import annotations

import time

import torch

from ..models import DynamicEulerBernoulliBeam, ForceParams
from ..models.simulate import simulate
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    get_material_properties,
    host,
    parsed_placement,
    placement,
)


def ramp_input(n, F_tip, ramp_t, device, dtype):
    """``u(t) = tip * F_tip * clip(t / ramp_t, 0, 1)`` (float or tensor ``t``)."""
    tip = torch.zeros(n, dtype=dtype, device=device)
    tip[-2] = 1.0

    def u(t):
        if isinstance(t, torch.Tensor):
            return tip * F_tip * torch.clamp(t / ramp_t, 0.0, 1.0)[..., None]
        return tip * F_tip * min(max(t / ramp_t, 0.0), 1.0)

    return u


def run(t_final=1.0, dt=0.001, device=None, dtype=None, verbose=False) -> dict:
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        beam = DynamicEulerBernoulliBeam(
            nonlinear_file, ForceParams(enable_fluid_effects=True, fluid_density=1000.0),
        )
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    n = beam.n_pos_states
    props = get_material_properties()
    L_total = props["length"] * 6
    EI = props["E"] * props["MInertia"]

    # Ramp to the force of a 10%-of-length linear static deflection, then
    # hold: the drag damps transients toward the nonlinear equilibrium.
    F_tip = 0.10 * L_total * 3 * EI / L_total**3
    u = ramp_input(n, F_tip, 0.2, device, dtype)
    x0 = torch.zeros(2 * n, dtype=dtype, device=device)

    t0 = time.time()
    res_imp = simulate(beam, x0, t_final, dt, method="generalized_alpha", u=u,
                       substeps=10, n_newton=3, rho_inf=0.7)
    tip_imp = host(res_imp.ys)[:, n - 2]
    t_imp = time.time() - t0

    rtol, atol = (1e-8, 1e-11) if dtype == torch.float64 else (1e-5, 1e-8)
    t0 = time.time()
    res_exp = simulate(beam, x0, t_final, dt, method="dopri5", u=u, rtol=rtol, atol=atol)
    tip_exp = host(res_exp.ys)[:, n - 2]
    t_exp = time.time() - t0

    # The ROM: 9 retained modes plus modal-derivative augmentation, the
    # exact element force in the residual (drag through the external path).
    t0 = time.time()
    res_rom = simulate(beam, x0, t_final, dt, method="modal_rom", u=u, substeps=10,
                       n_newton=2, rho_inf=0.7, n_modes=9, modal_derivatives=3)
    tip_rom = host(res_rom.ys)[:, n - 2]
    t_rom = time.time() - t0

    w_linear_static = F_tip * L_total**3 / (3 * EI)
    diff = abs(tip_imp[-1] - tip_exp[-1]) / abs(tip_exp[-1])
    diff_rom = abs(tip_rom[-1] - tip_exp[-1]) / abs(tip_exp[-1])
    stiffening = 1.0 - tip_exp[-1] / w_linear_static
    say(f"tip force: {F_tip:.3f} N (linear static prediction "
        f"{w_linear_static * 1e3:.1f} mm = 10% of length)")
    say(f"implicit (gen-alpha, dt=1e-4, 3 Newton): final tip "
        f"{tip_imp[-1] * 1e3:.3f} mm in {t_imp:.2f}s")
    say(f"explicit (dopri5 rtol {rtol:g}):            final tip "
        f"{tip_exp[-1] * 1e3:.3f} mm in {t_exp:.2f}s")
    say(f"implicit vs explicit relative difference: {diff:.2e}")
    say(f"modal-ROM (m=9 + modal derivatives):      final tip "
        f"{tip_rom[-1] * 1e3:.3f} mm in {t_rom:.2f}s (truncation error {diff_rom:.2e})")
    say(f"geometric stiffening: nonlinear deflection is "
        f"{stiffening * 100:.1f}% below the linear prediction")
    return {
        "F_tip": F_tip, "w_linear_static": w_linear_static,
        "tip_implicit": tip_imp, "tip_dopri5": tip_exp, "tip_rom": tip_rom,
        "implicit_vs_explicit": float(diff), "rom_vs_explicit": float(diff_rom),
        "stiffening": float(stiffening),
        "dopri5_steps": int(res_exp.stats.n_steps),
        "dopri5_accepted": int(res_exp.stats.n_accepted),
        "dopri5_rejected": int(res_exp.stats.n_rejected),
        "wall_s": {"implicit": t_imp, "dopri5": t_exp, "rom": t_rom},
    }


def main(argv=None):
    args = example_parser(__doc__).parse_args(argv)
    return run(verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

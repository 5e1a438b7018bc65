"""Error-controlled implicit stepping: no hand-picked dt.

Counterpart of the JAX package's ``examples/adaptive_stepping.py``. On a
stiff mesh, where a fixed explicit dt would have to sit below the mesh's
stability limit, the adaptive engines take their steps from a tolerance:

* ``generalized_alpha_adaptive``: the Zienkiewicz-Xie estimate with PI
  control around the implicit generalized-alpha step;
* ``sdirk3``: the L-stable third-order DIRK with an embedded estimate;
* ``modal_rom_adaptive``: the same controller on the nonlinear beam's ROM,
  where a rejected step costs one force evaluation, not a solve.

For each it reports accepted and rejected steps, the mean dt and the tip
error against an exact (matrix-exponential) or a tight Dopri5 oracle.

Usage: python -m continuum_robot_tpu_torch.examples.adaptive_stepping
[--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd
import torch

from ..models import DynamicEulerBernoulliBeam
from ..models.simulate import simulate
from ..ops.exponential import make_expm_propagator
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    get_material_properties,
    host,
    parsed_placement,
    placement,
)


def report(name, res, tip_ref, n, wall, say) -> dict:
    tip = host(res.ys)[:, n - 2]
    err = float(np.abs(tip - tip_ref).max() / (np.abs(tip_ref).max() + 1e-300))
    acc = int(res.stats.n_accepted)
    rej = int(res.stats.n_rejected)
    span = float(host(res.ts)[-1])
    say(f"  {name:28s} acc={acc:6d} rej={rej:4d} mean_dt={span / max(acc, 1):.3e}  "
        f"tip err={err:.2e}  wall={wall:.1f}s")
    return {"accepted": acc, "rejected": rej, "mean_dt": span / max(acc, 1),
            "tip_err": err, "tip": tip, "wall_s": wall}


def stiff_beam(n_el=60) -> DynamicEulerBernoulliBeam:
    """``n_el`` linear elements on a short (tenth-length) beam."""
    props = get_material_properties()
    L_el = props["length"] / 10.0
    return DynamicEulerBernoulliBeam(pd.DataFrame({
        "length": [L_el] * n_el,
        "elastic_modulus": [props["E"]] * n_el,
        "moment_inertia": [props["MInertia"]] * n_el,
        "density": [props["rho"]] * n_el,
        "cross_area": [props["A"]] * n_el,
        "type": ["linear"] * n_el,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n_el - 1),
    }))


def run(n_el=60, t_final=0.02, dt_out=1e-3, nl_t_final=0.05, rtols=(1e-4, 1e-6),
        device=None, dtype=None, verbose=False) -> dict:
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    out = {}

    # Stiff linear release: a static tip-load deflection released at t = 0.
    beam = stiff_beam(n_el)
    n = beam.n_pos_states
    K = beam.beam_model.get_stiffness_matrix()
    f = np.zeros(n)
    f[-2] = 0.1
    x0 = torch.as_tensor(np.concatenate([np.linalg.solve(K, f), np.zeros(n)]),
                         dtype=dtype, device=device)

    say(f"Stiff linear release ({n_el} elements):")
    exact = make_expm_propagator(beam, dt_out, dtype=torch.float64, device=device)
    xs_exact = host(exact(x0.double(), torch.zeros(int(t_final / dt_out), n,
                                                   dtype=torch.float64, device=device)))
    tip_ref = xs_exact[:, n - 2]
    for method, rtol in [("generalized_alpha_adaptive", 1e-6), ("sdirk3", 1e-6)]:
        t0 = time.time()
        res = simulate(beam, x0, t_final, dt_out, method=method, rtol=rtol, atol=1e-10,
                       linear_solver="btd")
        out[method] = report(f"{method} (rtol={rtol:g})", res, tip_ref, n,
                             time.time() - t0, say)

    # The nonlinear beam at ROM cost.
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        beam_nl = DynamicEulerBernoulliBeam(nonlinear_file)
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    n2 = beam_nl.n_pos_states
    u = torch.zeros(n2, dtype=dtype, device=device)
    u[-2] = 5.0
    x0_nl = torch.zeros(2 * n2, dtype=dtype, device=device)

    say("Nonlinear tip impulse, error-controlled at ROM cost:")
    ref = simulate(beam_nl, x0_nl, nl_t_final, 0.001, method="dopri5", u=u, rtol=1e-10,
                   atol=1e-12)
    tip_ref2 = host(ref.ys)[:, n2 - 2]
    out["dopri5_reference"] = {"accepted": int(ref.stats.n_accepted),
                               "rejected": int(ref.stats.n_rejected), "tip": tip_ref2}
    for rtol in rtols:
        t0 = time.time()
        res = simulate(beam_nl, x0_nl, nl_t_final, 0.001, method="modal_rom_adaptive", u=u,
                       rtol=rtol, atol=rtol * 1e-3, n_newton=3, rho_inf=0.8)
        out[f"modal_rom_adaptive_{rtol:g}"] = report(
            f"modal_rom_adaptive (rtol={rtol:g})", res, tip_ref2, n2, time.time() - t0, say)
    say("\nThe tolerance is the only accuracy dial: tightening rtol tightens the "
        "trajectory and raises the step count.")
    out["tip_exact"] = tip_ref
    return out


def main(argv=None):
    args = example_parser(__doc__).parse_args(argv)
    return run(verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

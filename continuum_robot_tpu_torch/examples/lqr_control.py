"""LQR tip-position control demo.

Counterpart of the JAX package's ``examples/lqr_control.py``: an LQR
controller for the 6-segment linear cantilever with gravity (positions
weighted 100, velocities 10, R = I), its gain wrapped in
``FullStateLinear``, and the uncontrolled against the controlled impulse
response (peak displacement, settling time). The gain is solved on the host
in float64; the closed loop feeds ``u = -K x`` into the Dopri5 rollout.

Usage: python -m continuum_robot_tpu_torch.examples.lqr_control [--plot]
[--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..control import FullStateLinear, LinearQuadraticRegulator
from ..models import DynamicEulerBernoulliBeam, ForceParams
from ..models.simulate import simulate
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    default_tolerances,
    example_parser,
    host,
    parsed_placement,
    placement,
    pyplot,
    settling_time,
    tip_impulse_input,
)


def design_lqr_controller(beam):
    """Dense K and M -> LQR -> ``(FullStateLinear, regulator)``."""
    K_beam = beam.beam_model.get_stiffness_matrix()
    M_beam = beam.beam_model.get_mass_matrix()
    n = K_beam.shape[0]
    Q = np.eye(2 * n)
    Q[:n, :n] *= 100.0
    Q[n:, n:] *= 10.0
    R = np.eye(n)
    lqr = LinearQuadraticRegulator(K_beam, M_beam, Q, R)
    lqr.compute_gain_matrix()
    return FullStateLinear(lqr.get_K()), lqr


def simulate_system(beam, controller, impulse_amplitude=0.1, t_final=0.5, dt=0.001,
                    device=None, dtype=None):
    """Impulse response, with feedback ``u = K (0 - x)`` when a controller
    is given, by Dopri5 at the dtype's tolerances."""
    device, dtype = placement(device, dtype)
    rtol, atol = default_tolerances(dtype)
    n = beam.n_pos_states
    x0 = torch.zeros(2 * n, dtype=dtype, device=device)
    disturbance = tip_impulse_input(n, impulse_amplitude, 0.01, device, dtype)
    forces_func = None
    if controller is not None:
        def forces_func(x, t):
            return controller.feedback(x, 0.0)
    return simulate(beam, x0, t_final, dt, method="dopri5", u=disturbance,
                    forces_func=forces_func, rtol=rtol, atol=atol)


def run(t_final=0.5, dt=0.001, impulse=0.1, plot=False, device=None, dtype=None,
        verbose=False) -> dict:
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        beam = DynamicEulerBernoulliBeam(linear_file, ForceParams(enable_gravity_effects=True))
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)

    controller, lqr = design_lqr_controller(beam)
    max_re = float(np.real(lqr._E).max())
    say(f"LQR gain: {controller.gain_matrix.shape}, closed-loop max Re(eig) = {max_re:.2f}")
    say("Simulating uncontrolled system...")
    res_open = simulate_system(beam, None, impulse, t_final, dt, device, dtype)
    say("Simulating controlled system...")
    res_closed = simulate_system(beam, controller, impulse, t_final, dt, device, dtype)

    n = beam.n_pos_states
    ts = host(res_open.ts)
    tip_open = host(res_open.ys)[:, n - 2]
    tip_closed = host(res_closed.ys)[:, n - 2]
    out = {
        "max_re_eig": max_re,
        "peak_open": float(np.abs(tip_open).max()),
        "peak_closed": float(np.abs(tip_closed).max()),
        "settle_open": settling_time(ts, tip_open),
        "settle_closed": settling_time(ts, tip_closed),
        "tip_open": tip_open, "tip_closed": tip_closed,
        "gain": np.asarray(controller.gain_matrix),
        "stats": {name: {"steps": int(r.stats.n_steps), "accepted": int(r.stats.n_accepted),
                         "rejected": int(r.stats.n_rejected)}
                  for name, r in (("open", res_open), ("closed", res_closed))},
    }
    say("\nRESULTS")
    say(f"  peak |tip| uncontrolled: {out['peak_open']:.4e} m")
    say(f"  peak |tip| controlled:   {out['peak_closed']:.4e} m")
    say(f"  settling time uncontrolled: {out['settle_open']:.3f} s")
    say(f"  settling time controlled:   {out['settle_closed']:.3f} s")

    if plot:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(ts, tip_open, label="uncontrolled")
        ax.plot(ts, tip_closed, label="LQR controlled")
        ax.set(xlabel="t [s]", ylabel="tip w [m]")
        ax.legend()
        fig.tight_layout()
        fig.savefig("lqr_control.png", dpi=120)
        say("wrote lqr_control.png")
    return out


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args(argv)
    return run(plot=args.plot, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

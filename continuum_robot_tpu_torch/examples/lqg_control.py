"""LQG output-feedback control demo.

Counterpart of the JAX package's ``examples/lqg_control.py``: the
controller measures only the tip's displacement and velocity and actuates
only the tip's axial and transverse forces.

  1. an actuator-subset LQR gain (``input_dofs``) on the host;
  2. the Kalman-Bucy estimator gain from the dual CARE;
  3. the exact zero-order-hold rollout of the augmented closed loop
     ``[x; x_hat]`` on the device (one ``addmm`` a frame).

Reports regulation (uncontrolled against LQG) and the observer's
convergence from a cold start.

Usage: python -m continuum_robot_tpu_torch.examples.lqg_control [--plot]
[--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..control import (
    LinearQuadraticEstimator,
    LinearQuadraticGaussian,
    LinearQuadraticRegulator,
    output_matrix,
)
from ..models import DynamicEulerBernoulliBeam
from ..ops.exponential import discretize_lti
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    host,
    parsed_placement,
    placement,
    pyplot,
    settling_time,
)


def build_plant():
    files = create_beam_parameters()  # (linear, nonlinear, mixed) CSVs
    try:
        beam = DynamicEulerBernoulliBeam(files[0])
    finally:
        cleanup_temp_files(*files)
    return beam.beam_model.get_stiffness_matrix(), beam.beam_model.get_mass_matrix()


def design_lqg(K_beam, M_beam):
    """Tip axial and transverse actuators, tip displacement and velocity
    sensors; returns ``(lqg, closed-loop max Re(eig))``."""
    nf = K_beam.shape[0]
    # Transverse-only actuation cannot stabilize: the linear element
    # decouples axial and bending, leaving the axial modes unreachable.
    act = [nf - 3, nf - 2]
    Q = np.diag([100.0] * nf + [10.0] * nf)
    R = 1e-8 * np.eye(len(act))
    lqr = LinearQuadraticRegulator(K_beam, M_beam, Q, R, input_dofs=act)
    lqr.compute_gain_matrix()

    meas = [nf - 3, nf - 2, 2 * nf - 3, 2 * nf - 2]
    C = output_matrix(2 * nf, meas)
    V = 1e-2 * np.eye(2 * nf)  # process noise: unmodeled distributed load
    W = 1e-8 * np.eye(len(meas))  # measurement noise: good tip sensing
    lqe = LinearQuadraticEstimator(K_beam, M_beam, C, V, W)
    lqe.compute_gain_matrix()

    lqg = LinearQuadraticGaussian(lqr, lqe)
    ev = np.linalg.eigvals(lqg.augmented_matrix())
    return lqg, float(np.real(ev).max())


def run(t_final=2.0, dt=1e-3, plot=False, device=None, dtype=None, verbose=False) -> dict:
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    K_beam, M_beam = build_plant()
    nf = K_beam.shape[0]
    lqg, max_re = design_lqg(K_beam, M_beam)
    say(f"LQG design: 2 actuators, 4 sensors, closed-loop max Re(eig) = {max_re:.2f}")
    n_frames = int(round(t_final / dt))

    # The tip deflected 1 mm; the observer starts cold (zero).
    z0 = torch.zeros(4 * nf, dtype=dtype, device=device)
    z0[nf - 2] = 1e-3
    propagate = lqg.make_closed_loop_propagator(dt, dtype=dtype, device=device)
    zs = host(propagate(z0, torch.zeros(n_frames, 2 * nf, dtype=dtype, device=device)))

    # Uncontrolled comparison: exact ZOH of the open-loop plant (host).
    Phi_ol, _ = discretize_lti(lqg.A, lqg.B, dt)
    x_ol = np.zeros((n_frames + 1, 2 * nf))
    x_ol[0, nf - 2] = 1e-3
    for k in range(n_frames):
        x_ol[k + 1] = Phi_ol @ x_ol[k]

    ts = dt * np.arange(n_frames + 1)
    x = zs[:, : 2 * nf]
    err = x - zs[:, 2 * nf:]
    tip_cl = x[:, nf - 2]
    tip_ol = x_ol[:, nf - 2]
    out = {
        "max_re_eig": max_re,
        "tip_final_open": float(abs(tip_ol[-1])),
        "tip_final_lqg": float(abs(tip_cl[-1])),
        "settle_open": settling_time(ts, tip_ol),
        "settle_lqg": settling_time(ts, tip_cl),
        "observer_err_start": float(np.linalg.norm(err[0])),
        "observer_err_end": float(np.linalg.norm(err[-1])),
        "zs": zs,
    }
    say("\nRESULTS")
    say(f"  tip |w| at t={t_final:.1f}s  uncontrolled: {out['tip_final_open']:.4e} m")
    say(f"  tip |w| at t={t_final:.1f}s  LQG:          {out['tip_final_lqg']:.4e} m")
    say(f"  settling time uncontrolled: {out['settle_open']:.3f} s")
    say(f"  settling time LQG:          {out['settle_lqg']:.3f} s")
    say(f"  observer error ||x - x_hat||: {out['observer_err_start']:.3e} -> "
        f"{out['observer_err_end']:.3e}")

    if plot:
        plt = pyplot()
        fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
        axes[0].plot(ts, tip_ol, label="uncontrolled")
        axes[0].plot(ts, tip_cl, label="LQG (2 actuators, 4 sensors)")
        axes[0].set(ylabel="tip w [m]")
        axes[0].legend()
        axes[1].semilogy(ts, np.linalg.norm(err, axis=1))
        axes[1].set(xlabel="t [s]", ylabel="||x - x_hat||")
        fig.tight_layout()
        fig.savefig("lqg_control.png", dpi=120)
        say("wrote lqg_control.png")
    return out


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args(argv)
    return run(plot=args.plot, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

"""Sampling-based planning: random-shooting MPC over batched rollouts.

Counterpart of the JAX package's ``examples/sampling_planner.py``. Each
round:

  1. sample K candidate input sequences (piecewise-constant tip forces)
     from a ``torch.Generator`` seeded 0,
  2. roll all K out as one batch (:func:`plan_cost`),
  3. apply the first segment of the best candidate (receding horizon).

The JAX script draws its candidates with ``jax.random``, whose numbers no
``torch.Generator`` reproduces; :func:`plan_cost` takes the candidates as
an argument, so both packages can be fed the same ones, and ``run`` takes
them too (``candidates=``).

Usage: python -m continuum_robot_tpu_torch.examples.sampling_planner
[n_candidates] (default 256) [--device cpu]
"""

from __future__ import annotations

import time

import torch

from ..models import DynamicEulerBernoulliBeam
from ..ops.integrators import integrate_fixed
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    host,
    parsed_placement,
    placement,
)


def tip_force(n: int, amplitude: torch.Tensor) -> torch.Tensor:
    """Forces ``(..., n)``: ``amplitude (...)`` on the tip's transverse DOF."""
    u = amplitude.new_zeros((*amplitude.shape, n))
    u[..., n - 2] = amplitude
    return u


def segment(rhs, x, f_amp, steps_per_seg: int, dt: float, substeps: int):
    """One piecewise-constant segment from ``x (..., 2n)`` under tip forces
    ``f_amp (...)``; returns the end state."""
    n = x.shape[-1] // 2
    _, xs = integrate_fixed(rhs, x, 0.0, dt, steps_per_seg, u=tip_force(n, f_amp),
                            substeps=substeps)
    return xs[-1]


def plan_cost(rhs, x0, candidates, steps_per_seg: int, dt: float, substeps: int,
              target_tip: float) -> torch.Tensor:
    """Costs ``(K,)`` of ``candidates (K, segments)`` from the state ``x0
    (2n,)``: tip tracking at each segment end, plus 1e-4 x the force effort
    and 1e-4 x the final velocity's energy, all K rolled out as one batch."""
    n = x0.shape[-1] // 2
    x = x0.expand(candidates.shape[0], -1)
    tips = []
    for s in range(candidates.shape[1]):
        x = segment(rhs, x, candidates[:, s], steps_per_seg, dt, substeps)
        tips.append(x[:, n - 2])
    tips = torch.stack(tips, dim=1)
    track = torch.sum((tips - target_tip) ** 2, dim=1)
    effort = 1e-4 * torch.sum(candidates**2, dim=1)
    terminal_v = 1e-4 * torch.sum(x[:, n:] ** 2, dim=1)
    return track + effort + terminal_v


def run(n_candidates=256, horizon_segments=4, seg_time=0.05, dt=0.001, substeps=10,
        n_mpc_rounds=6, target_tip=2e-3, seed=0, candidates=None, device=None, dtype=None,
        verbose=False) -> dict:
    """The MPC loop. ``candidates``: ``(rounds, K, segments)`` to use in
    place of the generator's draws."""
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        model = DynamicEulerBernoulliBeam(linear_file)
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    n = model.n_pos_states
    rhs = model.build_rhs()
    steps_per_seg = int(round(seg_time / dt))
    gen = torch.Generator(device="cpu").manual_seed(seed)

    x = torch.zeros(2 * n, dtype=dtype, device=device)
    say(f"target tip: {target_tip:.1e} m; {n_candidates} candidates, "
        f"{horizon_segments}x{seg_time}s horizon")
    rounds = []
    t0 = time.time()
    for rnd in range(n_mpc_rounds):
        if candidates is None:
            cand = 0.3 * torch.randn(n_candidates, horizon_segments, generator=gen,
                                     dtype=torch.float64)
        else:
            cand = torch.as_tensor(candidates[rnd])
        cand = cand.to(device, dtype)
        costs = plan_cost(rhs, x, cand, steps_per_seg, dt, substeps, target_tip)
        best = int(torch.argmin(costs))
        chosen = cand[best]
        # Apply only the first segment (receding horizon).
        x = segment(rhs, x, chosen[0], steps_per_seg, dt, substeps)
        rounds.append({"best_cost": float(costs[best]), "force": float(chosen[0]),
                       "tip": float(x[n - 2])})
        say(f"  round {rnd}: best cost {rounds[-1]['best_cost']:.3e}, "
            f"applied force {rounds[-1]['force']:+.3f} N, tip = {rounds[-1]['tip']:+.4e} m")
    wall = time.time() - t0

    tip = float(x[n - 2])
    err = abs(tip - target_tip) / target_tip
    total_rollouts = n_mpc_rounds * n_candidates
    say(f"\nfinal tip {tip:.4e} m (target {target_tip:.1e}, err {err * 100:.1f}%)")
    say(f"{total_rollouts} full rollouts in {wall:.2f}s -> "
        f"{total_rollouts / wall:.0f} rollouts/s")
    return {"rounds": rounds, "final_tip": tip, "tip_err": err, "wall_s": wall,
            "rollouts_per_s": total_rollouts / wall, "final_state": host(x)}


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("n_candidates", nargs="?", type=int, default=256)
    args = parser.parse_args(argv)
    return run(args.n_candidates, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

"""Gravity beam comparison sweep.

Counterpart of the JAX package's ``examples/beam_comparison_gravity.py``:
linear / nonlinear / mixed cantilevers sagging under standard gravity with a
tip impulse, then the performance table and tip statistics.

Usage: python -m continuum_robot_tpu_torch.examples.beam_comparison_gravity
[--plot] [--animate] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..models import ForceParams
from .beam_comparison_fluid import analytic_frequencies, run_tasks
from .example_utilities import (
    DT,
    N_SEGMENTS,
    T_FINAL,
    SimulationTask,
    animate_beam_shapes,
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    extract_beam_shapes,
    get_material_properties,
    host,
    parsed_placement,
    print_performance_table,
    pyplot,
)


def run(t_final=T_FINAL, dt=DT, plot=False, animate=False, device=None, dtype=None,
        verbose=False) -> dict:
    """The sweep; per task its wall time, solver counters, final tip sag,
    max |tip| and tip trace (``tips``)."""
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    gravity = ForceParams(enable_gravity_effects=True)
    tasks = [
        SimulationTask("Linear (Gravity)", linear_file, gravity),
        SimulationTask("Nonlinear (Gravity)", nonlinear_file, gravity),
        SimulationTask("Mixed Lin-Base/Nonlin-Tip (Gravity)", mixed_file, gravity),
    ]
    try:
        t0 = time.time()
        results, times, stats = run_tasks(tasks, t_final, dt, device, dtype, say)
        total = time.time() - t0
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    say(f"\nTotal sweep time: {total:.2f}s")
    if verbose:
        print_performance_table(times, stats)

    say("\nAnalytic frequencies (Hz):", [f"{f:.2f}" for f in analytic_frequencies()])
    tips, sag, tip_max = {}, {}, {}
    for name, res in results.items():
        ys = host(res.ys)
        n = ys.shape[-1] // 2
        tips[name] = ys[:, n - 2]
        sag[name] = float(tips[name][-1])
        tip_max[name] = float(np.abs(tips[name]).max())
        say(f"  {name}: final tip sag {sag[name]:.4e} m, max |tip| {tip_max[name]:.4e} m")

    if plot:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(10, 5))
        for name, res in results.items():
            ax.plot(host(res.ts), tips[name], label=name)
        ax.set(xlabel="t [s]", ylabel="tip w [m]")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig("beam_comparison_gravity.png", dpi=120)
        say("wrote beam_comparison_gravity.png")
    if animate:
        props = get_material_properties()
        shapes = {name: extract_beam_shapes(res, N_SEGMENTS, props["length"])
                  for name, res in results.items()}
        animate_beam_shapes(shapes, "beam_comparison_gravity.gif", dt=dt)
    return {"times": times, "stats": stats, "final_sag": sag, "tip_abs_max": tip_max,
            "tips": tips, "total_s": total}


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--animate", action="store_true")
    args = parser.parse_args(argv)
    return run(plot=args.plot, animate=args.animate, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

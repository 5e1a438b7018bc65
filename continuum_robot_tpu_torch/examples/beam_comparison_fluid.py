"""Fluid-drag beam comparison sweep.

Counterpart of the JAX package's ``examples/beam_comparison_fluid.py``: six
tasks, linear / nonlinear / mixed x {no fluid, water}, each a tip-impulse
Dopri5 rollout, then the solver performance table and the FFT of the tip
displacement against the analytic cantilever frequencies. The tasks run
one after another; ``batched_rollouts`` runs many environments as a batch.

Usage: python -m continuum_robot_tpu_torch.examples.beam_comparison_fluid
[--plot] [--animate] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..models import ForceParams
from .example_utilities import (
    DT,
    N_SEGMENTS,
    T_FINAL,
    SimulationTask,
    animate_beam_shapes,
    calculate_natural_frequencies,
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    extract_beam_shapes,
    get_material_properties,
    host,
    parsed_placement,
    print_performance_table,
    pyplot,
    simulate_single_beam,
)

FLUID_DENSITY = 1000.0  # water


def analytic_frequencies():
    props = get_material_properties()
    return calculate_natural_frequencies(
        props["length"] * N_SEGMENTS, props["E"], props["MInertia"], props["rho"], props["A"],
    )


def run_tasks(tasks, t_final, dt, device, dtype, say):
    """Each task's rollout: ``(results, times, stats)`` keyed by name."""
    results, times, stats = {}, {}, {}
    for task in tasks:
        name, res, wall, st = simulate_single_beam(task, t_final, dt, device=device,
                                                   dtype=dtype)
        results[name], times[name], stats[name] = res, wall, st
        say(f"  {name}: {wall:.2f}s")
    return results, times, stats


def run(t_final=T_FINAL, dt=DT, plot=False, animate=False, device=None, dtype=None,
        verbose=False) -> dict:
    """The sweep; per task its wall time, solver counters, dominant tip
    frequency, max |tip| and tip trace (``tips``)."""
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    fluid = ForceParams(enable_fluid_effects=True, fluid_density=FLUID_DENSITY)
    tasks = [
        SimulationTask("Linear (No Fluid)", linear_file),
        SimulationTask("Linear (Fluid)", linear_file, fluid),
        SimulationTask("Nonlinear (No Fluid)", nonlinear_file),
        SimulationTask("Nonlinear (Fluid)", nonlinear_file, fluid),
        SimulationTask("Mixed Lin-Base/Nonlin-Tip (No Fluid)", mixed_file),
        SimulationTask("Mixed Lin-Base/Nonlin-Tip (Fluid)", mixed_file, fluid),
    ]
    try:
        t0 = time.time()
        results, times, stats = run_tasks(tasks, t_final, dt, device, dtype, say)
        total = time.time() - t0
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    say(f"\nTotal sweep time: {total:.2f}s for {len(tasks)} simulations")
    if verbose:
        print_performance_table(times, stats)

    freqs_analytic = analytic_frequencies()
    say("\nAnalytic cantilever natural frequencies (Hz):",
        [f"{f:.2f}" for f in freqs_analytic])
    tips, peaks, tip_max = {}, {}, {}
    for name, res in results.items():
        ys = host(res.ys)
        n = ys.shape[-1] // 2
        tip = ys[:, n - 2]
        spectrum = np.abs(np.fft.rfft(tip - tip.mean()))
        freqs = np.fft.rfftfreq(len(tip), dt)
        tips[name] = tip
        peaks[name] = float(freqs[np.argmax(spectrum[1:]) + 1])
        tip_max[name] = float(np.abs(tip).max())
        damp = "damped" if "(Fluid)" in name else "undamped"
        say(f"  {name}: dominant tip frequency {peaks[name]:.2f} Hz ({damp}), "
            f"max |tip| {tip_max[name]:.4e} m")

    props = get_material_properties()
    if plot:
        plt = pyplot()
        fig, axes = plt.subplots(2, 1, figsize=(10, 8))
        for name, res in results.items():
            style = "--" if "(Fluid)" in name else "-"
            axes[0].plot(host(res.ts), tips[name], style, label=name)
            spec = np.abs(np.fft.rfft(tips[name] - tips[name].mean()))
            axes[1].semilogy(np.fft.rfftfreq(len(tips[name]), dt), spec, style, label=name)
        for f in freqs_analytic:
            axes[1].axvline(f, color="k", alpha=0.3)
        axes[0].set(xlabel="t [s]", ylabel="tip w [m]")
        axes[1].set(xlabel="f [Hz]", ylabel="|FFT|", xlim=(0, 300))
        axes[0].legend(fontsize=7)
        fig.tight_layout()
        fig.savefig("beam_comparison_fluid.png", dpi=120)
        say("wrote beam_comparison_fluid.png")
    shapes = {name: extract_beam_shapes(res, N_SEGMENTS, props["length"])
              for name, res in results.items()}
    if animate:
        animate_beam_shapes(shapes, "beam_comparison_fluid.gif", dt=dt)
    return {"times": times, "stats": stats, "analytic_hz": freqs_analytic,
            "dominant_hz": peaks, "tip_abs_max": tip_max, "tips": tips,
            "total_s": total}


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--animate", action="store_true")
    args = parser.parse_args(argv)
    return run(plot=args.plot, animate=args.animate, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

"""Shared workload utilities of the port's examples.

Counterpart of the JAX package's ``examples/example_utilities.py``: the
same Nitinol material constants, the same 6-segment cantilever
configurations (linear, nonlinear, mixed), the same tip-impulse workload on
a 1 s / 1 ms output grid, the analytic cantilever frequencies and the
performance table. Rollouts run on the card unless the caller passes
``device="cpu"``; every example's command line takes ``--device``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models import DynamicEulerBernoulliBeam, ForceParams
from ..models.simulate import resolve_device, simulate

# Simulation parameters
T_FINAL = 1.0
DT = 0.001
N_SEGMENTS = 6

# Material properties: Nitinol
MATERIAL_PROPS = {"length": 0.25, "E": 75e9, "r": 0.005, "rho": 6450, "drag_coef": 0.82}

# The examples' working dtype unless the caller names one: float64, whose
# adaptive tolerances (1e-8 / 1e-10) are the JAX examples' under x64.
DEFAULT_DTYPE = torch.float64


def placement(device=None, dtype=None) -> Tuple[torch.device, torch.dtype]:
    """``(device, dtype)`` of an example: ``device`` None is the card (raises
    without one), ``dtype`` None is :data:`DEFAULT_DTYPE`."""
    return resolve_device(device), dtype or DEFAULT_DTYPE


def example_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the port's ``--device``."""
    parser = argparse.ArgumentParser(description=(doc or "").strip().splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return parser


def parsed_placement(args) -> dict:
    """The ``device=`` keyword of ``run()`` from parsed arguments."""
    return {"device": args.device}


def get_material_properties():
    props = MATERIAL_PROPS.copy()
    props["MInertia"] = np.pi * props["r"] ** 4 / 4
    props["A"] = np.pi * props["r"] ** 2
    props["wetted_area"] = 2 * np.pi * props["r"] * props["length"]
    return props


def create_csv_file(beam_types, boundary_conditions):
    """Write a parameter CSV; returns its path (remove it with
    :func:`cleanup_temp_files`)."""
    props = get_material_properties()
    with tempfile.NamedTemporaryFile(mode="w", delete=False, suffix=".csv") as f:
        f.write(
            "length,elastic_modulus,moment_inertia,density,cross_area,"
            "type,boundary_condition,wetted_area,drag_coef\n"
        )
        for beam_type, bc in zip(beam_types, boundary_conditions):
            f.write(
                f"{props['length']},{props['E']},{props['MInertia']},"
                f"{props['rho']},{props['A']},{beam_type},{bc},"
                f"{props['wetted_area']},{props['drag_coef']}\n"
            )
        return f.name


@dataclass
class SimulationTask:
    """One entry of a comparison sweep."""

    name: str
    param_file: str
    force_params: Optional[ForceParams] = None

    def __post_init__(self):
        if self.force_params is None:
            self.force_params = ForceParams()


def create_beam_parameters() -> Tuple[str, str, str]:
    """Linear / nonlinear / mixed 6-segment cantilever CSVs."""
    boundary_conditions = ["FIXED"] + ["NONE"] * (N_SEGMENTS - 1)
    linear_file = create_csv_file(["linear"] * N_SEGMENTS, boundary_conditions)
    nonlinear_file = create_csv_file(["nonlinear"] * N_SEGMENTS, boundary_conditions)
    mixed_types = ["linear"] * (N_SEGMENTS // 2) + ["nonlinear"] * (
        N_SEGMENTS - N_SEGMENTS // 2
    )
    mixed_file = create_csv_file(mixed_types, boundary_conditions)
    return linear_file, nonlinear_file, mixed_file


def tip_impulse_input(n_pos, amplitude=0.1, t_end=0.01, device=None, dtype=None):
    """Tip impulse ``u(t)``: ``amplitude`` on the tip's transverse DOF while
    ``t < t_end``, zero after. ``t`` is a float (fixed-step integrators) or
    a tensor of the adaptive controller's shape (one force a lane)."""
    device, dtype = placement(device, dtype)
    base = torch.zeros(n_pos, dtype=dtype, device=device)
    tip = base.clone()
    tip[-2] = amplitude

    def u(t):
        if isinstance(t, torch.Tensor):
            return torch.where((t < t_end)[..., None], tip, base)
        return tip if t < t_end else base

    return u


def default_tolerances(dtype) -> Tuple[float, float]:
    """``(rtol, atol)`` of the adaptive examples: tolerances below the
    working precision make the controller thrash, so float32 gets looser
    ones (the JAX examples' choice without x64)."""
    return (1e-8, 1e-10) if dtype == torch.float64 else (1e-5, 1e-8)


def simulate_single_beam(
    task: SimulationTask,
    t_final: float = T_FINAL,
    dt: float = DT,
    method: str = "dopri5",
    rtol: float = None,
    atol: float = None,
    device=None,
    dtype=None,
) -> Tuple[str, Any, float, dict]:
    """One tip-impulse rollout from rest.

    Returns ``(name, result, wall_time, solver_stats)``: ``result`` has
    ``.ts``/``.ys``, the stats carry the RHS-evaluation counters (7 a
    Dopri5 step) and the accepted and rejected steps."""
    device, dtype = placement(device, dtype)
    d_rtol, d_atol = default_tolerances(dtype)
    rtol = d_rtol if rtol is None else rtol
    atol = d_atol if atol is None else atol

    start = time.time()
    beam = DynamicEulerBernoulliBeam(task.param_file, force_params=task.force_params)
    n = beam.n_pos_states
    x0 = torch.zeros(2 * n, dtype=dtype, device=device)
    u = tip_impulse_input(n, device=device, dtype=dtype)
    res = simulate(
        beam, x0, t_final, dt, method=method, u=u, rtol=rtol, atol=atol,
        substeps=50 if method == "newmark" else 1,
    )
    res.ys.cpu()  # waits for the card
    wall = time.time() - start
    if res.stats is not None:
        stats = {
            "nfev": 7 * int(res.stats.n_steps),
            "n_accepted": int(res.stats.n_accepted),
            "n_rejected": int(res.stats.n_rejected),
        }
    else:
        stats = {"nfev": 0, "n_accepted": 0, "n_rejected": 0}
    return task.name, res, wall, stats


def extract_beam_shapes(res, n_segments: int, dx: float):
    """Beam ``(x, y)`` coordinates over time, ``(frames, nodes)`` each."""
    ys = res.ys.detach().cpu().numpy()
    n_pos = ys.shape[-1] // 2
    w = ys[:, 1:n_pos:3]  # transverse displacements of the free nodes
    n_frames = ys.shape[0]
    x = np.tile(np.arange(n_segments + 1) * dx, (n_frames, 1))
    y = np.zeros((n_frames, n_segments + 1))
    y[:, 1:] = w[:, :n_segments]
    return x, y


def animate_beam_shapes(
    shapes: dict,
    filename: str = "beam_animation.gif",
    dt: float = None,
    stride: int = 10,
    fps: int = 25,
):
    """Animated beam deflection shapes written as a GIF.

    ``shapes``: ``{name: (x (frames, nodes), y (frames, nodes))}`` from
    :func:`extract_beam_shapes`; ``stride`` subsamples frames. Needs
    matplotlib and Pillow, imported here only."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError(
            "animate_beam_shapes needs matplotlib (not installed); run without "
            "--animate, or install matplotlib and Pillow"
        ) from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig, ax = plt.subplots(figsize=(8, 4))
    lines = {}
    y_max = max(np.abs(y).max() for _, y in shapes.values()) or 1e-6
    x_max = max(x.max() for x, _ in shapes.values())
    for name, (x, y) in shapes.items():
        (lines[name],) = ax.plot(x[0], y[0], lw=2, label=name)
    ax.set(
        xlim=(0, 1.05 * x_max),
        ylim=(-1.2 * y_max, 1.2 * y_max),
        xlabel="x [m]",
        ylabel="w [m]",
        title="Beam deflection",
    )
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)

    n_frames = min(len(x) for x, _ in shapes.values())
    frame_ids = range(0, n_frames, max(1, stride))

    def animate(frame):
        for name, (x, y) in shapes.items():
            lines[name].set_data(x[frame], y[frame])
        return list(lines.values())

    anim = FuncAnimation(
        fig, animate, frames=frame_ids,
        interval=(dt or 0.001) * 1000 * stride, blit=True,
    )
    anim.save(filename, writer=PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {filename} ({len(list(frame_ids))} frames)")
    return anim


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or a clear error without
    matplotlib (the ``--plot`` flags)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("--plot needs matplotlib (not installed)") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def calculate_natural_frequencies(
    length, elastic_modulus, moment_inertia, density, cross_area
):
    """Analytic cantilever frequencies (Hz) of the first four modes."""
    beta_L = [0.596864 * np.pi, 1.49418 * np.pi, 2.50025 * np.pi, 3.49999 * np.pi]
    return [
        (bl**2)
        * np.sqrt(elastic_modulus * moment_inertia / (density * cross_area * length**4))
        / (2 * np.pi)
        for bl in beta_L
    ]


def settling_time(ts, tip, threshold=0.02):
    """Time after which ``|tip|`` stays within ``threshold`` x its peak."""
    peak = np.abs(tip).max()
    bound = threshold * peak
    outside = np.where(np.abs(tip) > bound)[0]
    if len(outside) == 0:
        return 0.0
    last = outside[-1]
    return float(ts[min(last + 1, len(ts) - 1)])


def cleanup_temp_files(*file_paths):
    for p in file_paths:
        if p and os.path.exists(p):
            os.unlink(p)


def print_performance_table(computation_times, solver_statistics):
    """Formatted table of each configuration's wall time and solver counters."""
    print("\nDETAILED SOLVER PERFORMANCE:")
    print("=" * 100)
    header = (
        f"{'Configuration':<35} {'Time (s)':<10} {'nfev':<8} "
        f"{'accepted':<10} {'rejected':<10} {'nfev/s':<12}"
    )
    print(header)
    print("-" * 100)
    for name, t in computation_times.items():
        s = solver_statistics[name]
        nfev_s = s["nfev"] / t if t > 0 else 0.0
        print(
            f"{name:<35} {t:<10.3f} {s['nfev']:<8} {s['n_accepted']:<10} "
            f"{s['n_rejected']:<10} {nfev_s:<12.0f}"
        )
    print("-" * 100)


def host(x) -> np.ndarray:
    """A tensor (or array) as a host NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

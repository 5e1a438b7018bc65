"""Force-composition patterns demo.

Counterpart of the JAX package's ``examples/functional_composition_demo.py``:
the four wiring patterns (registry only, an external closure, registry plus
an external term, a force registered afterwards) feeding the same dynamics,
and gravity registered afterwards with a custom vector.

Usage: python -m continuum_robot_tpu_torch.examples.functional_composition_demo
[--device cpu]
"""

from __future__ import annotations

import torch

from ..models import AbstractForce, DynamicEulerBernoulliBeam, ForceParams, GravityForce
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    parsed_placement,
    placement,
)


class TipLoadForce(AbstractForce):
    """A user-defined force: a constant transverse tip load."""

    def __init__(self, magnitude, enabled=True):
        self.magnitude = magnitude
        self.enabled = enabled

    def compute_forces(self, x, t):
        n = x.shape[-1] // 2
        f = torch.zeros((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
        f[..., n - 2] = self.magnitude
        return f

    def is_enabled(self):
        return self.enabled


def external_forces(x, t):
    """An external closure: 0.5 N on every position DOF."""
    n = x.shape[-1] // 2
    return torch.full((*x.shape[:-1], n), 0.5, dtype=x.dtype, device=x.device)


def run(device=None, dtype=None, verbose=False) -> dict:
    """The patterns' ``max |dx/dt|`` at rest, in the JAX script's order."""
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        beam = DynamicEulerBernoulliBeam(
            linear_file, ForceParams(enable_fluid_effects=True, fluid_density=1000.0),
        )
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    x = torch.zeros(2 * beam.n_pos_states, dtype=dtype, device=device)

    def peak():
        return float(beam.system_func(x).abs().max())

    out = {}
    # Pattern 1: registry only (registered from ForceParams).
    beam.create_system_func(device=device)
    out["registry"] = peak()
    say("1. registry-only:", out["registry"])

    # Pattern 2: an external closure (bypasses the registry).
    beam.create_system_func(forces_func=external_forces, device=device)
    out["external"] = peak()
    say("2. external closure:", out["external"])

    # Pattern 3: the registry's aggregate plus an external term.
    registry_forces = beam.force_registry.create_aggregated_function()

    def hybrid(x, t):
        return registry_forces(x, t) + external_forces(x, t)

    beam.create_system_func(forces_func=hybrid, device=device)
    out["hybrid"] = peak()
    say("3. hybrid:", out["hybrid"])

    # Pattern 4: a force registered afterwards; the registry's aggregate
    # reads the enabled set at every evaluation.
    beam.create_system_func(device=device)
    out["before"] = peak()
    tip_load = TipLoadForce(2.0)
    beam.force_registry.register(tip_load)
    out["after"] = peak()
    tip_load.enabled = False
    out["disabled"] = peak()
    say(f"4. dynamic registration: before={out['before']}, after={out['after']}, "
        f"disabled={out['disabled']}")

    # Gravity registered afterwards with a custom (lunar) vector.
    g = GravityForce(beam.params[["density", "cross_area", "length"]],
                     gravity_vector=[0.0, -1.62, 0.0])
    beam.force_registry.register(g)
    out["lunar"] = peak()
    say("5. lunar gravity added:", out["lunar"])
    return out


def main(argv=None):
    args = example_parser(__doc__).parse_args(argv)
    return run(verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

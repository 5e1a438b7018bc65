"""Massively batched rollouts: thousands of environments as one batch.

Counterpart of the JAX package's ``examples/batched_rollouts.py``. The
environment axis is the leading batch axis of one rollout; under a launched
``torch.distributed`` world of several ranks it is split over a device mesh
(``parallel.batched_rollout(mesh=)``).

* an initial-condition sweep: the 6-segment cantilever in water, a batch
  of random tip perturbations, implicit generalized-alpha;
* the same sweep on the dry beam through the modal engine.

Usage: python -m continuum_robot_tpu_torch.examples.batched_rollouts [n_envs]
(default 512) [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import DynamicEulerBernoulliBeam, ForceParams
from ..parallel import batched_rollout, make_mesh, sweep_statistics
from ..utils import force_completion
from .example_utilities import (
    cleanup_temp_files,
    create_beam_parameters,
    example_parser,
    host,
    parsed_placement,
    placement,
)


def _mesh():
    """A mesh over the launched world's ranks, or None (one process)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def run(n_envs=512, t_final=0.25, dt=0.001, substeps=20, seed=0, device=None, dtype=None,
        verbose=False) -> dict:
    """The sweep and its figures; ``tip``/``tip_modal`` are the tip traces
    ``(frames, envs)`` of the two engines."""
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    linear_file, nonlinear_file, mixed_file = create_beam_parameters()
    try:
        beam = DynamicEulerBernoulliBeam(
            linear_file, ForceParams(enable_fluid_effects=True, fluid_density=1000.0)
        )
        beam_dry = DynamicEulerBernoulliBeam(linear_file)
    finally:
        cleanup_temp_files(linear_file, nonlinear_file, mixed_file)
    n = beam.n_pos_states

    # Initial-condition sweep: randomized tip perturbations.
    rng = np.random.default_rng(seed)
    x0 = np.zeros((n_envs, 2 * n))
    x0[:, n - 2] = rng.normal(scale=1e-3, size=n_envs)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    mesh = _mesh()
    kw = dict(t_final=t_final, dt=dt, substeps=substeps, mesh=mesh)

    t0 = time.time()
    res = batched_rollout(beam, x0, method="generalized_alpha", **kw)
    stats = sweep_statistics(res.ys)
    tip_max = float(stats["tip_abs_max"])
    wall = time.time() - t0

    frames = res.ys.shape[0] - 1
    env_steps = n_envs * frames * substeps
    say(f"{n_envs} envs x {frames * substeps} implicit steps in {wall:.2f}s "
        f"(first call) -> {env_steps / wall:,.0f} env-steps/s")
    say(f"max |tip| across sweep: {tip_max:.4e} m")
    say(f"state RMS: {float(stats['state_rms']):.4e}")

    # A second call: steady-state throughput.
    t0 = time.time()
    res2 = batched_rollout(beam, x0, method="generalized_alpha", **kw)
    force_completion(res2.ys)
    wall2 = time.time() - t0
    say(f"steady-state: {env_steps / wall2:,.0f} env-steps/s")

    # The modal engine runs the same gen-alpha recurrence diagonalized per
    # mode; it takes no state-dependent force, so it runs the dry beam.
    res3 = batched_rollout(beam_dry, x0, method="modal", **kw)
    force_completion(res3.ys)
    t0 = time.time()
    res3 = batched_rollout(beam_dry, x0, method="modal", **kw)
    force_completion(res3.ys)
    wall3 = time.time() - t0
    say(f"modal engine (dry beam): {env_steps / wall3:,.0f} env-steps/s")

    ys, ys3 = (r.ys.full_tensor() if hasattr(r.ys, "full_tensor") else r.ys
               for r in (res, res3))
    return {
        "n_envs": n_envs, "frames": frames, "env_steps": env_steps,
        "wall_s": wall, "env_steps_per_s": env_steps / wall,
        "tip_abs_max": tip_max, "state_rms": float(stats["state_rms"]),
        "steady_env_steps_per_s": env_steps / wall2,
        "modal_env_steps_per_s": env_steps / wall3,
        "tip": host(ys[..., n - 2]), "tip_modal": host(ys3[..., n - 2]),
    }


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("n_envs", nargs="?", type=int, default=512)
    args = parser.parse_args(argv)
    return run(args.n_envs, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

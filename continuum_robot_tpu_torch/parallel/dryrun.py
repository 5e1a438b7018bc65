"""Multi-rank dry run of the parallel layer on launched ranks.

The port's counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: factor N ranks into ``dp x sp``, build the mesh and
a node-sharded flagship beam (a hybrid linear/nonlinear cantilever with
fluid drag and gravity), take one batched RK4 step through
``build_spatial_rhs(cg_iters=32, cg_tol=1e-6)`` with the environments split
over ``dp``, reduce the cross-env statistics over the DTensor of the
result, then one fixed-step SPIKE gen-α frame (``local_solver="dense"``),
one adaptive gen-α interval and one SDIRK3 interval on the same mesh. The
ranks run one a card over NCCL, or gloo on the CPU for ``device="cpu"``
(:func:`collectives.launch`).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .collectives import env_block, launch, world_device


def mesh_factors(n_ranks: int):
    """``(dp, sp)`` of N ranks: sp the largest factor up to sqrt(N) (2 for
    an even N with no other), as the JAX package factors its devices."""
    sp = 1
    for f in range(2, int(np.sqrt(n_ranks)) + 1):
        if n_ranks % f == 0:
            sp = f
    if n_ranks % 2 == 0 and sp == 1:
        sp = 2
    return n_ranks // sp, sp


def flagship_model(n_segments: int = 6, forces: bool = True):
    """The hybrid Nitinol cantilever of the JAX package's dry run."""
    from ..models import DynamicEulerBernoulliBeam, ForceParams

    L, E, r, rho = 0.25, 75e9, 0.005, 6450.0
    n = n_segments
    df = pd.DataFrame({
        "length": [L / n] * n,
        "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n,
        "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n,
        "type": ["linear"] * (n // 2) + ["nonlinear"] * (n - n // 2),
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [2 * np.pi * r * L / n] * n,
        "drag_coef": [0.82] * n,
    })
    fp = ForceParams(enable_fluid_effects=True, fluid_density=1000.0,
                     enable_gravity_effects=True)
    return DynamicEulerBernoulliBeam(df, fp if forces else None)


def _dryrun_rank(n_ranks: int) -> dict:
    from . import (
        build_spatial_genalpha,
        build_spatial_genalpha_adaptive,
        build_spatial_rhs,
        build_spatial_sdirk3,
        make_mesh,
        make_spatial_beam,
        sweep_statistics,
    )

    dp, sp = mesh_factors(n_ranks)
    dev = world_device()
    mesh = make_mesh({"dp": dp, "sp": sp}, device=dev)
    model = flagship_model(n_segments=max(2 * sp, 6))
    beam = make_spatial_beam(model.beam_model.arrays,
                             model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    rhs = build_spatial_rhs(beam, cg_iters=32, cg_tol=1e-6).local

    n_envs = 2 * dp
    xb = torch.zeros((n_envs, 2, beam.n_nodes, 3), dtype=torch.float64, device=dev)
    xb[:, 0, 1, 1] = torch.linspace(1e-4, 2e-4, n_envs, dtype=torch.float64, device=dev)
    x = beam.local(env_block(xb, beam.dp))
    h = 1e-6
    k1 = rhs(0.0, x)
    k2 = rhs(0.0, x + 0.5 * h * k1)
    k3 = rhs(0.0, x + 0.5 * h * k2)
    k4 = rhs(0.0, x + h * k3)
    x1 = beam.gather(x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))
    place = [Shard(0) if name == "dp" else Replicate() for name in mesh.mesh_dim_names]
    xb1 = DTensor.from_local(x1.reshape(x1.shape[0], 1, -1), mesh, place, run_check=False)
    rms = sweep_statistics(xb1)["state_rms"]
    if not bool(torch.isfinite(rms)):
        raise AssertionError("dryrun produced non-finite stats")
    if tuple(xb1.shape) != (n_envs, 1, 2 * beam.n_nodes * 3):
        raise AssertionError(f"dryrun step shape {tuple(xb1.shape)}")

    u_node = torch.zeros((beam.n_nodes, 3), dtype=torch.float64, device=dev)
    u_node[1, 1] = 1e-3
    roll = build_spatial_genalpha(beam, dt=1e-5, rho_inf=0.8, n_newton=2,
                                  local_solver="dense")
    _, xs = roll(xb, 1, u=u_node, substeps=2)
    roll_ad = build_spatial_genalpha_adaptive(beam, rho_inf=0.9, n_newton=1)
    xs_ad, st_ad = roll_ad(xb, np.array([0.0, 2e-5]), u=u_node, rtol=1e-4, atol=1e-8)
    roll_s3 = build_spatial_sdirk3(beam, n_newton=1)
    xs_s3, st_s3 = roll_s3(xb, np.array([0.0, 2e-5]), u=u_node, rtol=1e-4, atol=1e-8)
    for name, arr in (("implicit", xs), ("adaptive", xs_ad), ("sdirk3", xs_s3)):
        if not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"{name} dryrun non-finite")
        if arr.shape[:2] != (2, n_envs):
            raise AssertionError(f"{name} dryrun frames {tuple(arr.shape)}")
    if int(st_ad.n_accepted.sum()) == 0 or int(st_s3.n_accepted.sum()) == 0:
        raise AssertionError("an adaptive dryrun accepted no step")
    return {"dp": dp, "sp": sp, "n_nodes": beam.n_nodes, "state_rms": float(rms),
            "accepted_adaptive": int(st_ad.n_accepted.sum()),
            "accepted_sdirk3": int(st_s3.n_accepted.sum()),
            "tip": float(xs[-1, 0, 0, 1, 1])}


def dryrun_multichip(n_ranks: int, timeout: float = 300.0, device=None) -> dict:
    """One batched step of every sharded engine on ``n_ranks`` launched
    ranks (``dp x sp`` as :func:`mesh_factors`): by default one a card
    over NCCL, gloo CPU ranks for ``device="cpu"`` (:func:`collectives.launch`;
    it raises without a card unless asked for the CPU). Returns rank 0's
    summary (mesh shape, the cross-env RMS, accepted adaptive steps); raises
    on a non-finite or misshapen result, a failed rank or the time limit."""
    return launch(_dryrun_rank, int(n_ranks), int(n_ranks), timeout=timeout,
                  device=device)[0]

"""Nonlinear ROM workflow: reduce, train a hyper-reduced sample, deploy.

Counterpart of the JAX package's ``examples/rom_hyper_reduction.py``:

1. build the Petrov-Galerkin modal ROM (``make_modal_rom``): the exact
   element force in the residual, the reduced linear operator diagonal;
2. run a training rollout of the target workload and collect modal
   snapshots;
3. train an ECSW element sample (``hyper_reduce``), so the correction force
   touches a fraction of the mesh;
4. deploy the same rollout and measure it against the full ROM over every
   frame, then rebuild the engine from the saved basis and sample files and
   check that its rollout is bit for bit the trained one's.

Usage: python -m continuum_robot_tpu_torch.examples.rom_hyper_reduction
[n_elements] (default 100) [--device cpu]
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import pandas as pd
import torch

from ..models import DynamicEulerBernoulliBeam
from ..models.simulate import load_basis, load_ecsw, make_modal_rom
from .example_utilities import (
    example_parser,
    get_material_properties,
    host,
    parsed_placement,
    placement,
)


def beam_dataframe(n: int) -> pd.DataFrame:
    """An ``n``-element nonlinear Nitinol cantilever."""
    props = get_material_properties()
    return pd.DataFrame({
        "length": [props["length"]] * n,
        "elastic_modulus": [props["E"]] * n,
        "moment_inertia": [props["MInertia"]] * n,
        "density": [props["rho"]] * n,
        "cross_area": [props["A"]] * n,
        "type": ["nonlinear"] * n,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
    })


def run(n=100, n_steps=2000, frames=40, basis=None, device=None, dtype=None,
        verbose=False) -> dict:
    """``basis``: a ``(V, W)`` pair to use in place of the eigensolve's."""
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    model = DynamicEulerBernoulliBeam(beam_dataframe(n))
    nred = model.n_pos_states
    # At most a third of the spectrum: the parity tangent's upper band turns
    # ill-conditioned as meshes refine.
    m = min(64, max(8, nred // 3))
    rom_kw = dict(rho_inf=0.5, device=device, dtype=dtype)
    t0 = time.time()
    ms = make_modal_rom(model, 1e-4, n_modes=m, basis=basis, **rom_kw)
    t_build = time.time() - t0
    say(f"{n}-element nonlinear beam, {nred} DOFs -> {ms.n_modes}-mode ROM")

    # A constant 2 N tip force; the training snapshots cover the whole
    # deployment horizon.
    u = np.zeros(nred)
    u[-2] = 2.0
    u_m = torch.as_tensor(ms.project_force_host(u), dtype=dtype, device=device)
    z = torch.zeros((1, ms.n_modes), dtype=dtype, device=device)
    substeps = n_steps // frames
    t0 = time.time()
    _, etas, _ = ms.rollout_frames(z, z, u_m, frames, substeps=substeps, n_newton=2)
    snaps = host(etas[:, 0, :])
    t_train_roll = time.time() - t0

    t0 = time.time()
    red, info = ms.hyper_reduce(snaps, tau=1e-4, return_info=True)
    t_nnls = time.time() - t0
    say(f"ECSW training: {info['n_sampled']}/{n} elements (train residual "
        f"{info['train_residual']:.2e}; snapshot rollout {t_train_roll:.1f}s, "
        f"NNLS {t_nnls:.1f}s)")

    def timed_frames(engine):
        t0 = time.time()
        _, etas_f, etads_f = engine.rollout_frames(z, z, u_m, frames, substeps=substeps,
                                                   n_newton=1)
        qs, _ = engine.from_modal(etas_f, etads_f)
        return host(qs), time.time() - t0

    qs_full, t_full = timed_frames(ms)
    qs_hr, t_hr = timed_frames(red)
    tip_full = float(qs_full[-1, 0, nred - 2])
    tip_hr = float(qs_hr[-1, 0, nred - 2])
    err = float(np.abs(qs_hr - qs_full).max() / np.abs(qs_full).max())
    say(f"full ROM:          tip {tip_full * 1e3:.3f} mm in {t_full:.2f}s")
    say(f"hyper-reduced ROM: tip {tip_hr * 1e3:.3f} mm in {t_hr:.2f}s")
    say(f"trajectory deviation (all frames, all DOFs): {err:.2e} relative "
        f"(sample {info['n_sampled']}/{n} elements)")

    # Deployment: the basis and the sample persist as .npz files, and the
    # engine is rebuilt from them without an eigensolve or an NNLS.
    with tempfile.TemporaryDirectory() as d:
        bpath = ms.save_basis(os.path.join(d, "basis.npz"))
        spath = red.save_ecsw(os.path.join(d, "ecsw.npz"))
        t0 = time.time()
        ms2 = make_modal_rom(model, 1e-4, basis=load_basis(bpath), **rom_kw)
        sample = load_ecsw(spath)
        red2 = ms2.apply_ecsw(*sample)
        t_deploy = time.time() - t0
    qs_dep, _ = timed_frames(red2)
    assert np.array_equal(qs_dep, qs_hr), "deployed engine must be exact"
    say(f"deploy-from-disk: engine rebuilt in {t_deploy:.2f}s (no eigensolve, no NNLS) "
        "- rollouts bit-identical")
    return {
        "n_modes": ms.n_modes, "n_sampled": int(info["n_sampled"]),
        "train_residual": float(info["train_residual"]), "sample": sample[0],
        "tip_full": tip_full, "tip_hr": tip_hr, "deviation": err,
        "qs_full": qs_full, "qs_hr": qs_hr, "qs_deployed": qs_dep,
        "wall_s": {"build": t_build, "train_rollout": t_train_roll, "nnls": t_nnls,
                   "full": t_full, "hyper_reduced": t_hr, "deploy": t_deploy},
    }


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("n", nargs="?", type=int, default=100)
    args = parser.parse_args(argv)
    return run(args.n, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

"""Several cards: a beam split over the cards, batched over environments.

Counterpart of the JAX package's ``examples/multichip_beam.py``. Every
sharded tier runs on a ``dp x sp`` mesh of ranks started by
``parallel.collectives.launch`` (one rank a card over NCCL; ``--device cpu``
runs gloo ranks on the CPU):

* explicit: ``spatial_rollout``, RK4 over the node-sharded state with halo
  exchanges and psum-CG mass solves;
* implicit: ``build_spatial_genalpha``, distributed-SPIKE solves of the
  block-tridiagonal effective Jacobian (on the cards each local "thomas"
  solve is the ``btd_solve`` kernel);
* error-controlled: ``build_spatial_sdirk3``, whose psum-contracted error
  norm gives every shard the same accept/reject decisions;
* reduced-order: ``build_spatial_modal_rom`` with an ECSW sample and its
  envelope audit over the beam axis, and a rollout out of the trained
  envelope that the audit flags;
* differentiable: the elastic modulus of the sharded beam identified from a
  tip trace, by reverse mode through the SPIKE rollout (``arrays=``).

Usage: python -m continuum_robot_tpu_torch.examples.multichip_beam
[--dp 2] [--sp 2] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pandas as pd
import torch

from ..models import DynamicEulerBernoulliBeam
from ..ops.cuda import btd_solve as kb
from ..parallel import (
    build_spatial_genalpha,
    build_spatial_modal_rom,
    build_spatial_sdirk3,
    collectives,
    make_mesh,
    make_spatial_beam,
    spatial_rollout,
)
from .example_utilities import example_parser, host

# The JAX script's spans (the first argument of each tier's call) and ROM width.
SPANS = dict(explicit_t=2e-4, explicit_dt=1e-6, explicit_substeps=20, ga_frames=10,
             sdirk_t=2e-3, rom_frames=20, guard_frames=6, sysid_frames=4, sysid_iters=8,
             rom_modes=24)


def make_long_beam(n_elements=96):
    """A hybrid (linear root half, nonlinear tip half) 1 m Nitinol cantilever."""
    L, E, r, rho = 1.0, 75e9, 0.005, 6450.0
    n = n_elements
    return DynamicEulerBernoulliBeam(pd.DataFrame({
        "length": [L / n] * n,
        "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n,
        "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n,
        "type": ["linear"] * (n // 2) + ["nonlinear"] * (n - n // 2),
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [2 * np.pi * r * L / n] * n,
        "drag_coef": [0.82] * n,
    }))


def _scalar(x) -> float:
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def rank_main(dp: int, sp: int, n_el: int, spans: dict, verbose: bool, basis=None) -> dict:
    """Every tier on this rank of a ``dp x sp`` world (run by ``launch``);
    returns each tier's tip values and wall seconds. ``basis``: a ``(V, W)``
    pair for the ROM tier in place of its eigensolve's."""
    lead = torch.distributed.get_rank() == 0
    say = print if verbose and lead else (lambda *a: None)
    dev = collectives.world_device()
    dtype = torch.float64
    model = make_long_beam(n_el)
    mesh = make_mesh({"dp": dp, "sp": sp}, device=dev)
    say(f"device mesh: dp={dp} sp={sp} over {dp * sp} ranks ({dev.type})")
    say(f"beam: {n_el} elements, {model.n_pos_states} free DOFs, "
        "root half linear / tip half nonlinear\n")
    beam = make_spatial_beam(model.beam_model.arrays,
                             model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    Np = beam.n_nodes
    B = 2  # environments, over dp
    tip = beam.n_nodes_real - 1
    u = torch.zeros((Np, 3), dtype=dtype, device=dev)
    u[tip, 1] = 0.5
    x0 = torch.zeros((B, 2, Np, 3), dtype=dtype, device=dev)
    out = {}

    # Explicit tier: RK4 with psum-CG mass solves.
    t0 = time.perf_counter()
    ts, xs = spatial_rollout(beam, x0, spans["explicit_t"], spans["explicit_dt"], u=u,
                             substeps=spans["explicit_substeps"])
    out["explicit_tip"] = host(xs[-1, :, 0, tip, 1])
    out["explicit_s"] = time.perf_counter() - t0
    say(f"explicit RK4      frames={len(ts)} tip w={out['explicit_tip'][0]:+.3e} m  "
        f"wall={out['explicit_s']:.1f}s")

    # Implicit tier: distributed-SPIKE generalized-alpha. On a card each
    # local solve is a launch of the btd_solve kernel (0 on the CPU).
    t0 = time.perf_counter()
    launches0 = kb.btd_solve.launches
    rollout_ga = build_spatial_genalpha(beam, 1e-5, rho_inf=0.8, n_newton=1)
    ts, xs = rollout_ga(x0, spans["ga_frames"], u=u, substeps=20)
    out["genalpha_tip"] = host(xs[-1, :, 0, tip, 1])
    out["genalpha_s"] = time.perf_counter() - t0
    out["genalpha_btd_launches"] = kb.btd_solve.launches - launches0
    say(f"implicit gen-a    frames={len(ts)} tip w={out['genalpha_tip'][0]:+.3e} m  "
        f"wall={out['genalpha_s']:.1f}s (dt=1e-5, {spans['ga_frames'] * 20} steps, "
        f"{out['genalpha_btd_launches']} btd_solve launches)")

    # Error-controlled tier: sharded SDIRK3.
    t0 = time.perf_counter()
    rollout_s3 = build_spatial_sdirk3(beam, n_newton=2)
    t_eval = np.linspace(0.0, spans["sdirk_t"], 5)
    xs, stats = rollout_s3(x0, t_eval, u=u, rtol=1e-6, atol=1e-9)
    out["sdirk3_tip"] = host(xs[-1, :, 0, tip, 1])
    out["sdirk3_accepted"] = host(stats.n_accepted)
    out["sdirk3_rejected"] = host(stats.n_rejected)
    out["sdirk3_s"] = time.perf_counter() - t0
    say(f"adaptive SDIRK3   acc={out['sdirk3_accepted'].tolist()} "
        f"rej={out['sdirk3_rejected'].tolist()} (per env)  tip w="
        f"{out['sdirk3_tip'][0]:+.3e} m  wall={out['sdirk3_s']:.1f}s (rtol=1e-6, no manual dt)")

    # Reduced-order tier: sharded modal ROM, ECSW sample and its audit.
    t0 = time.perf_counter()
    sm = build_spatial_modal_rom(model, mesh, 1e-5, rho_inf=0.5, n_modes=spans["rom_modes"],
                                 basis=basis)
    n = model.n_pos_states
    u_red = np.zeros(n)
    u_red[-2] = 0.5
    u_m = torch.as_tensor(sm.ms.project_force_host(u_red), dtype=dtype, device=dev)
    z = torch.zeros((1, sm.n_modes), dtype=dtype, device=dev)
    _, etas_tr, _ = sm.rollout_frames(z, z, u_m, spans["rom_frames"], substeps=10,
                                      n_newton=2)
    out["rom_training_tip_modal"] = host(etas_tr[-1, 0])
    out["rom_training_s"] = time.perf_counter() - t0
    say(f"sharded modal-ROM m={sm.n_modes} training rollout "
        f"wall={out['rom_training_s']:.1f}s")

    t0 = time.perf_counter()
    red, info = sm.hyper_reduce(host(etas_tr[::2, 0, :]), tau=1e-3, return_info=True)
    _, es, eds, guard = red.rollout_frames_guarded(
        etas_tr[-1, 0], torch.zeros(sm.n_modes, dtype=dtype, device=dev), u_m,
        spans["guard_frames"], substeps=10)
    out["ecsw_sampled"] = int(info["n_sampled"])
    out["ecsw_train_residual"] = float(info["train_residual"])
    out["guard_max_residual"] = _scalar(guard["max_residual"])
    out["guard_flagged"] = bool(_scalar(guard["flagged"]))
    out["guarded_s"] = time.perf_counter() - t0
    say(f"ECSW sample s={out['ecsw_sampled']}/{n_el} elements "
        f"(train residual {out['ecsw_train_residual']:.1e})")
    say(f"guarded rollout   max envelope residual {out['guard_max_residual']:.2e} "
        f"(tol {guard['guard_tol']:.0e}) flagged={out['guard_flagged']} "
        f"wall={out['guarded_s']:.1f}s")

    # Out-of-envelope content is flagged: force the clamp region, which the
    # tip-load training never excited.
    u_bad = np.zeros(n)
    u_bad[1] = 0.5
    u_bad_m = torch.as_tensor(sm.ms.project_force_host(u_bad), dtype=dtype, device=dev)
    _, _, _, g_bad = red.rollout_frames_guarded(z[0], z[0], u_bad_m, spans["guard_frames"],
                                                substeps=10)
    out["outside_max_residual"] = _scalar(g_bad["max_residual"])
    out["outside_flagged"] = bool(_scalar(g_bad["flagged"]))
    say(f"out-of-envelope   max residual {out['outside_max_residual']:.2e} "
        f"flagged={out['outside_flagged']}  <- the audit catches it")

    # Physical frames reconstruct shard-locally (node-sharded DTensors).
    qs, _ = red.physical_frames(es, eds)
    out["rom_tip"] = _scalar(qs.full_tensor()[-1, tip, 1])
    say(f"\nphysical frames: {tuple(qs.shape)} node-sharded over '{red.axis}'; "
        f"tip deflection {out['rom_tip']:+.3e} m")

    # Differentiable tier: identify the elastic modulus from a tip trace by
    # reverse mode through the distributed-SPIKE rollout (secant iteration
    # on d loss / d s = 0; each evaluation one backward pass).
    t0 = time.perf_counter()
    x1 = torch.zeros((2, Np, 3), dtype=dtype, device=dev)
    arrs0 = beam.arrays
    E0 = torch.as_tensor(np.asarray(arrs0.elastic_modulus), dtype=dtype, device=dev)

    def tip_trace(s):
        arrs = dataclasses.replace(arrs0, elastic_modulus=s * E0)
        _, xs = rollout_ga(x1, spans["sysid_frames"], u=u, substeps=5, arrays=arrs)
        return xs[:, 0, tip, 1]

    with torch.no_grad():
        target = tip_trace(torch.tensor(1.0, dtype=dtype, device=dev))  # the true E

    def loss_grad(s):
        s = torch.tensor(s, dtype=dtype, device=dev, requires_grad=True)
        d = tip_trace(s) - target
        val = torch.sum(d * d) / torch.sum(target * target)
        val.backward()
        return val.item(), s.grad.item()

    s_prev, s = 0.7, 0.8  # a 30% misestimate
    _, g_prev = loss_grad(s_prev)
    for _ in range(spans["sysid_iters"]):
        _, g = loss_grad(s)
        if g == g_prev or abs(g) < 1e-18:
            break
        s, s_prev, g_prev = s - g * (s - s_prev) / (g - g_prev), s, g
    val, _ = loss_grad(s)
    out["sysid_scale"], out["sysid_loss"] = s, val
    out["sysid_s"] = time.perf_counter() - t0
    say(f"sharded system ID: recovered E scale {s:.6f} (true 1.0, started 0.7, loss "
        f"{val:.1e}) wall={out['sysid_s']:.1f}s - reverse mode through the SPIKE rollout")
    return out


def run(dp=2, sp=2, n_elements=96, spans=None, basis=None, device=None, timeout=1800.0,
        verbose=False) -> dict:
    """Launch ``dp * sp`` ranks (the cards unless ``device="cpu"``) and
    return rank 0's results; ``spans`` overrides entries of :data:`SPANS`."""
    spans = {**SPANS, **(spans or {})}
    results = collectives.launch(rank_main, dp * sp, dp, sp, n_elements, spans, verbose,
                                 basis, timeout=timeout, device=device)
    return results[0]


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--sp", type=int, default=2)
    args = parser.parse_args(argv)
    return run(args.dp, args.sp, device=args.device, verbose=True)


if __name__ == "__main__":
    main()

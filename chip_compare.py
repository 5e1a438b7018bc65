#!/usr/bin/env python3
"""Time the same kernels and spans on two checkouts of the port, on one card.

    python3 chip_compare.py --tree DIR            # one checkout: a JSON line
    python3 chip_compare.py --ab PARENT_DIR       # parent, this, this, parent
    python3 chip_compare.py --ab PARENT_DIR --sections modal   # some sections only
    python3 chip_compare.py --splits              # the float32 project's slice count
    python3 chip_compare.py --tree . --sections adaptive   # host reads, RHS thresholds

``--tree`` imports ``continuum_robot_tpu_torch`` from ``DIR`` (its kernels
build from ``DIR``'s sources into ``DIR/build``) and measures, at the main
paths' shapes in float32 on the card, in sections (``--sections``, a
comma-separated subset of modal, rom, implicit, fused; all by default):

modal:

- the linear modal main path (``chip_smoke.py`` phases 4 and 6):
  ``rollout_power(K=64)`` (best of 3, its device time, host dispatch and
  launches by kernel) and ``rollout_pallas`` over 2000 steps; each modal
  kernel alone at phase 6's shapes (``modal_steps`` 2000 steps,
  ``modal_frames`` 64 envs x 10 x 20, ``affine_steps`` 31 applications,
  ``affine_drive`` where the tree has it): a lone launch (best of 5), its
  device time (the profiler; and CUDA events around launches queued
  behind a spin of the card) and host dispatch; the two frame drives
  through the engine's entries (``rollout_frames_pallas``,
  ``rollout_frames_power``; 10 frames x 20 substeps at 64 and 4096 envs):
  a lone call, its device time (the profiler), host dispatch and launches
  by kernel; SHA-256 of the
  float32 and float64 outputs of ``modal_steps`` and ``modal_frames``
  (undamped and damped), ``affine_steps``, ``rollout_power`` and the two
  frame drives (64 envs, the power frames also with a force released
  inside a frame; 4096 envs in float32) on seeded states;

rom:

- the dense-Newton ROM span (``chip_smoke.py`` phase 10: 256 modes, 4096
  envs, 200 steps; best of 3 by CUDA events) and its device time per
  kernel (``torch.profiler``, 20 steps);
- the ROM window span and the "highest" span (``nl_precision="highest"``),
  200 steps each, and the host's dispatch time of three ROM wrappers (200
  calls without synchronising);
- the four basis-transform GEMMs alone on a mid-span state: ``rom_expand``
  and ``rom_project`` (3xTF32), ``rom_expand_f32`` and ``rom_project_f32``
  (float32): a lone launch (best of 5), its device time, its host dispatch,
  and ``torch.matmul`` of the same product beside each;
- a SHA-256 of the tensor-core pair's outputs and one of the float32
  pair's, on seeded random operands at the main path's shapes, so that two
  trees' outputs can be compared bit for bit;
- ``rom_correction_window`` on the mid-span state and
  ``rom_correction_gathered`` on an evenly spread sample of 41 elements
  (the main path's ECSW sample size), with that sample's span (200 steps,
  host-launch-bound): a lone launch (best of 5), its
  device time, its host dispatch, its error against the float32 twin and
  against the float64 twin beside the float32 twin's own, as fractions of
  the twin's scale, and a SHA-256 of its output on seeded node states;
- ``rom_newton_dense`` alone (a lone launch, best of 5, and its device
  time) beside ``r @ Sinv^T`` by ``torch.matmul``;

implicit:

- ``btd_solve`` alone at 4096 x 1001 nodes (a lone launch, its device
  time and a SHA-256 of its output), its rows as the checkout's implicit
  operator hands them;
- a step of the linear and of the consistent von Karman implicit main
  paths (50 steps, best of 3);

fused:

- ``fused_gen_alpha_steps`` at the fused path's shape (the water beam's
  operators, 20 steps) at 4096 and 65536 envs, float32 and float64: a
  lone launch (best of 5), ten back-to-back launches, its device time and
  a SHA-256 of its output; and the fused span (``fused_rollout``, 4096
  envs, 250 frames x 20 substeps, float32): its time (best of 3), device
  time, launches by kernel and a SHA-256 of its frames.

adaptive (float64; not in the default sections):

- the adaptive driver's host-check interval (``integrators.
  HOST_CHECK_INTERVAL`` set to 1, 2, 4 and 8, each run twice in the order
  1 2 4 8 8 4 2 1): Dopri5 on nonlinear_fluid_gravity over 2 ms of the
  golden's tip impulse (1 env, and 4096 envs with ``per_env=True`` as in
  ``chip_smoke.py`` phase 23), and adaptive generalized-alpha on stiff60
  (``chip_smoke.py`` phase 24, ``dense_inv``; 1 env and 4096 envs): ms a
  trial over the trials the device ran (``stats.trials_run``, masked ones
  included), host reads, and whether every interval gave the same bits;
- the small-beam RHS's two thresholds: ms a Dopri5 trial (40 trials, the
  step cap of one long interval) on von Karman beams of 6, 8, 12, 16 and 24
  elements with drag and gravity, at 1 and 4096 envs, with the internal
  force as the cubic contraction or the element planes
  (``dynamic_beam_model.POLY_MAX_ELEMENTS``) and the dense products as row
  sums or matmuls (``dynamics.ROWSUM_MAX``), and each variant's last state
  against the cubic/row-sum one's.

``--ab`` runs ``--tree`` in four processes, parent, this checkout, this
checkout, parent, and prints their lines, which digests equal the
parent's, which differ from it and which differ between two runs of one
tree, and the card; compare the two trees only within one such call.

``--splits`` launches this checkout's ``rom_project_f32`` kernel with S =
1..12 slices on the operands of the card-only test
``test_float32_gemms_on_card`` (same seeds) at a few of its shapes and
4096 x 256 x 1000, and prints each S's error against ``torch.matmul`` and
against the float64 product, as fractions of the output's scale, beside
the slice count ``project_splits_f32`` picks.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _device_by_kernel(fn, dev, steps: int) -> dict:
    """``{kernel: (device ms per call of fn, launches per call)}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for _ in range(3):  # the profiler now and then records none of a call's kernels
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        if any(str(getattr(ev, "device_type", "")).endswith("CUDA")
               for ev in prof.key_averages()):
            break
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            key = ev.key.replace("(anonymous namespace)::", "")[:60]
            out[key] = (dev_us / 1e3 / steps, ev.count / steps)
    return out


def _smoke():
    """This checkout's ``chip_smoke.py``, whose set-up both trees share."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def measure(tree: str, sections) -> dict:
    cs = _smoke()
    sys.path.insert(0, tree)
    import torch

    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.utils import cuda_event_times

    assert crt.__file__.startswith(os.path.abspath(tree)), crt.__file__
    dev = torch.device(cs.DEVICE, 0)

    def best(fn, repeats=3):
        return min(cuda_event_times(fn, repeats=repeats, warmup=1, device=dev))

    def device(fn):
        return sum(v[0] for v in _device_by_kernel(fn, dev, 1).values())

    def digest(*outs):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    res = {"tree": tree, "sections": list(sections)}
    for name in sections:
        res.update(SECTIONS[name](cs, crt, dev, best, device, digest))
    return res


def measure_rom(cs, crt, dev, best, device, digest) -> dict:
    """The ROM spans and kernels of the imported tree."""
    import dataclasses

    import numpy as np
    import torch

    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

    res = {}
    steps = cs.ROM["dense_steps"]
    nn = cs.ROM["n_newton"]
    _, ms, eta, etad, u_m, _ = cs.rom_main_path(crt, dev)
    fused = ms.make_pallas_rollout()
    fused_d = dataclasses.replace(ms, Sinv_diag=None).make_pallas_rollout()
    res["dense_span_ms"] = best(lambda: fused_d(eta, etad, u_m, steps, n_newton=nn))
    res["dense_env_steps_per_s"] = steps * cs.N_ENVS / res["dense_span_ms"] * 1e3
    res["dense_profile"] = _device_by_kernel(
        lambda: fused_d(eta, etad, u_m, 20, n_newton=nn), dev, 20)
    res["window_span_ms"] = best(lambda: fused(eta, etad, u_m, steps, n_newton=nn))
    res["highest_span_ms"] = best(lambda: fused(eta, etad, u_m, steps, n_newton=nn,
                                                nl_precision="highest"))

    # One iteration's pieces on a mid-span state.
    st = fused(eta, etad, u_m, 50, n_newton=nn)
    a1 = st[2]
    op = fused.operators(st[0], u_m)
    op_d = fused_d.operators(st[0], u_m)
    g = rk.tma_rows(rk.rom_correction_window_plain(
        op, rk.rom_expand_plain(op, rk.rom_alpha_point_plain(op, *st, a1))))
    partials = rk.rom_project(op, g)
    gm = partials[0]
    for part in partials[1:]:  # slice order
        gm = gm + part
    r = rk._residual(op_d, gm, *st, a1)
    res["dispatch_us"] = {
        "rom_alpha_point": cs.dispatch_us(lambda: rk.rom_alpha_point(op, *st, a1), dev),
        "rom_update": cs.dispatch_us(lambda: rk.rom_update(op, partials, *st, a1, True), dev),
    }
    # The parent's kernel takes the residual r, this one the partials.
    takes = list(inspect.signature(rk.rom_newton_dense).parameters)[1]
    arg = partials if takes == "partials" else r
    dense = lambda: rk.rom_newton_dense(op_d, arg, *st, a1, True)  # noqa: E731
    res["dispatch_us"]["rom_newton_dense"] = cs.dispatch_us(dense, dev)
    res["rom_newton_dense"] = {"takes": takes, "ms": best(dense, 5),
                               "device_ms": sum(v[0] for v in _device_by_kernel(
                                   dense, dev, 1).values())}
    lib = lambda: r @ op_d.sinvT  # noqa: E731
    res["r_at_sinvT"] = {"ms": best(lib, 5), "device_ms": sum(
        v[0] for v in _device_by_kernel(lib, dev, 1).values())}

    # The basis-transform GEMMs alone, each beside torch.matmul of its product.
    op_h = fused.operators(st[0], u_m, "highest")
    eta_af = rk.rom_alpha_point_plain(op, *st, a1)

    gemms = {
        "rom_expand": (lambda: rk.rom_expand(op, eta_af), lambda: eta_af @ op.phiT),
        "rom_project": (lambda: rk.rom_project(op, g), lambda: g @ op.w),
        "rom_expand_f32": (lambda: rk.rom_expand_f32(op_h, eta_af),
                           lambda: eta_af @ op_h.phiT),
        "rom_project_f32": (lambda: rk.rom_project_f32(op_h, g), lambda: g @ op_h.w),
    }
    for name, (kern, lib) in gemms.items():
        res[name] = {"ms": best(kern, 5), "device_ms": device(kern),
                     "dispatch_us": cs.dispatch_us(kern, dev),
                     "matmul_ms": best(lib, 5), "matmul_device_ms": device(lib)}

    # Digests of the outputs on seeded operands at the main path's shapes.
    rng = np.random.default_rng(7)
    B, m, N = cs.N_ENVS, op.w.shape[1], op.n_rows

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    phiT, w = normal(m, N), normal(N, m)
    z = torch.zeros(1, device=dev)
    op_r = rk.ROMOperators(phiT=phiT, w=w, lam=z, u=z, cd=None, sinv=z, sinvT=None, L=z,
                           D=z, A=z, mask=z, gathered=False, sc=(0.0,) * 9,
                           split=rk.split_basis(phiT, w))
    af_r, g_r = normal(B, m), rk.tma_rows(normal(B, N))

    res["tf32_sha256"] = digest(rk.rom_expand(op_r, af_r), rk.rom_project(op_r, g_r))
    # The parent's float32 kernels read the unsplit bases from phiT and w.
    unsplit = "tf32" in inspect.signature(rk.split_basis).parameters
    op_rh = dataclasses.replace(op_r, nl_precision="highest", split=rk.split_basis(
        phiT, w, tf32=False) if unsplit else None)
    res["f32_sha256"] = digest(rk.rom_expand_f32(op_rh, af_r), rk.rom_project_f32(op_rh, g_r))

    # The two correction kernels alone, on the mid-span state and on seeded
    # node states (the window's operators, and an evenly spread sample of
    # ECSW_SAMPLE elements as the gathered layout).
    E = N // 3 - 1
    sel = np.unique(np.linspace(0, E - 1, ECSW_SAMPLE).round().astype(np.int64))
    fused_g = ms.apply_ecsw(sel, np.ones(sel.size)).make_pallas_rollout()
    res["ecsw_span_ms"] = best(lambda: fused_g(eta, etad, u_m, steps, n_newton=nn))
    op_g = fused_g.operators(st[0], u_m)
    x_mid = rk.rom_expand_plain(op, eta_af)
    xg_mid = rk.rom_expand_plain(op_g, eta_af)
    corr = {"rom_correction_window": (rk.rom_correction_window, op, x_mid,
                                      rk.rom_correction_window_plain),
            "rom_correction_gathered": (rk.rom_correction_gathered, op_g, xg_mid,
                                        rk.rom_correction_gathered_plain)}
    for name, (kern, o, xm, plain) in corr.items():
        run = lambda: kern(o, xm)  # noqa: E731
        out = run()
        twin = plain(o, xm)
        f64 = plain(fused.operators(xm.double(), u_m) if o is op
                    else fused_g.operators(xm.double(), u_m), xm.double())
        scale = float(twin.abs().max())
        xs = rk.tma_rows(normal(B, xm.shape[1]) * 1e-3)
        res[name] = {"ms": best(run, 5), "device_ms": device(run),
                     "dispatch_us": cs.dispatch_us(run, dev),
                     "vs_twin": float((out - twin).abs().max()) / scale,
                     "vs_f64": float((out.double() - f64).abs().max()) / scale,
                     "twin_vs_f64": float((twin.double() - f64).abs().max()) / scale,
                     "sha256": digest(kern(o, xs)), "repeat_equal": bool(
                         torch.equal(kern(o, xs), kern(o, xs)))}

    return res


def measure_implicit(cs, crt, dev, best, device, digest) -> dict:
    """``btd_solve`` alone and steps of the implicit main paths of the
    imported tree."""
    import numpy as np
    import torch

    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb

    res = {}
    # btd_solve alone, as the implicit operator calls it.
    model = crt.DynamicEulerBernoulliBeam(cs.bench_beam_dataframe(cs.N_ELEMENTS))
    a, c = cs.gen_alpha_system(cs.IMPLICIT["rho_lin"])
    fac = tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                for x in cs.btd_host_factors(model, a, c))
    n = fac[0].shape[0]
    rhs = torch.tensor(np.random.default_rng(0).normal(size=(cs.N_ENVS, n, 3)),
                       dtype=torch.float32, device=dev)
    if hasattr(kb, "pack_factors"):
        fac, rhs = kb.pack_factors(fac), cs.padded_rows(rhs, kb)
    solve = lambda: kb.btd_solve(fac, rhs)  # noqa: E731
    res["btd_solve"] = {"ms": best(solve, 5), "device_ms": device(solve),
                        "sha256": digest(solve())}

    # Steps of the implicit main paths.
    n_red = model.n_pos_states
    nl_model = crt.DynamicEulerBernoulliBeam(
        cs.bench_beam_dataframe(cs.N_ELEMENTS, "nonlinear"), use_consistent_nonlinear=True)
    for name, mdl, rho, newton in (
            ("implicit_linear_step_ms", model, cs.IMPLICIT["rho_lin"], cs.IMPLICIT["newton_lin"]),
            ("implicit_consistent_step_ms", nl_model, cs.IMPLICIT["rho_nl"],
             cs.IMPLICIT["newton_nl"])):
        o = cs.implicit_op(crt, mdl, rho, "pallas", dev)
        start = cs.implicit_start(o, n_red, torch.float32, dev)
        res[name] = best(lambda: cs.implicit_span(crt, o, start, 50, rho, newton)) / 50
    return res


def measure_fused(cs, crt, dev, best, device, digest) -> dict:
    """The fused small-beam kernel and span (``chip_smoke.py`` phases
    18-20) of the imported tree."""
    import numpy as np
    import torch

    from continuum_robot_tpu_torch.ops.cuda import fused_rollout as kf

    beam = cs.reference_beam(crt)
    mats, c_drag, u, x_main, h = cs.fused_main_case(kf, beam)
    F = cs.FUSED
    kw = dict(rho_inf=F["rho_inf"], n_newton=F["n_newton"])
    res = {}
    for envs in (F["envs"], F["big_envs"]):
        for dtype in (torch.float32, torch.float64):
            t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
            args = (tuple(t(A) for A in mats), t(c_drag), t(u),
                    t(np.tile(x_main, (envs // F["envs"], 1))), F["substeps"], h)
            run = lambda: kf.fused_gen_alpha_steps(*args, **kw)  # noqa: E731

            def ten():  # back-to-back launches, so dispatch overlaps
                for _ in range(10):
                    run()

            res[f"fused_gen_alpha_steps_{envs}_{str(dtype)[6:]}"] = {
                "ms": best(run, 5), "per_launch_ms": best(ten, 3) / 10,
                "device_ms": device(run), "sha256": digest(run())}
    T, dt = F["t_final"], F["dt"]
    x0 = torch.tensor(cs.fused_start(beam.n_pos_states, F["envs"]), dtype=torch.float32,
                      device=dev)
    span = lambda: kf.fused_rollout(beam, x0, T, dt, substeps=F["substeps"], **kw)  # noqa: E731
    kf.reset_launch_counts()
    ys = span()[1]
    res["fused_span_launches"] = {k.__name__: k.launches for k in kf.KERNELS}
    res["fused_span_sha256"] = digest(ys)
    res["fused_span_ms"] = best(span)
    res["fused_span_env_steps_per_s"] = (F["envs"] * round(T / dt) * F["substeps"]
                                         / res["fused_span_ms"] * 1e3)
    res["fused_span_device_ms"] = device(span)
    return res


def measure_modal(cs, crt, dev, best, device, digest) -> dict:
    """The linear modal main path (``chip_smoke.py`` phases 4 and 6) of the
    imported tree."""
    import numpy as np
    import torch

    from continuum_robot_tpu_torch.models import simulate as sim_mod
    from continuum_robot_tpu_torch.models.simulate import make_modal_genalpha
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as kr

    B, steps, K = cs.N_ENVS, cs.N_STEPS, cs.K_POWER
    model = crt.DynamicEulerBernoulliBeam(cs.bench_beam_dataframe(cs.N_ELEMENTS))
    ms = make_modal_genalpha(model, cs.DT, rho_inf=cs.RHO_INF, device=dev,
                             dtype=torch.float32)
    n_red = model.n_pos_states
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(B, n_red)), dtype=torch.float32, device=dev)
    eta, etad = ms.to_modal(q, torch.zeros_like(q))
    u = np.zeros(n_red)
    u[-2] = 0.1
    u_m = np.asarray(ms.project_force_host(u), np.float32)
    u64 = u_m.astype(np.float64)

    res = {}
    power = lambda: ms.rollout_power(eta, etad, u_m, steps, K=K)  # noqa: E731
    kr.reset_launch_counts()
    power()
    res["rollout_power_launches"] = {k.__name__: k.launches for k in kr.KERNELS}
    res["rollout_power_ms"] = best(power)
    res["rollout_power_env_steps_per_s"] = steps * B / res["rollout_power_ms"] * 1e3
    res["rollout_power_device_ms"] = device(power)
    res["rollout_power_dispatch_us"] = cs.dispatch_us(power, dev)
    res["rollout_pallas_ms"] = best(lambda: ms.rollout_pallas(eta, etad, u_m, steps))

    # Each kernel alone at phase 6's shapes: a lone launch (best of 5), its
    # device time (the profiler; and CUDA events around ten launches queued
    # behind a spin of the card).
    lam, winv, _ = ms._stepper_consts(eta)
    a0 = kr.initial_accel(lam, u_m, None, eta, etad)
    PK, bK = ms._power_map_device(K, u64, eta)
    Pr, br = ms._power_map_device(steps % K, u64, eta)
    apps = steps // K
    sim = cs.SIM
    sim_eta, sim_etad = eta[: sim["envs"]].contiguous(), etad[: sim["envs"]].contiguous()
    frames = dict(n_frames=sim["frames"], substeps=sim["substeps"], h=cs.DT,
                  rho_inf=cs.RHO_INF)
    u_t = torch.as_tensor(u_m, device=dev)  # on the card: no copy queues behind the spin
    # A tree whose modal_frames takes the engine's memoized rows gets them.
    frame_kw = ({"coeffs": kr.frame_coeffs(lam, winv, u_t, None, cs.RHO_INF, eta)}
                if "coeffs" in inspect.signature(kr.modal_frames).parameters else {})
    calls = {
        "modal_steps": lambda: kr.modal_steps(lam, winv, u_t, eta, etad, a0, steps, cs.DT,
                                              cs.RHO_INF),
        "modal_frames": lambda: kr.modal_frames(lam, winv, u_t, sim_eta, sim_etad, **frames,
                                                **frame_kw),
        "affine_steps": lambda: kr.affine_steps(PK, bK, eta, etad, a0, apps),
    }
    if hasattr(kr, "affine_drive"):
        calls["affine_drive"] = lambda: kr.affine_drive(lam, u_t, None, PK, bK, eta, etad,
                                                        apps, Pr, br)
    for name, run in calls.items():
        res[name] = {"ms": best(run, 5), "device_ms": device(run),
                     "queued_ms": cs.queued_device_ms(run, dev),
                     "dispatch_us": cs.dispatch_us(run, dev)}

    # The two frame drives through the engine's entries (the same calls in
    # either tree), at simulate's shape and at full width: a lone call (best
    # of 5), its device time (profiler), its host dispatch and its launches by
    # kernel. Not by queued CUDA events: the parent's entries copy the NumPy
    # force to the card on every call, a copy that waits behind the spin.
    F, sub = sim["frames"], sim["substeps"]
    for envs in (sim["envs"], B):
        e, ed = eta[:envs], etad[:envs]
        for name in ("rollout_frames_pallas", "rollout_frames_power"):
            run = lambda e=e, ed=ed, name=name: getattr(ms, name)(e, ed, u_m, F,  # noqa: E731
                                                                   substeps=sub)
            kr.reset_launch_counts()
            run()
            launches = {k.__name__: k.launches for k in kr.KERNELS}
            res[f"{name}_{envs}"] = {
                "ms": best(run, 5), "device_ms": device(run),
                "dispatch_us": cs.dispatch_us(run, dev), "launches": launches}

    # Digests of float32 and float64 outputs on seeded states at the main
    # path's shapes, undamped and damped (a Rayleigh-like 0.5 + 1e-6 lam).
    rng = np.random.default_rng(11)
    start = rng.normal(scale=1e-6, size=(2, B, n_red))
    cd = 0.5 + 1e-6 * ms.lam
    for dtype in (torch.float32, torch.float64):
        e, ed = (torch.tensor(x, dtype=dtype, device=dev) for x in start)
        key = str(dtype)[6:]
        for damped in (False, True):
            kw = dict(h=cs.DT, rho_inf=cs.RHO_INF, cdamp=cd if damped else None)
            tag = f"{key}{'_damped' if damped else ''}"
            res[f"modal_steps_{tag}_sha256"] = digest(*kr.modal_steps(
                ms.lam, ms.winv64(), u64, e, ed, steps=steps, **kw))
            res[f"modal_frames_{tag}_sha256"] = digest(*kr.modal_frames(
                ms.lam, ms.winv64(), u64, e[: sim["envs"]].contiguous(),
                ed[: sim["envs"]].contiguous(), sim["frames"], sim["substeps"], **kw))
        P, b = ms._power_map(K, u64)
        a = kr.initial_accel(ms.lam, u64, None, e, ed)
        res[f"affine_steps_{key}_sha256"] = digest(*kr.affine_steps(P, b, e, ed, a, apps))
        res[f"rollout_power_{key}_sha256"] = digest(*ms.rollout_power(e, ed, u_m, steps, K=K))
        # the frame drives: simulate's shape (and a force released inside a
        # frame), and full width in float32
        release = sim_mod.PiecewiseConstant(((4 * sim["substeps"] + 9.5) * cs.DT,),
                                            np.stack([u64, -0.5 * u64]))
        for envs in (sim["envs"], B) if dtype == torch.float32 else (sim["envs"],):
            for name, force in (("rollout_frames_pallas", u_m), ("rollout_frames_power", u_m),
                                ("rollout_frames_power_released", release)):
                drive = getattr(ms, name.replace("_released", ""))
                res[f"{name}_{envs}_{key}_sha256"] = digest(*drive(
                    e[:envs], ed[:envs], force, sim["frames"], substeps=sim["substeps"])[1:])
    return res


def measure_adaptive(cs, crt, dev, best, device, digest) -> dict:
    """The adaptive driver's host-check interval and the small-beam RHS's
    two thresholds, in the imported tree (float64)."""
    import numpy as np
    import torch

    from continuum_robot_tpu_torch.models import dynamic_beam_model as dbm
    from continuum_robot_tpu_torch.models import dynamics
    from continuum_robot_tpu_torch.ops import integrators

    with open(os.path.join(HERE, cs.GOLDEN_DIR, "trajectories_meta.json")) as f:
        meta = json.load(f)
    amp, t_end, dt = meta["impulse_amplitude"], meta["impulse_t_end"], meta["dt"]
    types, fp = cs.GOLDEN_CONFIGS["nonlinear_fluid_gravity"]
    nfg = cs.golden_beam(crt, types, fp)
    n = nfg.n_pos_states
    rhs = nfg.build_rhs()
    kw = dict(rtol=cs.PARITY["rtol"], atol=cs.PARITY["atol"], dt0=dt / 10.0)
    te = np.arange(ADAPTIVE["dopri5_frames"] + 1) * dt
    envs = ADAPTIVE["envs"]
    amps = torch.tensor(np.geomspace(*cs.PER_ENV["amp"], envs), device=dev)

    stiff = cs.golden_beam(crt, ["linear"] * cs.STIFF["n_el"], length=cs.STIFF["length"])
    ns = stiff.n_pos_states
    scales = torch.linspace(*cs.STIFF["scale"], envs, dtype=torch.float64, device=dev)
    ts = np.arange(int(round(cs.STIFF["horizon"] / cs.STIFF["frame"])) + 1) * cs.STIFF["frame"]
    gkw = dict(rtol=cs.STIFF["rtol"], atol=cs.STIFF["atol"], n_newton=cs.STIFF["n_newton"],
               rho_inf=cs.STIFF["rho_inf"])

    def dopri5(width):
        x0 = torch.zeros((width, 2 * n) if width > 1 else (2 * n,), dtype=torch.float64,
                         device=dev)
        u = cs.tip_impulse(n, amps if width > 1 else amp, t_end, torch.float64, dev)
        return lambda: integrators.integrate_adaptive(rhs, x0, te, u=u, per_env=width > 1,
                                                      **kw)

    def genalpha(width):
        op = crt.make_newmark_operator(stiff, dt=None, linear_solver="dense_inv",
                                       device=dev)
        q0 = torch.zeros((width, ns) if width > 1 else (ns,), dtype=torch.float64,
                         device=dev)
        u = cs.tip_impulse(ns, amp * (scales if width > 1 else 1.0), t_end, torch.float64,
                           dev)
        return lambda: integrators.integrate_generalized_alpha_adaptive(
            op, q0, torch.zeros_like(q0), ts, u=u, **gkw)[::2]

    res, real = {}, integrators.HOST_CHECK_INTERVAL
    order = ADAPTIVE["intervals"] + ADAPTIVE["intervals"][::-1]
    try:
        for name, make in (("dopri5_1", lambda: dopri5(1)),
                           (f"dopri5_per_env_{envs}", lambda: dopri5(envs)),
                           ("genalpha_stiff60_1", lambda: genalpha(1)),
                           (f"genalpha_stiff60_{envs}", lambda: genalpha(envs))):
            run = make()
            run()  # warm-up
            secs, outs = {k: [] for k in ADAPTIVE["intervals"]}, {}
            for k in order:
                integrators.HOST_CHECK_INTERVAL = k
                (xs, st), s = cs.wall(run)
                secs[k].append(s)
                outs[k] = (digest(xs), st)
            ref = outs[1][1]
            res[f"interval_{name}"] = {
                "trials": int(ref.n_steps.max()), "same_result": len(
                    {d for d, _ in outs.values()}) == 1,
                **{str(k): {"ms_per_trial_run": 1e3 * min(v) / outs[k][1].trials_run,
                            "ms": [1e3 * x for x in v], "trials_run": outs[k][1].trials_run,
                            "host_reads": outs[k][1].host_reads}
                   for k, v in secs.items()}}
            print(f"interval {name}: {res[f'interval_{name}']}", file=sys.stderr, flush=True)
    finally:
        integrators.HOST_CHECK_INTERVAL = real

    # The RHS's internal force (the cubic contraction or the element planes)
    # and dense products (row sums or matmuls): ms a Dopri5 trial, exactly
    # `trials` trials a run (the interval's step cap).
    real = dbm.POLY_MAX_ELEMENTS, dynamics.ROWSUM_MAX
    big = 10**6
    try:
        for n_el in ADAPTIVE["rhs_elements"]:
            rows = {}
            for poly in (True, False):
                for rowsum in (True, False):
                    dbm.POLY_MAX_ELEMENTS = big if poly else 0
                    dynamics.ROWSUM_MAX = big if rowsum else 0
                    model = cs.golden_beam(crt, ["nonlinear"] * n_el, fp)
                    m = model.n_pos_states
                    f = model.build_rhs()
                    for width in (1, envs):
                        x0 = torch.zeros(width, 2 * m, dtype=torch.float64, device=dev)
                        u = cs.tip_impulse(m, amp, t_end, torch.float64, dev)

                        def trials(cap):
                            return integrators.integrate_adaptive(
                                f, x0, [0.0, 1.0], u=u, max_steps_per_interval=cap, **kw)

                        trials(3)
                        (xs, st), s = cs.wall(lambda: trials(ADAPTIVE["rhs_trials"]))
                        rows[f"{'poly' if poly else 'planar'}/"
                             f"{'rowsum' if rowsum else 'matmul'}/{width}"] = (
                            1e3 * s / st.trials_run, xs[-1])
            base = {w: rows[f"poly/rowsum/{w}"][1] for w in (1, envs)}
            res[f"rhs_{n_el}_elements"] = {
                "dofs": m, **{k: {"ms_per_trial": v[0], "rel_vs_poly_rowsum": float(
                    (v[1] - base[int(k.split('/')[-1])]).abs().max()
                    / base[int(k.split('/')[-1])].abs().max())} for k, v in rows.items()}}
            print(f"rhs {n_el}: {res[f'rhs_{n_el}_elements']}", file=sys.stderr, flush=True)
    finally:
        dbm.POLY_MAX_ELEMENTS, dynamics.ROWSUM_MAX = real
    return res


SECTIONS = {"modal": measure_modal, "rom": measure_rom, "implicit": measure_implicit,
            "fused": measure_fused, "adaptive": measure_adaptive}
# The adaptive section: host-check intervals tried (each run twice, in the
# order 1 2 4 8 8 4 2 1), the Dopri5 runs' frames (of the golden's 1 ms) and
# width, and the RHS comparison's beams and trials a run.
ADAPTIVE = dict(intervals=[1, 2, 4, 8], dopri5_frames=2, envs=4096,
                rhs_elements=(6, 8, 12, 16, 24), rhs_trials=40)
ECSW_SAMPLE = 41  # elements of the main path's ECSW sample (chip_smoke.py phase 9)
SPLIT_SHAPES = ((4096, 256, 3003), (4096, 256, 1000), (4096, 256, 600), (4096, 13, 3003),
                (129, 256, 3003), (5, 37, 3003))


def splits_table() -> None:
    """``--splits``: see the module's docstring."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

    dev = torch.device("cuda", 0)
    for B, m, N in SPLIT_SHAPES:
        rng = np.random.default_rng(B + m + N)  # the card-only test's draws, in its order
        phiT = torch.tensor(rng.normal(size=(m, N)), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.normal(size=(N, m)), dtype=torch.float32, device=dev)
        basis = rk.split_basis(phiT, w, tf32=False)  # owns the buffer its maps point into
        wt = basis.wt_maps[0]
        rng.normal(size=(B, m))  # the test's eta_af
        g = rk.tma_rows(torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=dev))
        twin, ref = g @ w, g.double() @ w.double()
        scale = float(ref.abs().max())
        row = []
        for S in range(1, 13):
            if N // S < 32:
                break
            p = torch.empty((S, B, m), device=dev)
            rk._launch("rom_project_f32", g, B, m, N, S, g.data_ptr(), g.stride(0),
                       ctypes.addressof(wt), p.data_ptr())
            gm = p[0]
            for q in p[1:]:  # slice order, as rom_update sums them
                gm = gm + q
            row.append(f"S={S} twin {float((gm - twin).abs().max()) / scale:.2e} "
                       f"f64 {float((gm.double() - ref).abs().max()) / scale:.2e}")
        print(f"{B} x {m} x {N}: project_splits_f32 S={rk.project_splits_f32(B, m, N, dev)}, "
              f"torch.matmul vs f64 {float((twin.double() - ref).abs().max()) / scale:.2e} | "
              + " | ".join(row), flush=True)


def _digests(res: dict) -> dict:
    """``{name: sha256}`` of every digest in one ``--tree`` line."""
    out = {}
    for key, val in res.items():
        if key.endswith("sha256"):
            out[key] = val
        elif isinstance(val, dict) and "sha256" in val:
            out[f"{key}.sha256"] = val["sha256"]
    return out


def compare_digests(runs) -> list:
    """Lines saying, for the four runs of ``--ab`` (parent, this, this,
    parent), which digests equal the parent's, which differ from it, and
    which differ between two runs of one tree."""
    d = [_digests(r) for r in runs]
    same, changed, unstable = [], [], []
    for key in sorted(d[0]):
        vals = [x.get(key) for x in d]
        if vals[0] != vals[3] or vals[1] != vals[2]:
            unstable.append(key)
        elif vals[0] == vals[1]:
            same.append(key)
        else:
            changed.append(key)
    return [f"digests equal to the parent's: {same}",
            f"digests that differ from the parent's: {changed}",
            f"digests that differ between runs of one tree: {unstable}"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--ab")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--sections", default=",".join(k for k in SECTIONS if k != "adaptive"),
                    help=f"comma-separated, of {', '.join(SECTIONS)} (default: all but "
                         "adaptive)")
    args = ap.parse_args()
    sections = args.sections.split(",")
    for name in sections:
        if name not in SECTIONS:
            ap.error(f"unknown section {name!r}")
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.splits:
        splits_table()
        return 0
    if args.tree:
        t0 = time.time()
        res = measure(os.path.abspath(args.tree), sections)
        res["seconds"] = time.time() - t0
        print(json.dumps(res))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in (args.ab, HERE, HERE, args.ab):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                               "--sections", args.sections], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for line in compare_digests(runs):
        print(line, flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

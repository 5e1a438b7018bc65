#!/usr/bin/env python3
"""Time the same kernels and spans on two checkouts of the port, on one card.

    python3 chip_compare.py --tree DIR            # one checkout: a JSON line
    python3 chip_compare.py --ab PARENT_DIR       # parent, this, this, parent

``--tree`` imports ``continuum_robot_tpu_torch`` from ``DIR`` (its kernels
build from ``DIR``'s sources into ``DIR/build``) and measures, at the main
paths' shapes in float32 on the card:

- the dense-Newton ROM span (``chip_smoke.py`` phase 10: 256 modes, 4096
  envs, 200 steps; best of 3 by CUDA events) and its device time per
  kernel (``torch.profiler``, 20 steps);
- the ROM window span, 200 steps, and the host's dispatch time of three
  ROM wrappers (200 calls without synchronising);
- ``rom_newton_dense`` alone (a lone launch, best of 5, and its device
  time) beside ``r @ Sinv^T`` by ``torch.matmul``;
- ``btd_solve`` alone at 4096 x 1001 nodes (a lone launch and its device
  time), its rows as the checkout's implicit operator hands them;
- a step of the linear and of the consistent von Karman implicit main
  paths (50 steps, best of 3).

``--ab`` runs ``--tree`` in four processes, parent, this checkout, this
checkout, parent, and prints their lines and the card; compare the two
trees only within one such call.
"""

from __future__ import annotations

import argparse
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
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


def measure(tree: str) -> dict:
    import dataclasses

    cs = _smoke()
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk
    from continuum_robot_tpu_torch.utils import cuda_event_times

    assert crt.__file__.startswith(os.path.abspath(tree)), crt.__file__
    dev = torch.device(cs.DEVICE, 0)

    def best(fn, repeats=3):
        return min(cuda_event_times(fn, repeats=repeats, warmup=1, device=dev))

    res = {"tree": tree}
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
    res["btd_solve"] = {"ms": best(solve, 5), "device_ms": sum(
        v[0] for v in _device_by_kernel(solve, dev, 1).values())}

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--ab")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        t0 = time.time()
        res = measure(os.path.abspath(args.tree))
        res["seconds"] = time.time() - t0
        print(json.dumps(res))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in (args.ab, HERE, HERE, args.ab):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA kernels from the sources in this checkout;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, float32 and float64, at a small ragged size and at the main path's
   size; they must agree bit for bit;
4. main path: the 1000-element linear Nitinol cantilever (the JAX package's
   bench.py beam, built from the DataFrame schema), host float64 eigh, 4096
   envs in float32, ``rollout_power(K=64)`` over 2000 steps at dt=1e-4 and
   rho_inf=0.8, checked against the step kernel over the same span
   (``vs_stepper_rel`` <= 1e-4) and for finite physical states;
5. ``simulate(method="modal")`` with engines "pallas", "power" and "xla"
   (64 envs, 10 frames x 20 substeps), each held to "xla", the plain path;
6. timings: CUDA events, best of 3 after a warm-up.

Kernel launch counts are reset before phase 4 and read after phase 5: every
kernel must have been launched by the main path. The second-to-last lines
are the kernels' JSON record and the card line; the last line is the
driver's JSON result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ELEMENTS, N_ENVS, N_STEPS, K_POWER = 1000, 4096, 2000, 64
N_MODES_FULL = 3 * N_ELEMENTS  # the bench beam's free DOFs = its modes
DEVICE = "cuda"
DT, RHO_INF = 1e-4, 0.8
SMALL = dict(B=5, m=37, steps=17)
SIM = dict(envs=64, frames=10, substeps=20)
VS_STEPPER_MAX = 1e-4
SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/modal_rollout.cu"
REPLACES = {
    "modal_steps": "continuum_robot_tpu/ops/pallas/modal_rollout.py:201",
    "modal_frames": "continuum_robot_tpu/ops/pallas/modal_rollout.py:392",
    "affine_steps": "continuum_robot_tpu/ops/pallas/modal_rollout.py:280",
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def bench_beam_dataframe(n: int):
    """The JAX package's bench.py beam: 0.25/6 m Nitinol elements, fixed base."""
    import pandas as pd

    L_el, E, r, rho = 0.25 / 6, 75e9, 0.005, 6450.0
    return pd.DataFrame({
        "length": [L_el] * n,
        "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n,
        "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n,
        "type": ["linear"] * n,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
    })


def synthetic_engine(m: int, rng, damped: bool):
    """A modal engine with a beam-like spectrum (1 .. 1e12) and no basis:
    the coefficients the kernels see, without an eigensolve."""
    from continuum_robot_tpu_torch import convert

    lam = np.sort(10.0 ** rng.uniform(0.0, 12.0, m))
    cdamp = 0.5 + 1e-6 * lam if damped else None
    return convert.modal_engine_from_numpy(
        np.zeros((1, m)), np.zeros((m, 1)), lam, RHO_INF, DT, cdamp
    )


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_kernels(kr, dev):
    """Kernel vs plain on the card; returns {kernel: max |kernel - plain|}."""
    from continuum_robot_tpu_torch.utils import force_completion

    err = {name: 0.0 for name in REPLACES}
    rng = np.random.default_rng(1)
    sizes = [SMALL, dict(B=N_ENVS, m=N_MODES_FULL, steps=N_STEPS)]
    for dtype in (torch.float32, torch.float64):
        for size in sizes:
            B, m, steps = size["B"], size["m"], size["steps"]
            eta = torch.tensor(rng.normal(scale=1e-6, size=(B, m)), dtype=dtype, device=dev)
            etad = torch.tensor(rng.normal(scale=1e-6, size=(B, m)), dtype=dtype, device=dev)
            u = rng.normal(scale=1e-3, size=m)
            for damped in (False, True):
                ms = synthetic_engine(m, rng, damped)
                args = (ms.lam, ms.winv64(), u, eta, etad)
                kw = dict(h=DT, rho_inf=RHO_INF, cdamp=ms.cdamp)
                e = max_abs(kr.modal_steps(*args, steps=steps, **kw),
                            kr.modal_steps_plain(*args, steps=steps, **kw))
                err["modal_steps"] = max(err["modal_steps"], e)
                frames = dict(n_frames=4, substeps=max(1, steps // 4))
                e = max_abs(kr.modal_frames(*args, **frames, **kw),
                            kr.modal_frames_plain(*args, **frames, **kw))
                err["modal_frames"] = max(err["modal_frames"], e)
                P, b = ms._power_map(K_POWER, u)
                a0 = kr.initial_accel(ms.lam, u, ms.cdamp, eta, etad)
                apps = N_STEPS // K_POWER if B == N_ENVS else steps
                e = max_abs(kr.affine_steps(P, b, eta, etad, a0, apps=apps),
                            kr.affine_steps_plain(P, b, eta, etad, a0, apps=apps))
                err["affine_steps"] = max(err["affine_steps"], e)
            force_completion((eta,))
            print(f"phase 3 kernel vs plain: {str(dtype)[6:]} B={B} m={m} "
                  f"steps={steps}: max|kernel-plain| "
                  + " ".join(f"{k}={v:.3e}" for k, v in err.items()), flush=True)
    for name, e in err.items():
        require(e == 0.0, f"{name}: kernel and plain version differ by {e:.3e}")
    return err


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Imported here: a directory without the package fails at this point.
    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.models.simulate import make_modal_genalpha
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as kr
    from continuum_robot_tpu_torch.utils import cuda_event_times, force_completion

    dev = torch.device(DEVICE, 0)
    card = card_line()
    print(f"phase 1 device: {card} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)

    t0 = time.time()
    _build.library()
    build_s = time.time() - t0
    log = _build.library_path().with_suffix(".log").read_text()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln]
    print(f"phase 2 build: {build_s:.1f} s; ptxas: {' | '.join(regs)}", flush=True)

    err = phase_kernels(kr, dev)

    # -- phase 4: the main path ------------------------------------------------
    t0 = time.time()
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS))
    build_model_s = time.time() - t0
    t0 = time.time()
    ms = make_modal_genalpha(model, DT, rho_inf=RHO_INF, device=dev,
                             dtype=torch.float32)
    eigh_s = time.time() - t0
    n_red = model.n_pos_states
    require(n_red == N_MODES_FULL, f"expected {N_MODES_FULL} modes, got {n_red}")
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(N_ENVS, n_red)),
                     dtype=torch.float32, device=dev)
    v = torch.zeros_like(q)
    u = np.zeros(n_red, np.float32)
    u[-2] = 0.1
    eta, etad = ms.to_modal(q, v)
    u_m = np.asarray(ms.project_force_host(u), np.float32)

    kr.reset_launch_counts()
    e2, ed2, _ = ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER)
    er, edr, _ = ms.rollout_pallas(eta, etad, u_m, N_STEPS)
    num = torch.sqrt(((e2 - er) ** 2).sum() + ((ed2 - edr) ** 2).sum())
    den = torch.sqrt((er**2).sum() + (edr**2).sum())
    vs_stepper_rel = float(num / den)
    q2, v2 = ms.from_modal(e2, ed2)
    force_completion((q2, v2))
    finite = bool(torch.isfinite(q2).all() and torch.isfinite(v2).all())
    print(f"phase 4 main path: {N_ELEMENTS} elements, {n_red} modes, "
          f"{N_ENVS} envs, {N_STEPS} steps, K={K_POWER}: "
          f"vs_stepper_rel={vs_stepper_rel:.3e} finite={finite} "
          f"q shape {tuple(q2.shape)}; model build {build_model_s:.2f} s, "
          f"eigh {eigh_s:.2f} s (host)", flush=True)
    require(finite and q2.shape == (N_ENVS, n_red), "non-finite or misshapen states")
    require(vs_stepper_rel <= VS_STEPPER_MAX,
            f"vs_stepper_rel {vs_stepper_rel:.3e} > {VS_STEPPER_MAX}")

    # -- phase 5: simulate(method="modal") ----------------------------------
    x0 = np.zeros((SIM["envs"], 2 * n_red))
    x0[:, :n_red] = rng.normal(scale=1e-6, size=(SIM["envs"], n_red))
    frame_dt = DT * SIM["substeps"]
    ys = {}
    for engine in ("pallas", "power", "xla"):
        res = crt.simulate(model, x0, SIM["frames"] * frame_dt, frame_dt,
                           method="modal", u=u.astype(np.float64),
                           substeps=SIM["substeps"], rho_inf=RHO_INF,
                           engine=engine, device=dev, dtype=torch.float32)
        ys[engine] = force_completion(res.ys)
        require(tuple(res.ys.shape) == (SIM["frames"] + 1, SIM["envs"], 2 * n_red)
                and bool(torch.isfinite(res.ys).all()),
                f"simulate engine={engine}: bad output")
    rel_pallas = rel(ys["pallas"], ys["xla"])
    rel_power = rel(ys["power"], ys["xla"])
    print(f"phase 5 simulate: {SIM}: max rel vs xla: pallas {rel_pallas:.3e}, "
          f"power {rel_power:.3e}", flush=True)
    require(rel_pallas <= 1e-6, f"simulate pallas vs xla {rel_pallas:.3e}")
    require(rel_power <= 1e-4, f"simulate power vs xla {rel_power:.3e}")

    launches = {fn.__name__: fn.launches for fn in kr.KERNELS}
    print(f"main path launches: {launches}", flush=True)
    require(all(launches.values()), f"a kernel of the path was not launched: {launches}")

    # -- phase 6: timings -----------------------------------------------------
    def best(fn, *args):
        return min(cuda_event_times(fn, *args, repeats=3, warmup=1, device=dev))

    env_steps = N_STEPS * N_ENVS
    power_k = best(lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER))
    power_p = best(lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER,
                                            use_pallas=False))
    step_k = best(lambda: ms.rollout_pallas(eta, etad, u_m, N_STEPS))
    step_p = best(lambda: ms.rollout(eta, etad, u_m, N_STEPS))
    t0 = time.time()
    u64 = u_m.astype(np.float64)
    ms._power_map(K_POWER, u64)
    ms._power_map(N_STEPS % K_POWER, u64)
    compose_s = time.time() - t0

    lam, winv, _ = ms._stepper_consts(eta)
    a0 = kr.initial_accel(lam, u_m, None, eta, etad)
    PK, bK = ms._power_map_device(K_POWER, u64, eta)
    apps = N_STEPS // K_POWER
    sim_eta, sim_etad = eta[: SIM["envs"]].contiguous(), etad[: SIM["envs"]].contiguous()
    frames = dict(n_frames=SIM["frames"], substeps=SIM["substeps"], h=DT, rho_inf=RHO_INF)
    times = {
        "modal_steps": (
            best(kr.modal_steps, lam, winv, u_m, eta, etad, a0, N_STEPS, DT, RHO_INF),
            best(kr.modal_steps_plain, lam, winv, u_m, eta, etad, a0, N_STEPS, DT, RHO_INF),
        ),
        "modal_frames": (
            best(lambda: kr.modal_frames(lam, winv, u_m, sim_eta, sim_etad, **frames)),
            best(lambda: kr.modal_frames_plain(lam, winv, u_m, sim_eta, sim_etad, **frames)),
        ),
        "affine_steps": (
            best(kr.affine_steps, PK, bK, eta, etad, a0, apps),
            best(kr.affine_steps_plain, PK, bK, eta, etad, a0, apps),
        ),
    }
    print(f"phase 6 timings [{card}]: rollout_power K={K_POWER} "
          f"{env_steps / power_k * 1e3:.4e} env-steps/s ({power_k:.3f} ms) vs plain "
          f"{env_steps / power_p * 1e3:.4e} ({power_p:.3f} ms); rollout_pallas "
          f"{env_steps / step_k * 1e3:.4e} env-steps/s ({step_k:.3f} ms) vs plain "
          f"{env_steps / step_p * 1e3:.4e} ({step_p:.3f} ms); host eigh "
          f"{eigh_s:.2f} s, map composition {compose_s:.4f} s", flush=True)
    print(f"phase 6 kernels [{card}]: " + "; ".join(
        f"{k} {t[0]:.3f} ms vs plain {t[1]:.3f} ms" for k, t in times.items()),
        flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in REPLACES
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

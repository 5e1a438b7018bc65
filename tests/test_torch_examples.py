"""The port's examples against the JAX package: web demo, batched sweeps,
planner and force composition.

Each test runs a port example's ``run(device="cpu")`` at a small size and
rebuilds the JAX example's inner computation from the JAX package's public
API on the same inputs (float64, CPU): the web demo's payload (the JAX
``serve.run_simulation``, imported by path as ``test_legacy_and_demos.py``
does) and its HTTP routes, ``batched_rollouts``' two engines,
``sampling_planner`` on the same candidates and the force-composition
patterns. Tolerance 1e-10 relative throughout: both
packages run the same float64 recurrences.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
from continuum_robot_tpu.models import ForceParams as JForceParams
from continuum_robot_tpu.ops.integrators import integrate_fixed as jintegrate_fixed
from continuum_robot_tpu.parallel import batched_rollout as jbatched_rollout
from continuum_robot_tpu.parallel import sweep_statistics as jsweep_statistics
from continuum_robot_tpu_torch.examples import (
    batched_rollouts,
    example_utilities as ex,
    functional_composition_demo,
    sampling_planner,
)
from continuum_robot_tpu_torch.examples.web_demo import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale or (scale == 0 and err == 0), (err, scale)


def jax_serve():
    for sub in ("examples", os.path.join("examples", "web_demo")):
        path = os.path.join(REPO, sub)
        if path not in sys.path:
            sys.path.insert(0, path)
    from serve import run_simulation

    return run_simulation


def jax_beam(csv, fp=None):
    return jcrt.DynamicEulerBernoulliBeam(csv, force_params=fp)


# ---------------------------------------------------------------------------
# Web demo
# ---------------------------------------------------------------------------

DEMO = dict(n_segments=6, t_final=0.05, dt=0.001, impulse=0.1)


def test_web_demo_payload_matches_jax():
    got = serve.run_simulation(**DEMO, device="cpu")
    want = jax_serve()(**DEMO)
    assert set(got) == set(want) == {"times", "x_coords", "y_coords", "tip_displacement"}
    for key in want:
        close(got[key], want[key])
    assert max(abs(v) for v in got["tip_displacement"]) > 0
    # Memoized per device and dtype.
    assert serve.run_simulation(**DEMO, device="cpu") is got
    f32 = serve.run_simulation(**DEMO, device="cpu", dtype=torch.float32)
    assert f32 is not got
    close(f32["tip_displacement"], got["tip_displacement"], rtol=1e-4)


def test_web_demo_server_routes():
    server = serve.make_server(0, device="cpu", **DEMO)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/simulate", timeout=60) as r:
            assert r.headers["Content-Type"] == "application/json"
            payload = json.loads(r.read())
        assert payload == serve.run_simulation(**DEMO, device="cpu")
        for page in ("/", "/index.html"):
            with urllib.request.urlopen(base + page, timeout=60) as r:
                assert r.headers["Content-Type"] == "text/html"
                assert b"/simulate" in r.read()
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/nothing", timeout=60)
        assert exc.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_examples_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run_simulation(**DEMO)
    with pytest.raises(RuntimeError, match="CUDA"):
        functional_composition_demo.run()


# ---------------------------------------------------------------------------
# batched_rollouts
# ---------------------------------------------------------------------------


def test_batched_rollouts_match_jax():
    kw = dict(n_envs=4, t_final=0.004, dt=0.001, substeps=20)
    got = batched_rollouts.run(**kw, device="cpu")
    files = ex.create_beam_parameters()
    try:
        wet = jax_beam(files[0], JForceParams(enable_fluid_effects=True,
                                              fluid_density=1000.0))
        dry = jax_beam(files[0])
    finally:
        ex.cleanup_temp_files(*files)
    n = wet.n_pos_states
    x0 = np.zeros((kw["n_envs"], 2 * n))
    x0[:, n - 2] = np.random.default_rng(0).normal(scale=1e-3, size=kw["n_envs"])
    args = dict(t_final=kw["t_final"], dt=kw["dt"], substeps=kw["substeps"])
    res = jbatched_rollout(wet, x0, method="generalized_alpha", **args)
    stats = jsweep_statistics(res.ys)
    res3 = jbatched_rollout(dry, x0, method="modal", **args)
    close(got["tip"], np.asarray(res.ys)[..., n - 2])
    close(got["tip_modal"], np.asarray(res3.ys)[..., n - 2])
    close(got["tip_abs_max"], float(stats["tip_abs_max"]))
    close(got["state_rms"], float(stats["state_rms"]))
    assert got["env_steps"] == kw["n_envs"] * 4 * 20


# ---------------------------------------------------------------------------
# sampling_planner
# ---------------------------------------------------------------------------

PLAN = dict(n_candidates=5, horizon_segments=3, seg_time=0.004, dt=0.001, substeps=10,
            n_mpc_rounds=2, target_tip=2e-3)


def jax_plan():
    """The JAX script's segment and batched cost
    (``examples/sampling_planner.py:38-66``) at ``PLAN``'s sizes."""
    files = ex.create_beam_parameters()
    try:
        model = jax_beam(files[0])
    finally:
        ex.cleanup_temp_files(*files)
    n = model.n_pos_states
    rhs = model.build_rhs()
    dt, substeps = PLAN["dt"], PLAN["substeps"]
    steps = int(round(PLAN["seg_time"] / dt))

    def seg(x, f_amp):
        u = jnp.zeros(n).at[-2].set(f_amp)
        _, xs = jintegrate_fixed(rhs, x, 0.0, dt, steps, u=u, substeps=substeps)
        return xs[-1], xs[-1, n - 2]

    def plan_cost(x0, forces_seq):
        x_final, tips = jax.lax.scan(seg, x0, forces_seq)
        track = jnp.sum((tips - PLAN["target_tip"]) ** 2)
        effort = 1e-4 * jnp.sum(forces_seq**2)
        terminal_v = 1e-4 * jnp.sum(x_final[n:] ** 2)
        return track + effort + terminal_v

    return n, seg, jax.jit(jax.vmap(plan_cost, in_axes=(None, 0)))


def jax_planner(candidates):
    """The JAX script's MPC loop (``examples/sampling_planner.py:68-95``) on
    given candidates."""
    n, seg, batched_cost = jax_plan()
    x = jnp.zeros(2 * n)
    rounds = []
    for cand in candidates:
        costs = batched_cost(x, jnp.asarray(cand))
        best = int(jnp.argmin(costs))
        x, _ = seg(x, cand[best][0])
        rounds.append((float(costs[best]), float(cand[best][0]), float(x[n - 2])))
    return rounds, np.asarray(x)


def test_sampling_planner_matches_jax_on_the_same_candidates():
    rng = np.random.default_rng(11)
    cands = 0.3 * rng.normal(size=(PLAN["n_mpc_rounds"], PLAN["n_candidates"],
                                   PLAN["horizon_segments"]))
    got = sampling_planner.run(**PLAN, candidates=cands, device="cpu")
    rounds, x = jax_planner(cands)
    for mine, theirs in zip(got["rounds"], rounds):
        close(mine["best_cost"], theirs[0])
        assert mine["force"] == theirs[1]
        close(mine["tip"], theirs[2])
    close(got["final_state"], x)


def test_plan_cost_matches_jax():
    rng = np.random.default_rng(12)
    cand = 0.3 * rng.normal(size=(PLAN["n_candidates"], PLAN["horizon_segments"]))
    n, _, batched_cost = jax_plan()
    x0 = np.zeros(2 * n)
    x0[n - 2], x0[2 * n - 2] = 1e-4, -2e-3
    files = ex.create_beam_parameters()
    try:
        tm = sampling_planner.DynamicEulerBernoulliBeam(files[0])
    finally:
        ex.cleanup_temp_files(*files)
    steps = int(round(PLAN["seg_time"] / PLAN["dt"]))
    got = sampling_planner.plan_cost(tm.build_rhs(), torch.as_tensor(x0),
                                     torch.as_tensor(cand), steps, PLAN["dt"],
                                     PLAN["substeps"], PLAN["target_tip"])
    close(got.numpy(), np.asarray(batched_cost(x0, cand)))


def test_sampling_planner_draws_from_a_seeded_generator():
    kw = dict(PLAN, n_mpc_rounds=1)
    a = sampling_planner.run(**kw, device="cpu")
    b = sampling_planner.run(**kw, device="cpu")
    assert a["rounds"] == b["rounds"]


# ---------------------------------------------------------------------------
# functional_composition_demo
# ---------------------------------------------------------------------------


def jax_composition():
    """The JAX script's five patterns (``functional_composition_demo.py:43-92``)."""
    from continuum_robot_tpu.models import AbstractForce, GravityForce

    class TipLoadForce(AbstractForce):
        def __init__(self, magnitude, enabled=True):
            self.magnitude, self.enabled = magnitude, enabled

        def compute_forces(self, x, t):
            n = x.shape[-1] // 2
            return jnp.zeros((*x.shape[:-1], n), dtype=x.dtype).at[..., n - 2].set(
                self.magnitude)

        def is_enabled(self):
            return self.enabled

    files = ex.create_beam_parameters()
    try:
        beam = jax_beam(files[0], JForceParams(enable_fluid_effects=True,
                                               fluid_density=1000.0))
    finally:
        ex.cleanup_temp_files(*files)
    x = np.zeros(36)

    def peak():
        return float(np.abs(np.asarray(beam.system_func(x))).max())

    def external(x, t):
        return jnp.full((*x.shape[:-1], x.shape[-1] // 2), 0.5, dtype=x.dtype)

    out = {}
    beam.create_system_func()
    out["registry"] = peak()
    beam.create_system_func(forces_func=external)
    out["external"] = peak()
    registry = beam.force_registry.create_aggregated_function()
    beam.create_system_func(forces_func=lambda x, t: registry(x, t) + external(x, t))
    out["hybrid"] = peak()
    beam.create_system_func()
    out["before"] = peak()
    tip_load = TipLoadForce(2.0)
    beam.force_registry.register(tip_load)
    out["after"] = peak()
    tip_load.enabled = False
    out["disabled"] = peak()
    beam.force_registry.register(GravityForce(
        beam.params[["density", "cross_area", "length"]], gravity_vector=[0.0, -1.62, 0.0]))
    out["lunar"] = peak()
    return out


def test_functional_composition_matches_jax():
    got = functional_composition_demo.run(device="cpu")
    want = jax_composition()
    assert list(got) == list(want)
    for key in want:
        close(got[key], want[key])
    assert got["after"] > 0 and got["lunar"] > 0


def test_package_rules_scan_every_example():
    """The no-JAX import scan (``test_torch_package_rules.py``) covers each
    example, the helper module and the server."""
    from test_torch_package_rules import PORT_FILES

    examples = {p.name for p in PORT_FILES if p.parent.name in ("examples", "web_demo")}
    jax_scripts = {n for n in os.listdir(os.path.join(REPO, "examples")) if n.endswith(".py")}
    assert jax_scripts <= examples
    assert {"serve.py", "__init__.py"} <= examples
    assert os.path.exists(os.path.join(os.path.dirname(serve.__file__), "index.html"))

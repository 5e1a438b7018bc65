"""The port's adaptive implicit engines and exponential propagator against
the JAX package.

``integrate_generalized_alpha_adaptive`` and ``integrate_sdirk3_adaptive``
on 4-element linear and von Kármán beams (both packages built from one CSV,
the same seeded NumPy states, float64, CPU): equal accepted and rejected
counts and states within 1e-10 of the state scale; the frozen-tangent
reuse, per-environment control, truncation, ``simulate(chunk=)`` and the
exact exponential propagator, with its stiff60 golden.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu.models import simulate as jsim
from continuum_robot_tpu.ops import exponential as jexp
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu_torch.models import simulate as tsim
from continuum_robot_tpu_torch.ops import exponential as texp
from continuum_robot_tpu_torch.ops import integrators as ti

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
TOL = 1e-10


def models(kind, n_el=4, **csv_kw):
    csv = helpers.write_beam_csv([kind] * n_el, **csv_kw)
    jm, tm = jcrt.DynamicEulerBernoulliBeam(csv), tcrt.DynamicEulerBernoulliBeam(csv)
    os.unlink(csv)
    return jm, tm


def scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def start(n, envs=2, seed=1):
    rng = np.random.default_rng(seed)
    q0 = rng.normal(scale=1e-3, size=(envs, n))
    u = np.zeros(n)
    u[-2] = 0.5
    return q0, np.zeros((envs, n)), u


ENGINES = {
    "genalpha": (ji.integrate_generalized_alpha_adaptive,
                 ti.integrate_generalized_alpha_adaptive, {"rho_inf": 0.9}),
    "sdirk3": (ji.integrate_sdirk3_adaptive, ti.integrate_sdirk3_adaptive, {}),
}
# (kind, linear_solver, t_final, rtol) of generalized-alpha; the nonlinear
# SDIRK3 runs over 1e-4 s at rtol 1e-4 (few trials, each carrying a
# forward-mode jvp of the planar element force). Cases with the same
# engine, kind, span and tolerance share one JAX run ("pallas" is the JAX
# package's "btd").
CASES = [
    ("linear", "dense_inv", 2e-4, 1e-5),
    ("nonlinear", "btd", 2e-4, 1e-5),
    ("nonlinear", "pallas", 1e-4, 1e-4),
]
_jax_runs = {}


def jax_adaptive(engine, kind, t_final, rtol):
    """The JAX package's run of one case (memoized: a JAX call compiles)."""
    key = (engine, kind, t_final, rtol)
    if key not in _jax_runs:
        jf, _, kw = ENGINES[engine]
        jm, _ = models(kind)
        jop = jsim.make_newmark_operator(
            jm, dt=None, linear_solver="dense_inv" if kind == "linear" else "btd")
        q0, v0, u = start(jm.n_pos_states)
        _jax_runs[key] = jf(jop, jnp.asarray(q0), jnp.asarray(v0),
                            np.linspace(0.0, t_final, 5), u=jnp.asarray(u), rtol=rtol,
                            atol=rtol * 1e-3, **kw)
    return _jax_runs[key]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("kind,solver,t_final,rtol", CASES)
def test_adaptive_matches_jax(engine, kind, solver, t_final, rtol):
    if engine == "sdirk3" and kind == "nonlinear":
        t_final, rtol = 1e-4, 1e-4
    _, tf, kw = ENGINES[engine]
    _, tm = models(kind)
    top = tsim.make_newmark_operator(tm, dt=None, linear_solver=solver, device="cpu")
    q0, v0, u = start(tm.n_pos_states)
    jq, jv, js = jax_adaptive(engine, kind, t_final, rtol)
    tq, tv, ts = tf(top, torch.tensor(q0), torch.tensor(v0), np.linspace(0.0, t_final, 5),
                    u=u, rtol=rtol, atol=rtol * 1e-3, **kw)
    assert int(ts.n_accepted) == int(js.n_accepted)
    assert int(ts.n_rejected) == int(js.n_rejected)
    assert int(ts.n_incomplete) == 0 and int(ts.n_steps) > 10
    assert scaled(tq, jq) <= TOL and scaled(tv, jv) <= TOL
    assert float(ts.dt_next) == pytest.approx(float(js.dt_next), rel=1e-9)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_frozen_tangent_reuse_is_arithmetic_neutral(engine):
    import dataclasses

    _, tf, kw = ENGINES[engine]
    _, tm = models("linear")
    op = tsim.make_newmark_operator(tm, dt=None, linear_solver="dense_inv", device="cpu")
    assert op.tangent_frozen
    op_refactor = dataclasses.replace(op, tangent_frozen=False)
    n = tm.n_pos_states
    q0 = torch.zeros(n, dtype=torch.float64)
    q0[-2] = 1e-4
    t_eval = np.linspace(0.0, 6e-4, 4)
    out_a = tf(op, q0, torch.zeros_like(q0), t_eval, rtol=1e-5, atol=1e-8, **kw)
    out_b = tf(op_refactor, q0, torch.zeros_like(q0), t_eval, rtol=1e-5, atol=1e-8, **kw)
    for a, b in zip(out_a[:2], out_b[:2]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-16)
    assert int(out_a[2].n_accepted) == int(out_b[2].n_accepted)


def test_per_env_matches_jax_vmap():
    """The JAX package's per-env dt (``jax.vmap`` of the integrator) is
    ``per_env=True``: per-lane counts that differ, each lane its solo run."""
    jm, tm = models("linear", n_el=6)
    n = jm.n_pos_states
    jop = jsim.make_newmark_operator(jm, dt=None, linear_solver="dense_inv")
    top = tsim.make_newmark_operator(tm, dt=None, linear_solver="dense_inv", device="cpu")
    t_eval = np.linspace(0.0, 5e-4, 3)
    us = np.zeros((2, n))
    us[:, -2] = [0.1, 200.0]
    kw = dict(rtol=1e-5, atol=1e-12, dt0=1e-5)

    def jax_one(q, v, u):
        return ji.integrate_generalized_alpha_adaptive(jop, q, v, t_eval, u=u, **kw)

    jq, _, js = jax.vmap(jax_one)(jnp.zeros((2, n)), jnp.zeros((2, n)), jnp.asarray(us))
    z = torch.zeros(2, n, dtype=torch.float64)
    tq, _, ts = ti.integrate_generalized_alpha_adaptive(top, z, z, t_eval, u=us,
                                                        per_env=True, **kw)
    acc = ts.n_accepted.tolist()
    assert acc == np.asarray(js.n_accepted).tolist() and acc[0] != acc[1]
    assert ts.n_rejected.tolist() == np.asarray(js.n_rejected).tolist()
    assert scaled(tq.transpose(0, 1), jq) <= TOL  # JAX: envs leading
    for i in range(2):
        qi, _, si = ti.integrate_generalized_alpha_adaptive(top, z[i], z[i], t_eval,
                                                            u=us[i], **kw)
        assert scaled(tq[:, i], qi) <= TOL and int(si.n_accepted) == acc[i]


def test_engine_surfaces_truncation():
    _, tm = models("linear")
    op = tsim.make_newmark_operator(tm, dt=1e-4, linear_solver="dense_inv", device="cpu")
    n = tm.n_pos_states
    q0 = torch.zeros(n, dtype=torch.float64)
    q0[-2] = 1e-3
    t_eval = np.linspace(0.0, 2e-3, 3)
    _, _, stats = ti.integrate_generalized_alpha_adaptive(
        op, q0, torch.zeros_like(q0), t_eval, rtol=1e-10, atol=1e-13,
        max_steps_per_interval=2)
    assert int(stats.n_incomplete) > 0
    _, _, ok = ti.integrate_generalized_alpha_adaptive(
        op, q0, torch.zeros_like(q0), t_eval, rtol=1e-4, atol=1e-7)
    assert int(ok.n_incomplete) == 0


# -- simulate() and chunked driving ------------------------------------------------


@pytest.mark.parametrize("method,chunk,solver", [
    ("generalized_alpha_adaptive", 4, "btd"),
    ("implicit_adaptive", 3, "pallas"),
    ("sdirk3", 4, "dense_inv"),
    ("sdirk3_adaptive", 3, "dense_inv"),
])
def test_chunked_equals_monolithic(method, chunk, solver):
    _, tm = models("linear", n_el=6)
    n = tm.n_pos_states
    x0 = np.zeros(2 * n)
    x0[n - 2] = 1e-4
    kw = dict(method=method, rtol=1e-5, atol=1e-8, linear_solver=solver, device="cpu")
    res_m = tcrt.simulate(tm, x0, 5e-4, 1e-4, **kw)
    res_c = tcrt.simulate(tm, x0, 5e-4, 1e-4, chunk=chunk, **kw)
    assert torch.equal(res_c.ys, res_m.ys) and torch.equal(res_c.ts, res_m.ts)
    for a, b in zip(res_c.stats[:5], res_m.stats[:5]):
        assert torch.equal(a, b)
    assert res_m.stats.n_incomplete == 0 and res_m.ys.shape == (6, 2 * n)


def test_simulate_adaptive_matches_jax():
    jm, tm = models("nonlinear")
    n = jm.n_pos_states
    x0 = np.zeros(2 * n)
    x0[n - 2] = 1e-4
    for method in ("generalized_alpha_adaptive", "sdirk3"):
        kw = dict(method=method, rtol=1e-4, atol=1e-7)
        ref = jsim.simulate(jm, x0, 2e-4, 1e-4, **kw)
        res = tcrt.simulate(tm, x0, 2e-4, 1e-4, device="cpu", **kw)
        assert int(res.stats.n_accepted) == int(ref.stats.n_accepted)
        assert scaled(res.ys, ref.ys) <= TOL
        np.testing.assert_array_equal(res.ts.numpy(), np.asarray(ref.ts))


def test_chunk_validation_and_the_methods_left():
    _, tm = models("linear")
    x0 = np.zeros(2 * tm.n_pos_states)
    with pytest.raises(ValueError, match="adaptive"):
        tcrt.simulate(tm, x0, 4e-4, 1e-4, method="generalized_alpha", chunk=2,
                      device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        tcrt.simulate(tm, x0, 4e-4, 1e-4, method="sdirk3", chunk=0, device="cpu")
    # No method is left unported: modal_rom_adaptive takes chunk= too.
    assert not hasattr(tsim, "_NOT_PORTED")
    assert "modal_rom_adaptive" in tsim._CHUNKED
    with pytest.raises(ValueError, match="chunk"):
        tcrt.simulate(tm, x0, 4e-4, 1e-4, method="modal_rom_adaptive", chunk=0,
                      device="cpu")
    with pytest.raises(ValueError, match="Unknown method"):
        tcrt.simulate(tm, x0, 4e-4, 1e-4, method="lsoda", device="cpu")


# -- the exact exponential propagator ----------------------------------------------


def test_expm_propagator_matches_jax():
    jm, tm = models("linear", n_el=6)
    n = jm.n_pos_states
    rng = np.random.default_rng(4)
    x0 = rng.normal(scale=1e-3, size=(3, 2 * n))
    u_frames = np.zeros((12, n))
    u_frames[:5, -2] = 0.1
    ref = np.asarray(jexp.make_expm_propagator(jm, 1e-3, dtype=jnp.float64)(
        jnp.asarray(x0), jnp.asarray(u_frames)))
    got = texp.make_expm_propagator(tm, 1e-3, dtype=torch.float64, device="cpu")(
        x0, u_frames)
    assert got.shape == ref.shape == (13, 3, 2 * n)
    assert scaled(got, ref) <= 1e-12
    Phi, Gamma = texp.discretize_lti(np.array([[-2.0]]), np.array([[1.0]]), 0.5)
    assert Phi[0, 0] == pytest.approx(np.exp(-1.0))
    assert Gamma[0, 0] == pytest.approx((1 - np.exp(-1.0)) / 2.0)


def test_expm_propagator_gates():
    _, tm = models("nonlinear")
    with pytest.raises(ValueError, match="purely linear"):
        texp.make_expm_propagator(tm, 1e-3, device="cpu")
    csv = helpers.linear_csv()
    fluid = tcrt.DynamicEulerBernoulliBeam(
        csv, tcrt.ForceParams(enable_fluid_effects=True, fluid_density=1000.0))
    os.unlink(csv)
    with pytest.raises(ValueError, match="state-dependent"):
        texp.make_expm_propagator(fluid, 1e-3, device="cpu")


@pytest.mark.xfail(strict=True, reason=(
    "the port's propagator reads 2.837e-7 against the stiff60 golden's 1e-9 "
    "bound, as the JAX package's does (2.834e-7): the two propagators agree "
    "to 1e-12, so the offset lies between the exact flow of this assembly "
    "and the golden, not in either port"))
def test_stiff60_golden():
    with open(os.path.join(GOLDEN_DIR, "trajectories_meta.json")) as f:
        meta = json.load(f)
    y_ref = np.load(os.path.join(GOLDEN_DIR, "trajectories.npz"))["stiff60_y"]
    _, tm = models("linear", n_el=int(meta["stiff_n_elements"]),
                   length=meta["stiff_segment_length"])
    n = tm.n_pos_states
    prop = texp.make_expm_propagator(tm, meta["dt"], dtype=torch.float64, device="cpu")
    n_frames = int(round(meta["t_final"] / meta["dt"]))
    u_frames = np.zeros((n_frames, n))
    u_frames[: int(round(meta["impulse_t_end"] / meta["dt"])), -2] = meta["impulse_amplitude"]
    ys = prop(np.zeros(2 * n), u_frames).numpy()
    err = np.abs(ys.T[:, : y_ref.shape[1]] - y_ref).max() / np.abs(y_ref).max()
    assert err < 1e-9, f"stiff60: normalized trajectory error {err:.3e}"

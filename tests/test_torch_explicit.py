"""The reference-parity path of the PyTorch port against the JAX package.

The model's right-hand side (``build_rhs``, ``create_system_func`` /
``get_dynamic_system``), RK4 and Dopri5 steps, the adaptive driver and
``simulate(method="rk4"|"dopri5")``: both packages built from one CSV and
fed the same seeded NumPy inputs (float64, CPU). The golden prefix runs
the port alone against ``tests/goldens/trajectories.npz``; the adaptive
driver holds its interval by interval, so a 3 ms run is the first 4
frames of the full 1 s run (a Dopri5 trial is 2-3 ms of small torch ops
here, ~180 trials a frame; ``chip_smoke.py`` phase 21 runs 5 ms of every
configuration and 15 ms of one on the card).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu_torch.ops import integrators as ti
from continuum_robot_tpu_torch.parallel import rollout as trollout

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
PREFIX_FRAMES = 3  # 3 ms of the golden's 1 ms frames
RHS_TOL = 1e-12

# tests/test_parity_golden.py's six configurations.
CONFIGS = {
    "linear": (["linear"] * 6, {}),
    "nonlinear": (["nonlinear"] * 6, {}),
    "mixed": (["linear"] * 3 + ["nonlinear"] * 3, {}),
    "linear_fluid": (["linear"] * 6, {"enable_fluid_effects": True, "fluid_density": 1000.0}),
    "linear_gravity": (["linear"] * 6, {"enable_gravity_effects": True}),
    "nonlinear_fluid_gravity": (["nonlinear"] * 6, {
        "enable_fluid_effects": True, "fluid_density": 1000.0,
        "enable_gravity_effects": True}),
}


def tip_impulse(n, amplitude=0.1, t_end=0.01):
    """The golden's tip impulse as a torch callable: a tensor time of any
    batch shape (the adaptive drivers) or a float (the fixed-step ones)."""
    base = torch.zeros(n, dtype=torch.float64)
    tip = base.clone()
    tip[-2] = amplitude

    def u(t):
        if isinstance(t, torch.Tensor):
            return torch.where((t < t_end)[..., None], tip, base)
        return tip if t < t_end else base

    return u


def models(name):
    types, fp = CONFIGS[name]
    csv = helpers.write_beam_csv(types)
    jm = jcrt.DynamicEulerBernoulliBeam(csv, jcrt.ForceParams(**fp))
    tm = tcrt.DynamicEulerBernoulliBeam(csv, tcrt.ForceParams(**fp))
    os.unlink(csv)
    return jm, tm


def scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def meta():
    with open(os.path.join(GOLDEN_DIR, "trajectories_meta.json")) as f:
        return json.load(f)


_prefix_runs = {}


def port_prefix(name, meta):
    """``simulate(method="dopri5")`` of the port over the golden prefix,
    run once per configuration for the tests that read it."""
    if name not in _prefix_runs:
        _, tm = models(name)
        n = tm.n_pos_states
        u = tip_impulse(n, meta["impulse_amplitude"], meta["impulse_t_end"])
        _prefix_runs[name] = tcrt.simulate(
            tm, np.zeros(2 * n), PREFIX_FRAMES * meta["dt"], meta["dt"],
            method="dopri5", u=u, rtol=1e-10, atol=1e-12, device="cpu")
    return _prefix_runs[name]


# -- the right-hand side -----------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rhs_matches_jax(name):
    jm, tm = models(name)
    n = jm.n_pos_states
    rng = np.random.default_rng(3)
    x = rng.normal(scale=1e-2, size=(4, 2 * n))
    u = rng.normal(size=n)
    ref = np.asarray(jm.build_rhs()(0.0, x, u))
    got = tm.build_rhs()(0.0, torch.tensor(x), torch.tensor(u)).numpy()
    assert scaled(got, ref) <= RHS_TOL
    jm.create_system_func()
    jm.create_input_func()
    tm.create_system_func(device="cpu")
    tm.create_input_func(device="cpu")
    for uu in (u, lambda t: u * np.cos(t)):
        ref = np.asarray(jm.get_dynamic_system()(0.3, x[1], uu))
        got = tm.get_dynamic_system()(0.3, x[1], uu).numpy()
        assert scaled(got, ref) <= RHS_TOL
    np.testing.assert_allclose(tm.M_inv, jm.M_inv, rtol=0, atol=0)


@pytest.mark.parametrize("side", ["at", "past"])
def test_rhs_at_and_past_the_small_beam_thresholds(side):
    """A beam of ``POLY_MAX_ELEMENTS`` elements takes the cubic internal
    force and row sums (as the six configurations above do); one element
    more, past ``ROWSUM_MAX`` DOFs too, the element planes and matmuls. The
    RHS matches the JAX package's on either side (drag and gravity on a von
    Karman beam)."""
    from continuum_robot_tpu_torch.models import dynamic_beam_model as tdbm
    from continuum_robot_tpu_torch.models import dynamics as td

    n_el = tdbm.POLY_MAX_ELEMENTS + (side == "past")
    csv = helpers.write_beam_csv(["nonlinear"] * n_el)
    fp = CONFIGS["nonlinear_fluid_gravity"][1]
    jm = jcrt.DynamicEulerBernoulliBeam(csv, jcrt.ForceParams(**fp))
    tm = tcrt.DynamicEulerBernoulliBeam(csv, tcrt.ForceParams(**fp))
    os.unlink(csv)
    n = jm.n_pos_states
    assert (n > td.ROWSUM_MAX) == (side == "past")
    rng = np.random.default_rng(9)
    x = rng.normal(scale=1e-2, size=(3, 2 * n))
    u = rng.normal(size=n)
    ref = np.asarray(jm.build_rhs()(0.0, x, u))
    got = tm.build_rhs()(0.0, torch.tensor(x), torch.tensor(u)).numpy()
    assert scaled(got, ref) <= RHS_TOL


def test_sum_forces_matches_jax():
    from continuum_robot_tpu.models import dynamics as jd
    from continuum_robot_tpu_torch.models import dynamics as td

    jm, tm = models("nonlinear_fluid_gravity")
    n = jm.n_pos_states
    x = np.random.default_rng(4).normal(scale=1e-2, size=(3, 2 * n))
    ref = jd.sum_forces([f.compute_forces for f in jm.force_registry.get_registered_forces()])
    got = td.sum_forces([f.compute_forces for f in tm.force_registry.get_registered_forces()])
    assert scaled(got(torch.tensor(x), 0.0), ref(jnp.asarray(x), 0.0)) <= RHS_TOL
    assert torch.equal(td.sum_forces([])(torch.tensor(x), 0.0),
                       torch.zeros(3, n, dtype=torch.float64))


def test_input_contracts_and_force_toggle():
    _, tm = models("linear_gravity")
    n = tm.n_pos_states
    with pytest.raises(RuntimeError, match="not yet created"):
        tm.get_system_func()
    with pytest.raises(RuntimeError, match="must be created first"):
        tm.get_dynamic_system()
    tm.create_system_func(device="cpu")
    tm.create_input_func(device="cpu")
    f = tm.input_func
    with pytest.raises(ValueError, match="numpy arrays"):
        f([0.0] * (2 * n), np.zeros(n))
    with pytest.raises(ValueError, match="1D"):
        f(np.zeros((2, 2 * n)), np.zeros(n))
    with pytest.raises(ValueError, match="must match position DOFs"):
        f(np.zeros(2 * n), np.zeros(n + 1))
    # A force disabled at run time drops out of the next evaluation.
    x = np.zeros(2 * n)
    with_g = tm.get_system_func()(x)
    (gravity,) = tm.force_registry.get_registered_forces()
    gravity.set_enabled(False)
    without = tm.get_system_func()(x)
    gravity.set_enabled(True)
    assert with_g.abs().max() > 0 and without.abs().max() == 0
    assert torch.equal(tm.get_system_func()(x), with_g)


# -- RK4 and Dopri5 steps ------------------------------------------------------


def test_rk4_and_integrate_fixed_match_jax():
    jm, tm = models("nonlinear_fluid_gravity")
    n = jm.n_pos_states
    rng = np.random.default_rng(5)
    x0 = rng.normal(scale=1e-4, size=(3, 2 * n))
    jrhs, trhs = jm.build_rhs(), tm.build_rhs()
    u_const = np.zeros(n)
    u_const[-2] = 0.1
    step_ref = ji.rk4_step(jrhs, 0.0, jnp.asarray(x0), 1e-5, jnp.asarray(u_const))
    step = ti.rk4_step(trhs, 0.0, torch.tensor(x0), 1e-5, torch.tensor(u_const))
    assert scaled(step, step_ref) <= RHS_TOL
    for ju, tu in ((u_const, u_const), (helpers.tip_impulse(n, 0.1, 3e-5),
                                        tip_impulse(n, 0.1, 3e-5))):
        ts_r, xs_r = ji.integrate_fixed(jrhs, jnp.asarray(x0), 0.0, 2e-5, 4, u=ju,
                                        substeps=2)
        ts, xs = ti.integrate_fixed(trhs, torch.tensor(x0), 0.0, 2e-5, 4, u=tu,
                                    substeps=2)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ts_r))
        assert xs.shape == xs_r.shape and scaled(xs, xs_r) <= RHS_TOL


def test_remat_gradient_matches_plain():
    def osc(t, x, u=None):
        return torch.stack([x[1], -4.0 * x[0]])

    def value_grad(remat):
        x0 = torch.tensor([1.0, 0.0], dtype=torch.float64, requires_grad=True)
        _, xs = ti.integrate_fixed(osc, x0, 0.0, 0.1, 5, substeps=10, remat=remat)
        loss = (xs[-1] ** 2).sum()
        loss.backward()
        return float(loss.detach()), x0.grad

    v_plain, g_plain = value_grad(False)
    v_remat, g_remat = value_grad(True)
    assert v_plain == pytest.approx(v_remat, rel=1e-12)
    torch.testing.assert_close(g_remat, g_plain, rtol=1e-10, atol=0)


def test_dopri5_step_matches_jax():
    jm, tm = models("mixed")
    n = jm.n_pos_states
    rng = np.random.default_rng(6)
    x0 = rng.normal(scale=1e-3, size=(2, 2 * n))
    ju, tu = helpers.tip_impulse(n, 0.1, 2e-5), tip_impulse(n, 0.1, 2e-5)
    x5_r, err_r = ji.dopri5_step(jm.build_rhs(), jnp.asarray(1e-5), jnp.asarray(x0),
                                 jnp.asarray(3e-5), ju)
    x5, err = ti.dopri5_step(tm.build_rhs(), torch.tensor(1e-5, dtype=torch.float64),
                             torch.tensor(x0), torch.tensor(3e-5, dtype=torch.float64), tu)
    assert scaled(x5, x5_r) <= 1e-13
    assert scaled(err, err_r) <= 1e-11  # a difference of nearly equal sums


# -- Dopri5 against the JAX package and the golden -----------------------------


@pytest.mark.parametrize("name", ["linear", "nonlinear_fluid_gravity"])
def test_integrate_adaptive_matches_jax(name, meta):
    jm, _ = models(name)
    n = jm.n_pos_states
    t_eval = np.arange(PREFIX_FRAMES + 1) * meta["dt"]
    xs_r, st_r = ji.integrate_adaptive(
        jm.build_rhs(), jnp.zeros(2 * n), t_eval,
        u=helpers.tip_impulse(n, meta["impulse_amplitude"], meta["impulse_t_end"]),
        rtol=1e-10, atol=1e-12, dt0=meta["dt"] / 10.0)
    res = port_prefix(name, meta)
    assert int(res.stats.n_accepted) == int(st_r.n_accepted)
    assert int(res.stats.n_rejected) == int(st_r.n_rejected)
    assert int(res.stats.n_incomplete) == 0
    assert scaled(res.ys, xs_r) <= 1e-10


@pytest.mark.parametrize("name", list(CONFIGS))
def test_golden_prefix(name, meta):
    """The JAX package's golden trajectory test on its first frames."""
    y_ref = np.load(os.path.join(GOLDEN_DIR, "trajectories.npz"))[f"{name}_y"]
    res = port_prefix(name, meta)
    y_ref = y_ref[:, : PREFIX_FRAMES + 1]
    assert res.ys.shape == (PREFIX_FRAMES + 1, y_ref.shape[0])
    err = np.abs(res.ys.numpy().T - y_ref).max() / np.abs(y_ref).max()
    assert err < 2e-6, f"{name}: normalized trajectory error {err:.3e}"


def test_piecewise_constant_force_in_the_adaptive_drive():
    """A ``PiecewiseConstant`` tip impulse takes the adaptive driver's
    tensor times (per env too) and equals the ``torch.where`` impulse."""
    _, tm = models("linear")
    n = tm.n_pos_states
    tip = np.zeros(n)
    tip[-2] = 0.1
    pwc = tcrt.PiecewiseConstant((2e-4,), np.stack([tip, np.zeros(n)]))
    kw = dict(method="dopri5", rtol=1e-8, atol=1e-11, device="cpu")
    ref = tcrt.simulate(tm, np.zeros(2 * n), 4e-4, 1e-4, u=tip_impulse(n, 0.1, 2e-4), **kw)
    res = tcrt.simulate(tm, np.zeros(2 * n), 4e-4, 1e-4, u=pwc, **kw)
    assert torch.equal(res.ys, ref.ys)
    t = torch.tensor([0.0, 1e-4, 2e-4, 3e-4], dtype=torch.float64)
    assert torch.equal(pwc(t), torch.tensor(np.stack([tip, tip, np.zeros(n), np.zeros(n)])))


# -- the adaptive driver's contracts ---------------------------------------------


def drive(n_frames, frame_len, dtmax, **kw):
    def trial(t, dt, x):
        return x + dt, (dt / dtmax) ** 3

    t_eval = np.arange(n_frames + 1) * frame_len
    out = ti.adaptive_drive(trial, torch.tensor(0.0, dtype=torch.float64), t_eval,
                            torch.tensor(dtmax / 4.0, dtype=torch.float64), -1.0 / 3.0,
                            **kw)
    return out, t_eval


def test_frames_exact_and_complete():
    (_, frames, stats), t_eval = drive(10, 1.25e-3, 1e-3)
    np.testing.assert_allclose(frames.numpy(), t_eval[1:], rtol=1e-12)
    assert int(stats.n_incomplete) == 0
    assert int(stats.n_steps) == int(stats.n_accepted) + int(stats.n_rejected)


def test_clamped_frame_end_keeps_learned_dt():
    F = 20
    (_, frames, stats), t_eval = drive(F, 1.000001e-3, 1e-3)
    np.testing.assert_allclose(frames.numpy(), t_eval[1:], rtol=1e-9)
    assert int(stats.n_incomplete) == 0
    assert int(stats.n_steps) <= 3 * F + 8, int(stats.n_steps)


def test_truncated_interval_is_counted():
    F = 4
    (_, frames, stats), t_eval = drive(F, 10e-3, 1e-3, max_steps_per_interval=3)
    assert int(stats.n_incomplete) == F
    assert float(frames[0]) < t_eval[1]


def test_stall_exits_fast_and_is_counted():
    def trial(t, dt, x):
        return x + dt, torch.tensor(1.0, dtype=torch.float64)

    _, _, stats = ti.adaptive_drive(
        trial, torch.tensor(0.0, dtype=torch.float64), [1.0, 2.0],
        torch.tensor(1e-18, dtype=torch.float64), -1.0 / 3.0,
        max_steps_per_interval=100_000)
    assert int(stats.n_incomplete) == 1
    assert int(stats.n_steps) <= 3, int(stats.n_steps)


# -- per-environment control and the host reads -----------------------------------


def per_env_case():
    _, tm = models("linear")
    n = tm.n_pos_states
    amps = torch.tensor([0.05, 5.0, 50.0], dtype=torch.float64)
    base = torch.zeros(n, dtype=torch.float64)

    def u_lane(a):
        def u(t):
            tip = base.clone()
            tip[-2] = 1.0
            on = (t < 1e-3)[..., None]
            return torch.where(on, a[..., None] * tip, base)
        return u

    t_eval = np.arange(4) * 5e-4
    kw = dict(rtol=1e-7, atol=1e-10, dt0=5e-5)
    return tm.build_rhs(), n, amps, u_lane, t_eval, kw


def test_per_env_lanes_equal_solo_runs():
    rhs, n, amps, u_lane, t_eval, kw = per_env_case()
    x0 = torch.zeros(3, 2 * n, dtype=torch.float64)
    xs, st = ti.integrate_adaptive(rhs, x0, t_eval, u=u_lane(amps), per_env=True, **kw)
    assert xs.shape == (4, 3, 2 * n) and st.n_accepted.shape == (3,)
    acc = st.n_accepted.tolist()
    assert len(set(acc)) > 1, acc
    for i in range(3):
        xi, si = ti.integrate_adaptive(rhs, x0[i], t_eval, u=u_lane(amps[i]), **kw)
        assert scaled(xs[:, i], xi) <= 1e-10
        assert int(si.n_accepted) == acc[i]
        assert int(si.n_rejected) == int(st.n_rejected[i])


@pytest.mark.parametrize("per_env", [False, True])
def test_host_check_interval_moves_no_result(per_env, monkeypatch):
    rhs, n, amps, u_lane, t_eval, kw = per_env_case()
    x0 = torch.zeros(3, 2 * n, dtype=torch.float64)
    runs = {}
    for every in (1, 8):
        monkeypatch.setattr(ti, "HOST_CHECK_INTERVAL", every)
        runs[every] = ti.integrate_adaptive(rhs, x0, t_eval, u=u_lane(amps),
                                            per_env=per_env, **kw)
    (x1, s1), (x8, s8) = runs[1], runs[8]
    assert torch.equal(x1, x8)
    for a, b in zip(s1[:5], s8[:5]):
        assert torch.equal(a, b)
    assert s8.host_reads < s1.host_reads


# -- batched rollouts and the entry point -------------------------------------------


def test_batched_rk4_equals_simulate_per_env():
    _, tm = models("nonlinear_fluid_gravity")
    n = tm.n_pos_states
    rng = np.random.default_rng(8)
    x0 = np.zeros((5, 2 * n))
    x0[:, n - 2] = rng.normal(scale=1e-3, size=5)
    kw = dict(method="rk4", substeps=5, u=tip_impulse(n, 0.1, 2e-5))
    res = trollout.batched_rollout(tm, x0, 4e-5, 1e-5, device="cpu", **kw)
    assert res.ys.shape == (5, 5, 2 * n)
    for i in range(5):
        solo = tcrt.simulate(tm, x0[i], 4e-5, 1e-5, device="cpu", **kw)
        assert torch.equal(res.ys[:, i], solo.ys)
        assert torch.equal(res.ts, solo.ts)


def test_batched_rk4_bit_equal_on_the_widest_batch_invariant_beam():
    """Up to ``POLY_MAX_ELEMENTS`` elements (and ``ROWSUM_MAX`` DOFs) a batch
    row of RK4 is bit for bit its solo run."""
    from continuum_robot_tpu_torch.models import dynamic_beam_model as tdbm
    from continuum_robot_tpu_torch.models import dynamics as td

    csv = helpers.write_beam_csv(["nonlinear"] * tdbm.POLY_MAX_ELEMENTS)
    tm = tcrt.DynamicEulerBernoulliBeam(csv, tcrt.ForceParams(
        **CONFIGS["nonlinear_fluid_gravity"][1]))
    os.unlink(csv)
    n = tm.n_pos_states
    assert n <= td.ROWSUM_MAX
    x0 = np.zeros((4, 2 * n))
    x0[:, n - 2] = np.random.default_rng(10).normal(scale=1e-3, size=4)
    kw = dict(method="rk4", substeps=2, device="cpu")
    res = trollout.batched_rollout(tm, x0, 2e-5, 1e-5, **kw)
    for i in range(4):
        assert torch.equal(res.ys[:, i], tcrt.simulate(tm, x0[i], 2e-5, 1e-5, **kw).ys)


def test_entry_matches_jax():
    import __graft_entry__ as graft
    from continuum_robot_tpu_torch.entry import entry

    step_r, (x_r, u_r) = graft.entry()
    step, (x0, u0) = entry(device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(x_r))
    np.testing.assert_array_equal(u0.numpy(), np.asarray(u_r))
    ref = np.asarray(step_r(x_r, u_r))
    assert scaled(step(x0, u0), ref) <= RHS_TOL
    step32, (x32, u32) = entry(device="cpu")
    out = step32(x32, u32)
    assert out.dtype == torch.float32 and scaled(out.double(), ref) <= 1e-5

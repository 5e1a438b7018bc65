"""The port's error-controlled ROM (``rollout_adaptive``,
``simulate(method="modal_rom_adaptive")``) against the JAX package.

Both packages built from one CSV, fed the same seeded NumPy states and, for
the engine-level cases, one basis and one ECSW sample, float64 on the CPU:
equal accepted and rejected counts and states within 1e-10 of the state
scale, plain and hyper-reduced, batched, damped and on the consistent
element (whose engine has no ``lam``); ``chunk=`` bit for bit the one-call
run; the first 0.02 s of the ``nonlinear_fluid_gravity`` golden workload
(6 segments in water with gravity, the golden's tip impulse); drag
dissipates; and the refusal without ``Sinv_diag``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch.models as tm
import helpers
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch.models import simulate as ts

torch.set_num_threads(1)

TOL = 1e-10
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
WET_GRAVITY = dict(enable_fluid_effects=True, fluid_density=1000.0,
                   enable_gravity_effects=True)


def pair(n_el, consistent=False, include_fluid=False, **fp):
    csv = helpers.write_beam_csv(["nonlinear"] * n_el, include_fluid=include_fluid)
    out = (jm.DynamicEulerBernoulliBeam(csv, jm.ForceParams(**fp),
                                        use_consistent_nonlinear=consistent),
           tm.DynamicEulerBernoulliBeam(csv, tm.ForceParams(**fp),
                                        use_consistent_nonlinear=consistent))
    os.unlink(csv)
    return out


def scaled(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def same_counts(s_t, s_j):
    for k in ("n_steps", "n_accepted", "n_rejected", "n_incomplete"):
        assert int(getattr(s_t, k)) == int(getattr(s_j, k)), k


def tip(n, amp):
    u = np.zeros(n)
    u[-2] = amp
    return u


@pytest.fixture(scope="module")
def engines():
    """The 12-element von Karman ROM of the JAX test (12 modes), in both
    packages on the JAX basis, and its ECSW sample trained in the JAX
    package and applied in both."""
    jb, tb = pair(12)
    jms = js.make_modal_rom(jb, 1e-4, rho_inf=0.8, n_modes=12)
    ms = ts.make_modal_rom(tb, 1e-4, rho_inf=0.8, basis=(jms.Phi, jms.PhiW), device="cpu")
    u_m = jms.project_force_host(tip(tb.n_pos_states, 5.0))
    z = np.zeros((1, 12))
    _, etas, _ = jms.rollout_frames(z, z, u_m, 10, substeps=10, n_newton=2)
    jred = jms.hyper_reduce(np.asarray(etas[:, 0, :]), tau=1e-3)
    sp = jred.sampled_params
    red = ms.apply_ecsw(sp["sel"], sp["xi"], train_tau=1e-3)
    return {"plain": (jms, ms), "ecsw": (jred, red)}, u_m


@pytest.mark.parametrize("which", ["plain", "ecsw"])
def test_rollout_adaptive_matches_jax(engines, which):
    (jms, ms), u_m = engines[0][which], engines[1]
    rng = np.random.default_rng(1)
    eta = rng.normal(scale=1e-3, size=(2, 12))
    t_eval = np.linspace(0.0, 2e-3, 5)
    kw = dict(rtol=1e-6, atol=1e-9, n_newton=2)
    ej, edj, sj = jms.rollout_adaptive(eta, 0 * eta, u_m, t_eval, **kw)
    et, edt, st = ms.rollout_adaptive(torch.tensor(eta), torch.zeros(2, 12,
                                                                     dtype=torch.float64),
                                      u_m, t_eval, **kw)
    assert et.shape == (5, 2, 12) and int(st.n_accepted) > 0
    same_counts(st, sj)
    assert scaled(et, ej) <= TOL and scaled(edt, edj) <= TOL
    assert torch.equal(et[0], torch.tensor(eta))
    # A batch shares one controller, and its envs differ.
    assert float((et[-1, 0] - et[-1, 1]).abs().max()) > 0


def test_continuation_hooks_are_exact(engines):
    """``return_final`` and ``etadd0``: two spans continued from the
    algorithmic carry and the controller's ``dt_next`` are the one span."""
    (_, ms), u_m = engines[0]["plain"], engines[1]
    z = torch.zeros((1, 12), dtype=torch.float64)
    kw = dict(rtol=1e-6, atol=1e-9, n_newton=2)
    t_eval = np.linspace(0.0, 2e-3, 5)
    e_all, _, s_all = ms.rollout_adaptive(z, z, u_m, t_eval, **kw)
    e1, _, s1, fin = ms.rollout_adaptive(z, z, u_m, t_eval[:3], return_final=True, **kw)
    e2, _, s2 = ms.rollout_adaptive(fin[0], fin[1], u_m, t_eval[2:], dt0=s1.dt_next,
                                    etadd0=fin[2], **kw)
    assert torch.equal(torch.cat([e1, e2[1:]]), e_all)
    assert int(s1.n_accepted) + int(s2.n_accepted) == int(s_all.n_accepted)


def test_simulate_and_chunk_match_jax():
    """``simulate(method="modal_rom_adaptive")`` in both packages (each its
    own eigensolve), damped; ``chunk=`` bit for bit the one-call run."""
    jb, tb = pair(6)
    n = tb.n_pos_states
    kw = dict(method="modal_rom_adaptive", u=tip(n, 5.0), rtol=1e-5, atol=1e-9,
              n_newton=2, rayleigh=(2.0, 1e-6))
    ref = js.simulate(jb, np.zeros(2 * n), 0.004, 1e-3, **kw)
    got = ts.simulate(tb, np.zeros(2 * n), 0.004, 1e-3, device="cpu", **kw)
    same_counts(got.stats, ref.stats)
    assert scaled(got.ys, ref.ys) <= TOL
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(ref.ts))
    for chunk in (1, 3):
        res = ts.simulate(tb, np.zeros(2 * n), 0.004, 1e-3, device="cpu", chunk=chunk, **kw)
        assert torch.equal(res.ys, got.ys)
        same_counts(res.stats, got.stats)


def test_consistent_element_matches_jax():
    """The consistent element's engine has no ``lam``: the adaptive ROM
    recovers the reduced operator's diagonal from ``Sinv_diag``."""
    jb, tb = pair(4, consistent=True)
    jms = js.make_modal_rom(jb, 1e-4, rho_inf=0.8, rayleigh=(1.0, 1e-6))
    ms = ts.make_modal_rom(tb, 1e-4, rho_inf=0.8, rayleigh=(1.0, 1e-6),
                           basis=(jms.Phi, jms.PhiW), device="cpu")
    assert ms.lam is None and ms.Sinv_diag is not None
    m = ms.n_modes
    u_m = jms.project_force_host(tip(tb.n_pos_states, 2.0))
    t_eval = np.linspace(0.0, 2e-4, 3)
    ej, _, sj = jms.rollout_adaptive(np.zeros(m), np.zeros(m), u_m, t_eval,
                                     rtol=1e-5, atol=1e-9)
    et, _, st = ms.rollout_adaptive(np.zeros(m), np.zeros(m), u_m, t_eval,
                                    rtol=1e-5, atol=1e-9)
    same_counts(st, sj)
    assert int(st.n_accepted) > 3
    assert scaled(et, ej) <= TOL


def test_golden_prefix_matches_jax():
    """The ``nonlinear_fluid_gravity`` golden's workload (reduced drag and
    gravity on the split path, the golden's tip impulse) over its first
    0.02 s: the port's run equals the JAX package's."""
    with open(os.path.join(GOLDEN_DIR, "trajectories_meta.json")) as f:
        meta = json.load(f)
    jb, tb = pair(6, include_fluid=True, **WET_GRAVITY)
    n = tb.n_pos_states
    amp, t_end = meta["impulse_amplitude"], meta["impulse_t_end"]
    base = torch.zeros(n, dtype=torch.float64)
    tip_t = torch.tensor(tip(n, amp))

    def u(t):  # tensor times of the controller's shape
        return torch.where((t < t_end)[..., None], tip_t, base)

    kw = dict(method="modal_rom_adaptive", rtol=1e-4, atol=1e-8, n_newton=2)
    ref = js.simulate(jb, np.zeros(2 * n), 0.02, meta["dt"],
                      u=helpers.tip_impulse(n, amp, t_end), **kw)
    got = ts.simulate(tb, np.zeros(2 * n), 0.02, meta["dt"], u=u, device="cpu", **kw)
    assert got.ys.shape == (21, 2 * n)
    same_counts(got.stats, ref.stats)
    assert scaled(got.ys, ref.ys) <= TOL


def test_drag_dissipates():
    """Reduced drag rides the adaptive ROM: the beam in water moves slower
    than the same beam in air."""
    _, wet = pair(6, include_fluid=True, enable_fluid_effects=True, fluid_density=1000.0)
    _, dry = pair(6)
    n = wet.n_pos_states
    kw = dict(method="modal_rom_adaptive", u=tip(n, 0.1), rtol=1e-4, atol=1e-8,
              n_newton=2, device="cpu")
    vel = [float(ts.simulate(m, np.zeros(2 * n), 0.02, 1e-2, **kw).ys[-1, n:].abs().max())
           for m in (wet, dry)]
    assert np.isfinite(vel[0]) and vel[0] < vel[1]


def test_requires_diagonal_reduced_jacobian(engines):
    (jms, ms), _ = engines[0]["plain"], engines[1]
    eta = np.zeros((2, 12))
    t_eval = np.linspace(0.0, 1e-3, 3)
    with pytest.raises(ValueError) as ej:
        dataclasses.replace(jms, Sinv_diag=None).rollout_adaptive(eta, eta, None, t_eval)
    with pytest.raises(ValueError, match="diagonal reduced") as et:
        dataclasses.replace(ms, Sinv_diag=None).rollout_adaptive(eta, eta, None, t_eval)
    assert str(et.value) == str(ej.value)

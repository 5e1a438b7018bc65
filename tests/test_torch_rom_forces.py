"""Reduced external forces and the general force path of the port's modal
ROM against the JAX package.

Both packages built from one CSV (6-segment Nitinol beams in water, with
gravity), fed the same seeded NumPy states, float64 on the CPU:

* each force's reduced closure (``ext_modal``) equals ``PhiW^T
  compute_forces(x, t)`` (<= 1e-12 relative), and the JAX package's closure
  on the same basis;
* registry forces on the split path against an explicit ``forces_func``
  on the general path (as ``tests/test_modal_forces.py::TestPathEquivalence``),
  each against the JAX package (<= 1e-10 of the state scale);
* the consistent element's ROM with registered forces (general path),
  ``batched_rollout(method="modal_rom", forces_func=...)`` and every
  refusal message.
"""

import os

import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch as tcrt
import continuum_robot_tpu_torch.models as tm
import helpers
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch import parallel as tpar
from continuum_robot_tpu_torch.models import simulate as ts

torch.set_num_threads(1)

TOL = 1e-10
CLOSURE_TOL = 1e-12
WATER = dict(enable_fluid_effects=True, fluid_density=1000.0)
GRAVITY = dict(enable_gravity_effects=True)
WET_GRAVITY = dict(WATER, **GRAVITY)
TRAJ = dict(t_final=0.01, dt=1e-3, substeps=5, n_newton=2, rho_inf=0.7)


def pair(kind="nonlinear", n_el=6, consistent=False, **fp):
    types = {"linear": ["linear"] * n_el, "nonlinear": ["nonlinear"] * n_el,
             "mixed": ["linear"] * (n_el // 2) + ["nonlinear"] * (n_el - n_el // 2)}
    csv = helpers.write_beam_csv(types[kind])
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


def tip(n, amp=0.1):
    u = np.zeros(n)
    u[-2] = amp
    return u


_runs = {}


def jax_sim(key, model, **kw):
    """The JAX package's ``simulate`` of a test case, run once per module."""
    if key not in _runs:
        n = model.n_pos_states
        _runs[key] = np.asarray(js.simulate(model, np.zeros(2 * n), **kw).ys)
    return _runs[key]


# -- the reduced closures ------------------------------------------------------

CLOSURES = {
    "fluid": ("nonlinear", WATER, False),
    "gravity": ("nonlinear", GRAVITY, False),
    "fluid_gravity_batched": ("nonlinear", dict(
        WATER, fluid_density=800.0, enable_gravity_effects=True,
        gravity_vector=[1.0, -9.81, 0.0]), True),
    "gravity_quirk_linear": ("linear", GRAVITY, False),
}


@pytest.mark.parametrize("case", list(CLOSURES))
def test_closure_is_the_projected_force(case):
    """``ext_modal(eta, etad, t) == PhiW^T compute_forces([Phi eta; Phi
    etad], t)`` in the port, and equal to the JAX package's closure on the
    same basis."""
    kind, fp, batch = CLOSURES[case]
    jb, tb = pair(kind, **fp)
    ms = ts.make_modal_rom(tb, 1e-4, device="cpu")
    assert ms.ext_modal is not None and ms.external_force is None
    n = tb.n_pos_states
    rng = np.random.default_rng(3)
    x = rng.normal(scale=1e-2, size=(4, 2 * n) if batch else (2 * n,))
    eta, etad = ms.to_modal(x[..., :n], x[..., n:])
    got = ms.ext_modal(eta, etad, 0.0)
    q, v = ms.from_modal(eta, etad)
    agg = tb.force_registry.create_aggregated_function()
    want = ms.project_force(agg(torch.cat([q, v], dim=-1), 0.0))
    assert scaled(got, want.numpy()) <= CLOSURE_TOL
    if batch:  # the JAX package's closure on the same basis
        jms = js.make_modal_rom(jb, 1e-4, basis=(ms.Phi, ms.PhiW))
        assert scaled(got, jms.ext_modal(eta.numpy(), etad.numpy(), 0.0)) <= CLOSURE_TOL
    # Every force alone has a closure; drag has none on a basis whose rows
    # do not match its state mapping (as in the JAX package).
    for force in tb.force_registry.get_registered_forces():
        assert force.make_reduced_modal(ms.Phi, ms.PhiW) is not None
        if isinstance(force, tm.FluidDragForce):
            assert force.make_reduced_modal(ms.Phi[:-1], ms.PhiW[:-1]) is None


def test_disabled_force_contributes_zero():
    _, tb = pair("nonlinear", n_el=4, **GRAVITY)
    ms = ts.make_modal_rom(tb, 1e-4, device="cpu")
    grav = tb.force_registry.get_registered_forces()[0]
    m = ms.n_modes
    ones = torch.ones(m, dtype=torch.float64)
    grav.set_enabled(False)
    assert torch.equal(ms.ext_modal(ones, ones, 0.0), torch.zeros(m, dtype=torch.float64))
    grav.set_enabled(True)
    assert float(ms.ext_modal(1e-3 * ones, 0 * ones, 0.0).abs().max()) > 0
    # The gravity vector is read at each call.
    before = ms.ext_modal(1e-3 * ones, 0 * ones, 0.0)
    grav.set_gravity_vector([0.0, -2 * 9.81, 0.0])
    assert not torch.equal(ms.ext_modal(1e-3 * ones, 0 * ones, 0.0), before)


# -- trajectories --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["nonlinear", "mixed"])
def test_split_and_general_paths_match_jax(kind):
    """Registry forces on the split path and the same forces as an explicit
    ``forces_func`` on the general path: the port's two runs agree to
    roundoff (as the JAX package's do) and each equals its JAX run."""
    jb, tb = pair(kind, **WET_GRAVITY)
    n = tb.n_pos_states
    kw = dict(TRAJ, method="modal_rom", u=tip(n))
    split = ts.simulate(tb, np.zeros(2 * n), device="cpu", **kw).ys
    general = ts.simulate(tb, np.zeros(2 * n), device="cpu",
                          forces_func=tb.force_registry.create_aggregated_function(),
                          **kw).ys
    assert scaled(split, general.numpy()) < 1e-9
    assert scaled(split, jax_sim(("split", kind), jb, **kw)) <= TOL
    ref = jax_sim(("general", kind), jb,
                  forces_func=jb.force_registry.create_aggregated_function(), **kw)
    assert scaled(general, ref) <= TOL


def test_linear_beam_in_water_runs_on_the_rom():
    """A linear beam in water runs on ``modal_rom`` (the modal engine
    refuses it) and matches the full-order generalized-alpha path."""
    _, tb = pair("linear", **WATER)
    n = tb.n_pos_states
    kw = dict(TRAJ, u=tip(n), device="cpu")
    rom = ts.simulate(tb, np.zeros(2 * n), method="modal_rom", **kw).ys
    dense = ts.simulate(tb, np.zeros(2 * n), method="generalized_alpha", **kw).ys
    np.testing.assert_allclose(rom.numpy(), dense.numpy(), rtol=1e-7, atol=1e-13)


def test_consistent_rom_with_forces_matches_jax():
    """The consistent element has no split path: registered forces take the
    registry aggregate on the general path, in both packages."""
    jb, tb = pair("nonlinear", n_el=4, consistent=True, **WET_GRAVITY)
    ms = ts.make_modal_rom(tb, 1e-4, device="cpu")
    assert ms.lam is None and ms.ext_modal is None and ms.external_force is not None
    n = tb.n_pos_states
    kw = dict(TRAJ, method="modal_rom", u=tip(n))
    got = ts.simulate(tb, np.zeros(2 * n), device="cpu", **kw).ys
    assert scaled(got, jax_sim(("consistent",), jb, **kw)) <= TOL


def test_batched_rollout_with_forces_func():
    _, tb = pair("nonlinear", n_el=4, **WATER)
    n = tb.n_pos_states
    rng = np.random.default_rng(4)
    x0 = np.zeros((3, 2 * n))
    x0[:, :n] = rng.normal(scale=1e-4, size=(3, n))
    agg = tb.force_registry.create_aggregated_function()
    kw = dict(method="modal_rom", forces_func=agg, substeps=5, n_newton=2)
    res = tpar.batched_rollout(tb, torch.tensor(x0), 0.005, 1e-3, **kw)
    sim = ts.simulate(tb, x0, 0.005, 1e-3, device="cpu", **kw)
    assert res.ys.shape == (6, 3, 2 * n)
    assert torch.equal(res.ys, sim.ys)


# -- refusals ------------------------------------------------------------------


def _messages(fn_j, fn_t, exc=ValueError):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_refusals_match_jax():
    jb, tb = pair("nonlinear", n_el=4, **WATER)
    n = tb.n_pos_states
    x0 = np.zeros(2 * n)
    # The fused ROM kernel evaluates no external force.
    msg = _messages(
        lambda: js.simulate(jb, x0, 0.01, 1e-3, method="modal_rom", engine="pallas"),
        lambda: ts.simulate(tb, x0, 0.01, 1e-3, method="modal_rom", engine="pallas",
                            device="cpu"))
    assert "reduced external forces" in msg
    custom_j = lambda x, t: -0.1 * x[..., x.shape[-1] // 2:]  # noqa: E731
    jdry, tdry = pair("nonlinear", n_el=4)
    msg = _messages(
        lambda: js.simulate(jdry, x0, 0.01, 1e-3, method="modal_rom", engine="pallas",
                            forces_func=custom_j),
        lambda: ts.simulate(tdry, x0, 0.01, 1e-3, method="modal_rom", engine="pallas",
                            forces_func=custom_j, device="cpu"))
    assert "no external forces" in msg
    # A general-path engine cannot be hyper-reduced.
    jms = js.make_modal_rom(jdry, 1e-4, n_modes=4, forces_func=custom_j)
    tms = ts.make_modal_rom(tdry, 1e-4, n_modes=4, forces_func=custom_j, device="cpu")
    assert tms.external_force is not None and tms.ext_modal is None
    _messages(lambda: jms.hyper_reduce(np.zeros((2, 4))),
              lambda: tms.hyper_reduce(np.zeros((2, 4))))
    # The modal engine refuses registered forces with a pointer to the ROM.
    jlin, tlin = pair("linear", n_el=4, **WATER)
    _messages(lambda: js.simulate(jlin, x0, 0.01, 1e-3, method="modal"),
              lambda: ts.simulate(tlin, x0, 0.01, 1e-3, method="modal", device="cpu"))
    assert tcrt.make_modal_rom is ts.make_modal_rom

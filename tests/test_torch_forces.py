"""Registered forces and batched rollouts of the PyTorch port against the
JAX package.

``FluidDragForce`` and ``GravityForce`` evaluate on batched states for a
fixed, a pinned-pinned and a free base (gravity's reduced-index quirk
shifts with the constraints), alone and through the registry aggregate, to
1e-14 of the force scale; ``simulate(method="generalized_alpha"|"newmark")``
on the water + gravity beam and ``parallel.batched_rollout`` /
``sweep_statistics`` agree with the JAX package to 1e-10 (float64, CPU,
both packages fed one CSV and the same NumPy states).
"""

import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
from continuum_robot_tpu.models import simulate as jsim
from continuum_robot_tpu.parallel import rollout as jpar
from continuum_robot_tpu_torch import parallel as tpar

FORCE_TOL = 1e-14
ROLLOUT_TOL = 1e-10
BASES = {
    "fixed": ["FIXED"] + ["NONE"] * 5,
    "pinned_pinned": ["PINNED"] + ["NONE"] * 4 + ["PINNED"],
    "free": ["NONE"] * 6,
}
FORCES = dict(enable_fluid_effects=True, fluid_density=1000.0,
              enable_gravity_effects=True, gravity_vector=[3.0, -9.81, 0.0])


def _beams(bcs, kind="linear", **force_kw):
    from tests import helpers  # inside: a site-packages `tests` can shadow the repo's

    csv = helpers.write_beam_csv([kind] * len(bcs), bcs)
    fp = {**FORCES, **force_kw}
    return (jcrt.DynamicEulerBernoulliBeam(csv, jcrt.ForceParams(**fp)),
            tcrt.DynamicEulerBernoulliBeam(csv, tcrt.ForceParams(**fp)))


def _states(n, shape, seed=0):
    """Batched ``[q; v]`` with rotations up to ~0.3 rad and velocities of
    either sign, so both forces are far from linear."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(scale=0.1, size=(*shape, n)),
                           rng.normal(scale=0.5, size=(*shape, n))], axis=-1)


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("which", ["fluid", "gravity", "aggregate"])
def test_forces_match_jax(base, which):
    jb, tb = _beams(BASES[base])
    n = tb.n_pos_states
    x = _states(n, (4, 3))
    t = 0.01
    if which == "aggregate":
        ref = jb.force_registry.create_aggregated_function()(x, t)
        out = tb.force_registry.create_aggregated_function()(torch.tensor(x), t)
    else:
        k = 0 if which == "fluid" else 1
        jf, tf = (b.force_registry.get_registered_forces()[k] for b in (jb, tb))
        assert type(tf).__name__ == type(jf).__name__
        ref = jf.compute_forces(x, t)
        out = tf.compute_forces(torch.tensor(x), t)
    assert out.shape == (4, 3, n) and out.dtype == torch.float64
    assert np.abs(np.asarray(ref)).max() > 0
    assert _rel(out, ref) <= FORCE_TOL


def test_force_contracts():
    """Disabled drag is the zero force; gravity follows set_gravity_vector
    and evaluates single states; float32 stays float32."""
    jb, tb = _beams(BASES["fixed"])
    n = tb.n_pos_states
    x = _states(n, ())
    fluid, grav = tb.force_registry.get_registered_forces()
    jfluid, jgrav = jb.force_registry.get_registered_forces()
    for f in (fluid, jfluid):
        f.enabled = False
    agg = tb.force_registry.create_aggregated_function()(torch.tensor(x))
    ref = jb.force_registry.create_aggregated_function()(x)
    assert _rel(agg, ref) <= FORCE_TOL
    assert not fluid.compute_forces(torch.tensor(x), 0.0).any()
    for g in (grav, jgrav):
        g.set_gravity_vector([1.0, -2.0, 0.0])
    assert _rel(grav.compute_forces(torch.tensor(x), 0.0),
                jgrav.compute_forces(x, 0.0)) <= FORCE_TOL
    out32 = grav.compute_forces(torch.tensor(x, dtype=torch.float32), 0.0)
    assert out32.dtype == torch.float32 and out32.shape == (n,)


@pytest.mark.parametrize("method", ["generalized_alpha", "newmark"])
def test_simulate_with_drag_and_gravity_matches_jax(method):
    jb, tb = _beams(BASES["fixed"])
    n = tb.n_pos_states
    rng = np.random.default_rng(1)
    x0 = np.zeros((3, 2 * n))
    x0[:, n - 2] = rng.normal(scale=1e-3, size=3)
    x0[:, n:] = rng.normal(scale=0.05, size=(3, n))
    kw = dict(method=method, substeps=10, rho_inf=0.8)
    ref = np.asarray(jsim.simulate(jb, x0, 0.004, 1e-3, **kw).ys)
    out = tcrt.simulate(tb, x0, 0.004, 1e-3, device="cpu", **kw).ys
    assert out.shape == ref.shape == (5, 3, 2 * n)
    assert _rel(out, ref) <= ROLLOUT_TOL


@pytest.mark.parametrize("method,kind,forces", [
    ("generalized_alpha", "linear", True),
    ("newmark", "linear", True),
    ("modal", "linear", False),
    ("modal_power", "linear", False),
    ("modal_rom", "nonlinear", False),
])
def test_batched_rollout_and_sweep_statistics_match_jax(method, kind, forces):
    fkw = {} if forces else dict(enable_fluid_effects=False, enable_gravity_effects=False)
    jb, tb = _beams(BASES["fixed"], kind, **fkw)
    n = tb.n_pos_states
    x0 = np.zeros((4, 2 * n))
    x0[:, n - 2] = np.random.default_rng(0).normal(scale=1e-3, size=4)
    u = np.zeros(n)
    u[-2] = 0.05
    kw = dict(method=method, substeps=5, u=u)
    ref = jpar.batched_rollout(jb, x0, 0.003, 1e-3, **kw)
    out = tpar.batched_rollout(tb, x0, 0.003, 1e-3, device="cpu", **kw)
    assert out.ys.shape == ref.ys.shape == (4, 4, 2 * n)
    np.testing.assert_allclose(out.ts.numpy(), np.asarray(ref.ts), rtol=1e-15)
    assert _rel(out.ys, ref.ys) <= ROLLOUT_TOL
    s_ref, s_out = jpar.sweep_statistics(ref.ys), tpar.sweep_statistics(out.ys)
    assert s_out.keys() == s_ref.keys()
    for key in s_ref:
        np.testing.assert_allclose(float(s_out[key]), float(s_ref[key]),
                                   rtol=ROLLOUT_TOL, err_msg=key)


def test_batched_rollout_equals_simulate_and_contracts():
    _, tb = _beams(BASES["fixed"])
    n = tb.n_pos_states
    x0 = np.zeros((4, 2 * n))
    x0[:, n - 2] = [1e-3, -1e-3, 2e-3, 0.0]
    kw = dict(method="generalized_alpha", substeps=4)
    res = tpar.batched_rollout(tb, torch.tensor(x0), 0.002, 1e-3, **kw)
    sim = tcrt.simulate(tb, x0, 0.002, 1e-3, device="cpu", **kw)
    assert torch.equal(res.ys, sim.ys)
    with pytest.raises(NotImplementedError, match="sdirk3"):
        tpar.batched_rollout(tb, x0, 0.002, 1e-3, method="sdirk3", device="cpu")
    # A one-rank gloo dp mesh: the envs' block is the whole batch, ys a
    # DTensor equal to simulate()'s.
    import torch.distributed as dist

    tpar.init_process_group("cpu")
    try:
        mesh = tpar.make_mesh({"dp": 1}, device="cpu")
        res_m = tpar.batched_rollout(tb, x0, 0.002, 1e-3, mesh=mesh, **kw)
        assert torch.equal(res_m.ys.full_tensor(), sim.ys)
        stats = tpar.sweep_statistics(res_m.ys)
        assert float(stats["tip_abs_max"]) == float(tpar.sweep_statistics(sim.ys)["tip_abs_max"])
    finally:
        tpar.destroy_process_group()
    assert not dist.is_initialized()

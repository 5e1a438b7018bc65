"""The PyTorch port's modal engine and ``simulate`` against the JAX package.

The port's engine is built from the JAX engine's eigenbasis
(``convert.modal_engine_from_numpy``), so both step the same modes; the
JAX side runs its plain XLA paths (``rollout``, ``rollout_frames``,
``rollout_power(use_pallas=False)``). Bounds: 1e-12 relative for the
steppers, 1e-10 for composed maps and ``simulate`` (physical ``ys``), all
in float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.models import simulate as ts
from tests import helpers

torch.set_num_threads(1)

N_EL, B, DT = 6, 4, 1e-4
RAYLEIGH = {"undamped": None, "rayleigh": (0.5, 1e-6)}


@pytest.fixture(scope="module")
def models():
    csv = helpers.linear_csv(N_EL)
    return jm.DynamicEulerBernoulliBeam(csv), tm.DynamicEulerBernoulliBeam(csv)


def _engines(jmodel, rayleigh):
    ms = js.make_modal_genalpha(jmodel, DT, rho_inf=0.8, rayleigh=rayleigh)
    port = convert.modal_engine_from_numpy(
        ms.Phi, ms.PhiTM, ms.lam, ms.rho_inf, ms.dt, ms.cdamp, device="cpu"
    )
    n = jmodel.n_pos_states
    rng = np.random.default_rng(3)
    eta = rng.normal(scale=1e-4, size=(B, n))
    etad = rng.normal(scale=1e-4, size=(B, n))
    u = np.zeros(n)
    u[-2] = 0.1
    return ms, port, eta, etad, ms.project_force_host(u)


def _rel(port, ref):
    a, b = port.numpy(), np.asarray(ref)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def _tip_impulse_pwc(n):
    """``helpers.tip_impulse(n)`` as a PiecewiseConstant schedule."""
    fn = helpers.tip_impulse(n)
    t_end = 0.01
    return np.asarray(fn(0.0)), np.asarray(fn(t_end)), t_end


@pytest.mark.parametrize("rayleigh", sorted(RAYLEIGH))
def test_steppers_match(models, rayleigh):
    ms, port, eta, etad, um = _engines(models[0], RAYLEIGH[rayleigh])
    ref = ms.rollout(jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um), 37)
    e, ed = torch.tensor(eta), torch.tensor(etad)
    for out in (port.rollout(e, ed, um, 37), port.rollout_pallas(e, ed, um, 37)):
        for a, b in zip(out, ref):
            assert _rel(a, b) <= 1e-12
    # no force: the zero modal force path
    ref0 = ms.rollout(jnp.asarray(eta), jnp.asarray(etad), None, 19)
    for a, b in zip(port.rollout_pallas(e, ed, None, 19), ref0):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("rayleigh", sorted(RAYLEIGH))
def test_frames_match(models, rayleigh):
    ms, port, eta, etad, um = _engines(models[0], RAYLEIGH[rayleigh])
    ts_ref, e_ref, ed_ref = ms.rollout_frames(
        jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um), 5, substeps=7
    )
    e, ed = torch.tensor(eta), torch.tensor(etad)
    for out in (port.rollout_frames(e, ed, um, 5, substeps=7),
                port.rollout_frames_pallas(e, ed, um, 5, substeps=7)):
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ts_ref), rtol=1e-15)
        assert _rel(out[1], e_ref) <= 1e-12
        assert _rel(out[2], ed_ref) <= 1e-12


@pytest.mark.parametrize("K", [1, 16, 64])
@pytest.mark.parametrize("rayleigh", sorted(RAYLEIGH))
def test_rollout_power_matches(models, rayleigh, K):
    ms, port, eta, etad, um = _engines(models[0], RAYLEIGH[rayleigh])
    ref = ms.rollout_power(jnp.asarray(eta), jnp.asarray(etad),
                           jnp.asarray(um), 137, K=K, use_pallas=False)
    e, ed = torch.tensor(eta), torch.tensor(etad)
    for use_pallas in (True, False):
        out = port.rollout_power(e, ed, um, 137, K=K, use_pallas=use_pallas)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= 1e-10


@pytest.mark.parametrize("rayleigh", sorted(RAYLEIGH))
def test_rollout_power_tip_impulse(models, rayleigh):
    """The reference's tip impulse (held 10 ms, then released) as a
    PiecewiseConstant: the port's composed drive matches the JAX composed
    drive and the JAX stepper fed ``helpers.tip_impulse`` itself."""
    ms, port, eta, etad, _ = _engines(models[0], RAYLEIGH[rayleigh])
    n = models[0].n_pos_states
    tip, rest, t_end = _tip_impulse_pwc(n)
    pwc_t = ts.PiecewiseConstant((t_end,), np.stack([tip, rest]))
    pwc_j = js.PiecewiseConstant((t_end,), np.stack([tip, rest]))
    fn = helpers.tip_impulse(n)
    for t in (0.0, 0.005, t_end - 1e-9, t_end, 0.02):
        np.testing.assert_array_equal(pwc_t(t).numpy(), np.asarray(fn(t)))
    pm_t = pwc_t.map_values(port.project_force_host)
    pm_j = pwc_j.map_values(ms.project_force_host)
    e, ed = torch.tensor(eta), torch.tensor(etad)
    out = port.rollout_power(e, ed, pm_t, 137, K=16)
    ref = ms.rollout_power(jnp.asarray(eta), jnp.asarray(etad), pm_j, 137,
                           K=16, use_pallas=False)
    stepper = ms.rollout(jnp.asarray(eta), jnp.asarray(etad),
                         lambda t: ms.project_force(fn(t)), 137)
    port_stepper = port.rollout(e, ed, pm_t, 137)
    for a, b, c, d in zip(out, ref, stepper, port_stepper):
        assert _rel(a, b) <= 1e-10
        assert _rel(a, c) <= 1e-10
        assert _rel(d, c) <= 1e-12


@pytest.mark.parametrize("force", ["constant", "tip_impulse"])
def test_rollout_frames_power_matches(models, force):
    ms, port, eta, etad, um = _engines(models[0], RAYLEIGH["rayleigh"])
    if force == "tip_impulse":
        tip, rest, t_end = _tip_impulse_pwc(models[0].n_pos_states)
        # break mid-frame: frame 1 of substeps=7 crosses step 10
        vals = np.stack([ms.project_force_host(tip), ms.project_force_host(rest)])
        u_t = ts.PiecewiseConstant((t_end / 10,), vals)
        u_j = js.PiecewiseConstant((t_end / 10,), vals)
    else:
        u_t, u_j = um, jnp.asarray(um)
    t_ref, e_ref, ed_ref = ms.rollout_frames_power(
        jnp.asarray(eta), jnp.asarray(etad), u_j, 6, substeps=7
    )
    t_out, e_out, ed_out = port.rollout_frames_power(
        torch.tensor(eta), torch.tensor(etad), u_t, 6, substeps=7
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(t_ref), rtol=1e-15)
    assert _rel(e_out, e_ref) <= 1e-10 and _rel(ed_out, ed_ref) <= 1e-10


def _simulate_inputs(model, batch):
    n = model.n_pos_states
    rng = np.random.default_rng(5)
    x0 = rng.normal(scale=1e-6, size=(3, 2 * n)) if batch else np.zeros(2 * n)
    u = np.zeros(n)
    u[-2] = 0.1
    return x0, u


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("engine", ["xla", "pallas", "power"])
def test_simulate_matches(models, engine, batch):
    jmodel, tmodel = models
    x0, u = _simulate_inputs(jmodel, batch)
    kw = dict(method="modal", u=u, substeps=10, rho_inf=0.8,
              rayleigh=(0.5, 1e-6) if batch else None)
    # engine="pallas" is the same arithmetic as "xla" in the JAX package
    ref = js.simulate(jmodel, x0, 0.01, 1e-3,
                      engine="xla" if engine == "pallas" else engine, **kw)
    out = ts.simulate(tmodel, x0, 0.01, 1e-3, engine=engine, device="cpu", **kw)
    ys_ref = np.asarray(ref.ys)
    assert tuple(out.ys.shape) == ys_ref.shape
    np.testing.assert_allclose(out.ts.numpy(), np.asarray(ref.ts), rtol=1e-15)
    err = np.abs(out.ys.numpy() - ys_ref).max()
    assert err <= 1e-10 * np.abs(ys_ref).max()


@pytest.mark.parametrize("engine", ["xla", "power"])
def test_simulate_tip_impulse(models, engine):
    """simulate with the reference tip impulse: the port's schedule against
    JAX fed ``helpers.tip_impulse`` (a traced callable)."""
    jmodel, tmodel = models
    n = jmodel.n_pos_states
    tip, rest, t_end = _tip_impulse_pwc(n)
    pwc = ts.PiecewiseConstant((t_end,), np.stack([tip, rest]))
    ref = js.simulate(jmodel, np.zeros(2 * n), 0.02, 1e-3, method="modal",
                      u=helpers.tip_impulse(n), substeps=10)
    out = ts.simulate(tmodel, np.zeros(2 * n), 0.02, 1e-3, method="modal",
                      u=pwc, substeps=10, engine=engine, device="cpu")
    ys_ref = np.asarray(ref.ys)
    assert np.abs(ys_ref).max() > 0
    assert np.abs(out.ys.numpy() - ys_ref).max() <= 1e-10 * np.abs(ys_ref).max()


@pytest.mark.parametrize("kwargs, exc", [
    (dict(method="modal_rom_adaptive", chunk=0), ValueError),
    (dict(method="modal_rom_adaptive", engine="pallas"), ValueError),
    (dict(method="bogus"), ValueError),
    (dict(method="modal", engine="triton"), ValueError),
    (dict(method="newmark", engine="power"), ValueError),
    (dict(method="modal", engine="power", u="callable"), ValueError),
    (dict(method="modal", engine="pallas", u="callable"), ValueError),
    (dict(method="newmark", rayleigh=(0.1, 0.0)), ValueError),
    (dict(method="modal", chunk=2), ValueError),
])
def test_simulate_contracts(models, kwargs, exc):
    jmodel, tmodel = models
    n = jmodel.n_pos_states
    kwargs = dict(kwargs)
    if kwargs.get("u") == "callable":
        kwargs["u"] = lambda t: np.zeros(n)
    with pytest.raises(exc) as et:
        ts.simulate(tmodel, np.zeros(2 * n), 0.01, 1e-3, device="cpu", **kwargs)
    if exc is ValueError:
        with pytest.raises(ValueError) as ej:
            js.simulate(jmodel, np.zeros(2 * n), 0.01, 1e-3, **kwargs)
        assert str(et.value) == str(ej.value)


def test_engine_contracts(models, tmp_path):
    _, port, eta, etad, um = _engines(models[0], None)
    e, ed = torch.tensor(eta), torch.tensor(etad)
    with pytest.raises(ValueError, match="constant"):
        port.rollout_power(e, ed, lambda t: um, 10)
    with pytest.raises(ValueError, match="constant"):
        port.rollout_frames_power(e, ed, lambda t: um, 10)
    with pytest.raises(ValueError, match="K"):
        port.rollout_power(e, ed, um, 10, K=0)
    fluid = tm.DynamicEulerBernoulliBeam(
        helpers.linear_csv(3, path=str(tmp_path / "f.csv")),
        tm.ForceParams(enable_fluid_effects=True, fluid_density=1000.0),
    )
    with pytest.raises(ValueError, match="registry forces"):
        ts.make_modal_genalpha(fluid, DT, device="cpu")
    mixed = tm.DynamicEulerBernoulliBeam(
        helpers.mixed_csv(4, path=str(tmp_path / "m.csv"))
    )
    with pytest.raises(ValueError, match="purely linear"):
        ts.make_modal_genalpha(mixed, DT, device="cpu")


def test_make_modal_genalpha_matches(models):
    """The port's own host eigensolve gives the JAX spectrum and the same
    physical trajectories (mode signs may differ; ``Phi PhiTM`` may not)."""
    jmodel, tmodel = models
    ms = js.make_modal_genalpha(jmodel, DT, rayleigh=(0.5, 1e-6))
    port = ts.make_modal_genalpha(tmodel, DT, rayleigh=(0.5, 1e-6), device="cpu")
    np.testing.assert_allclose(port.lam, ms.lam, rtol=1e-12)
    np.testing.assert_allclose(port.cdamp, ms.cdamp, rtol=1e-12)
    np.testing.assert_allclose(port.Phi @ port.PhiTM, ms.Phi @ ms.PhiTM,
                               atol=1e-10)


def test_memo_is_keyed_and_bounded(models):
    _, port, eta, etad, um = _engines(models[0], None)
    e = torch.tensor(eta)
    P1, b1 = port._power_map_device(8, um, e)
    P2, _ = port._power_map_device(8, um.copy(), e)
    assert P1 is P2
    assert port._power_map_device(8, um, e.float())[0].dtype == torch.float32
    assert port._power_map_device(8, 2.0 * um, e)[0] is not P1
    assert port._power_map_device(4, um, e)[0] is not P1
    for k in range(1, 40):
        port._power_map_device(k, um, e)
    assert len(port._memo_cache) == ts._MEMO_SIZE
    assert port._power_map_device(8, um, e)[0] is not P1  # evicted, rebuilt
    fresh = port.with_dt(port.dt)
    assert "_memo_cache" not in fresh.__dict__

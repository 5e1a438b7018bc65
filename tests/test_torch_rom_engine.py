"""The port's modal-ROM engine, ECSW and ``simulate`` against the JAX package.

The port's engines share the JAX engines' bases
(``convert.modal_rom_engine_from_numpy``), so mode signs and ARPACK roundoff
decide nothing. Bounds: float64 rollouts and ECSW weights to 1e-10 relative (the ECSW
sample identical). The fused rollout and ``simulate(method="modal_rom")``
are held to the JAX package in ``test_torch_rom_fused.py``, which shares
the engines built here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch import convert
import helpers

torch.set_num_threads(1)

N_EL, M, B, DT, RHO = 8, 12, 5, 1e-4, 0.5
CSV = {"nonlinear": helpers.nonlinear_csv, "mixed": helpers.mixed_csv}


@pytest.fixture(scope="module")
def beams():
    out = {}
    for kind, fn in CSV.items():
        csv = fn(N_EL, include_fluid=False)
        out[kind] = (jm.DynamicEulerBernoulliBeam(csv),
                     tm.DynamicEulerBernoulliBeam(csv))
    return out


def _port(ms, tmodel, **kw):
    """The port's engine on the JAX engine's basis (CPU)."""
    return convert.modal_rom_engine_from_numpy(
        ms.Phi, ms.PhiW, ms.PhiTM, ms.Sinv, ms.lam, ms.rho_inf, ms.dt, tmodel,
        Sinv_diag=ms.Sinv_diag, cdamp=ms.cdamp, device="cpu", **kw,
    )


_ENGINES = {}
_REDUCED = {}


def _engines(beams, beam, rayleigh=None):
    """``(JAX engine, port engine)``, built once per module. A damped engine
    takes the undamped engine's basis: the same eigensolve, run once."""
    key = (beam, rayleigh)
    if key not in _ENGINES:
        jb, tb = beams[beam]
        basis = None
        if rayleigh is not None:
            base = _engines(beams, beam)[0]
            basis = (base.Phi, base.PhiW)
        ms = js.make_modal_rom(jb, DT, rho_inf=RHO, n_modes=M, rayleigh=rayleigh,
                               basis=basis)
        _ENGINES[key] = (ms, _port(ms, tb))
    return _ENGINES[key]


def _inputs(ms, tb, amp, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    eta = rng.normal(scale=amp, size=(B, M)).astype(dtype)
    etad = rng.normal(scale=amp, size=(B, M)).astype(dtype)
    u = np.zeros(tb.n_pos_states)
    u[-2] = 5.0
    return eta, etad, ms.project_force_host(u).astype(dtype)


def _rel(port, ref):
    a, b = port.numpy(), np.asarray(ref)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


@pytest.mark.parametrize("beam, n_newton, rayleigh", [
    ("nonlinear", 1, None),
    ("nonlinear", 2, None),
    ("mixed", 2, None),
    ("nonlinear", 2, (0.5, 1e-6)),
])
def test_rollout_matches(beams, beam, n_newton, rayleigh):
    ms, port = _engines(beams, beam, rayleigh)
    eta, etad, um = _inputs(ms, beams[beam][1], 1e-2)
    ref = ms.rollout(jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um), 50,
                     n_newton=n_newton)
    out = port.rollout(torch.tensor(eta), torch.tensor(etad), um, 50,
                       n_newton=n_newton)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= 1e-10
    # frames, and a callable force: the same recurrence
    ts_r, e_r, ed_r = ms.rollout_frames(jnp.asarray(eta), jnp.asarray(etad),
                                        lambda t: jnp.asarray(um), 4, substeps=5,
                                        n_newton=n_newton)
    ts_o, e_o, ed_o = port.rollout_frames(torch.tensor(eta), torch.tensor(etad),
                                          lambda t: torch.tensor(um), 4,
                                          substeps=5, n_newton=n_newton)
    np.testing.assert_allclose(ts_o.numpy(), np.asarray(ts_r), rtol=1e-15)
    assert _rel(e_o, e_r) <= 1e-10 and _rel(ed_o, ed_r) <= 1e-10


def _snapshots(ms, tb):
    u = np.zeros(tb.n_pos_states)
    u[-2] = 3.0
    z = jnp.zeros((1, M))
    _, etas, _ = ms.rollout_frames(z, z, jnp.asarray(ms.project_force_host(u)),
                                   10, substeps=5, n_newton=2)
    return np.asarray(etas[::2, 0, :])


def _reduced(beams, beam):
    """``((JAX engine, info), (port engine, info))`` of ECSW on the same
    snapshots of the undamped engine, built once per module."""
    if beam not in _REDUCED:
        ms, port = _engines(beams, beam)
        snaps = _snapshots(ms, beams[beam][1])
        _REDUCED[beam] = (ms.hyper_reduce(snaps, tau=1e-3, return_info=True),
                          port.hyper_reduce(snaps, tau=1e-3, return_info=True))
    return _REDUCED[beam]


@pytest.mark.parametrize("beam", sorted(CSV))
def test_hyper_reduce_matches(beams, beam):
    ms, port = _engines(beams, beam)
    (red_j, info_j), (red_t, info_t) = _reduced(beams, beam)
    np.testing.assert_array_equal(red_t.sampled_params["sel"],
                                  red_j.sampled_params["sel"])
    assert info_t["n_sampled"] == info_j["n_sampled"]
    np.testing.assert_allclose(info_t["weights"], info_j["weights"], rtol=1e-10)
    np.testing.assert_allclose(red_t.PhiW_planar, red_j.PhiW_planar, rtol=1e-10)
    assert red_t.window_params is None and red_t.guard_Phi is not None
    eta, etad, um = _inputs(ms, beams[beam][1], 1e-2, seed=1)
    ref = red_j.rollout(jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um),
                        30, n_newton=2)
    out = red_t.rollout(torch.tensor(eta), torch.tensor(etad), um, 30,
                        n_newton=2)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= 1e-10
    # the gathered layout's fused plain twin is the same recurrence
    fused = red_t.make_pallas_rollout()(torch.tensor(eta), torch.tensor(etad),
                                        um, 30, n_newton=2)
    for a, b in zip(fused, ref):
        assert _rel(a, b) <= 1e-10


def test_convert_round_trip(beams):
    ms, port = _engines(beams, "mixed")
    for name in ("Phi", "PhiW", "PhiTM", "Sinv", "lam", "Sinv_diag",
                 "Phi_planar", "PhiW_planar"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ms, name))
    for key, val in ms.window_params.items():
        np.testing.assert_array_equal(port.window_params[key], val)
    assert port.device == torch.device("cpu") and port.n_modes == M
    again = _port(port, beams["mixed"][1])
    eta, etad, um = _inputs(ms, beams["mixed"][1], 1e-2)
    for a, b in zip(again.rollout(eta, etad, um, 5), port.rollout(eta, etad, um, 5)):
        assert torch.equal(a, b)

"""The node-sharded modal tier of the port (``parallel/spatial_modal.py``).

One gloo world of 4 CPU ranks runs every case (4-shard ``sp`` mesh
and 2 x 2 ``dp x sp``). Each sharded engine is held to the single-device
engine it splits, built in the same rank on the same basis (the JAX test
``TestSpatialModalROM``'s pattern), and the ROM's rollout to the JAX
package's sharded ROM at 4 shards fed the same basis. Float64; tolerances
relative to the scale of what is compared:

* sharded against single-device frames and transforms: 1e-12;
* the JAX package's sharded ROM: 1e-11;
* adaptive: equal counts, 1e-11;
* the ECSW guard's residuals: 1e-8 (a ratio of two norms of differences).

The world has a 180 s limit.
"""

import numpy as np
import pytest

import continuum_robot_tpu_torch as tcrt
import helpers
import torch_parallel_cases as cases
from continuum_robot_tpu_torch.parallel import collectives

N_RANKS = 4
SP4 = {"sp": 4}
DPSP = {"dp": 2, "sp": 2}


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _specs():
    rng = np.random.default_rng(0)
    specs = {}
    csv_h = helpers.mixed_csv(14)
    model = tcrt.DynamicEulerBernoulliBeam(csv_h)
    n = model.n_pos_states
    u = np.zeros(n)
    u[-2] = 0.1
    x = rng.normal(scale=1e-4, size=2 * n)
    # One basis for both packages: mode signs and eigensolver roundoff
    # decide nothing.
    rom = tcrt.make_modal_rom(model, 1e-4, rho_inf=0.5, device="cpu")
    basis = (rom.Phi, rom.PhiW)
    t_ad = np.linspace(0.0, 5e-5, 3)
    specs["hyb"] = dict(case="rom_engine_case", mesh=SP4, csv=csv_h, x_red=x, u_red=u,
                        basis=basis, adaptive_t=t_ad)
    specs["hyb_damped"] = dict(case="rom_engine_case", mesh=SP4, csv=csv_h, x_red=x,
                               u_red=u, rayleigh=(0.5, 1e-6), adaptive_t=t_ad)
    csv_n = helpers.nonlinear_csv(14)
    specs["nl_trunc"] = dict(case="rom_engine_case", mesh=SP4, csv=csv_n, x_red=x, u_red=u,
                             n_modes=12, rayleigh=(0.5, 1e-6), n_frames=3, substeps=4,
                             n_newton=1)
    xb = rng.normal(scale=1e-4, size=(3, 2 * n))
    specs["batch"] = dict(case="rom_engine_case", mesh=DPSP, csv=csv_h, x_red=xb, u_red=u,
                          n_frames=3, substeps=2, adaptive_t=np.linspace(0.0, 2.5e-5, 2),
                          solo=True)
    csv22 = helpers.nonlinear_csv(22)
    n22 = tcrt.DynamicEulerBernoulliBeam(csv22).n_pos_states
    u22, bad = np.zeros(n22), np.zeros(n22)
    u22[-2], bad[1] = 3.0, 3.0
    specs["ecsw"] = dict(case="ecsw_case", mesh=SP4, csv=csv22, u_red=u22, u_bad=bad,
                         n_modes=16)
    csv_l = helpers.linear_csv(14)
    specs["linear"] = dict(case="modal_linear_case", mesh=SP4, csv=csv_l,
                           x_red=rng.normal(scale=1e-4, size=2 * n), u_red=u)
    specs["contracts"] = dict(case="modal_contracts_case", mesh=SP4,
                              csv_mixed6=helpers.mixed_csv(6))
    return specs, dict(basis=basis, x=x, u=u)


def _jax_rom(spec, basis):
    """The JAX package's sharded ROM at 4 shards on the same basis."""
    import jax
    import jax.numpy as jnp

    import continuum_robot_tpu as jcrt
    from continuum_robot_tpu import parallel as jpar

    model = jcrt.DynamicEulerBernoulliBeam(spec["csv"])
    mesh = jpar.make_mesh(dict(spec["mesh"]), devices=jax.devices()[:4])
    sm = jpar.build_spatial_modal_rom(model, mesh, 1e-4, rho_inf=0.5, basis=basis)
    n = spec["x_red"].shape[-1] // 2
    eta, etad = sm.ms.to_modal(jnp.asarray(spec["x_red"][:n]), jnp.asarray(spec["x_red"][n:]))
    u_m = jnp.asarray(sm.ms.project_force_host(spec["u_red"]))
    _, es, eds = jax.jit(lambda e, ed: sm.rollout_frames(e, ed, u_m, 4, substeps=3,
                                                         n_newton=2))(eta, etad)
    return np.asarray(es), np.asarray(eds)


@pytest.fixture(scope="module")
def world():
    specs, meta = _specs()
    w = collectives.start(cases.run_cases, N_RANKS, specs, timeout=180.0, device="cpu")
    try:
        ref = _jax_rom(specs["hyb"], meta["basis"])
    except BaseException:
        w.kill()
        raise
    return specs, w.result(), ref


@pytest.mark.parametrize("name", ["hyb", "hyb_damped", "nl_trunc", "batch"])
def test_sharded_rom_frames_match_single_device(world, name):
    _, ranks, _ = world
    out = ranks[0][name]
    assert _rel(out["etas"], out["etas1"]) <= 1e-12
    assert _rel(out["etads"], out["etads1"]) <= 1e-12
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name]["etas"], out["etas"])


def test_truncation(world):
    assert world[1][0]["nl_trunc"]["n_modes"] == 12


def test_sharded_rom_matches_jax(world):
    _, ranks, (es, eds) = world
    out = ranks[0]["hyb"]
    assert _rel(out["etas"], es) <= 1e-11
    assert _rel(out["etads"], eds) <= 1e-11


@pytest.mark.parametrize("name", ["hyb", "batch"])
def test_transforms(world, name):
    """``to_modal`` and ``project_force`` (one psum each) equal the host
    transforms; ``physical_frames`` is a node-sharded DTensor whose
    gathered frames are the host expansion."""
    specs, ranks, _ = world
    out = ranks[0][name]
    assert _rel(out["eta_sh"], out["eta"]) <= 1e-12
    assert _rel(out["f_sh"], out["f_host"]) <= 1e-12
    model = tcrt.DynamicEulerBernoulliBeam(specs[name]["csv"])
    free = np.asarray(model.beam_model.bc_info.free_dofs)
    qs = out["qs"]
    q = qs.reshape(*qs.shape[:-2], -1)[..., free]
    assert _rel(q, out["q_ref"]) <= 1e-12
    S = specs[name]["mesh"]["sp"]
    assert out["q_local"][-2] * S == qs.shape[-2]


@pytest.mark.parametrize("name", ["hyb", "hyb_damped"])
def test_adaptive_matches_single_device(world, name):
    out = world[1][0][name]
    for got, want in zip(out["ad_stats"][:4], out["ad1_stats"][:4]):
        np.testing.assert_array_equal(got, want)
    assert int(out["ad_stats"][3]) == 0
    assert _rel(out["ad"], out["ad1"]) <= 1e-11
    assert _rel(out["ad_d"], out["ad1_d"]) <= 1e-11


def test_adaptive_batch_controls_each_env(world):
    """A batch split over dp steps each environment as its solo run."""
    out = world[1][0]["batch"]
    for b, (es, _, st) in enumerate(out["ad_solo"]):
        assert int(out["ad_stats"][1][b]) == int(st[1])
        assert _rel(out["ad"][:, b], es) <= 1e-12


def test_ecsw_guard(world):
    out = world[1][0]["ecsw"]
    assert out["hyper"] and 0 < out["n_sampled"] < 22
    np.testing.assert_allclose(out["rho"], out["rho1"], rtol=1e-8, atol=1e-14)
    assert _rel(out["g_etas"], out["g1_etas"]) <= 1e-11
    np.testing.assert_allclose(out["g_max"], out["g1_max"], rtol=1e-8, atol=1e-14)
    assert not bool(out["g_flag"]) and bool(out["bad_flag"])
    np.testing.assert_array_equal(out["plain"], out["plain1"])
    np.testing.assert_array_equal(out["ad"], out["ad1"])


def test_linear_spatial_modal(world):
    specs, ranks, _ = world
    out = ranks[0]["linear"]
    assert _rel(out["eta"], out["eta0"]) <= 1e-12
    assert _rel(out["etad"], out["etad0"]) <= 1e-12
    model = tcrt.DynamicEulerBernoulliBeam(specs["linear"]["csv"])
    free = np.asarray(model.beam_model.bc_info.free_dofs)
    q = out["qs"][-1].reshape(-1)[free]
    assert _rel(q, out["q_ref"]) <= 1e-12


def test_error_contracts(world):
    out = world[1][0]["contracts"]
    assert "external" in out["opaque"]
    assert "split fast path" in out["consistent"]
    assert out["ext"] and out["moved"] > 0.0

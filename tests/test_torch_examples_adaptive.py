"""The port's error-controlled examples against the JAX package: the fluid
and gravity comparison sweeps (Dopri5) and ``adaptive_stepping``
(adaptive generalized-alpha, SDIRK3, the expm reference, Dopri5 and the
adaptive modal ROM).

Each test runs a port example's ``run(device="cpu")`` over a short span and
rebuilds the JAX example's inner computation from the JAX package's public
API on the same inputs (float64, CPU): trajectories agree to 1e-10 of their
scale and every adaptive run takes the same accepted and rejected steps.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd

import continuum_robot_tpu as jcrt
from continuum_robot_tpu.models import ForceParams as JForceParams
from continuum_robot_tpu.models.simulate import simulate as jsimulate
from continuum_robot_tpu.ops.exponential import make_expm_propagator as jexpm
from continuum_robot_tpu_torch.examples import (
    adaptive_stepping,
    beam_comparison_fluid,
    beam_comparison_gravity,
    example_utilities as ex,
)

RTOL = 1e-10


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale or (scale == 0 and err == 0), (err, scale)


def counts(res):
    return int(res.stats.n_accepted), int(res.stats.n_rejected)


def jax_beam(kind: int, fp=None):
    """The JAX package's 6-segment cantilever: 0 linear, 1 nonlinear, 2 mixed."""
    files = ex.create_beam_parameters()
    try:
        return jcrt.DynamicEulerBernoulliBeam(files[kind], force_params=fp)
    finally:
        ex.cleanup_temp_files(*files)


# ---------------------------------------------------------------------------
# beam_comparison_fluid / beam_comparison_gravity
# ---------------------------------------------------------------------------

SWEEP = dict(t_final=0.002, dt=0.001)


def jax_task(csv, fp, dt, t_final):
    beam = jcrt.DynamicEulerBernoulliBeam(csv, force_params=fp)
    n = beam.n_pos_states
    tip = jnp.zeros(n).at[-2].set(0.1)

    def u(t):
        return jnp.where(t < 0.01, tip, jnp.zeros(n))

    res = jsimulate(beam, np.zeros(2 * n), t_final, dt, method="dopri5", u=u,
                    rtol=1e-8, atol=1e-10)
    return np.asarray(res.ys)[:, n - 2], res.stats


def check_sweep(got, fps):
    files = ex.create_beam_parameters()
    names = {"Linear": files[0], "Nonlinear": files[1], "Mixed Lin-Base/Nonlin-Tip": files[2]}
    try:
        for name, tip in got["tips"].items():
            base, label = name.split(" (")
            want, stats = jax_task(names[base], fps[label.rstrip(")")], **SWEEP)
            close(tip, want)
            assert got["stats"][name]["n_accepted"] == int(stats.n_accepted), name
            assert got["stats"][name]["n_rejected"] == int(stats.n_rejected), name
            assert got["stats"][name]["nfev"] == 7 * int(stats.n_steps), name
    finally:
        ex.cleanup_temp_files(*files)


def test_beam_comparison_fluid_matches_jax():
    got = beam_comparison_fluid.run(**SWEEP, device="cpu")
    assert len(got["tips"]) == 6
    check_sweep(got, {"No Fluid": None, "Fluid": JForceParams(
        enable_fluid_effects=True, fluid_density=beam_comparison_fluid.FLUID_DENSITY)})
    for name, tip in got["tips"].items():
        assert got["tip_abs_max"][name] == np.abs(tip).max()
    freqs = ex.calculate_natural_frequencies(1.5, 75e9, np.pi * 0.005**4 / 4, 6450,
                                             np.pi * 0.005**2)
    np.testing.assert_allclose(got["analytic_hz"], freqs, rtol=1e-15)


def test_beam_comparison_gravity_matches_jax():
    got = beam_comparison_gravity.run(**SWEEP, device="cpu")
    assert len(got["tips"]) == 3
    check_sweep(got, {"Gravity": JForceParams(enable_gravity_effects=True)})
    for name, tip in got["tips"].items():
        assert got["final_sag"][name] == tip[-1]


# ---------------------------------------------------------------------------
# adaptive_stepping
# ---------------------------------------------------------------------------

ADAPTIVE = dict(n_el=4, t_final=2e-4, dt_out=1e-4, nl_t_final=0.002, rtols=(1e-4, 1e-6))


def test_adaptive_stepping_matches_jax():
    got = adaptive_stepping.run(**ADAPTIVE, device="cpu")
    props = ex.get_material_properties()
    n_el = ADAPTIVE["n_el"]
    beam = jcrt.DynamicEulerBernoulliBeam(pd.DataFrame({
        "length": [props["length"] / 10.0] * n_el,
        "elastic_modulus": [props["E"]] * n_el,
        "moment_inertia": [props["MInertia"]] * n_el,
        "density": [props["rho"]] * n_el,
        "cross_area": [props["A"]] * n_el,
        "type": ["linear"] * n_el,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n_el - 1),
    }))
    n = beam.n_pos_states
    f = np.zeros(n)
    f[-2] = 0.1
    x0 = np.concatenate([np.linalg.solve(beam.beam_model.get_stiffness_matrix(), f),
                         np.zeros(n)])
    t_final, dt_out = ADAPTIVE["t_final"], ADAPTIVE["dt_out"]
    exact = jexpm(beam, dt_out, dtype=jnp.float64)
    xs = np.asarray(exact(jnp.asarray(x0), jnp.zeros((int(t_final / dt_out), n))))
    close(got["tip_exact"], xs[:, n - 2])
    for method in ("generalized_alpha_adaptive", "sdirk3"):
        res = jsimulate(beam, x0, t_final, dt_out, method=method, rtol=1e-6, atol=1e-10,
                        linear_solver="btd")
        close(got[method]["tip"], np.asarray(res.ys)[:, n - 2])
        assert (got[method]["accepted"], got[method]["rejected"]) == counts(res), method

    beam_nl = jax_beam(1)
    n2 = beam_nl.n_pos_states
    u = np.zeros(n2)
    u[-2] = 5.0
    x0_nl = np.zeros(2 * n2)
    T = ADAPTIVE["nl_t_final"]
    ref = jsimulate(beam_nl, x0_nl, T, 0.001, method="dopri5", u=u, rtol=1e-10, atol=1e-12)
    close(got["dopri5_reference"]["tip"], np.asarray(ref.ys)[:, n2 - 2])
    assert (got["dopri5_reference"]["accepted"],
            got["dopri5_reference"]["rejected"]) == counts(ref)
    for rtol in ADAPTIVE["rtols"]:
        res = jsimulate(beam_nl, x0_nl, T, 0.001, method="modal_rom_adaptive", u=u,
                        rtol=rtol, atol=rtol * 1e-3, n_newton=3, rho_inf=0.8)
        mine = got[f"modal_rom_adaptive_{rtol:g}"]
        close(mine["tip"], np.asarray(res.ys)[:, n2 - 2])
        assert (mine["accepted"], mine["rejected"]) == counts(res), rtol

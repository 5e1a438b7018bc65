"""The port's solver examples against the JAX package: LQR, LQG, the
nonlinear large-deflection workload and the ROM hyper-reduction workflow.

Each test runs a port example's ``run(device="cpu")`` at a small size and
rebuilds the JAX example's inner computation from the JAX package's public
API on the same inputs (float64, CPU). Trajectories agree to 1e-10 of their
scale; Dopri5 takes the same accepted and rejected steps; the ROM workflow
picks the same ECSW sample (both packages fed one basis, so eigensolver
signs decide nothing) and its deployed run equals the trained engine's bit
for bit. Without matplotlib the plotting helpers raise a clear error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuum_robot_tpu as jcrt
from continuum_robot_tpu.control import (
    FullStateLinear as JFullStateLinear,
    LinearQuadraticEstimator as JLQE,
    LinearQuadraticGaussian as JLQG,
    LinearQuadraticRegulator as JLQR,
    output_matrix as joutput_matrix,
)
from continuum_robot_tpu.models import ForceParams as JForceParams
from continuum_robot_tpu.models.simulate import make_modal_rom as jmake_modal_rom
from continuum_robot_tpu.models.simulate import simulate as jsimulate
from continuum_robot_tpu.ops.exponential import discretize_lti as jdiscretize_lti
from continuum_robot_tpu_torch.examples import (
    example_utilities as ex,
    lqg_control,
    lqr_control,
    nonlinear_large_deflection,
    rom_hyper_reduction,
)

RTOL = 1e-10


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale or (scale == 0 and err == 0), (err, scale)


def jax_beam(kind: int, fp=None):
    """The JAX package's 6-segment cantilever: 0 linear, 1 nonlinear, 2 mixed."""
    files = ex.create_beam_parameters()
    try:
        return jcrt.DynamicEulerBernoulliBeam(files[kind], force_params=fp)
    finally:
        ex.cleanup_temp_files(*files)


def counts(res):
    return int(res.stats.n_accepted), int(res.stats.n_rejected)


# ---------------------------------------------------------------------------
# lqr_control / lqg_control
# ---------------------------------------------------------------------------


def test_lqr_control_matches_jax():
    t_final, dt = 0.004, 0.001
    got = lqr_control.run(t_final=t_final, dt=dt, device="cpu")
    beam = jax_beam(0, JForceParams(enable_gravity_effects=True))
    # The design from the port's own K and M: equal in value to the JAX
    # package's, but the CARE's sign-function iteration is sensitive to
    # their memory layout (1e-5 of the gain between the two packages' arrays,
    # whichever package solves it).
    files = ex.create_beam_parameters()
    try:
        tbeam = lqr_control.DynamicEulerBernoulliBeam(files[0])
    finally:
        ex.cleanup_temp_files(*files)
    K, M = tbeam.beam_model.get_stiffness_matrix(), tbeam.beam_model.get_mass_matrix()
    n = K.shape[0]
    Q = np.eye(2 * n)
    Q[:n, :n] *= 100.0
    Q[n:, n:] *= 10.0
    lqr = JLQR(K, M, Q, np.eye(n))
    gain = lqr.compute_gain_matrix()
    close(got["gain"], gain)
    close(got["max_re_eig"], np.real(lqr._E).max())
    Kg = jnp.asarray(JFullStateLinear(gain).gain_matrix)
    tip = jnp.zeros(n).at[-2].set(0.1)

    def disturbance(t):
        return jnp.where(t < 0.01, tip, jnp.zeros(n))

    for name, ff in (("open", None),
                     ("closed", lambda x, t: -jnp.einsum("ij,...j->...i", Kg, x))):
        res = jsimulate(beam, np.zeros(2 * n), t_final, dt, method="dopri5", u=disturbance,
                        forces_func=ff, rtol=1e-8, atol=1e-10)
        close(got[f"tip_{name}"], np.asarray(res.ys)[:, n - 2])
        assert (got["stats"][name]["accepted"], got["stats"][name]["rejected"]) == counts(res)


def test_lqg_control_matches_jax():
    t_final, dt = 0.05, 1e-3
    got = lqg_control.run(t_final=t_final, dt=dt, device="cpu")
    K, M = lqg_control.build_plant()  # the port's arrays (see the LQR test)
    nf = K.shape[0]
    act = [nf - 3, nf - 2]
    lqr = JLQR(K, M, np.diag([100.0] * nf + [10.0] * nf), 1e-8 * np.eye(2), input_dofs=act)
    lqr.compute_gain_matrix()
    meas = [nf - 3, nf - 2, 2 * nf - 3, 2 * nf - 2]
    lqe = JLQE(K, M, joutput_matrix(2 * nf, meas), 1e-2 * np.eye(2 * nf), 1e-8 * np.eye(4))
    lqe.compute_gain_matrix()
    lqg = JLQG(lqr, lqe)
    close(got["max_re_eig"], np.real(np.linalg.eigvals(lqg.augmented_matrix())).max())
    n_frames = int(round(t_final / dt))
    z0 = jnp.zeros(4 * nf).at[nf - 2].set(1e-3)
    zs = np.asarray(jax.jit(lqg.make_closed_loop_propagator(dt, dtype=jnp.float64))(
        z0, jnp.zeros((n_frames, 2 * nf))))
    close(got["zs"], zs)
    Phi_ol, _ = jdiscretize_lti(lqg.A, lqg.B, dt)
    x_ol = np.zeros(2 * nf)
    x_ol[nf - 2] = 1e-3
    for _ in range(n_frames):
        x_ol = Phi_ol @ x_ol
    close(got["tip_final_open"], abs(x_ol[nf - 2]))
    close(got["observer_err_end"], np.linalg.norm(zs[-1, :2 * nf] - zs[-1, 2 * nf:]))


# ---------------------------------------------------------------------------
# nonlinear_large_deflection
# ---------------------------------------------------------------------------


def test_nonlinear_large_deflection_matches_jax():
    t_final, dt = 0.004, 0.001
    got = nonlinear_large_deflection.run(t_final=t_final, dt=dt, device="cpu")
    beam = jax_beam(1, JForceParams(enable_fluid_effects=True, fluid_density=1000.0))
    n = beam.n_pos_states
    tip = jnp.zeros(n).at[-2].set(1.0)
    F_tip = got["F_tip"]
    props = ex.get_material_properties()
    L, EI = props["length"] * 6, props["E"] * props["MInertia"]
    assert F_tip == 0.10 * L * 3 * EI / L**3

    def u(t):
        return tip * F_tip * jnp.clip(t / 0.2, 0.0, 1.0)

    x0 = np.zeros(2 * n)
    imp = jsimulate(beam, x0, t_final, dt, method="generalized_alpha", u=u, substeps=10,
                    n_newton=3, rho_inf=0.7)
    exp = jsimulate(beam, x0, t_final, dt, method="dopri5", u=u, rtol=1e-8, atol=1e-11)
    rom = jsimulate(beam, x0, t_final, dt, method="modal_rom", u=u, substeps=10,
                    n_newton=2, rho_inf=0.7, n_modes=9, modal_derivatives=3)
    close(got["tip_implicit"], np.asarray(imp.ys)[:, n - 2])
    close(got["tip_dopri5"], np.asarray(exp.ys)[:, n - 2])
    close(got["tip_rom"], np.asarray(rom.ys)[:, n - 2])
    assert (got["dopri5_accepted"], got["dopri5_rejected"]) == counts(exp)


# ---------------------------------------------------------------------------
# rom_hyper_reduction
# ---------------------------------------------------------------------------

ROM = dict(n=10, n_steps=60, frames=6)


def test_rom_hyper_reduction_matches_jax():
    model = jcrt.DynamicEulerBernoulliBeam(rom_hyper_reduction.beam_dataframe(ROM["n"]))
    nred = model.n_pos_states
    m = min(64, max(8, nred // 3))
    ms = jmake_modal_rom(model, 1e-4, rho_inf=0.5, n_modes=m)
    basis = (np.asarray(ms.Phi), np.asarray(ms.PhiW))
    got = rom_hyper_reduction.run(**ROM, basis=basis, device="cpu")
    assert got["n_modes"] == ms.n_modes

    u = np.zeros(nred)
    u[-2] = 2.0
    u_m = jnp.asarray(ms.project_force_host(u))
    z = jnp.zeros((1, ms.n_modes))
    substeps = ROM["n_steps"] // ROM["frames"]
    _, etas, _ = ms.rollout_frames(z, z, u_m, ROM["frames"], substeps=substeps, n_newton=2)
    red, info = ms.hyper_reduce(np.asarray(etas[:, 0, :]), tau=1e-4, return_info=True)
    np.testing.assert_array_equal(got["sample"], np.asarray(red.sampled_params["sel"]))
    assert got["n_sampled"] == info["n_sampled"]
    close(got["train_residual"], info["train_residual"], rtol=1e-8)

    def frames(engine):
        _, e, ed = engine.rollout_frames(z, z, u_m, ROM["frames"], substeps=substeps,
                                         n_newton=1)
        return np.asarray(engine.from_modal(e, ed)[0])

    close(got["qs_full"], frames(ms))
    close(got["qs_hr"], frames(red))
    np.testing.assert_array_equal(got["qs_deployed"], got["qs_hr"])


def test_plotting_without_matplotlib_raises_clearly(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="matplotlib"):
        ex.pyplot()
    with pytest.raises(RuntimeError, match="matplotlib"):
        ex.animate_beam_shapes({"a": (np.zeros((2, 3)), np.zeros((2, 3)))},
                               os.devnull)

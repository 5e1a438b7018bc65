"""The control layer of the PyTorch port against the JAX package.

The CARE solvers, the LQR, LQE and LQG designs, ``FullStateLinear``, the
LQG closed loop and its exact propagator, and the extended Kalman filter:
both packages fed the same seeded NumPy inputs (float64, CPU). First the
repaired fault: ``torch.func.jacfwd`` of an RK4 step through the RHS of a
freshly built nonlinear model, whose polynomial internal force used to be
built lazily, under the transform, at the first RHS call.

The LQR closed-loop golden (``tests/goldens/lqr_closed_loop.npz``, 1 s)
runs here over its first ``GOLDEN_PREFIX_FRAMES`` frames (a Dopri5 trial
at rtol 1e-10 costs a few ms of small torch ops on the CPU);
``chip_smoke.py`` phase 25 runs it on the card for a wall-time budget.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu import control as jctl
from continuum_robot_tpu.ops import care as jcare
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu_torch import control as tctl
from continuum_robot_tpu_torch.models import dynamics as tdyn
from continuum_robot_tpu_torch.ops import care as tcare
from continuum_robot_tpu_torch.ops import integrators as ti
from test_unified_beam_system import make_df

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_PREFIX_FRAMES = 2  # 2 ms of the closed-loop golden's 1 s
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: intra-op threads only add their start-up (a 12 x 12
    batched product takes ms on a loaded host with 8 threads, tens of us
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN_DIR, "lqr.npz"))


def scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def nonlinear_df(n, forces=False):
    """``tests/test_control.py``'s EKF beam: ``make_df`` von Karman
    segments, fixed base; with ``forces`` the fluid columns for drag."""
    df = make_df(["nonlinear"] * n)
    df["boundary_condition"] = ["FIXED"] + ["NONE"] * (n - 1)
    if forces:
        df["wetted_area"] = helpers.WETTED_AREA
        df["drag_coef"] = helpers.DRAG_COEF
    return df


FORCES = {"enable_fluid_effects": True, "fluid_density": 1000.0,
          "enable_gravity_effects": True}


# -- the repaired fault: jacfwd through a fresh model ------------------------


@pytest.mark.parametrize("forces", [False, True], ids=["plain", "drag_gravity"])
def test_cold_jacfwd_of_rk4_step_matches_jax(forces):
    fp = FORCES if forces else {}
    tm = tcrt.DynamicEulerBernoulliBeam(nonlinear_df(2, forces), tcrt.ForceParams(**fp))
    jm = jcrt.DynamicEulerBernoulliBeam(nonlinear_df(2, forces), jcrt.ForceParams(**fp))
    n = tm.n_pos_states
    x = np.random.default_rng(5).normal(scale=1e-3, size=2 * n)
    h = 2e-5
    t_rhs = tm.build_rhs()  # no RHS evaluation before the transform
    got = torch.func.jacfwd(lambda z: ti.rk4_step(t_rhs, 0.0, z, h))(torch.tensor(x))
    j_rhs = jm.build_rhs()
    ref = jax.jit(jax.jacfwd(lambda z: ji.rk4_step(j_rhs, 0.0, z, h)))(jnp.asarray(x))
    assert scaled(got.numpy(), ref) <= 1e-10


# -- CARE --------------------------------------------------------------------


def beam_AB(golden):
    A = tctl.lqr.beam_state_matrix(golden["K_beam"], golden["M_beam"])
    n = golden["M_beam"].shape[0]
    B = np.zeros((2 * n, n))
    B[n:] = np.linalg.inv(golden["M_beam"])
    return A, B


def care_problem(case, golden):
    if case == "beam":
        A, B = beam_AB(golden)
        return A, B, golden["Q"], golden["R"]
    # One shape for the three (one JAX compile for each newton_refine).
    rng = np.random.default_rng(int(case[-1]))
    n, m = 6, 3
    A = rng.normal(size=(n, n)) * 0.5
    B = rng.normal(size=(n, m))
    return A, B, np.eye(n), np.eye(m)


# P against the JAX package's, x max|P|. The beam's Hamiltonian has a
# condition number near 1e9: the two packages' LAPACK inverses round apart
# in the last bit and the sign iteration (and the Kleinman pass of
# newton_refine=1) carries that past 1e-10 of max|P|, each package as far
# from scipy's golden P as from the other. The beam is held at the JAX
# test's golden bound, the well-conditioned systems at 1e-10.
CARE_TOL = {"beam": 1e-8, "random": 1e-10}


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("case", ["beam", "random0", "random1", "random2"])
def test_solve_care_matches_jax(case, refine, golden):
    A, B, Q, R = care_problem(case, golden)
    ref = jcare.solve_care(A, B, Q, R, newton_refine=refine)
    got = tcare.solve_care(A, B, Q, R, newton_refine=refine, device=CPU)
    assert got.P.dtype == torch.float64 and got.P.device.type == "cpu"
    assert int(got.iterations) == int(ref.iterations)
    P_ref = np.asarray(ref.P)
    tol = CARE_TOL["beam" if case == "beam" else "random"] * np.abs(P_ref).max()
    assert np.abs(got.P.numpy() - P_ref).max() <= tol
    if case == "beam":
        assert np.abs(got.P.numpy() - golden["P"]).max() <= tol
    else:
        assert abs(float(got.residual) - float(ref.residual)) <= 1e-10


def test_solve_care_batch_equals_each_design(golden):
    """Leading axes are a batch of designs, each iterating until its own
    condition fails (the JAX package's vmap)."""
    A, B, Q, R = care_problem("random0", golden)
    As = np.stack([A, 2.0 * A, A - np.eye(6)])
    got = tcare.solve_care(As, np.stack([B] * 3), np.stack([Q] * 3), np.stack([R] * 3),
                           device=CPU)
    for i in range(3):
        one = tcare.solve_care(As[i], B, Q, R, device=CPU)
        assert int(got.iterations[i]) == int(one.iterations)
        np.testing.assert_allclose(got.P[i].numpy(), one.P.numpy(), rtol=0,
                                   atol=1e-12 * float(one.P.abs().max()))


def test_host_design_matches_jax(golden):
    A, B = beam_AB(golden)
    for fn in ("solve_care_numpy",):
        got, ref = getattr(tcare, fn)(A, B, golden["Q"], golden["R"]), getattr(jcare, fn)(
            A, B, golden["Q"], golden["R"])
        np.testing.assert_array_equal(got.P, ref.P)
        assert int(got.iterations) == int(ref.iterations)
    lqr_t = tctl.LinearQuadraticRegulator(golden["K_beam"], golden["M_beam"], golden["Q"],
                                          golden["R"])
    lqr_j = jctl.LinearQuadraticRegulator(golden["K_beam"], golden["M_beam"], golden["Q"],
                                          golden["R"])
    K = lqr_t.compute_gain_matrix()
    np.testing.assert_array_equal(K, lqr_j.compute_gain_matrix())
    assert K is lqr_t.get_K()
    np.testing.assert_array_equal(lqr_t.get_A(), lqr_j.get_A())
    np.testing.assert_array_equal(lqr_t.get_B(), lqr_j.get_B())
    assert np.all(np.real(lqr_t._E) < 0)
    scale = np.abs(golden["K_gain"]).max()
    assert np.abs(K - golden["K_gain"]).max() <= 1e-4 * scale
    # The tensor gains on well-scaled systems (the stiff beam needs the host
    # path's polish), against the JAX package's.
    rng = np.random.default_rng(7)
    n, p = 6, 2
    A = rng.normal(size=(n, n)) - 3.0 * np.eye(n)
    C = rng.normal(size=(p, n))
    for fn, args in (("lqr_gain", (A, C.T, np.eye(n), np.eye(p))),
                     ("lqe_gain", (A, C, np.eye(n), np.eye(p)))):
        Kt, Pt, _ = getattr(tcare, fn)(*args, device=CPU)
        Kj, Pj, _ = getattr(jcare, fn)(*map(jnp.asarray, args))
        assert scaled(Kt.numpy(), Kj) <= 1e-10 and scaled(Pt.numpy(), Pj) <= 1e-10
    Lt, Pt, _ = tcare.lqe_gain_numpy(A, C, np.eye(n), np.eye(p))
    Lj, Pj, _ = jcare.lqe_gain_numpy(A, C, np.eye(n), np.eye(p))
    np.testing.assert_array_equal(Lt, Lj)


# -- validation contracts (tests/test_control.py) ----------------------------


def _small_beam(n_segments=3):
    beam = tcrt.EulerBernoulliBeam(make_df(["linear"] * n_segments))
    beam.apply_boundary_conditions({0: tcrt.BoundaryConditionType.FIXED})
    return beam.get_stiffness_matrix(), beam.get_mass_matrix()


def _invalid(ctl, name, g, small, small4):
    """Build the invalid object ``name`` with the control package ``ctl``."""
    K, M = g["K_beam"], g["M_beam"]
    n = K.shape[0]
    Kb, Mb = small
    nf = Kb.shape[0]
    LQR, LQE = ctl.LinearQuadraticRegulator, ctl.LinearQuadraticEstimator
    C1 = ctl.output_matrix(2 * nf, [0])
    cases = {
        "non_square_stiffness": lambda: LQR(K[:, :3], M, np.eye(2 * n), np.eye(n)),
        "mismatched_km": lambda: LQR(K[:3, :3], M, np.eye(6), np.eye(3)),
        "q_not_square": lambda: LQR(K, M, np.ones((2 * n, 3)), np.eye(n)),
        "q_not_psd": lambda: LQR(K, M, -np.eye(2 * n), np.eye(n)),
        "r_not_pd": lambda: LQR(K, M, np.eye(2 * n), np.zeros((n, n))),
        "q_dimension": lambda: LQR(K, M, np.eye(n), np.eye(n)).compute_gain_matrix(),
        "r_dimension": lambda: LQR(K, M, np.eye(2 * n), np.eye(n + 1)).compute_gain_matrix(),
        "input_dofs_range": lambda: LQR(Kb, Mb, np.eye(2 * nf), np.eye(1), input_dofs=[nf]),
        "input_dofs_unique": lambda: LQR(Kb, Mb, np.eye(2 * nf), np.eye(2),
                                         input_dofs=[1, 1]),
        "input_dofs_empty": lambda: LQR(Kb, Mb, np.eye(2 * nf), np.eye(1), input_dofs=[]),
        "output_range": lambda: ctl.output_matrix(4, [4]),
        "output_unique": lambda: ctl.output_matrix(4, [1, 1]),
        "output_empty": lambda: ctl.output_matrix(4, []),
        "lqe_C": lambda: LQE(Kb, Mb, np.eye(3), np.eye(2 * nf), np.eye(1)),
        "lqe_V_psd": lambda: LQE(Kb, Mb, C1, -np.eye(2 * nf), np.eye(1)),
        "lqe_W_pd": lambda: LQE(Kb, Mb, C1, np.eye(2 * nf), np.zeros((1, 1))),
        "lqe_W_dim": lambda: LQE(Kb, Mb, C1, np.eye(2 * nf), np.eye(2)),
        "lqg_same_beam": lambda: ctl.LinearQuadraticGaussian(
            LQR(Kb, Mb, np.eye(2 * nf), np.eye(nf)),
            LQE(small4[0], small4[1], ctl.output_matrix(2 * small4[0].shape[0], [0]),
                np.eye(2 * small4[0].shape[0]), np.eye(1))),
        "fsl_2d": lambda: ctl.FullStateLinear(np.ones(4)),
        "fsl_1d": lambda: ctl.FullStateLinear(np.ones((2, 4))).compute_input(
            np.ones((2, 4)), np.ones(4), 0.0),
        "fsl_same_length": lambda: ctl.FullStateLinear(np.ones((2, 4))).compute_input(
            np.ones(4), np.ones(3), 0.0),
        "fsl_columns": lambda: ctl.FullStateLinear(np.ones((2, 4))).compute_input(
            np.ones(5), np.ones(5), 0.0),
    }
    return cases[name]


VALIDATIONS = [
    "non_square_stiffness", "mismatched_km", "q_not_square", "q_not_psd", "r_not_pd",
    "q_dimension", "r_dimension", "input_dofs_range", "input_dofs_unique",
    "input_dofs_empty", "output_range", "output_unique", "output_empty", "lqe_C",
    "lqe_V_psd", "lqe_W_pd", "lqe_W_dim", "lqg_same_beam", "fsl_2d", "fsl_1d",
    "fsl_same_length", "fsl_columns",
]


@pytest.mark.parametrize("name", VALIDATIONS)
def test_validation_raises_as_jax(name, golden):
    small, small4 = _small_beam(3), _small_beam(4)
    with pytest.raises(ValueError) as ref:
        _invalid(jctl, name, golden, small, small4)()
    with pytest.raises(ValueError) as got:
        _invalid(tctl, name, golden, small, small4)()
    assert str(got.value) == str(ref.value)


def test_full_state_linear_matches_jax():
    rng = np.random.default_rng(11)
    K = rng.normal(size=(3, 8))
    x, r = rng.normal(size=8), rng.normal(size=8)
    xb = rng.normal(size=(5, 8))
    th = tcrt.FullStateLinear(K, device=CPU)
    jh = jcrt.FullStateLinear(K)
    assert th.is_enabled() and isinstance(th, tcrt.models.AbstractInputHandler)
    got = th.compute_input(x, r, 0.0)
    assert got.device.type == "cpu"
    assert scaled(got.numpy(), jh.compute_input(x, r, 0.0)) <= 1e-14
    assert scaled(th.compute_input(torch.tensor(x), torch.tensor(r), 0.0).numpy(),
                  jh.compute_input(x, r, 0.0)) <= 1e-14
    assert scaled(th.feedback(torch.tensor(xb), r).numpy(), jh.feedback(xb, r)) <= 1e-14
    assert scaled(th.feedback(torch.tensor(xb), 0.0).numpy(), jh.feedback(xb, 0.0)) <= 1e-14


# -- LQG ---------------------------------------------------------------------


def lqg_pair():
    """``tests/test_control.py``'s LQG design (3 segments, tip axial and
    transverse actuators, tip displacement and velocity sensors) in both
    packages."""
    Kb, Mb = _small_beam(3)
    nf = Kb.shape[0]
    Q = np.diag([100.0] * nf + [10.0] * nf)
    meas = [nf - 3, nf - 2, 2 * nf - 3, 2 * nf - 2]
    out = []
    for ctl in (tctl, jctl):
        lqr = ctl.LinearQuadraticRegulator(Kb, Mb, Q, 1e-6 * np.eye(2),
                                           input_dofs=[nf - 3, nf - 2])
        C = ctl.output_matrix(2 * nf, meas)
        lqe = ctl.LinearQuadraticEstimator(Kb, Mb, C, 1e-2 * np.eye(2 * nf),
                                           1e-8 * np.eye(len(meas)))
        out.append(ctl.LinearQuadraticGaussian(lqr, lqe))
    return out[0], out[1], nf


def test_lqg_matches_jax():
    tq, jq, nf = lqg_pair()
    for name in ("A", "B", "C", "K", "L"):
        np.testing.assert_array_equal(getattr(tq, name), getattr(jq, name))
    aug = tq.augmented_matrix()
    np.testing.assert_array_equal(aug, jq.augmented_matrix())
    ev_aug = np.sort_complex(np.linalg.eigvals(aug))
    ev_sep = np.sort_complex(np.concatenate([np.linalg.eigvals(tq.A - tq.B @ tq.K),
                                             np.linalg.eigvals(tq.A - tq.L @ tq.C)]))
    assert np.max(np.abs(ev_aug - ev_sep)) < 1e-6 * np.max(np.abs(ev_sep))
    rng = np.random.default_rng(2)
    z = rng.normal(size=(3, 4 * nf)) * 1e-3
    r = rng.normal(size=2 * nf) * 1e-3
    zt = torch.tensor(z)
    assert scaled(tq.control(zt[..., 2 * nf:], r).numpy(),
                  jq.control(jnp.asarray(z[..., 2 * nf:]), r)) <= 1e-12
    for rr in (None, r):
        got = tq.closed_loop_rhs(rr)(0.0, zt, np.ones(2)).numpy()
        ref = np.asarray(jq.closed_loop_rhs(rr)(0.0, jnp.asarray(z), jnp.ones(2)))
        assert scaled(got, ref) <= 1e-12
    # 200 frames of the exact propagator: a batch, the plant hit and the
    # observer cold; a constant and a per-frame reference.
    z0 = np.zeros((2, 4 * nf))
    z0[:, nf - 2] = [1e-3, -5e-4]
    r_frames = rng.normal(size=(200, 2 * nf)) * 1e-4
    prop_t = tq.make_closed_loop_propagator(1e-3, dtype=torch.float64, device=CPU)
    prop_j = jq.make_closed_loop_propagator(1e-3, dtype=jnp.float64)
    got = prop_t(z0, r_frames)
    assert got.shape == (201, 2, 4 * nf) and got.device.type == "cpu"
    assert scaled(got.numpy(), prop_j(jnp.asarray(z0), jnp.asarray(r_frames))) <= 1e-12
    got = prop_t(z0[0], np.zeros(2 * nf), n_frames=200)
    ref = prop_j(jnp.asarray(z0[0]), jnp.zeros(2 * nf), n_frames=200)
    assert scaled(got.numpy(), ref) <= 1e-12
    with pytest.raises(ValueError, match="n_frames"):
        prop_t(z0[0], np.zeros(2 * nf))


# -- EKF ---------------------------------------------------------------------


def ekf_pair(measure, joseph):
    """The 2-segment nonlinear beam of tests/test_control.py's EKF tests,
    both packages' filters (one RK4 step of 2e-5 s a filter step)."""
    tm = tcrt.DynamicEulerBernoulliBeam(nonlinear_df(2))
    jm = jcrt.DynamicEulerBernoulliBeam(nonlinear_df(2))
    nf = tm.n_pos_states
    step_t = tctl.make_discrete_step(tm, 2e-5)
    step_j = jctl.make_discrete_step(jm, 2e-5)
    if measure == "C":
        C = tctl.output_matrix(2 * nf, [nf - 2, 2 * nf - 2])
        h_t = h_j = C
        y_of = lambda xs: xs @ C.T  # noqa: E731
    else:
        def h_t(x):
            return torch.stack([x[nf - 2] ** 2 * 1e3, x[2 * nf - 2]])

        def h_j(x):
            return jnp.stack([x[nf - 2] ** 2 * 1e3, x[2 * nf - 2]])

        y_of = lambda xs: np.stack([xs[..., nf - 2] ** 2 * 1e3, xs[..., 2 * nf - 2]], -1)  # noqa: E731
    V, W = 1e-12 * np.eye(2 * nf), 1e-12 * np.eye(2)
    return (nf, step_t, tctl.make_ekf(step_t, h_t, V, W, joseph=joseph),
            jctl.make_ekf(step_j, h_j, V, W, joseph=joseph), y_of)


@pytest.mark.parametrize("measure,joseph", [("C", True), ("h", False)])
def test_ekf_matches_jax_and_batches(measure, joseph):
    """20 filter steps from a cold (or, for the quadratic sensor, warm)
    start on noise-free measurements of three truths: filter 0 against the
    JAX package's, and the three as one batch against each alone."""
    T = 20
    nf, step_t, ekf_t, ekf_j, y_of = ekf_pair(measure, joseph)
    rng = np.random.default_rng(4)
    x0 = np.zeros((3, 2 * nf))
    x0[:, nf - 2] = rng.normal(scale=5e-4, size=3)
    xs = [torch.tensor(x0)]
    for _ in range(T):
        xs.append(step_t(xs[-1]))
    ys = y_of(torch.stack(xs[1:]).numpy())  # (T, 3, p)
    x_init = np.zeros(2 * nf)
    if measure == "h":
        x_init[nf - 2] = 4e-4
    P0 = 1e-6 * np.eye(2 * nf)
    solo = [tctl.run_ekf(ekf_t, x_init, P0, ys[:, i], device=CPU) for i in range(3)]
    (xj, Pj), est_j = jctl.run_ekf(ekf_j, jnp.asarray(x_init), jnp.asarray(P0),
                                   jnp.asarray(ys[:, 0]))
    (_, P_0), est_0 = solo[0]
    assert est_0.shape == (T, 2 * nf) and est_0.device.type == "cpu"
    assert scaled(est_0.numpy(), est_j) <= 1e-10
    assert np.abs(P_0.numpy() - np.asarray(Pj)).max() <= 1e-10 * np.abs(np.asarray(Pj)).max()
    xb = np.broadcast_to(x_init, (3, 2 * nf)).copy()
    Pb = np.broadcast_to(P0, (3, 2 * nf, 2 * nf)).copy()
    (_, P3), est3 = tctl.run_ekf(ekf_t, xb, Pb, ys, device=CPU)
    for i, ((_, Pi), ei) in enumerate(solo):
        assert scaled(est3[:, i].numpy(), ei.numpy()) <= 1e-10
        assert np.abs(P3[i].numpy() - Pi.numpy()).max() <= 1e-10 * Pi.abs().max().item()


# -- the LQR closed-loop golden's prefix -------------------------------------


@pytest.mark.parametrize("tag", ["uncontrolled", "controlled"])
def test_lqr_closed_loop_golden_prefix(tag):
    """``examples/lqr_control.py``'s workload (6 linear segments with
    gravity, 10 N / 10 ms tip impulse, ``u = K (0 - x)`` by
    ``FullStateLinear``) through ``simulate(method="dopri5",
    forces_func=...)`` against the golden's first frames."""
    g = np.load(os.path.join(GOLDEN_DIR, "lqr_closed_loop.npz"))
    beam = tcrt.DynamicEulerBernoulliBeam(
        make_df(["linear"] * 6).assign(boundary_condition=["FIXED"] + ["NONE"] * 5),
        tcrt.ForceParams(enable_gravity_effects=True))
    n = beam.n_pos_states
    forces = [beam.force_registry.create_aggregated_function()]
    if tag == "controlled":
        ctrl = tcrt.FullStateLinear(g["K_gain"])
        forces.append(lambda x, t: ctrl.feedback(x, 0.0))
    tip = torch.zeros(n, dtype=torch.float64)
    tip[-2] = 10.0

    def u(t):
        return torch.where((t < 0.01)[..., None], tip, torch.zeros_like(tip))

    dt = 1e-3
    res = tcrt.simulate(beam, np.zeros(2 * n), GOLDEN_PREFIX_FRAMES * dt, dt,
                        method="dopri5", u=u, forces_func=tdyn.sum_forces(forces),
                        rtol=1e-10, atol=1e-12, device=CPU)
    y_ref = g[f"{tag}_y"][:, : GOLDEN_PREFIX_FRAMES + 1]
    assert res.ys.shape == (GOLDEN_PREFIX_FRAMES + 1, 2 * n)
    assert scaled(res.ys.numpy().T, y_ref) < 2e-6


# -- the card by default -----------------------------------------------------


def _default_entry_points():
    tq, _, nf = lqg_pair()
    A, B = np.eye(2) * -1.0, np.eye(2)
    tm = tcrt.DynamicEulerBernoulliBeam(nonlinear_df(2))
    ekf = tctl.make_ekf(tctl.make_discrete_step(tm, 2e-5), np.eye(2 * tm.n_pos_states)[:1],
                        np.eye(2 * tm.n_pos_states), np.eye(1))
    return {
        "solve_care": lambda: tcare.solve_care(A, B, np.eye(2), np.eye(2)).P,
        "propagator": lambda: tq.make_closed_loop_propagator(1e-3)(
            np.zeros(4 * nf), np.zeros(2 * nf), n_frames=2),
        "run_ekf": lambda: tctl.run_ekf(ekf, np.zeros((2, 2 * tm.n_pos_states)),
                                        np.eye(2 * tm.n_pos_states),
                                        np.zeros((2, 2, 1)))[1],
    }


@pytest.mark.parametrize("name", ["solve_care", "propagator", "run_ekf"])
def test_entry_points_need_a_card_by_default(name):
    """No silent CPU fallback (``chip_smoke.py`` phases 25-27 call them
    with their defaults on the card)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_entry_points()[name]()


"""Full-order implicit operators of the PyTorch port against the JAX package.

``make_newmark_operator`` in each ``linear_solver`` mode (mass apply,
internal force and solves, prefactored and at a linearization point), the
consistent von Kármán element and the state-dependent tangent, full Newton,
a user ``forces_func``, and the port's implicit path against its own modal
engine (the same discrete recurrence, diagonalized). Float64 on the CPU;
both packages are built from one CSV and fed the same NumPy inputs. The
JAX package's "pallas" mode needs a TPU kernel, so the port's "pallas"
mode (its kernel's plain version on CPU tensors) is held to JAX "btd".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
from continuum_robot_tpu.models import assembly as ja
from continuum_robot_tpu.models import elements as je
from continuum_robot_tpu.models import simulate as jsim
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu_torch.models import assembly as ta
from continuum_robot_tpu_torch.models import elements as te
from continuum_robot_tpu_torch.models import simulate as tsim
from continuum_robot_tpu_torch.ops import integrators as ti
from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb

RTOL = 1e-10
RHO, DT = 0.8, 1e-4


def _gen_alpha_system(rho=RHO, h=DT):
    am = (2 * rho - 1) / (rho + 1)
    af = rho / (rho + 1)
    return 1.0 - am, (1.0 - af) * 0.25 * (1 - am + af) ** 2 * h * h


def _close(port, ref, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def helpers():
    # Imported here: the card-only test below runs where ``tests`` may name
    # another package.
    from tests import helpers

    return helpers


@pytest.fixture(scope="module")
def beams(helpers):
    """``{kind: (jax model, port model)}`` of 8-element beams from one CSV."""
    out = {}
    for kind, make, consistent in (("linear", helpers.linear_csv, False),
                                   ("hybrid", helpers.mixed_csv, False),
                                   ("consistent", helpers.nonlinear_csv, True)):
        csv = make(8)
        out[kind] = (jcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent),
                     tcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent))
    return out


@pytest.mark.parametrize("mode", ["btd", "cr", "dense_inv", "pallas"])
def test_operator_matches_jax(beams, mode):
    jm, tm = beams["hybrid"]
    systems = [_gen_alpha_system()]
    jop = jsim.make_newmark_operator(jm, dt=None, extra_systems=systems,
                                     linear_solver="btd" if mode == "pallas" else mode)
    top = tcrt.make_newmark_operator(tm, dt=None, extra_systems=systems,
                                     linear_solver=mode, device="cpu")
    assert top.tangent_frozen and top.external_force is None
    n = jm.n_pos_states
    rng = np.random.default_rng(1)
    q, a, r = (rng.normal(scale=s, size=(3, n)) for s in (1e-4, 1.0, 1.0))
    # Prefactored systems, and one that is not (factored at the call).
    keys = [(1.0, 0.0), systems[0], (1.0, 3e-9)]

    def apply(op, q, a, r):
        return (op.mass_apply(a), op.internal_force(q),
                *[op.solve(q, c, s)(r) for s, c in keys])

    ref = jax.jit(lambda *x: apply(jop, *x))(*(jnp.asarray(x) for x in (q, a, r)))
    for port, want in zip(apply(top, *(torch.tensor(x) for x in (q, a, r))), ref):
        _close(port, want)


def test_pallas_mode_on_cpu_is_the_plain_sweep(beams):
    """On CPU tensors the kernel mode launches nothing and equals "btd"
    bit for bit."""
    _, tm = beams["linear"]
    ops = {m: tcrt.make_newmark_operator(tm, dt=DT, linear_solver=m, device="cpu")
           for m in ("btd", "pallas")}
    rng = np.random.default_rng(2)
    q, r = (torch.tensor(rng.normal(size=(4, tm.n_pos_states))) for _ in range(2))
    kb.reset_launch_counts()
    for c in (0.0, 0.25 * DT * DT):
        assert torch.equal(ops["pallas"].solve(q, c)(r), ops["btd"].solve(q, c)(r))
    assert kb.btd_solve.launches == 0


def test_consistent_element_and_tangent_match_jax(beams, helpers):
    rng = np.random.default_rng(3)
    q6 = rng.normal(scale=1e-2, size=(4, 8, 6))
    L, E = np.full(8, helpers.LENGTH), np.full(8, helpers.E_MOD)
    I, A = np.full(8, helpers.M_INERTIA), np.full(8, helpers.CROSS_AREA)
    _close(te.nonlinear_internal_force_consistent(torch.tensor(q6), L, E, I, A),
           je.nonlinear_internal_force_consistent(q6, L, E, I, A), 1e-12)
    _close(te.element_strain_energy(q6, L, E, I, A),
           je.element_strain_energy(q6, L, E, I, A), 1e-12)
    for kind in ("hybrid", "consistent"):
        jm, tm = beams[kind]
        arrays_j, arrays_t = jm.beam_model.arrays, tm.beam_model.arrays
        cons = tm.use_consistent_nonlinear
        q = rng.normal(scale=1e-2, size=(2, 27))
        ref = jax.jit(lambda x: ja.tangent_block_tridiagonal(
            arrays_j, x, use_consistent=cons))(jnp.asarray(q))
        for qq in (q, torch.tensor(q)):  # NumPy and tensor inputs
            for port, r in zip(ta.tangent_block_tridiagonal(arrays_t, qq, use_consistent=cons),
                               ref):
                _close(port, r, 1e-12)
        free = tm.beam_model.bc_info.free_dofs
        _close(tsim.reduce_matrix_dense(arrays_t, free, cons),
               jsim.reduce_matrix_dense(arrays_j, free, cons), 1e-12)


# The float32 tangent against the float64 JAX tangent at the same
# (float32) state, by the blocks' largest entry: four float32 epsilons. It
# reads 3.8e-8 for both elements on the 4-element beam below.
TANGENT_F32_MAX = 4 * float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("consistent", [False, True], ids=["parity", "consistent"])
def test_element_tangent_keeps_the_state_dtype(helpers, consistent):
    """``element_tangent_stiffness`` returns the state's dtype for the
    parity and the consistent element, and its values are the JAX
    package's: 1e-12 in float64, float32 roundoff in float32."""
    csv = helpers.nonlinear_csv(4)
    jm = jcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent)
    tm = tcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent)
    q6 = np.random.default_rng(5).normal(scale=1e-2, size=(2, 4, 6))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, TANGENT_F32_MAX)):
        q = torch.tensor(q6, dtype=dtype)
        ref = ja.element_tangent_stiffness(jm.beam_model.arrays, jnp.asarray(q.double().numpy()),
                                           use_consistent=consistent)
        out = ta.element_tangent_stiffness(tm.beam_model.arrays, q, use_consistent=consistent)
        assert out.dtype == dtype
        _close(out.double(), ref, tol)


def test_full_newton_matches_jax(beams):
    """``use_modified_newton=False``: the tangent is refactored per env at
    every Newton iterate."""
    jm, tm = beams["consistent"]
    systems = [_gen_alpha_system(0.5)]
    jop = jsim.make_newmark_operator(jm, dt=None, extra_systems=systems,
                                     use_modified_newton=False, linear_solver="btd")
    n = jm.n_pos_states
    rng = np.random.default_rng(4)
    q0 = rng.normal(scale=1e-3, size=(2, n))
    v0 = np.zeros((2, n))
    u = np.zeros(n)
    u[-2] = 5.0
    _, jq, jv = jax.jit(lambda q, v: ji.integrate_generalized_alpha(
        jop, q, v, 0.0, DT, 4, u=jnp.asarray(u), rho_inf=0.5))(jnp.asarray(q0),
                                                               jnp.asarray(v0))
    for mode in ("btd", "cr", "pallas"):
        top = tcrt.make_newmark_operator(tm, dt=None, extra_systems=systems,
                                         use_modified_newton=False, linear_solver=mode,
                                         device="cpu")
        assert not top.tangent_frozen
        _, tq, tv = ti.integrate_generalized_alpha(
            top, torch.tensor(q0), torch.tensor(v0), 0.0, DT, 4, u=u, rho_inf=0.5)
        _close(tq, jq)
        _close(tv, jv)


def test_user_forces_func_matches_jax(beams):
    """A state- and time-dependent user force: damping plus a tip sine."""
    jm, tm = beams["hybrid"]
    n = jm.n_pos_states
    tip = np.zeros(n)
    tip[-2] = 1.0

    def jf(x, t):
        return -0.05 * x[..., n:] + jnp.sin(2e3 * t) * jnp.asarray(tip)

    def tf(x, t):
        return -0.05 * x[..., n:] + np.sin(2e3 * t) * torch.tensor(tip)

    x0 = np.zeros((2, 2 * n))
    x0[:, :n] = np.random.default_rng(5).normal(scale=1e-5, size=(2, n))
    for method in ("generalized_alpha", "newmark"):
        kw = dict(method=method, substeps=2, u=lambda t: 0.1 * tip)
        ref = jsim.simulate(jm, x0, 4e-4, 1e-4, forces_func=jf, **kw).ys
        out = tcrt.simulate(tm, x0, 4e-4, 1e-4, forces_func=tf, device="cpu", **kw).ys
        _close(out, ref)


def test_matches_own_modal_engine(beams):
    """Identical recurrence, diagonalized: the implicit path equals the
    modal stepper to roundoff (the JAX package's own check)."""
    _, tm = beams["linear"]
    n = tm.n_pos_states
    op = tcrt.make_newmark_operator(tm, dt=None, extra_systems=[_gen_alpha_system()],
                                    device="cpu")
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(3, n)))
    v = torch.zeros_like(q)
    u = torch.zeros(n, dtype=torch.float64)
    u[-2] = 0.1
    a = op.solve(q, 0.0)(u - op.internal_force(q))
    qd, vd = q, v
    for _ in range(100):
        qd, vd, a = ti.generalized_alpha_step(op, 0.0, qd, vd, a, DT, u, rho_inf=RHO,
                                              n_newton=1)
    ms = tcrt.make_modal_genalpha(tm, DT, rho_inf=RHO, device="cpu")
    eta, etad = ms.to_modal(q, v)
    e1, ed1, _ = ms.rollout(eta, etad, ms.project_force_host(u.numpy()), 100)
    qm, vm = ms.from_modal(e1, ed1)
    _close(qm, qd.numpy(), 1e-9)
    _close(vm, vd.numpy(), 1e-8)


def test_entry_points_default_to_the_card(beams):
    _, tm = beams["linear"]
    x0 = np.zeros(2 * tm.n_pos_states)
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    for method in ("newmark", "generalized_alpha"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcrt.simulate(tm, x0, 1e-3, 1e-4, method=method)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcrt.make_newmark_operator(tm, dt=DT)


def test_contracts(beams, helpers):
    _, tm = beams["linear"]
    x0 = np.zeros(2 * tm.n_pos_states)
    with pytest.raises(ValueError, match="linear_solver"):
        tcrt.make_newmark_operator(tm, dt=DT, linear_solver="lu", device="cpu")
    op = tcrt.make_newmark_operator(tm, dt=DT, device="cpu")
    z = torch.zeros(tm.n_pos_states, dtype=torch.float64)
    u = torch.zeros_like(z)
    u[-2] = 0.1
    plain, remat = (ti.integrate_generalized_alpha(op, z, z, 0.0, DT, 2, u=u, substeps=2,
                                                   remat=r) for r in (False, True))
    for a, b in zip(plain, remat):  # checkpointed frames: the same values, bit for bit
        assert torch.equal(a, b)
    # The ROM tier runs on the CPU too: the adaptive ROM and the consistent
    # element's ROM (no split path: lam is None).
    res = tcrt.simulate(tm, x0, 1e-3, 1e-4, method="modal_rom_adaptive", device="cpu")
    assert res.stats is not None and bool(torch.isfinite(res.ys).all())
    cons = tcrt.make_modal_rom(
        tcrt.DynamicEulerBernoulliBeam(helpers.nonlinear_csv(4),
                                       use_consistent_nonlinear=True),
        DT, n_modes=4, device="cpu")
    assert cons.lam is None and cons.n_modes == 4
    # A single environment (no batch axis) runs through every mode.
    ys = {m: tcrt.simulate(tm, x0, 2e-4, 1e-4, method="newmark", linear_solver=m,
                           u=np.ones(tm.n_pos_states), device="cpu").ys
          for m in ("btd", "pallas", "cr", "dense_inv")}
    assert ys["btd"].shape == (3, 2 * tm.n_pos_states)
    assert torch.equal(ys["pallas"], ys["btd"])
    for m in ("cr", "dense_inv"):
        _close(ys[m], ys["btd"].numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["generalized_alpha", "newmark"])
def test_simulate_kernel_mode_bit_equal_on_card(cuda_device, method):
    import pandas as pd

    n_el = 8
    tm = tcrt.DynamicEulerBernoulliBeam(pd.DataFrame({
        "length": [0.25] * n_el, "elastic_modulus": [75e9] * n_el,
        "moment_inertia": [np.pi * 0.005**4 / 4] * n_el, "density": [6450.0] * n_el,
        "cross_area": [np.pi * 0.005**2] * n_el,
        "type": ["linear", "nonlinear"] * (n_el // 2),
        "boundary_condition": ["FIXED"] + ["NONE"] * (n_el - 1),
    }))
    n = tm.n_pos_states
    x0 = np.zeros((5, 2 * n))
    x0[:, :n] = np.random.default_rng(6).normal(scale=1e-5, size=(5, n))
    ys = {}
    for solver in ("pallas", "btd"):
        kb.reset_launch_counts()
        ys[solver] = tcrt.simulate(tm, x0, 5e-4, 1e-4, method=method, substeps=2,
                                   linear_solver=solver, device=cuda_device).ys
        assert (kb.btd_solve.launches > 0) == (solver == "pallas")
    assert torch.equal(ys["pallas"], ys["btd"])

"""The port's parameter sweeps (``parallel/sweep.py``) against the JAX package.

The cases of ``tests/test_sweep.py`` on the same beams and inputs (NumPy,
float64, on the CPU): batched configurations, the parametric RHS and RK4
rollout, the traced implicit operator under fixed-step generalized-alpha,
the frozen-basis ROM rollout, and their reverse-mode derivatives in the
physical parameters (the error-controlled cases are in
``test_torch_sweep_adaptive.py``). Bounds: forward values 1e-10 of the JAX
package's (relative to the compared scale), gradients 1e-9 of ``jax.grad``
and within the JAX test's own finite-difference bound, remat gradients
equal to plain ones (rtol 1e-10). The JAX references
are computed once each, jitted, on two threads while the port's cases run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu.models import DynamicEulerBernoulliBeam as JBeam
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu.parallel import sweep as js
from continuum_robot_tpu_torch.ops import integrators as ti
from continuum_robot_tpu_torch.parallel import sweep as ts

CPU = "cpu"
F64 = torch.float64
E0 = 75e9


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _grad(loss, x0):
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    return float(torch.autograd.grad(loss(x), x)[0])


def _fd(loss, x0, eps):
    with torch.no_grad():
        x = torch.tensor(x0, dtype=F64)
        return float((loss(x + eps) - loss(x - eps)) / (2 * eps))


# ---------------------------------------------------------------------------
# The cases' beams and inputs, and the JAX package's references
# ---------------------------------------------------------------------------


def _beams(csv):
    return JBeam(csv), tcrt.DynamicEulerBernoulliBeam(csv)


class Case:
    """The beams and inputs every test here shares (built once)."""

    def __init__(self):
        self.lin6 = _beams(helpers.linear_csv())
        self.lin5 = _beams(helpers.linear_csv(5))
        self.nl5 = _beams(helpers.nonlinear_csv(5))
        n6 = self.lin6[1].n_pos_states
        self.x_rhs = np.random.default_rng(0).normal(scale=1e-3, size=2 * n6)
        self.x0_rk4 = np.zeros(2 * n6)
        self.x0_rk4[n6 - 2] = 1e-3
        n5 = self.lin5[1].n_pos_states
        self.x0_ga = np.zeros(2 * n5)
        self.x0_ga[n5 - 2] = 1e-4
        self.u_ga = np.zeros(n5)
        self.u_ga[-2] = 0.01
        self.E_sweep = np.array([50e9, 100e9])[:, None]
        self.E_batch = np.array([50e9, 75e9, 100e9])[:, None]


# The JAX package's side: each a function of the case, jitted.

def _j_rk4_loss(c):
    jm, n = c.lin6[0], c.lin6[0].n_pos_states

    def loss(E):
        b = js.override_arrays(jm.beam_model.arrays, elastic_modulus=E[None, None])
        _, ys = js.parametric_rollout(jm.beam_model.bc_info, b, jnp.asarray(c.x0_rk4)[None],
                                      0.002, 0.001, substeps=20)
        return jnp.sum(ys[-1, 0, :n] ** 2) * 1e6

    return loss


def _j_ga_loss(c):
    jm, n = c.lin5[0], c.lin5[0].n_pos_states

    def loss(E):
        b = js.override_arrays(jm.beam_model.arrays, elastic_modulus=E[None, None])
        _, ys = js.parametric_genalpha_rollout(jm.beam_model.bc_info, b,
                                               jnp.asarray(c.x0_ga)[None], 0.01, 1e-3,
                                               u=jnp.asarray(c.u_ga), substeps=10)
        return jnp.sum(ys[-1, 0, :n] ** 2) * 1e6

    return loss


def _j_rhs(c):
    jm = c.lin6[0]
    arrays = jax.tree_util.tree_map(jnp.asarray, jm.beam_model.arrays)
    rhs = js.make_parametric_rhs(jm.beam_model.bc_info)
    return np.asarray(jax.jit(lambda x: rhs(0.0, x, None, arrays))(jnp.asarray(c.x_rhs)))


def _j_x0_grad(c):
    rhs = c.lin6[0].build_rhs()
    return jax.jit(jax.grad(lambda z: jnp.sum(ji.integrate_fixed(
        rhs, z, 0.0, 0.001, 3, substeps=20)[1][-1] ** 2)))(jnp.asarray(c.x0_rk4))


def _j_rollouts(c):
    """The forward rollouts: the RK4 sweep, the tiled implicit rollouts of
    both beams, the modulus batch."""
    jm6, jm5, jn5 = c.lin6[0], c.lin5[0], c.nl5[0]
    out = {}
    out["sweep"] = jax.jit(lambda b, x: js.parametric_rollout(
        jm6.beam_model.bc_info, b, x, 0.01, 0.001, substeps=20)[1])(
        js.override_arrays(jm6.beam_model.arrays, elastic_modulus=c.E_sweep),
        jnp.asarray(np.tile(c.x0_rk4, (2, 1))))
    u = jnp.asarray(c.u_ga)
    for kind, jm, arrs, envs in (
            ("linear", jm5, js.tile_arrays(jm5.beam_model.arrays, 2), 2),
            ("nonlinear", jn5, js.tile_arrays(jn5.beam_model.arrays, 2), 2),
            ("batch", jm5, js.override_arrays(jm5.beam_model.arrays,
                                              elastic_modulus=c.E_batch), 3)):
        uu = None if kind == "batch" else u
        out[kind] = jax.jit(lambda b, x, jm=jm, uu=uu: js.parametric_genalpha_rollout(
            jm.beam_model.bc_info, b, x, 0.01, 1e-3, u=uu, substeps=10)[1])(
            arrs, jnp.asarray(np.tile(c.x0_ga, (envs, 1))))
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_refs(c):
    grad = lambda loss, x: float(jax.jit(jax.grad(loss))(jnp.asarray(x)))  # noqa: E731
    return {
        "rk4_grad": lambda: grad(_j_rk4_loss(c), E0),
        "ga_grad": lambda: grad(_j_ga_loss(c), E0),
        "rhs": lambda: _j_rhs(c),
        "x0_grad": lambda: np.asarray(_j_x0_grad(c)),
        "rollouts": lambda: _j_rollouts(c),
    }


@pytest.fixture(scope="module")
def case():
    c = Case()
    pool = ThreadPoolExecutor(2)  # XLA compiles off the GIL
    c.refs = {k: pool.submit(fn) for k, fn in _jax_refs(c).items()}
    yield c
    pool.shutdown(wait=True, cancel_futures=True)


def ref(c, name, key=None):
    out = c.refs[name].result()
    return out if key is None else out[key]


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------


def test_tile_and_override(case):
    jm, tm = case.lin6
    E = np.linspace(50e9, 100e9, 4)[:, None]
    batch = ts.override_arrays(tm.beam_model.arrays, elastic_modulus=E, device=CPU)
    want = js.override_arrays(jm.beam_model.arrays, elastic_modulus=E)
    assert batch.elastic_modulus.shape == (4, 6)
    for f in ("length", "elastic_modulus", "moment_inertia", "density", "cross_area",
              "wetted_area", "drag_coef", "nonlinear_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(batch, f)), np.asarray(getattr(want, f)))
    assert batch.elastic_modulus.dtype == F64 and batch.nonlinear_mask.dtype == bool
    tiled = ts.tile_arrays(tm.beam_model.arrays, 3, device=CPU)
    np.testing.assert_array_equal(tiled.length.numpy(),
                                  np.asarray(js.tile_arrays(jm.beam_model.arrays, 3).length))
    # A tensor column keeps its graph and places the batch.
    E_t = torch.tensor(E0, dtype=F64, requires_grad=True)
    b = ts.override_arrays(tm.beam_model.arrays, elastic_modulus=E_t * torch.ones(2, 1, dtype=F64))
    assert b.elastic_modulus.requires_grad and b.length.device.type == "cpu"


def test_unknown_field_rejected(case):
    tm = case.lin6[1]
    with pytest.raises(ValueError, match="no field"):
        ts.override_arrays(tm.beam_model.arrays, youngs=np.ones((2, 1)))
    with pytest.raises(ValueError, match="at least one"):
        ts.override_arrays(tm.beam_model.arrays)


# ---------------------------------------------------------------------------
# Parametric RHS and RK4 rollout
# ---------------------------------------------------------------------------


def test_parametric_rhs_matches_fixed_model(case):
    """At the model's own arrays: the JAX package's parametric RHS (1e-10)
    and the port's fixed-model RHS (the JAX test's bound)."""
    jm, tm = case.lin6
    x = case.x_rhs
    out = ts.make_parametric_rhs(tm.beam_model.bc_info)(0.0, _t(x), None, tm.beam_model.arrays)
    assert _rel(out, ref(case, "rhs")) <= 1e-10
    fixed = tm.build_rhs()(0.0, _t(x), None).numpy()
    np.testing.assert_allclose(out.numpy(), fixed, rtol=1e-8, atol=1e-10 * np.abs(fixed).max())


def test_sweep_changes_dynamics(case):
    tm = case.lin6[1]
    n = tm.n_pos_states
    _, ys = ts.parametric_rollout(tm.beam_model.bc_info,
                                  ts.override_arrays(tm.beam_model.arrays,
                                                     elastic_modulus=case.E_sweep, device=CPU),
                                  np.tile(case.x0_rk4, (2, 1)), 0.01, 0.001, substeps=20)
    assert ys.shape == (11, 2, 2 * n)
    assert not torch.allclose(ys[:, 0], ys[:, 1])
    assert _rel(ys, ref(case, "rollouts", "sweep")) <= 1e-10


def test_matches_single_env_simulate(case):
    """A one-environment parametric rollout is the fixed-model RK4 rollout."""
    tm = case.lin6[1]
    x0 = case.x0_rk4
    _, ys = ts.parametric_rollout(tm.beam_model.bc_info,
                                  ts.tile_arrays(tm.beam_model.arrays, 1, device=CPU),
                                  x0[None], 0.005, 0.001, substeps=40)
    res = tcrt.simulate(tm, x0, 0.005, 0.001, method="rk4", substeps=40, device=CPU)
    np.testing.assert_allclose(ys[:, 0].numpy(), res.ys.numpy(), rtol=1e-7,
                               atol=1e-9 * np.abs(res.ys.numpy()).max())


def test_gradient_wrt_elastic_modulus(case):
    """d(loss)/dE through a whole RK4 rollout: jax.grad's value, and the
    JAX test's central difference (rel 2e-3)."""
    tm = case.lin6[1]
    n = tm.n_pos_states

    def loss(E):
        b = ts.override_arrays(tm.beam_model.arrays, elastic_modulus=E[None, None])
        _, ys = ts.parametric_rollout(tm.beam_model.bc_info, b, _t(case.x0_rk4)[None], 0.002,
                                      0.001, substeps=20)
        return (ys[-1, 0, :n] ** 2).sum() * 1e6

    g = _grad(loss, E0)
    assert g == pytest.approx(_fd(loss, E0, 1e3), rel=2e-3)
    g_ref = ref(case, "rk4_grad")
    assert abs(g - g_ref) <= 1e-9 * abs(g_ref)


def test_gradient_wrt_initial_state(case):
    tm = case.lin6[1]
    x = _t(case.x0_rk4).requires_grad_()
    _, xs = ti.integrate_fixed(tm.build_rhs(), x, 0.0, 0.001, 3, substeps=20)
    g, = torch.autograd.grad((xs[-1] ** 2).sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert _rel(g, ref(case, "x0_grad")) <= 1e-9


# ---------------------------------------------------------------------------
# Traced implicit rollouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "nonlinear"])
def test_matches_prefactored_generalized_alpha(case, kind):
    """Two tiled configurations: the port's host-prefactored
    ``simulate(method="generalized_alpha")`` (1e-12 of scale, the JAX
    test's bound) and the JAX package's traced rollout (1e-10)."""
    tm = (case.lin5 if kind == "linear" else case.nl5)[1]
    x0 = np.tile(case.x0_ga, (2, 1))
    _, ys = ts.parametric_genalpha_rollout(tm.beam_model.bc_info,
                                           ts.tile_arrays(tm.beam_model.arrays, 2, device=CPU),
                                           x0, 0.01, 1e-3, u=case.u_ga, substeps=10)
    res = tcrt.simulate(tm, case.x0_ga, 0.01, 1e-3, method="generalized_alpha",
                        linear_solver="btd", substeps=10, u=case.u_ga, device=CPU)
    scale = float(res.ys.abs().max())
    np.testing.assert_allclose(ys[:, 0].numpy(), res.ys.numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(ys[:, 1].numpy(), ys[:, 0].numpy())
    assert _rel(ys, ref(case, "rollouts", kind)) <= 1e-10


def _ga_loss(case, remat=False):
    tm = case.lin5[1]
    n = tm.n_pos_states

    def loss(E):
        b = ts.override_arrays(tm.beam_model.arrays, elastic_modulus=E[None, None])
        _, ys = ts.parametric_genalpha_rollout(tm.beam_model.bc_info, b, _t(case.x0_ga)[None],
                                               0.01, 1e-3, u=case.u_ga, substeps=10,
                                               remat=remat)
        return (ys[-1, 0, :n] ** 2).sum() * 1e6

    return loss


def test_genalpha_gradient_matches_finite_difference(case):
    loss = _ga_loss(case)
    g = _grad(loss, E0)
    np.testing.assert_allclose(g, _fd(loss, E0, 1e3), rtol=1e-5)
    g_ref = ref(case, "ga_grad")
    assert abs(g - g_ref) <= 1e-9 * abs(g_ref)


def test_parameter_batch_varies_output(case):
    tm = case.lin5[1]
    _, ys = ts.parametric_genalpha_rollout(
        tm.beam_model.bc_info, ts.override_arrays(tm.beam_model.arrays,
                                                  elastic_modulus=case.E_batch, device=CPU),
        np.tile(case.x0_ga, (3, 1)), 0.01, 1e-3, substeps=10)
    assert bool(torch.isfinite(ys).all())
    assert float((ys[:, 0] - ys[:, 1]).abs().max()) > 0
    assert float((ys[:, 1] - ys[:, 2]).abs().max()) > 0
    assert _rel(ys, ref(case, "rollouts", "batch")) <= 1e-10


def test_remat_gradient_matches(case):
    """Checkpointed frames change memory, not values: the remat gradient
    equals the plain one (rtol 1e-10) and the JAX package's."""
    g_plain, g_remat = _grad(_ga_loss(case), E0), _grad(_ga_loss(case, remat=True), E0)
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-10)
    g_ref = ref(case, "ga_grad")
    assert abs(g_remat - g_ref) <= 1e-9 * abs(g_ref)


def test_integrate_generalized_alpha_remat_is_bit_equal(case):
    """``integrate_generalized_alpha(remat=True)`` on the traced operator:
    the same frames bit for bit, and the same gradient in the initial
    state."""
    tm = case.nl5[1]
    n = tm.n_pos_states
    x0 = np.tile(case.x0_ga, (2, 1))
    op = ts.make_traced_genalpha_operator(tm.beam_model.bc_info, tm.beam_model.arrays, 2e-4,
                                          device=CPU)
    outs = []
    for remat in (False, True):
        q0 = _t(x0[:, :n]).requires_grad_()
        _, qs, vs = ti.integrate_generalized_alpha(op, q0, _t(x0[:, n:]), 0.0, 1e-3, 4,
                                                   u=case.u_ga, substeps=5, remat=remat)
        g, = torch.autograd.grad((qs[-1] ** 2).sum() + vs[-1].sum(), q0)
        outs.append((qs.detach(), vs.detach(), g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

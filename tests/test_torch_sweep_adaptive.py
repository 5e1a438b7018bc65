"""Error-controlled stepping on the port's traced operator, against the JAX package.

``tests/test_sweep.py``'s ``TestAdaptiveOnTracedOperator`` on its 5-element
linear beam (float64, CPU): adaptive generalized-alpha on
``make_traced_genalpha_operator`` (factored at the tensor trial ``c``)
against the port's host-prefactored ``"btd"`` operator and the JAX
package's traced run, and forward sensitivities in the elastic modulus
through the engine by ``torch.autograd.forward_ad``: ``jax.jvp``'s tangent
(1e-9) and the JAX test's central difference (1e-6). The difference comes
from the same batched run: three environments ``E - h, E, E + h`` with their
own controllers (``per_env``, the JAX package's ``vmap``), the middle one
carrying the tangent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu.models import DynamicEulerBernoulliBeam as JBeam
from continuum_robot_tpu.ops import integrators as ji
from continuum_robot_tpu.parallel import sweep as js
from continuum_robot_tpu_torch.ops import integrators as ti
from continuum_robot_tpu_torch.parallel import sweep as ts

F64 = torch.float64
RHO = 0.9


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


@pytest.fixture(scope="module")
def beams():
    csv = helpers.linear_csv(5)
    jm, tm = JBeam(csv), tcrt.DynamicEulerBernoulliBeam(csv)
    n = tm.n_pos_states
    q0 = np.zeros(n)
    q0[-2] = 1e-4
    u = np.zeros(n)
    u[-2] = 0.01
    return jm, tm, q0, u


def _jax_adaptive(jm, q0, u, t_eval, E=None, **kw):
    arrays = jm.beam_model.arrays
    if E is not None:
        arrays = dataclasses.replace(arrays, elastic_modulus=E * jnp.ones(5))
    op = js.make_traced_genalpha_operator(jm.beam_model.bc_info, arrays, dt=1e-4, rho_inf=RHO)
    return ji.integrate_generalized_alpha_adaptive(op, jnp.asarray(q0), jnp.zeros(q0.size),
                                                   t_eval, u=jnp.asarray(u),
                                                   rho_inf=RHO, **kw)


def test_adaptive_matches_host_prefactored(beams):
    """The traced operator under adaptive gen-alpha: the port's
    host-prefactored ``"btd"`` operator (rtol 1e-9, counts equal, the JAX
    test's pairing) and the JAX package's traced run (1e-10)."""
    jm, tm, q0, u = beams
    n = q0.size
    t_eval = np.linspace(0.0, 5e-3, 4)
    kw = dict(u=_t(u), rho_inf=RHO, rtol=1e-6, atol=1e-9)
    op = ts.make_traced_genalpha_operator(tm.beam_model.bc_info, tm.beam_model.arrays,
                                          dt=1e-4, rho_inf=RHO, device="cpu")
    assert op.tangent_frozen  # all-linear, modified Newton
    qs, _, st = ti.integrate_generalized_alpha_adaptive(op, _t(q0), torch.zeros(n, dtype=F64),
                                                        t_eval, **kw)
    op_h = tcrt.make_newmark_operator(tm, dt=None, linear_solver="btd", device="cpu")
    qs_h, _, st_h = ti.integrate_generalized_alpha_adaptive(
        op_h, _t(q0), torch.zeros(n, dtype=F64), t_eval, **kw)
    np.testing.assert_allclose(qs.numpy(), qs_h.numpy(), rtol=1e-9, atol=1e-15)
    assert int(st.n_accepted) == int(st_h.n_accepted) and int(st.n_incomplete) == 0
    qs_j, _, st_j = jax.jit(lambda: _jax_adaptive(jm, q0, u, t_eval, rtol=1e-6,
                                                  atol=1e-9))()
    assert int(st.n_accepted) == int(st_j.n_accepted)
    assert float(np.abs(qs.numpy() - np.asarray(qs_j)).max()) <= 1e-10 * float(
        np.abs(np.asarray(qs_j)).max())


def test_forward_sensitivities_through_adaptive(beams):
    """Forward mode through the error-controlled engine (its host reads of
    the loop flag see the primal): the tangent of the realized step
    sequence, as the JAX package's ``jax.jvp``."""
    jm, tm, q0, u = beams
    n = q0.size
    t_eval = np.linspace(0.0, 5e-3, 3)
    E0, h = 75e9, 75e9 * 1e-5
    with fwAD.dual_level():
        E = fwAD.make_dual(_t([E0 - h, E0, E0 + h]), _t([0.0, 1.0, 0.0]))
        arr = ts.override_arrays(tm.beam_model.arrays, elastic_modulus=E[:, None])
        op = ts.make_traced_genalpha_operator(tm.beam_model.bc_info, arr, dt=1e-4,
                                              rho_inf=RHO)
        qs, _, st = ti.integrate_generalized_alpha_adaptive(
            op, _t(q0).expand(3, n), torch.zeros(3, n, dtype=F64), t_eval, u=_t(u),
            rho_inf=RHO, rtol=1e-7, atol=1e-10, per_env=True)
        tip, tangent = fwAD.unpack_dual(qs[-1, :, -2])
    g = float(tangent[1])

    def tip_j(E):
        return _jax_adaptive(jm, q0, u, t_eval, E=E, rtol=1e-7, atol=1e-10)[0][-1, -2]

    value_j, g_j = jax.jit(lambda e: jax.jvp(tip_j, (e,), (jnp.asarray(1.0),)))(
        jnp.asarray(E0))
    assert abs(float(tip[1]) - float(value_j)) <= 1e-10 * abs(float(value_j))
    assert abs(g - float(g_j)) <= 1e-9 * abs(float(g_j))
    fd = float(tip[2] - tip[0]) / (2 * h)
    assert abs(g - fd) / abs(fd) < 1e-6
    assert int(st.n_incomplete.max()) == 0

"""The port's ``system_identification`` example against the JAX package.

The 4-segment cantilever's tip trace through ``parallel.sweep``'s
``parametric_rollout`` and ``override_arrays`` over a shortened span: the
observed trace to 1e-10, the loss and d loss / d log E to 1e-8 relative at
the JAX script's start point (a 40% misestimate of E), and five
``torch.optim.Adam`` iterates to five ``optax.adam`` ones (learning rate
3e-2, optax's betas and eps) to 1e-8, all float64 on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax

import continuum_robot_tpu as jcrt
from continuum_robot_tpu.parallel.sweep import override_arrays as joverride_arrays
from continuum_robot_tpu.parallel.sweep import parametric_rollout as jparametric_rollout
from continuum_robot_tpu_torch.examples import example_utilities as ex
from continuum_robot_tpu_torch.examples import system_identification

RTOL = 1e-10


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale or (scale == 0 and err == 0), (err, scale)


# ---------------------------------------------------------------------------
# system_identification
# ---------------------------------------------------------------------------

SYSID = dict(t_final=0.002, dt=2e-4, substeps=5)
SYSID_RTOL = 1e-8


def jax_sysid():
    """The JAX script's loss (``examples/system_identification.py:48-90``)."""
    f = ex.create_csv_file(["linear"] * 4, ["FIXED"] + ["NONE"] * 3)
    try:
        model = jcrt.DynamicEulerBernoulliBeam(f)
    finally:
        ex.cleanup_temp_files(f)
    bc_info, arrays, n = model.beam_model.bc_info, model.beam_model.arrays, model.n_pos_states
    x0 = jnp.zeros((1, 2 * n))
    imp = jnp.zeros(n).at[-2].set(0.1)

    def u(t):
        return jnp.where(t < 0.002, imp, jnp.zeros_like(imp))

    def tip_trace(log_E):
        batch = joverride_arrays(arrays, elastic_modulus=jnp.exp(log_E)[None, None])
        _, ys = jparametric_rollout(bc_info, batch, x0, SYSID["t_final"], SYSID["dt"], u=u,
                                    substeps=SYSID["substeps"])
        return ys[:, 0, n - 2]

    def loss(log_E, y_obs, scale):
        trace = tip_trace(log_E)
        return jnp.mean(((trace - y_obs) / scale) ** 2), trace

    # One compiled program gives the observed trace (the aux output at the
    # true E) and every value and gradient after it.
    # (Arguments strongly typed float64 throughout: a weakly typed scalar
    # would compile a second program.)
    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    zeros = jnp.zeros(int(round(SYSID["t_final"] / SYSID["dt"])) + 1)
    (_, y_obs), _ = value_and_grad(jnp.float64(math.log(system_identification.TRUE_E)),
                                   zeros, jnp.float64(1.0))
    scale = jnp.abs(y_obs).max()

    def vg(log_E):
        (v, _), g = value_and_grad(jnp.float64(log_E), y_obs, scale)
        return v, g

    return np.asarray(y_obs), vg


def test_system_identification_matches_jax():
    y_obs, value_and_grad = jax_sysid()
    iters = 5
    got = system_identification.run(iters=iters, **SYSID, device="cpu")
    close(got["y_obs"], y_obs)
    log_E = jnp.log(jnp.asarray(0.6 * system_identification.TRUE_E))
    opt = optax.adam(system_identification.LEARNING_RATE)
    state = opt.init(log_E)
    for it in range(iters):
        v, g = value_and_grad(log_E)
        mine_v, mine_g = got["history"][it]
        assert math.isclose(mine_v, float(v), rel_tol=SYSID_RTOL), (it, mine_v, float(v))
        assert math.isclose(mine_g, float(g), rel_tol=SYSID_RTOL), (it, mine_g, float(g))
        updates, state = opt.update(g, state)
        log_E = optax.apply_updates(log_E, updates)
        assert math.isclose(got["log_E_path"][it], float(log_E), rel_tol=SYSID_RTOL), it
    assert math.isclose(got["log_E"], float(log_E), rel_tol=SYSID_RTOL)

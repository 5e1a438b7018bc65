"""Full-order implicit rollouts of the PyTorch port against the JAX package.

``simulate(method="newmark"|"generalized_alpha")`` on 8-element linear,
parity-nonlinear, consistent-nonlinear and hybrid beams, both packages
built from one CSV and fed the same NumPy initial states and input force
(float64, CPU). Every ``linear_solver`` mode of the port ("btd", "cr",
"dense_inv" and "pallas", whose kernel runs its plain version on CPU
tensors) is held to the JAX package's block-Thomas rollout at 1e-10
relative.
"""

import numpy as np
import pytest

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
from continuum_robot_tpu.models import simulate as jsim
from tests import helpers

RTOL = 1e-10
FRAME_DT, N_FRAMES, SUBSTEPS = 1e-4, 4, 2

BEAMS = {
    "linear": (helpers.linear_csv, False),
    "nonlinear": (helpers.nonlinear_csv, False),
    "consistent": (helpers.nonlinear_csv, True),
    "hybrid": (helpers.mixed_csv, False),
}


@pytest.mark.parametrize("method", ["newmark", "generalized_alpha"])
@pytest.mark.parametrize("kind", list(BEAMS))
def test_rollout_matches_jax(kind, method):
    make_csv, consistent = BEAMS[kind]
    csv = make_csv(8)
    jm = jcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent)
    tm = tcrt.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent)
    n = jm.n_pos_states
    rng = np.random.default_rng(0)
    x0 = np.zeros((3, 2 * n))
    x0[:, :n] = rng.normal(scale=1e-5, size=(3, n))
    x0[:, n:] = rng.normal(scale=1e-3, size=(3, n))
    u = np.zeros(n)
    u[-2] = 0.1
    kw = dict(method=method, u=u, substeps=SUBSTEPS, rho_inf=0.6)
    ref = np.asarray(jsim.simulate(jm, x0, N_FRAMES * FRAME_DT, FRAME_DT,
                                   linear_solver="btd", **kw).ys)
    scale = np.abs(ref).max()
    for solver in ("btd", "cr", "dense_inv", "pallas"):
        res = tcrt.simulate(tm, x0, N_FRAMES * FRAME_DT, FRAME_DT, linear_solver=solver,
                            device="cpu", **kw)
        assert res.ys.shape == ref.shape and res.ts.shape == (N_FRAMES + 1,)
        np.testing.assert_allclose(res.ys.numpy(), ref, rtol=0, atol=RTOL * scale,
                                   err_msg=f"linear_solver={solver}")

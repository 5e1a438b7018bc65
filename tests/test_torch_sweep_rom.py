"""The port's frozen-basis ROM rollout (``parametric_modal_rom_rollout``)
against the JAX package.

``tests/test_sweep.py``'s ``TestParametricModalROM`` on its beams (40 and 20
von Karman elements without fluid, 16 and 8 modes, float64, CPU): the
gradient in an elastic-modulus scale against ``jax.grad`` (1e-9) and the
JAX test's central difference (1e-6), remat against plain (rtol 1e-10) in a
density scale, and the ``save_every`` frames (the JAX package's vmapped
layout, 1e-10). The port rolls out the JAX engine's bases, so the two hold
one reduced model; the JAX references are jitted on two threads while the
port's cases run.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu.models import DynamicEulerBernoulliBeam as JBeam
from continuum_robot_tpu.models.simulate import make_modal_rom as j_make_modal_rom
from continuum_robot_tpu.parallel import sweep as js
from continuum_robot_tpu_torch.parallel import sweep as ts

CPU = "cpu"
F64 = torch.float64


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


def _rom(n_el, modes, tip):
    csv = helpers.nonlinear_csv(n_el, include_fluid=False)
    jm, tm = JBeam(csv), tcrt.DynamicEulerBernoulliBeam(csv)
    jms = j_make_modal_rom(jm, 1e-4, rho_inf=0.5, n_modes=modes)
    u = np.zeros(jm.n_pos_states)
    u[-2] = tip
    frozen = types.SimpleNamespace(Phi=np.asarray(jms.Phi), PhiW=np.asarray(jms.PhiW),
                                   dt=jms.dt)
    return dict(jm=jm, tm=tm, jms=jms, frozen=frozen, u_m=np.asarray(jms.project_force_host(u)))


class Case:
    def __init__(self):
        self.rom = {"grad": _rom(40, 16, 2.0), "remat": _rom(20, 8, 1.0)}
        self.eta_frames = np.random.default_rng(3).normal(
            scale=1e-6, size=(2, self.rom["remat"]["jms"].n_modes))


def _j_rom_loss(c, key):
    r = c.rom[key]
    jm, m = r["jm"], r["jms"].n_modes
    arrays = jm.beam_model.arrays
    eta0 = jnp.zeros((1, m))

    def loss(scale):
        if key == "grad":
            E = float(np.asarray(arrays.elastic_modulus)[0])
            arrs = js.override_arrays(arrays, elastic_modulus=(scale * E) * jnp.ones((1, 1)))
            kw = dict(n_steps=50, n_newton=2)
        else:
            arrs = js.override_arrays(arrays, density=scale * jnp.asarray(
                np.asarray(arrays.density)[None, :]))
            kw = dict(n_steps=20)
        eta, _ = js.parametric_modal_rom_rollout(r["jms"], jm.beam_model.bc_info, arrs, eta0,
                                                 eta0, u_modal=r["u_m"], **kw)
        return jnp.sum(eta ** 2) * 1e6

    return loss


def _j_rom_frames(c):
    r = c.rom["remat"]
    out = jax.jit(lambda b, e: js.parametric_modal_rom_rollout(
        r["jms"], r["jm"].beam_model.bc_info, b, e, jnp.zeros_like(e), u_modal=r["u_m"],
        n_steps=20, save_every=5))(js.tile_arrays(r["jm"].beam_model.arrays, 2),
                                   jnp.asarray(c.eta_frames))
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def case():
    c = Case()
    grad = lambda loss: float(jax.jit(jax.grad(loss))(jnp.asarray(1.0)))  # noqa: E731
    pool = ThreadPoolExecutor(2)  # XLA compiles off the GIL
    c.refs = {"rom_grad": pool.submit(grad, _j_rom_loss(c, "grad")),
              "rom_remat": pool.submit(grad, _j_rom_loss(c, "remat")),
              "rom_frames": pool.submit(_j_rom_frames, c)}
    yield c
    pool.shutdown(wait=True, cancel_futures=True)


def ref(c, name):
    return c.refs[name].result()


# ---------------------------------------------------------------------------
# The frozen-basis ROM rollout
# ---------------------------------------------------------------------------


def _rom_loss(case, key, remat=False):
    r = case.rom[key]
    tm, m = r["tm"], r["jms"].n_modes
    arrays = tm.beam_model.arrays
    eta0 = torch.zeros(1, m, dtype=F64)

    def loss(scale):
        if key == "grad":
            E = float(np.asarray(arrays.elastic_modulus)[0])
            arrs = ts.override_arrays(arrays, elastic_modulus=(scale * E) * torch.ones(
                1, 1, dtype=F64))
            kw = dict(n_steps=50, n_newton=2)
        else:
            arrs = ts.override_arrays(arrays, density=scale * _t(
                np.asarray(arrays.density)[None, :]))
            kw = dict(n_steps=20, remat=remat)
        eta, _ = ts.parametric_modal_rom_rollout(r["frozen"], tm.beam_model.bc_info, arrs,
                                                 eta0, eta0, u_modal=r["u_m"], **kw)
        return (eta ** 2).sum() * 1e6

    return loss


def test_rom_grad_matches_finite_difference(case):
    loss = _rom_loss(case, "grad")
    g = _grad(loss, 1.0)
    fd = _fd(loss, 1.0, 1e-5)
    assert abs(g - fd) / abs(fd) < 1e-6, f"grad {g} vs fd {fd}"
    g_ref = ref(case, "rom_grad")
    assert abs(g - g_ref) <= 1e-9 * abs(g_ref)


def test_rom_remat_matches_plain(case):
    """Checkpointed steps: the plain gradient (rtol 1e-10) and the JAX
    package's; and every frame of ``save_every`` (the JAX vmapped layout)
    equal to the JAX package's."""
    g_plain = _grad(_rom_loss(case, "remat"), 1.0)
    g_remat = _grad(_rom_loss(case, "remat", remat=True), 1.0)
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-10)
    r = case.rom["remat"]
    eta0 = _t(case.eta_frames)
    etas, etads = ts.parametric_modal_rom_rollout(
        r["frozen"], r["tm"].beam_model.bc_info, ts.tile_arrays(r["tm"].beam_model.arrays, 2,
                                                                device=CPU),
        eta0, torch.zeros_like(eta0), u_modal=r["u_m"], n_steps=20, save_every=5)
    assert etas.shape == (2, 4, r["jms"].n_modes)
    want = ref(case, "rom_frames")
    assert _rel(etas, want[0]) <= 1e-10 and _rel(etads, want[1]) <= 1e-10
    g_ref = ref(case, "rom_remat")
    assert abs(g_plain - g_ref) <= 1e-9 * abs(g_ref)

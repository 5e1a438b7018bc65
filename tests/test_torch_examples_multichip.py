"""The port's ``multichip_beam`` example against the JAX package.

The example's rank body runs on a gloo world of 2 CPU ranks (dp x sp = 1 x
2) with a 16-element beam, shortened spans and a 12-mode ROM; while the
ranks run, the test process computes the JAX script's same calls
(``examples/multichip_beam.py:75-228``) on the conftest's fake CPU mesh,
devices ``[:2]`` as a 1 x 2 mesh, jitted. Both packages get one ROM basis
(the JAX package's), so eigensolver signs decide nothing. Each tier's tip
values agree to 1e-9 of their scale (float64; the sharded sums run in
another order), SDIRK3 takes the same accepted and rejected steps, the ECSW
sample and the audit's flags are equal, and the sharded system
identification's secant iterate agrees to 1e-9.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuum_robot_tpu as jcrt
from continuum_robot_tpu.models.simulate import make_modal_rom as jmake_modal_rom
from continuum_robot_tpu.parallel import (
    build_spatial_genalpha as jbuild_genalpha,
    build_spatial_modal_rom as jbuild_modal_rom,
    build_spatial_sdirk3 as jbuild_sdirk3,
    make_mesh as jmake_mesh,
    make_spatial_beam as jmake_spatial_beam,
    spatial_rollout as jspatial_rollout,
)
from continuum_robot_tpu_torch.examples import multichip_beam as mb
from continuum_robot_tpu_torch.parallel import collectives

N_EL, DP, SP = 16, 1, 2
SPANS = dict(explicit_t=2e-6, explicit_dt=1e-6, explicit_substeps=2, ga_frames=2,
             sdirk_t=5e-5, rom_frames=4, guard_frames=2, sysid_frames=2, sysid_iters=2,
             rom_modes=12)
RTOL = 1e-9
TIMEOUT = 240.0  # s: a hang fails the module instead of stalling the suite
JAX_THREADS = 2  # the JAX references are compiled two at a time


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale or (scale == 0 and err == 0), (err, scale)


def jax_setup(model):
    """The JAX script's mesh, spatial beam, tip node, tip load and start."""
    mesh = jmake_mesh({"dp": DP, "sp": SP}, devices=jax.devices()[:DP * SP])
    beam = jmake_spatial_beam(model.beam_model.arrays,
                              model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    Np, tip = beam.n_nodes, beam.n_nodes_real - 1
    u = np.zeros((Np, 3))
    u[tip, 1] = 0.5
    return mesh, beam, tip, jnp.asarray(u), jnp.zeros((2, 2, Np, 3))


def jax_implicit_tiers(model, basis):
    """The explicit, implicit and error-controlled tiers
    (``examples/multichip_beam.py:99-131``) at :data:`SPANS`, every sharded
    call jitted (eager shard_map runs ~40x slower)."""
    _, beam, tip, u_j, x0 = jax_setup(model)
    out = {}
    _, xs = jax.jit(lambda x: jspatial_rollout(beam, x, SPANS["explicit_t"],
                                               SPANS["explicit_dt"], u=u_j,
                                               substeps=SPANS["explicit_substeps"]))(x0)
    out["explicit_tip"] = np.asarray(xs)[-1, :, 0, tip, 1]
    rollout_ga = jbuild_genalpha(beam, 1e-5, rho_inf=0.8, n_newton=1)
    _, xs = jax.jit(lambda x: rollout_ga(x, SPANS["ga_frames"], u=u_j, substeps=20))(x0)
    out["genalpha_tip"] = np.asarray(xs)[-1, :, 0, tip, 1]
    rollout_s3 = jbuild_sdirk3(beam, n_newton=2)
    t_eval = np.linspace(0.0, SPANS["sdirk_t"], 5)
    xs, stats = jax.jit(lambda x: rollout_s3(x, t_eval, u=u_j, rtol=1e-6, atol=1e-9))(x0)
    out["sdirk3_tip"] = np.asarray(xs)[-1, :, 0, tip, 1]
    out["sdirk3_accepted"] = np.asarray(stats.n_accepted)
    out["sdirk3_rejected"] = np.asarray(stats.n_rejected)
    return out


def jax_rom_tier(model, basis):
    """The reduced-order tier with its ECSW audit (``:133-183``)."""
    mesh, _, tip, _, _ = jax_setup(model)
    out = {}
    sm = jbuild_modal_rom(model, mesh, 1e-5, rho_inf=0.5, n_modes=SPANS["rom_modes"],
                          basis=basis)
    n = model.n_pos_states
    u_red = np.zeros(n)
    u_red[-2] = 0.5
    u_m = jnp.asarray(sm.ms.project_force_host(u_red))
    z = jnp.zeros((1, sm.n_modes))
    _, etas_tr, _ = jax.jit(lambda z, u: sm.rollout_frames(
        z, z, u, SPANS["rom_frames"], substeps=10, n_newton=2))(z, u_m)
    out["rom_training_tip_modal"] = np.asarray(etas_tr[-1, 0])
    red, info = sm.hyper_reduce(np.asarray(etas_tr[::2, 0, :]), tau=1e-3, return_info=True)
    guarded = jax.jit(lambda e, ed, u: red.rollout_frames_guarded(
        e, ed, u, SPANS["guard_frames"], substeps=10))
    _, es, eds, guard = guarded(etas_tr[-1, 0], jnp.zeros(sm.n_modes), u_m)
    out["ecsw_sampled"] = int(info["n_sampled"])
    out["ecsw_train_residual"] = float(info["train_residual"])
    out["guard_max_residual"] = float(guard["max_residual"])
    out["guard_flagged"] = bool(guard["flagged"])
    u_bad = np.zeros(n)
    u_bad[1] = 0.5
    _, _, _, g_bad = guarded(z[0], z[0], jnp.asarray(sm.ms.project_force_host(u_bad)))
    out["outside_max_residual"] = float(g_bad["max_residual"])
    out["outside_flagged"] = bool(g_bad["flagged"])
    qs, _ = jax.jit(red.physical_frames)(es, eds)
    out["rom_tip"] = float(qs[-1, tip, 1])
    return out


def jax_sysid_tier(model, basis):
    """The differentiable tier's secant iteration (``:192-228``)."""
    _, beam, tip, u_j, _ = jax_setup(model)
    rollout_ga = jbuild_genalpha(beam, 1e-5, rho_inf=0.8, n_newton=1)
    x1 = jnp.zeros((2, beam.n_nodes, 3))
    arrs0 = jax.tree_util.tree_map(jnp.asarray, beam.arrays)
    E0 = jnp.asarray(beam.arrays.elastic_modulus)

    def tip_trace(s):
        arrs = dataclasses.replace(arrs0, elastic_modulus=s * E0)
        _, xs = rollout_ga(x1, SPANS["sysid_frames"], u=u_j, substeps=5, arrays=arrs)
        return xs[:, 0, tip, 1]

    target = jax.jit(tip_trace)(jnp.asarray(1.0))

    @jax.jit
    def loss_grad(s):
        def loss(s):
            d = tip_trace(s) - target
            return jnp.sum(d * d) / jnp.sum(target * target)
        return jax.value_and_grad(loss)(s)

    s_prev, s = 0.7, 0.8
    g_prev = float(loss_grad(jnp.asarray(s_prev))[1])
    for _ in range(SPANS["sysid_iters"]):
        g = float(loss_grad(jnp.asarray(s))[1])
        if g == g_prev or abs(g) < 1e-18:
            break
        s, s_prev, g_prev = s - g * (s - s_prev) / (g - g_prev), s, g
    return {"sysid_scale": s, "sysid_loss": float(loss_grad(jnp.asarray(s))[0])}


@pytest.fixture(scope="module")
def runs():
    model = jcrt.DynamicEulerBernoulliBeam(mb.make_long_beam(N_EL).params.copy())
    ms = jmake_modal_rom(model, 1e-5, rho_inf=0.5, n_modes=SPANS["rom_modes"])
    basis = (np.asarray(ms.Phi), np.asarray(ms.PhiW))
    world = collectives.start(mb.rank_main, DP * SP, DP, SP, N_EL, SPANS, False, basis,
                              timeout=TIMEOUT, device="cpu")
    want = {}
    with ThreadPoolExecutor(JAX_THREADS) as pool:  # XLA compiles off the GIL
        for part in pool.map(lambda f: f(model, basis),
                             (jax_sysid_tier, jax_implicit_tiers, jax_rom_tier)):
            want.update(part)
    got = world.result()
    return got, want


TIERS = {
    "explicit": ("explicit_tip",),
    "genalpha": ("genalpha_tip",),
    "sdirk3": ("sdirk3_tip",),
    "rom": ("rom_training_tip_modal", "guard_max_residual", "outside_max_residual",
            "rom_tip"),
    "sysid": ("sysid_scale", "sysid_loss"),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_multichip_tier_matches_jax(runs, tier):
    got, want = runs
    for rank in got:
        for key in TIERS[tier]:
            close(rank[key], want[key])


def test_multichip_counts_and_flags_match_jax(runs):
    got, want = runs
    for rank in got:
        np.testing.assert_array_equal(rank["sdirk3_accepted"], want["sdirk3_accepted"])
        np.testing.assert_array_equal(rank["sdirk3_rejected"], want["sdirk3_rejected"])
        assert rank["ecsw_sampled"] == want["ecsw_sampled"]
        close(rank["ecsw_train_residual"], want["ecsw_train_residual"], rtol=1e-8)
        assert rank["guard_flagged"] is want["guard_flagged"] is False
        assert rank["outside_flagged"] is want["outside_flagged"] is True


def test_multichip_refuses_the_cpu_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.run(1, 2, N_EL, spans=SPANS)

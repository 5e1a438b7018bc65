"""The differentiable sharded path of the port against the JAX package.

One gloo world of 2 CPU ranks (``torch_parallel_cases.run_cases``, an
``sp = 2`` mesh) runs every case; the test process computes the JAX
package's references on its fake CPU mesh at the same shard count (jitted,
two threads, while the ranks run). The cases are ``tests/test_sharding.py``'s
``TestSpatialParametric`` on its 14-element hybrid beam, float64:

* ``arrays=beam.arrays`` as tensors reproduces the baked-constant span with
  drag and gravity (the JAX test's 1e-14 x max(scale, 1));
* reverse mode through the fixed-step SPIKE rollout with respect to a scale
  on the elastic modulus and on the density: the JAX package's
  ``jax.grad`` (1e-9) and central differences (rtol 2e-5, the JAX test's);
* forward mode (``torch.autograd.forward_ad``) through the adaptive
  generalized-alpha and SDIRK3 engines: ``jax.jvp`` (1e-9) and central
  differences (rtol 1e-4, the JAX test's);
* ``simulate_sharded(arrays=...)`` on fixed-step and adaptive gen-alpha,
  ``chunk=`` included, against the baked run;

and the collectives' backward and tangent on 2 ranks against their closed
forms. The world has a 240 s limit.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import helpers
import torch_parallel_cases as cases
from continuum_robot_tpu_torch.parallel import collectives

N_RANKS = 2
SP2 = {"sp": 2}
FRAMES, SUBSTEPS, H = 2, 4, 1e-5
T_EVAL = np.linspace(0.0, 4e-4, 3)


def _specs():
    csv = helpers.mixed_csv(14)
    specs = {"collectives": dict(case="collectives_grad_case", mesh=SP2),
             "traced": dict(case="traced_genalpha_case", mesh=SP2, csv=csv, frames=3,
                            substeps=4, fluid=1000.0, gravity=(0.0, -9.81, 0.0))}
    for field in ("elastic_modulus", "density"):
        specs[f"grad_{field}"] = dict(case="traced_grad_case", mesh=SP2, csv=csv, field=field,
                                      frames=FRAMES, substeps=SUBSTEPS, h=H)
    specs["facade"] = dict(case="facade_arrays_case", mesh=SP2, csv=csv)
    for engine in ("genalpha", "sdirk3"):
        specs[f"jvp_{engine}"] = dict(case="traced_jvp_case", mesh=SP2, csv=csv,
                                      engine=engine, t_eval=T_EVAL, h=H)
    return specs


@pytest.fixture(scope="module")
def world():
    specs = _specs()
    w = collectives.start(cases.run_cases, N_RANKS, specs, timeout=240.0, device="cpu")
    try:
        with ThreadPoolExecutor(2) as pool:  # XLA compiles off the GIL
            futs = {name: pool.submit(fn, specs[name]) for name, fn in _jax_refs().items()}
            refs = {name: f.result() for name, f in futs.items()}
    except BaseException:
        w.kill()
        raise
    return specs, w.result(), refs


# ---------------------------------------------------------------------------
# The JAX package's side
# ---------------------------------------------------------------------------


def _jax_setup(csv, builder):
    import jax
    import jax.numpy as jnp

    from continuum_robot_tpu import parallel as jpar
    from continuum_robot_tpu.models import DynamicEulerBernoulliBeam

    model = DynamicEulerBernoulliBeam(csv)
    mesh = jpar.make_mesh(dict(SP2), devices=jax.devices()[:2])
    beam = jpar.make_spatial_beam(model.beam_model.arrays,
                                  model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    roll = builder(jpar, beam)
    tip = beam.n_nodes_real - 1
    u = np.zeros((beam.n_nodes, 3))
    u[tip, 1] = 0.05
    arrs0 = jax.tree_util.tree_map(jnp.asarray, beam.arrays)
    return jax, jnp, beam, roll, jnp.asarray(u), tip, arrs0


def _jax_grad(spec):
    import dataclasses

    jax, jnp, beam, roll, u, tip, arrs0 = _jax_setup(
        spec["csv"], lambda jpar, b: jpar.build_spatial_genalpha(b, 1e-4, rho_inf=0.8,
                                                                 n_newton=1))
    x0 = jnp.zeros((2, beam.n_nodes, 3))
    base = getattr(arrs0, spec["field"])

    def loss(s):
        arrs = dataclasses.replace(arrs0, **{spec["field"]: s * base})
        _, xs = roll(x0, FRAMES, u=u, substeps=SUBSTEPS, arrays=arrs)
        return jnp.sum(xs[-1, 0, tip]) * 1e3

    return float(jax.jit(jax.grad(loss))(jnp.asarray(1.0)))


def _jax_jvp(spec):
    import dataclasses

    genalpha = spec["engine"] == "genalpha"
    jax, jnp, beam, roll, u, tip, arrs0 = _jax_setup(
        spec["csv"],
        lambda jpar, b: (jpar.build_spatial_genalpha_adaptive(b, rho_inf=0.9, n_newton=2)
                         if genalpha else jpar.build_spatial_sdirk3(b, n_newton=2)))
    x0 = jnp.zeros((2, beam.n_nodes, 3))

    def tip_at_end(s):
        arrs = dataclasses.replace(arrs0, elastic_modulus=s * arrs0.elastic_modulus)
        xs, _ = roll(x0, T_EVAL, u=u, rtol=1e-7, atol=1e-10, arrays=arrs)
        return xs[-1, 0, tip, 1] * 1e3

    value, g = jax.jit(lambda s: jax.jvp(tip_at_end, (s,), (jnp.asarray(1.0),)))(
        jnp.asarray(1.0))
    return float(value), float(g)


def _jax_refs():
    return {"grad_elastic_modulus": _jax_grad, "grad_density": _jax_grad,
            "jvp_genalpha": _jax_jvp, "jvp_sdirk3": _jax_jvp}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def test_collectives_backward_and_tangent(world):
    """ppermute's backward is the inverse permutation, psum's a psum,
    all_gather's a reduce-scatter; each tangent is the collective of the
    tangent; a loss computed alike from ``gather_out`` of a
    ``replicated_in`` input has the whole gradient on every rank."""
    _, ranks, _ = world
    outs = [r["collectives"] for r in ranks]
    S = len(outs)
    for k, o in enumerate(outs):
        np.testing.assert_array_equal(o["ppermute"], outs[(k + 1) % S]["w"])
        np.testing.assert_array_equal(o["psum"], sum(p["w"] for p in outs))
        np.testing.assert_array_equal(o["all_gather"], sum(p["W"][k] for p in outs))
        np.testing.assert_array_equal(o["ppermute_jvp"], outs[(k - 1) % S]["t"])
        np.testing.assert_array_equal(o["psum_jvp"], sum(p["t"] for p in outs))
        np.testing.assert_array_equal(o["all_gather_jvp"], np.stack([p["t"] for p in outs]))
        ramp = np.arange(1.0, 2 * S + 1)
        assert float(o["boundary"]) == pytest.approx(float(np.sum(ramp * ramp ** 2 * 2 * 1.5)),
                                                     rel=1e-15)


def test_traced_arrays_reproduce_baked(world):
    """arrays=beam.arrays (tensors) == the baked-constant path, with drag
    and gravity."""
    _, ranks, _ = world
    out = ranks[0]["traced"]
    scale = max(float(np.abs(out["baked"]).max()), 1.0)
    np.testing.assert_allclose(out["traced"], out["baked"], rtol=0, atol=1e-14 * scale)
    np.testing.assert_array_equal(ranks[1]["traced"]["traced"], out["traced"])


@pytest.mark.parametrize("field", ["elastic_modulus", "density"])
def test_grad_through_spike_matches_jax_and_fd(world, field):
    """Autograd through the sharded SPIKE rollout (the mass bands are traced
    too, so the density gradient is live): ``jax.grad``'s value on every
    rank, and the central difference."""
    _, ranks, refs = world
    name = f"grad_{field}"
    g_ref = refs[name]
    for r in ranks:
        g = float(r[name]["g"])
        assert np.isfinite(g) and abs(g) > 0
        assert abs(g - g_ref) <= 1e-9 * abs(g_ref)
        np.testing.assert_allclose(g, float(r[name]["fd"]), rtol=2e-5)


@pytest.mark.parametrize("engine", ["genalpha", "sdirk3"])
def test_forward_mode_through_adaptive_engines(world, engine):
    """Forward mode through the error-controlled sharded engines:
    ``jax.jvp``'s tangent and value, and the central difference."""
    _, ranks, refs = world
    value_ref, g_ref = refs[f"jvp_{engine}"]
    for r in ranks:
        out = r[f"jvp_{engine}"]
        assert abs(float(out["value"]) - value_ref) <= 1e-10 * abs(value_ref)
        g = float(out["g"])
        assert np.isfinite(g) and abs(g) > 0
        assert abs(g - g_ref) <= 1e-9 * abs(g_ref)
        np.testing.assert_allclose(g, float(out["fd"]), rtol=1e-4)


def test_simulate_sharded_takes_arrays(world):
    """``simulate_sharded(arrays=...)`` on fixed-step and adaptive gen-alpha
    (``chunk=`` on the latter) reproduces the baked run (the JAX test's
    1e-14 x max(scale, 1))."""
    _, ranks, _ = world
    for method, (baked, traced) in ranks[0]["facade"].items():
        scale = max(float(np.abs(baked).max()), 1.0)
        assert float(np.abs(traced - baked).max()) <= 1e-14 * scale, method

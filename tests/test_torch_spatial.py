"""The node-sharded tier of the port against the JAX package.

One gloo world of 4 CPU ranks runs every case of this module
(``torch_parallel_cases.run_cases``) on a 4-shard ``sp`` mesh and on a
2 x 2 ``dp x sp`` mesh; the test process holds the results against the
JAX package at the same shard count (its fake 8-device CPU mesh, devices
``[:S]``; computed, jitted, while the ranks run), against the port's
single-device ``simulate()`` (the slower runs made by single ranks after
the sharded cases) and, for SPIKE, against a dense solve.
Float64, inputs from NumPy seeds. Tolerances, relative to the scale of
what is compared:

* RHS with a fixed CG count, fixed-step gen-α: 1e-10 of the JAX package
  (the same operations in another order); SPIKE: 1e-10 of the dense solve;
* CG with a tolerance stop: 100 ``cg_tol`` (a relative-residual stop at
  ``cg_tol = 1e-10`` bounds the solve's error by the mass matrix's
  conditioning times ``cg_tol``);
* adaptive gen-α and SDIRK3: equal accept/reject counts and 1e-9 of the
  JAX package;
* against ``simulate()``: 1e-8 (gen-α) and the JAX package's own bounds
  (RK4 through CG: 5e-7; adaptive: 1e-5, counts equal).

The world has a 240 s limit: a hang fails the module instead of stalling
the suite.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch as tcrt
import helpers
import torch_parallel_cases as cases
from continuum_robot_tpu_torch.parallel import collectives

N_RANKS = 4
JAX_THREADS = 2  # the JAX references are compiled two at a time
SP4 = {"sp": 4}
DPSP = {"dp": 2, "sp": 2}
FORCES = dict(fluid_density=1000.0, gravity=(2.0, -9.81, 0.0))


def n_pad(n_el, S):
    return -(-(n_el + 1) // S) * S


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _node(model_free, Np, x_red):
    """Reduced ``[q; v]`` (..., 2n) -> node layout (..., 2, Np, 3)."""
    n = x_red.shape[-1] // 2
    out = np.zeros(x_red.shape[:-1] + (2, Np * 3))
    out[..., 0, model_free] = x_red[..., :n]
    out[..., 1, model_free] = x_red[..., n:]
    return out.reshape(x_red.shape[:-1] + (2, Np, 3))


def _specs():
    rng = np.random.default_rng(0)
    specs, meta = {}, {}

    def free_of(csv):
        return np.asarray(tcrt.DynamicEulerBernoulliBeam(csv).beam_model.bc_info.free_dofs)

    for n_el in (6, 16):
        csv = helpers.linear_csv(n_el)
        Np = n_pad(n_el, 4)
        mask = np.zeros(Np * 3)
        mask[free_of(csv)] = 1.0
        x = rng.normal(scale=1e-4, size=(2, Np * 3)) * mask
        specs[f"rhs_lin{n_el}"] = dict(case="rhs_case", mesh=SP4, csv=csv,
                                      x=x.reshape(2, Np, 3), cg_iters=40)
    csv = helpers.mixed_csv(10)
    Np = n_pad(10, 2)
    mask = np.zeros(Np * 3)
    mask[free_of(csv)] = 1.0
    x = np.stack([rng.normal(scale=s, size=(2, Np * 3)) * mask for s in (1e-3, 0.05, 0.3)])
    specs["rhs_forces"] = dict(case="rhs_case", mesh=DPSP, csv=csv,
                               x=x.reshape(3, 2, Np, 3), cg_iters=40, with_nf=True,
                               **FORCES)
    csv = helpers.linear_csv(14)
    Np = n_pad(14, 4)
    mask = np.zeros(Np * 3)
    mask[free_of(csv)] = 1.0
    x = (rng.normal(scale=1e-4, size=(2, Np * 3)) * mask).reshape(2, Np, 3)
    specs["rhs_tol"] = dict(case="rhs_case", mesh=SP4, csv=csv, x=x, cg_iters=64,
                            cg_tol=1e-10)
    specs["rhs_fixed64"] = dict(case="rhs_case", mesh=SP4, csv=csv, x=x, cg_iters=64)
    Np2 = n_pad(14, 2)
    mask2 = np.zeros(Np2 * 3)
    mask2[free_of(csv)] = 1.0
    x2 = (rng.normal(scale=1e-4, size=(3, 2, Np2 * 3)) * mask2).reshape(3, 2, Np2, 3)
    specs["rhs_cap"] = dict(case="rhs_info_case", mesh=DPSP, csv=csv, x=x2, cg_iters=2,
                            cg_tol=1e-12)
    specs["rhs_conv"] = dict(case="rhs_info_case", mesh=DPSP, csv=csv, x=x2, cg_iters=64,
                             cg_tol=1e-8)

    csv = helpers.linear_csv(10)
    n = len(free_of(csv)) // 1
    x0 = np.zeros((2, 2 * n))
    x0[0, n - 2] = 1e-4
    x0[1, n - 1] = -2e-4
    specs["rk4"] = dict(case="spatial_rollout_case", mesh=DPSP, csv=csv, x0=x0,
                        kw=dict(t_final=2e-4, dt=1e-4, substeps=2, cg_iters=40,
                                cg_stats=True))

    csv = helpers.linear_csv(14)
    Np = n_pad(14, 4)
    mask = np.zeros(Np * 3)
    mask[free_of(csv)] = 1.0
    specs["spike"] = dict(case="spike_case", mesh=SP4, csv=csv,
                          r=(rng.normal(size=Np * 3) * mask).reshape(Np, 3))

    for name, kind, mesh in (("ga_lin", "linear", DPSP), ("ga_hyb", "hybrid", SP4)):
        csv = helpers.linear_csv(14) if kind == "linear" else helpers.mixed_csv(14)
        free = free_of(csv)
        n = len(free)
        Np = n_pad(14, mesh["sp"])
        x_red = rng.normal(scale=1e-4, size=(3, 2 * n))
        u_red = np.zeros(n)
        u_red[-2] = 0.1
        specs[name] = dict(case="genalpha_case", mesh=mesh, csv=csv,
                           x_node=_node(free, Np, x_red), u_node=_node(free, Np, np.r_[
                               u_red, np.zeros(n)])[0], dt=1e-4, n_frames=4, substeps=3,
                           chunk_at=2)
        meta[name] = dict(x_red=x_red, u_red=u_red)

    csv = helpers.mixed_csv(14)
    free = free_of(csv)
    n = len(free)
    Np = n_pad(14, 4)
    x_red = np.zeros(2 * n)
    x_red[n:] = rng.normal(scale=0.05, size=n)
    u_red = np.zeros(n)
    u_red[-2] = 0.1
    u_node = _node(free, Np, np.r_[u_red, np.zeros(n)])[0]
    specs["ga_forces"] = dict(case="genalpha_case", mesh=SP4, csv=csv,
                              x_node=_node(free, Np, x_red), u_node=u_node, dt=1e-4,
                              n_frames=3, substeps=2, with_nf=True, engine_kw=FORCES)

    csv = helpers.linear_csv(14)
    free = free_of(csv)
    n = len(free)
    Np = n_pad(14, 4)
    u_red = np.zeros(n)
    u_red[-2] = 0.1
    u_node = _node(free, Np, np.r_[u_red, np.zeros(n)])[0]
    t_eval = np.linspace(0.0, 5e-4, 3)
    for eng, kw in (("genalpha", dict(rho_inf=0.9, n_newton=2)), ("sdirk3", dict(n_newton=2))):
        specs[f"ad_{eng}"] = dict(case="adaptive_case", mesh=SP4, csv=csv,
                                  x_node=np.zeros((2, Np, 3)), u_node=u_node, t_eval=t_eval,
                                  engine=eng, engine_kw=kw)
    meta["ad"] = dict(u_red=u_red, t_eval=t_eval)
    # Two environments of very different energy: per-environment step control.
    Np2 = n_pad(14, 2)
    x_red = rng.normal(scale=1e-6, size=2 * n)
    xb = np.zeros((2, 2 * n))
    xb[0, :n] = x_red[:n]
    xb[1, :n] = 1e1 * x_red[:n]
    specs["ad_batched"] = dict(case="adaptive_case", mesh=DPSP, csv=csv,
                               x_node=_node(free, Np2, xb), u_node=None,
                               t_eval=np.linspace(0.0, 1.5e-4, 3), engine="genalpha",
                               engine_kw=dict(rho_inf=0.9), rtol=1e-4, atol=1e-10)
    # SDIRK3 with drag, gravity and a nodewise force on a hybrid beam.
    csv = helpers.mixed_csv(14)
    free = free_of(csv)
    n = len(free)
    x_red = np.zeros(2 * n)
    x_red[n:] = rng.normal(scale=0.02, size=n)
    specs["sd_forces"] = dict(case="adaptive_case", mesh=SP4, csv=csv,
                              x_node=_node(free, Np, x_red),
                              u_node=_node(free, Np, np.r_[u_red, np.zeros(n)])[0],
                              t_eval=np.linspace(0.0, 1.5e-4, 3), engine="sdirk3",
                              engine_kw=dict(n_newton=2, **FORCES), with_nf=True)

    csv = helpers.write_beam_csv(["linear"] * 240)
    n = len(free_of(csv))
    x0 = np.zeros(2 * n)
    x0[n - 2] = 2e-4
    u = np.zeros(n)
    u[n - 2] = 0.05
    specs["big_ga"] = dict(case="simulate_sharded_case", mesh=SP4, csv=csv, x0=x0,
                           kw=dict(t_final=4e-4, dt=2e-4, method="generalized_alpha", u=u,
                                   substeps=2, rho_inf=0.8, n_newton=2))
    specs["big_sdirk3"] = dict(case="simulate_sharded_case", mesh=SP4, csv=csv, x0=x0,
                               kw=dict(t_final=2e-4, dt=2e-4, method="sdirk3", rtol=1e-5,
                                       atol=1e-8))

    # The port's single-device references, each run by one rank after the
    # sharded cases (while the JAX references compile here).
    for rank, (name, solver) in enumerate((("big_ga", "btd"), ("big_sdirk3", "dense_inv")),
                                          start=1):
        specs[name + "_ref"] = dict(case="simulate_case", rank=rank, csv=csv, x0=x0,
                                    kw=dict(specs[name]["kw"], linear_solver=solver))
    for name, method in (("ad_genalpha", "generalized_alpha_adaptive"),
                         ("ad_sdirk3", "sdirk3")):
        spec = specs[name]
        n = len(free_of(spec["csv"]))
        te = meta["ad"]["t_eval"]
        specs[name + "_ref"] = dict(
            case="simulate_case", rank=3, csv=spec["csv"], x0=np.zeros(2 * n),
            kw=dict(t_final=float(te[-1]), dt=float(te[1]), method=method,
                    u=meta["ad"]["u_red"], rtol=1e-6, atol=1e-9, n_newton=2,
                    linear_solver="dense_inv", **({"rho_inf": 0.9} if name == "ad_genalpha"
                                                  else {})))
    return specs, meta


@pytest.fixture(scope="module")
def world():
    """The ranks' results, and the JAX package's references (computed while
    the ranks run)."""
    specs, meta = _specs()
    w = collectives.start(cases.run_cases, N_RANKS, specs, timeout=240.0, device="cpu")
    try:
        with ThreadPoolExecutor(JAX_THREADS) as pool:  # XLA compiles off the GIL
            futs = {name: pool.submit(fn, specs[name]) for name, fn in _jax_refs().items()}
            refs = {name: f.result() for name, f in futs.items()}
    except BaseException:
        w.kill()
        raise
    return specs, meta, w.result(), refs


# ---------------------------------------------------------------------------
# The JAX package's side (every call jitted: eager shard_map is slow)
# ---------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    import continuum_robot_tpu as jcrt
    from continuum_robot_tpu import parallel as jpar

    return jax, jnp, jcrt, jpar


def _jax_beam(csv, mesh_sizes, forces=None):
    jax, _, jcrt, jpar = _jax()
    n_dev = int(np.prod(list(mesh_sizes.values())))
    mesh = jpar.make_mesh(dict(mesh_sizes), devices=jax.devices()[:n_dev])
    fp = None if forces is None else jcrt.ForceParams(**forces)
    model = jcrt.DynamicEulerBernoulliBeam(csv, fp)
    beam = jpar.make_spatial_beam(model.beam_model.arrays,
                                  model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    return model, mesh, beam


def _jax_node_force():
    _, jnp, _, _ = _jax()

    def nf(x, t):
        q, v = x[0], x[1]
        return jnp.zeros_like(q).at[:, 1].set(
            -cases.K_W * q[:, 1] - cases.C_W * v[:, 1] + cases.AMP * jnp.sin(cases.OMEGA * t))

    return nf


def _jax_rhs(spec):
    jax, jnp, _, jpar = _jax()
    _, _, beam = _jax_beam(spec["csv"], spec["mesh"])
    rhs = jpar.build_spatial_rhs(
        beam, cg_iters=spec.get("cg_iters", 40), cg_tol=spec.get("cg_tol"),
        fluid_density=spec.get("fluid_density"), gravity=spec.get("gravity"),
        node_force=_jax_node_force() if spec.get("with_nf") else None)
    x = jnp.asarray(spec["x"])
    if x.ndim == 4:
        return np.asarray(jax.jit(jax.vmap(lambda xe: rhs(0.0, xe)))(x))
    return np.asarray(jax.jit(lambda xe: rhs(0.0, xe))(x))


def _jax_rk4(spec):
    jax, jnp, _, jpar = _jax()
    model, _, beam = _jax_beam(spec["csv"], spec["mesh"])
    xn = jpar.reduced_to_node_layout(model, jnp.asarray(spec["x0"]), beam.n_nodes)
    _, xs, st = jax.jit(lambda x: jpar.spatial_rollout(beam, x, **spec["kw"]))(xn)
    return np.asarray(xs), np.asarray(st["cg_incomplete"]), st["cg_evals"]


def _jax_genalpha(spec):
    jax, jnp, _, jpar = _jax()
    _, _, beam = _jax_beam(spec["csv"], spec["mesh"])
    kw = dict(spec.get("engine_kw") or {})
    if spec.get("with_nf"):
        kw["node_force"] = _jax_node_force()
    roll = jpar.build_spatial_genalpha(beam, spec["dt"], rho_inf=0.8, n_newton=2, **kw)
    _, xs = jax.jit(lambda x: roll(x, spec["n_frames"], u=spec["u_node"],
                                   substeps=spec["substeps"]))(jnp.asarray(spec["x_node"]))
    return np.asarray(xs)


def _jax_adaptive(spec):
    jax, jnp, _, jpar = _jax()
    _, _, beam = _jax_beam(spec["csv"], spec["mesh"])
    kw = dict(spec["engine_kw"])
    if spec.get("with_nf"):
        kw["node_force"] = _jax_node_force()
    build = (jpar.build_spatial_genalpha_adaptive if spec["engine"] == "genalpha"
             else jpar.build_spatial_sdirk3)
    u = None if spec["u_node"] is None else jnp.asarray(spec["u_node"])
    roll = build(beam, **kw)
    xs, stats = jax.jit(lambda x: roll(x, spec["t_eval"], u=u, rtol=spec.get("rtol", 1e-6),
                                       atol=spec.get("atol", 1e-9)))(
        jnp.asarray(spec["x_node"]))
    return np.asarray(xs), [np.asarray(c) for c in stats[:4]]


def _jax_refs():
    refs = {name: _jax_rhs for name in
            ("rhs_lin6", "rhs_lin16", "rhs_forces", "rhs_fixed64", "rhs_tol")}
    refs.update(rk4=_jax_rk4, ga_lin=_jax_genalpha, ga_forces=_jax_genalpha)
    refs.update({name: _jax_adaptive for name in ("ad_batched", "sd_forces")})
    return refs


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rhs_lin6", "rhs_lin16", "rhs_forces", "rhs_fixed64"])
def test_rhs_matches_jax(world, name):
    _, _, ranks, refs = world
    out = ranks[0][name]
    assert _rel(out, refs[name]) <= 1e-10
    for r in ranks[1:]:  # the same global result on every rank
        np.testing.assert_array_equal(r[name], out)


def test_rhs_tolerance_stop(world):
    """The tolerance-stopped CG lands on the converged solve (JAX test
    ``test_cg_tol_matches_fixed_iters``), and on the JAX package's."""
    specs, _, ranks, refs = world
    out = ranks[0]["rhs_tol"]
    bound = 100 * specs["rhs_tol"]["cg_tol"]
    assert _rel(out, ranks[0]["rhs_fixed64"]) < bound
    assert _rel(out, refs["rhs_tol"]) < bound


def test_rhs_matches_dense_rhs(world):
    """The sharded RHS is the port's reduced-coordinate RHS, node by node."""
    specs, _, ranks, _ = world
    spec = specs["rhs_lin16"]
    model = tcrt.DynamicEulerBernoulliBeam(spec["csv"])
    free = np.asarray(model.beam_model.bc_info.free_dofs)
    nf = model.beam_model.bc_info.n_dofs_full
    x = spec["x"].reshape(2, -1)
    x_red = torch.as_tensor(np.r_[x[0, free], x[1, free]])
    dx = model.build_rhs()(0.0, x_red, None).numpy()
    out = ranks[0]["rhs_lin16"].reshape(2, -1)
    n = len(free)
    scale = np.abs(dx).max()
    assert np.abs(out[0, free] - dx[:n]).max() <= 1e-8 * scale
    assert np.abs(out[1, free] - dx[n:]).max() <= 1e-6 * scale
    assert np.all(out[:, nf:] == 0.0)


def test_cg_incomplete_flags(world):
    r = world[2][0]
    np.testing.assert_array_equal(r["rhs_cap"]["info"], np.ones(3))
    np.testing.assert_array_equal(r["rhs_conv"]["info"], np.zeros(3))
    assert _rel(r["rhs_cap"]["out"], r["rhs_conv"]["out"]) > 1e-6


def test_rk4_rollout_matches_jax_and_simulate(world):
    specs, _, ranks, refs = world
    spec = specs["rk4"]
    out = ranks[0]["rk4"]
    xs, n_inc, n_evals = refs["rk4"]
    assert out["xs"].shape == xs.shape and xs.shape[:3] == (3, 2, 2)
    assert _rel(out["xs"], xs) <= 1e-9
    np.testing.assert_array_equal(out["stats"]["cg_incomplete"], n_inc)
    assert out["stats"]["cg_evals"] == n_evals == 16  # 2 frames x 2 substeps x 4 stages
    tm = tcrt.DynamicEulerBernoulliBeam(spec["csv"])
    free = np.asarray(tm.beam_model.bc_info.free_dofs)
    kw = spec["kw"]
    res = tcrt.simulate(tm, spec["x0"], kw["t_final"], kw["dt"], method="rk4",
                        substeps=kw["substeps"], device="cpu")
    n = len(free)
    q = out["xs"][:, :, 0].reshape(3, 2, -1)[..., free]
    ys = res.ys.numpy()
    assert np.abs(q - ys[..., :n]).max() <= 5e-7 * np.abs(ys[..., :n]).max()


def test_spike_solves_match_dense(world):
    """Each local solver's SPIKE solve on 4 shards equals the dense solve
    of the BC-masked operator (the JAX test ``test_spike_solve_matches_dense``)."""
    from scipy.linalg import solve as dense_solve

    specs, _, ranks, _ = world
    spec = specs["spike"]
    model = tcrt.DynamicEulerBernoulliBeam(spec["csv"])
    beam_arrays, Np = cases.tpar.spatial.pad_arrays_for_shards(model.beam_model.arrays, 4)
    mdiag, moff = cases.assembly.mass_block_tridiagonal(beam_arrays)
    mdiag, moff = np.asarray(mdiag)[:Np], np.asarray(moff)[: Np - 1]
    mask = np.zeros((Np, 3))
    mask[: model.beam_model.arrays.n_elements + 1] = model.beam_model.bc_info.free_mask.reshape(
        -1, 3)
    T = np.zeros((3 * Np, 3 * Np))
    for i in range(Np):
        mi = np.diag(mask[i])
        T[3 * i:3 * i + 3, 3 * i:3 * i + 3] = mi @ mdiag[i] @ mi + np.diag(1.0 - mask[i])
    for i in range(Np - 1):
        mi, mj = np.diag(mask[i]), np.diag(mask[i + 1])
        T[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6] = mi @ moff[i] @ mj
        T[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = mj @ moff[i].T @ mi
    x_dense = dense_solve(T, spec["r"].reshape(-1)).reshape(Np, 3)
    for solver, x in ranks[0]["spike"].items():
        assert _rel(x, x_dense) < 1e-10, solver


def _reduced(xs, free):
    """Node-layout frames (..., 2, Np, 3) -> reduced (..., 2n)."""
    lead = xs.shape[:-3]
    q = xs[..., 0, :, :].reshape(*lead, -1)[..., free]
    v = xs[..., 1, :, :].reshape(*lead, -1)[..., free]
    return np.concatenate([q, v], axis=-1)


@pytest.mark.parametrize("name", ["ga_lin", "ga_forces"])
def test_genalpha_matches_jax(world, name):
    """Fixed-step SPIKE gen-alpha against the JAX package's at the same
    shard count: a batch on the 2 x 2 mesh (envs split over dp), and drag,
    gravity and a nodewise force on a hybrid beam at 4 shards."""
    _, _, ranks, refs = world
    assert _rel(ranks[0][name]["xs"], refs[name]) <= 1e-10


@pytest.mark.parametrize("name", ["ga_lin", "ga_hyb"])
def test_genalpha_matches_simulate(world, name):
    """The port's single-device implicit gen-alpha: the same recurrence."""
    specs, meta, ranks, _ = world
    spec = specs[name]
    tm = tcrt.DynamicEulerBernoulliBeam(spec["csv"])
    free = np.asarray(tm.beam_model.bc_info.free_dofs)
    h = spec["dt"] * spec["substeps"]
    res = tcrt.simulate(tm, meta[name]["x_red"], spec["n_frames"] * h, h,
                        method="generalized_alpha", u=meta[name]["u_red"], rho_inf=0.8,
                        n_newton=2, substeps=spec["substeps"], linear_solver="btd",
                        device="cpu")
    assert _rel(_reduced(ranks[0][name]["xs"], free), res.ys.numpy()) <= 1e-8


@pytest.mark.parametrize("name", ["ga_lin", "ga_hyb"])
def test_genalpha_carry_is_exact(world, name):
    """A span driven as two calls through the carry is the one-call span,
    bit for bit, frame times included."""
    out = world[2][0][name]
    np.testing.assert_array_equal(out["chunked"], out["xs"])
    np.testing.assert_array_equal(out["chunked_ts"], out["ts"])


@pytest.mark.parametrize("name", ["ad_batched", "sd_forces"])
def test_adaptive_matches_jax_counts(world, name):
    """Adaptive gen-alpha (two envs on 2 x 2, each with its own step) and
    SDIRK3 with drag, gravity and a nodewise force (4 shards): the JAX
    package's accept/reject counts, state within 1e-9."""
    _, _, ranks, refs = world
    out = ranks[0][name]
    xs, counts = refs[name]
    for got, ref in zip(out["stats"][:4], counts):
        np.testing.assert_array_equal(got, ref)
    assert _rel(out["xs"], xs) <= 1e-9
    assert np.all(out["stats"][3] == 0)


def test_adaptive_batched_steps_per_env(world):
    """Each environment of a batch takes its own steps (the JAX package's
    vmap): two envs of different energy accept different counts."""
    acc = world[2][0]["ad_batched"]["stats"][1]
    assert acc.shape == (2,) and acc[0] != acc[1]


@pytest.mark.parametrize("name,method", [("ad_genalpha", "generalized_alpha_adaptive"),
                                         ("ad_sdirk3", "sdirk3")])
def test_adaptive_matches_simulate(world, name, method):
    """The sharded controller takes the decisions of the port's
    single-device engine (same estimate, psum-contracted norm)."""
    specs, _, ranks, _ = world
    spec = specs[name]
    out = ranks[0][name]
    tm = tcrt.DynamicEulerBernoulliBeam(spec["csv"])
    free = np.asarray(tm.beam_model.bc_info.free_dofs)
    ref = ranks[3][name + "_ref"]
    assert specs[name + "_ref"]["kw"]["method"] == method
    assert int(out["stats"][1]) == int(ref["stats"].n_accepted)
    assert int(out["stats"][2]) == int(ref["stats"].n_rejected)
    assert _rel(_reduced(out["xs"], free), ref["ys"]) < 1e-5


@pytest.mark.parametrize("name", ["big_ga", "big_sdirk3"])
def test_240_elements_at_4_shards(world, name):
    """61 nodes a shard: partition bookkeeping at a realistic size, held to
    the port's simulate() (the JAX test ``TestShardedScaleParity``)."""
    specs, _, ranks, _ = world
    out = ranks[0][name]
    ref_spec = specs[name + "_ref"]
    res = ranks[ref_spec["rank"]][name + "_ref"]
    assert ref_spec["kw"]["linear_solver"] == ("btd" if name == "big_ga" else "dense_inv")
    assert _rel(out["ys"], res["ys"]) <= (1e-8 if name == "big_ga" else 1e-7)
    if name == "big_sdirk3":
        for got, want in zip(out["stats"][:4], res["stats"][:4]):
            assert int(got) == int(want)

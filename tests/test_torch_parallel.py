"""The port's parallel runtime and ``simulate_sharded`` on 2 gloo ranks.

One world of 2 CPU ranks runs every case: the collectives on a
1-D mesh (ring ``ppermute`` both ways, a partial perm, ``psum``,
``all_gather``, environment blocks), ``make_mesh``'s validation,
``batched_rollout(mesh=)`` over ``dp`` (a DTensor; ``sweep_statistics`` of
it global), the dry run, and ``simulate_sharded`` on a 2-shard ``sp`` mesh
for every method. The facade is held to the JAX package's
``simulate_sharded`` on 2 devices (computed while the ranks run) and to the
port's ``simulate()``. Float64; tolerances relative to the state's scale:

* fixed-step gen-α, the modal methods: 1e-10 of the JAX package, 1e-9 of
  ``simulate()`` (the JAX test's bound);
* RK4 through the CG mass solve (``cg_tol=1e-8``): 1e-6 of ``simulate()``
  (the JAX test's bound; ``test_torch_spatial.py`` holds the RK4 tier to
  the JAX package);
* adaptive methods: equal counts and 1e-9 of the JAX package; ``chunk=``
  bit for bit the one-call run.

The world has a 180 s limit. Also here: the launcher's own contract (a
failing rank and a time limit raise and leave no rank behind).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch as tcrt
import helpers
import torch_parallel_cases as cases
from continuum_robot_tpu_torch.models.simulate import PiecewiseConstant
from continuum_robot_tpu_torch.parallel import collectives

N_RANKS = 2
JAX_THREADS = 2  # the JAX references are compiled two at a time
SP2 = {"sp": 2}
DP2 = {"dp": 2}


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _specs():
    specs, meta = {}, {}
    specs["coll_sp"] = dict(case="collectives_case", mesh=SP2)
    specs["coll_dp"] = dict(case="collectives_case", mesh=DP2)
    specs["mesh_error"] = dict(case="mesh_error_case", mesh=DP2)
    csv_l = helpers.linear_csv(6)
    n_l = tcrt.DynamicEulerBernoulliBeam(csv_l).n_pos_states
    xb = np.zeros((5, 2 * n_l))
    xb[:, n_l - 2] = np.linspace(1e-4, 2e-3, 5)
    meta["batched"] = dict(csv=csv_l, x0=xb, t_final=0.003, dt=1e-3,
                           kw=dict(method="modal", substeps=10))
    specs["batched"] = dict(case="batched_rollout_case", mesh=DP2, csv=csv_l, x0=xb,
                            kw=dict(t_final=0.003, dt=1e-3, method="modal", substeps=10))
    specs["dryrun"] = dict(case="dryrun_case", mesh=DP2)

    csv = helpers.mixed_csv(14)
    n = tcrt.DynamicEulerBernoulliBeam(csv).n_pos_states
    x0 = np.zeros(2 * n)
    x0[n - 2] = 2e-4
    u = np.zeros(n)
    u[n - 2] = 0.05
    xb = np.zeros((2, 2 * n))
    xb[0, n - 2], xb[1, n - 2] = 2e-4, 4e-4
    fp = dict(fluid_density=1000.0, enable_fluid_effects=True,
              gravity_vector=[0.0, -9.81, 0.0], enable_gravity_effects=True)

    def fac(name, x, kw, **extra):
        specs[name] = dict(case="simulate_sharded_case", mesh=SP2, csv=csv, x0=x, kw=kw,
                           **extra)

    fac("ga", x0, dict(t_final=4e-4, dt=1e-4, method="generalized_alpha", u=u, substeps=4,
                       rho_inf=0.8, n_newton=2))
    fac("ga_auto", x0, dict(t_final=2e-4, dt=1e-4, method="generalized_alpha", substeps=2),
        forces=fp)
    fac("ga_explicit", x0, dict(t_final=2e-4, dt=1e-4, method="generalized_alpha",
                                substeps=2, fluid_density=1000.0, gravity=(0.0, -9.81, 0.0)))
    fac("ga_cr", x0, dict(t_final=4e-4, dt=1e-4, method="generalized_alpha", u=u,
                          substeps=4, rho_inf=0.8, n_newton=2, local_solver="cr"))
    fac("ga_dense", x0, dict(t_final=4e-4, dt=1e-4, method="generalized_alpha", u=u,
                             substeps=4, rho_inf=0.8, n_newton=2, local_solver="dense"))
    fac("rk4_nf", x0, dict(t_final=2e-4, dt=1e-4, method="rk4", u=u, substeps=2),
        with_nf=True)
    fac("ad", xb, dict(t_final=4e-4, dt=2e-4, method="generalized_alpha_adaptive",
                       rtol=1e-5, atol=1e-8, rho_inf=0.9), also_chunk=1)
    fac("sd_nf", x0, dict(t_final=2e-4, dt=1e-4, method="sdirk3", u=u, rtol=1e-5,
                          atol=1e-8), with_nf=True, also_chunk=1)

    rng = np.random.default_rng(0)
    xl = rng.normal(scale=1e-4, size=(3, 2 * n))
    ul = np.zeros(n)
    ul[n - 2] = 0.1
    csv_lin = helpers.linear_csv(14)
    for name, eng in (("modal", "xla"), ("modal_pallas", "pallas"), ("modal_power", "power")):
        specs[name] = dict(case="simulate_sharded_case", mesh=SP2, csv=csv_lin, x0=xl,
                           kw=dict(t_final=4e-4, dt=1e-4, method="modal", u=ul, substeps=4,
                                   rho_inf=0.9, engine=eng))
    pwc = PiecewiseConstant(breaks=np.array([2e-4]), values=np.stack([ul, -0.5 * ul]))
    specs["modal_pwc"] = dict(case="simulate_sharded_case", mesh=SP2, csv=csv_lin, x0=xl[0],
                              kw=dict(t_final=6e-4, dt=1e-4, method="modal", u=pwc,
                                      substeps=8, rho_inf=0.9, engine="power"))
    specs["modal_damped"] = dict(case="simulate_sharded_case", mesh=SP2, csv=csv_lin,
                                 x0=xl[0], kw=dict(t_final=4e-4, dt=1e-4, method="modal",
                                                   substeps=4, rayleigh=(4.0, 1e-7)))
    fac("rom", xl, dict(t_final=4e-4, dt=1e-4, method="modal_rom", u=u, substeps=4,
                        rho_inf=0.8, n_newton=2, n_modes=12))
    fac("rom_ad", x0, dict(t_final=4e-4, dt=2e-4, method="modal_rom_adaptive", rtol=1e-5,
                           atol=1e-10))
    fac("rom_forced", x0, dict(t_final=4e-4, dt=1e-4, method="modal_rom", substeps=4),
        forces=dict(enable_gravity_effects=True, gravity_vector=[0.0, -9.81, 0.0]))

    z = np.zeros(2 * n)
    specs["contracts"] = dict(case="error_contracts_case", mesh=SP2, csv=csv, calls=[
        dict(method="lsoda"),
        dict(u=cases.const_force),
        dict(x0=np.zeros((2, 2, 2 * n))),
        dict(u=np.zeros(3)),
        dict(method="rk4", arrays=object()),
        dict(method="rk4", local_solver="cr"),
        dict(method="generalized_alpha", chunk=2),
        dict(method="generalized_alpha", rayleigh=(1.0, 0.0)),
        dict(method="generalized_alpha", engine="pallas"),
        dict(method="modal", engine="magic"),
        dict(method="modal_rom", engine="pallas"),
        dict(method="modal_rom", fluid_density=1000.0),
        dict(method="modal_rom", node_force=cases.node_force),
        dict(method="modal_rom", use_consistent=True),
        dict(method="generalized_alpha", local_solver="lu"),
        dict(x0=z, method="generalized_alpha"),
    ])
    return specs, meta


def _jax_facade(name, spec):
    import jax
    import jax.numpy as jnp

    import continuum_robot_tpu as jcrt
    from continuum_robot_tpu import parallel as jpar

    forces = spec.get("forces")
    model = jcrt.DynamicEulerBernoulliBeam(
        spec["csv"], None if forces is None else jcrt.ForceParams(**forces))
    mesh = jpar.make_mesh(dict(spec["mesh"]), devices=jax.devices()[:2])
    kw = dict(spec["kw"])
    t_final, dt = kw.pop("t_final"), kw.pop("dt")
    if spec.get("with_nf"):
        def nf(x, t):
            q, v = x[0], x[1]
            return jnp.zeros_like(q).at[:, 1].set(
                -cases.K_W * q[:, 1] - cases.C_W * v[:, 1]
                + cases.AMP * jnp.sin(cases.OMEGA * t))

        kw["node_force"] = nf
    if kw.get("u") is not None:
        kw["u"] = jnp.asarray(kw["u"])

    x0 = jnp.asarray(spec["x0"])
    if kw["method"].startswith("modal"):
        return _jax_modal(jpar, model, mesh, x0, t_final, dt, kw)

    def run(x):
        res = jpar.simulate_sharded(model, x, t_final, dt, mesh, **kw)
        return res.ys, res.stats

    ys, stats = jax.jit(run)(x0)
    if stats is not None and not isinstance(stats, dict):
        stats = [np.asarray(s) for s in stats[:4]]
    return np.asarray(ys), stats


def _jax_modal(jpar, model, mesh, x0, t_final, dt, kw):
    """The JAX facade's modal path with its host setup outside ``jax.jit``
    (the engines' eigensolves are host NumPy) and its rollout inside."""
    import jax
    import jax.numpy as jnp

    method, sub = kw["method"], kw.get("substeps", 1)
    h = dt / sub
    build = jpar.build_spatial_modal if method == "modal" else jpar.build_spatial_modal_rom
    eng = build(model, mesh, h, rho_inf=kw.get("rho_inf", 0.8), n_modes=kw.get("n_modes"))
    n_frames = int(round(t_final / dt))
    u_m = None if kw.get("u") is None else jnp.asarray(eng.ms.project_force_host(kw["u"]))
    xn = jpar.reduced_to_node_layout(model, x0, eng.n_nodes)
    stats = None

    def run(xn):
        eta, etad = eng.to_modal(xn)
        if method == "modal_rom_adaptive":
            te = np.linspace(0.0, t_final, n_frames + 1)
            es, eds, st = eng.rollout_adaptive(eta, etad, u_m, te, rtol=kw["rtol"],
                                               atol=kw["atol"], n_newton=2)
        else:
            extra = {} if method == "modal" else dict(n_newton=kw.get("n_newton", 2))
            _, es, eds = eng.rollout_frames(eta, etad, u_m, n_frames, substeps=sub, **extra)
            st = None
        qs, vs = eng.ms.from_modal(es, eds)
        return jnp.concatenate([qs, vs], axis=-1), st

    ys, stats = jax.jit(run)(xn)
    if ys.ndim == 3:
        ys = jnp.moveaxis(ys, 1, 0)
    if stats is not None:
        stats = [np.asarray(s) for s in stats[:4]]
    return np.asarray(ys), stats


JAX_CASES = ("ga", "ad", "sd_nf", "modal", "rom", "rom_ad")


@pytest.fixture(scope="module")
def world():
    specs, meta = _specs()
    w = collectives.start(cases.run_cases, N_RANKS, specs, timeout=180.0, device="cpu")
    try:
        with ThreadPoolExecutor(JAX_THREADS) as pool:  # XLA compiles off the GIL
            futs = {name: pool.submit(_jax_facade, name, specs[name]) for name in JAX_CASES}
            refs = {name: f.result() for name, f in futs.items()}
    except BaseException:
        w.kill()
        raise
    return specs, meta, w.result(), refs


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["coll_sp", "coll_dp"])
def test_collectives(world, axis):
    ranks = world[2]
    name = axis.split("_")[1]
    for r in range(N_RANKS):
        c = ranks[r][axis][name]
        assert c["index"] == r and c["size"] == 2 and c["ranks"] == [0, 1]
        other = 1 - r
        np.testing.assert_array_equal(c["right"], [other, 10.0 * other, 1.0])
        np.testing.assert_array_equal(c["left"], [other, 10.0 * other, 1.0])
        # A perm that names only (0 -> 1): rank 1 receives, rank 0 gets zeros.
        np.testing.assert_array_equal(c["first_only"], [0.0, 0.0, 1.0] if r else np.zeros(3))
        np.testing.assert_array_equal(c["psum"], [1.0, 10.0, 2.0])
        np.testing.assert_array_equal(c["gather"], [[0.0, 0.0, 1.0], [1.0, 10.0, 1.0]])
        np.testing.assert_array_equal(c["env_block"], [0.0, 1.0, 2.0] if r == 0 else
                                      [3.0, 4.0, 4.0])
        np.testing.assert_array_equal(c["gathered_envs"], np.arange(5.0))


def test_self_permute_is_a_copy():
    """On one position (no peer) a ring ppermute returns the payload
    itself, without a process group."""
    ax = collectives.MeshAxis(None, "sp")
    x = torch.arange(3.0)
    for perm in (collectives.right_perm(1), collectives.left_perm(1)):
        y = collectives.ppermute(x, ax, perm)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(collectives.psum(x, ax), x)
    assert torch.equal(collectives.all_gather(x, ax), x[None])


def test_make_mesh_validates_world_size(world):
    assert world[2][0]["mesh_error"] == "Mesh axes {'dp': 3, 'sp': 5} need 15 devices, got 2"


def test_batched_rollout_on_a_mesh(world):
    """``batched_rollout(mesh=)``: a DTensor split over dp (5 envs: chunks
    of 3 and 2) equal to the one-device rollout, statistics global."""
    specs, meta, ranks, _ = world
    m = meta["batched"]
    model = tcrt.DynamicEulerBernoulliBeam(m["csv"])
    ref = tcrt.parallel.batched_rollout(model, m["x0"], m["t_final"], m["dt"],
                                        device="cpu", **m["kw"])
    stats = tcrt.parallel.sweep_statistics(ref.ys)
    for r in range(N_RANKS):
        out = ranks[r]["batched"]
        assert out["local_shape"] == (4, 3 - r, ref.ys.shape[-1])
        assert out["placements"] == "(Shard(dim=1),)"
        np.testing.assert_array_equal(out["ys"], ref.ys.numpy())
        np.testing.assert_array_equal(out["ts"], ref.ts.numpy())
        for key, val in stats.items():
            assert out["stats"][key] == pytest.approx(float(val), rel=1e-14), key


def test_dryrun(world):
    out = world[2][0]["dryrun"]
    assert (out["dp"], out["sp"]) == (1, 2)
    assert np.isfinite(out["state_rms"]) and out["accepted_adaptive"] > 0
    assert out["accepted_sdirk3"] > 0


def test_launcher_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        collectives.launch(cases.fail_on_rank, 2, 1, timeout=60.0, device="cpu")


@pytest.mark.parametrize("entry", ["launch", "start", "dryrun_multichip"])
def test_launcher_defaults_to_the_cards(entry):
    """With no device named the ranks go on the cards: without one the
    launcher raises ``resolve_device``'s error and starts no rank."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default world would run on it")
    call = {"launch": lambda: collectives.launch(cases.fail_on_rank, 2, 1, timeout=5.0),
            "start": lambda: collectives.start(cases.fail_on_rank, 2, 1, timeout=5.0),
            "dryrun_multichip": lambda: tcrt.parallel.dryrun_multichip(2, timeout=5.0)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()


def test_destroy_removes_the_store():
    """A one-rank world's store lives in a temporary directory of its own,
    which destroy_process_group removes with the group."""
    import os

    import torch.distributed as dist

    collectives.init_process_group("cpu")
    store_dir = collectives._own_store_dir
    try:
        assert store_dir is not None and os.path.isdir(store_dir)
    finally:
        collectives.destroy_process_group()
    assert not os.path.exists(store_dir) and not dist.is_initialized()
    assert collectives._own_store_dir is None


def test_launcher_time_limit():
    with pytest.raises(TimeoutError, match="did not finish within"):
        collectives.launch(cases.sleep_case, 1, 60.0, timeout=1.0, device="cpu")


# ---------------------------------------------------------------------------
# simulate_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JAX_CASES)
def test_simulate_sharded_matches_jax(world, name):
    _, _, ranks, refs = world
    out = ranks[0][name]
    ys, stats = refs[name]
    assert out["ys"].shape == ys.shape
    tol = 1e-9 if name in ("ad", "sd_nf", "rom_ad") else 1e-10
    assert _rel(out["ys"], ys) <= tol
    if name in ("ad", "sd_nf", "rom_ad"):
        for got, want in zip(out["stats"][:4], stats):
            np.testing.assert_array_equal(got, want)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name]["ys"], out["ys"])


def _simulate(spec, **over):
    forces = spec.get("forces")
    model = tcrt.DynamicEulerBernoulliBeam(
        spec["csv"], None if forces is None else tcrt.ForceParams(**forces))
    kw = dict(spec["kw"], **over)
    t_final, dt = kw.pop("t_final"), kw.pop("dt")
    for key in ("local_solver", "fluid_density", "gravity"):
        kw.pop(key, None)
    if spec.get("with_nf"):
        kw["forces_func"] = cases.forces_func(model)
    res = tcrt.simulate(model, spec["x0"], t_final, dt, device="cpu", **kw)
    ys = res.ys.numpy()
    return (np.moveaxis(ys, 1, 0) if ys.ndim == 3 else ys), res


@pytest.mark.parametrize("name,tol", [
    ("ga", 1e-9), ("ga_cr", 1e-9), ("ga_dense", 1e-9), ("rk4_nf", 1e-6),
    ("modal", 1e-9), ("modal_pallas", 1e-9), ("modal_power", 1e-9), ("modal_pwc", 1e-9),
    ("modal_damped", 1e-9), ("rom", 1e-9), ("rom_forced", 1e-9)])
def test_simulate_sharded_matches_simulate(world, name, tol):
    """Every method against the port's single-device simulate() (each
    local solver, engine and force dial)."""
    specs, _, ranks, _ = world
    ys, _ = _simulate(specs[name])
    assert ranks[0][name]["ys"].shape == ys.shape
    assert _rel(ranks[0][name]["ys"], ys) <= tol


@pytest.mark.parametrize("name", ["ad", "sd_nf"])
def test_adaptive_facade_counts_and_chunk(world, name):
    """Per-env AdaptiveStats (env batch leading in ys), and ``chunk=`` bit
    for bit the one-call run with the same counts."""
    specs, _, ranks, _ = world
    out = ranks[0][name]
    np.testing.assert_array_equal(out["chunked"], out["ys"])
    for a, b in zip(out["chunked_stats"][:4], out["stats"][:4]):
        np.testing.assert_array_equal(a, b)
    if name == "ad":
        assert out["ys"].shape[:2] == (2, 3)
        acc = out["stats"][1]
        assert acc.shape == (2,) and np.all(acc > 0)


def test_force_params_auto_wiring(world):
    """ForceParams drag and gravity reach the sharded engines as the
    explicit dials do, and they act."""
    specs, _, ranks, _ = world
    auto, explicit = ranks[0]["ga_auto"]["ys"], ranks[0]["ga_explicit"]["ys"]
    np.testing.assert_allclose(auto, explicit, atol=1e-14 * np.abs(explicit).max())
    plain = ranks[0]["ga"]["ys"][:3]
    assert np.abs(auto - plain).max() > 1e-12 * np.abs(explicit).max()


def test_error_contracts(world):
    out = world[2][0]["contracts"]
    want = [
        ("ValueError", "Unknown sharded method"),
        ("ValueError", "constant reduced force"),
        ("ValueError", "at most one leading"),
        ("ValueError", "shape"),
        ("ValueError", "arrays= (traced parameters)"),
        ("ValueError", "local_solver="),
        ("ValueError", "chunk= applies"),
        ("ValueError", "rayleigh"),
        ("ValueError", "modal stepping engine"),
        ("ValueError", "Unknown engine"),
        ("ValueError", "method='modal'"),
        ("ValueError", "force registry"),
        ("ValueError", "node_force"),
        ("ValueError", "parity element"),
        ("ValueError", "local_solver must be"),
        None,
    ]
    assert len(out) == len(want)
    for got, w in zip(out, want):
        if w is None:
            assert got is None
        else:
            assert got[0] == w[0] and w[1] in got[1], (got, w)


def test_sweep_path_is_not_ported_yet():
    """The differentiable-parameter path is ported now: the seven sweep
    entry points are the parallel layer's exports (held to the JAX package
    in tests/test_torch_sweep.py), and none of them raises a not-ported
    error on a small call."""
    from continuum_robot_tpu_torch import parallel as tpar
    from continuum_robot_tpu_torch.parallel import sweep

    for name in ("tile_arrays", "override_arrays", "make_parametric_rhs",
                 "parametric_rollout", "make_traced_genalpha_operator",
                 "parametric_modal_rom_rollout", "parametric_genalpha_rollout"):
        assert getattr(tpar, name) is getattr(sweep, name) and name in tpar.__all__
    model = tcrt.DynamicEulerBernoulliBeam(helpers.linear_csv(3))
    n = model.n_pos_states
    batch = sweep.tile_arrays(model.beam_model.arrays, 2, device="cpu")
    _, ys = sweep.parametric_genalpha_rollout(model.beam_model.bc_info, batch,
                                              np.zeros((2, 2 * n)), 2e-4, 1e-4)
    assert ys.shape == (3, 2, 2 * n) and bool(torch.isfinite(ys).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spike_thomas_launches_the_kernel_on_card(cuda_device):
    """On a one-rank NCCL world the fixed-step SPIKE gen-alpha's "thomas"
    solves are the btd_solve kernel, one launch a Newton correction plus
    the initial acceleration, and the span is the single-device implicit
    gen-alpha's (float64, 1e-12 of the state's scale)."""
    from continuum_robot_tpu_torch import parallel as tpar
    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb
    from continuum_robot_tpu_torch.parallel import facade

    model = tcrt.DynamicEulerBernoulliBeam(helpers.mixed_csv(14))
    n = model.n_pos_states
    x = np.zeros((3, 2 * n))
    x[:, n - 2] = [1e-4, 2e-4, -1e-4]
    u = np.zeros(n)
    u[n - 2] = 0.05
    tpar.init_process_group(cuda_device)
    try:
        mesh = tpar.make_mesh({"sp": 1}, device=cuda_device)
        beam = tpar.make_spatial_beam(model.beam_model.arrays,
                                      model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
        xn = tpar.reduced_to_node_layout(model, torch.tensor(x, device=cuda_device),
                                         beam.n_nodes)
        u_node = facade._node_force(model, u, beam.n_nodes, xn)
        roll = tpar.build_spatial_genalpha(beam, 1e-4, n_newton=2, local_solver="thomas")
        roll(xn, 1, u=u_node, substeps=1)  # the SPIKE preparations (4 column solves)
        kb.reset_launch_counts()
        _, xs = roll(xn, 3, u=u_node, substeps=4)
        assert kb.btd_solve.launches == 1 + 3 * 4 * 2
        ref = tcrt.simulate(model, x, 1.2e-3, 4e-4, method="generalized_alpha", u=u,
                            substeps=4, n_newton=2, linear_solver="pallas",
                            device=cuda_device)
        ys = facade._node_frames_to_reduced(model, xs)
        assert _rel(ys.cpu(), ref.ys.cpu()) <= 1e-12
    finally:
        tpar.destroy_process_group()


def _cards(n: int) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs (NCCL ranks, one a card)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards for {n} NCCL ranks, found {torch.cuda.device_count()}")


@pytest.mark.cuda
def test_nccl_collectives_match_gloo():
    """A 2-rank NCCL world (one rank a card): ``ppermute`` both ways and on
    a partial perm, ``psum``, ``all_gather`` and the environment blocks on
    an ``sp`` and a ``dp`` mesh equal the gloo CPU world's answers exactly
    (integer-valued float64 payloads)."""
    _cards(2)
    specs = {"coll_sp": dict(case="collectives_case", mesh=SP2),
             "coll_dp": dict(case="collectives_case", mesh=DP2)}
    nccl = collectives.launch(cases.run_cases, 2, specs, timeout=240.0)
    gloo = collectives.launch(cases.run_cases, 2, specs, timeout=120.0, device="cpu")
    for r in range(2):
        for key in specs:
            for name, want in gloo[r][key].items():
                for field, val in want.items():
                    np.testing.assert_array_equal(nccl[r][key][name][field], val,
                                                  err_msg=f"rank {r} {key} {name} {field}")


@pytest.mark.cuda
def test_spike_on_four_cards_matches_one_card():
    """The fixed-step SPIKE gen-alpha ("thomas": the btd_solve kernel) on
    an 8-element hybrid beam split over 4 cards (sp = 4, NCCL) equals the
    same span on one card (sp = 1) to 1e-12 of the state's scale
    (float64)."""
    _cards(4)
    csv = helpers.mixed_csv(8)
    n = tcrt.DynamicEulerBernoulliBeam(csv).n_pos_states
    x = np.zeros((3, 2 * n))
    x[:, n - 2] = [1e-4, 2e-4, -1e-4]
    u = np.zeros(n)
    u[n - 2] = 0.05
    spec = dict(case="spike_span_case", csv=csv, x_red=x, u_red=u, frames=3, substeps=4)
    one = collectives.launch(cases.run_cases, 1, {"s": dict(spec, mesh={"sp": 1})},
                             timeout=240.0)[0]["s"]
    four = collectives.launch(cases.run_cases, 4, {"s": dict(spec, mesh={"sp": 4})},
                              timeout=240.0)
    for r in range(4):
        assert _rel(four[r]["s"], one) <= 1e-12

"""Cases of the parallel-layer tests that run on launched ranks (gloo CPU
ranks, or one rank a card over NCCL in the card-only tests).

The ranks import this module by name (``collectives.launch``), so it
imports no JAX: the tests build the inputs (CSV paths, NumPy arrays) in the
test process, every rank runs :func:`run_cases` on them, and the tests hold
the results against the JAX package there. A case is a dict with ``case``
(a function name below), ``mesh`` (axis sizes) and its inputs; it returns
NumPy arrays (``collectives.launch`` converts tensors and DTensors).
"""

from __future__ import annotations

import numpy as np
import torch

import continuum_robot_tpu_torch as tcrt
from continuum_robot_tpu_torch import parallel as tpar
from continuum_robot_tpu_torch.models import assembly
from continuum_robot_tpu_torch.parallel import collectives as col
from continuum_robot_tpu_torch.parallel import spatial_implicit as si


def port_model(csv, forces=None, consistent=False):
    fp = None if forces is None else tcrt.ForceParams(**forces)
    return tcrt.DynamicEulerBernoulliBeam(csv, fp, use_consistent_nonlinear=consistent)


def spatial_beam(model, mesh):
    return tpar.make_spatial_beam(model.beam_model.arrays,
                                  model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)


# Nodewise force of the node_force cases: spring + damper on w and a
# harmonic drive; ``t`` is a float or a tensor of the controller's shape.
K_W, C_W, AMP, OMEGA = 40.0, 0.8, 0.03, 2500.0


def node_force(x, t):
    q, v = x[..., 0, :, :], x[..., 1, :, :]
    t = torch.as_tensor(t, dtype=q.dtype, device=q.device)
    drive = AMP * torch.sin(OMEGA * t)
    f = torch.zeros_like(q)
    f[..., 1] = -K_W * q[..., 1] - C_W * v[..., 1] + drive[..., None]
    return f


def forces_func(model):
    """The reduced-coordinate counterpart of :func:`node_force`."""
    free = np.asarray(model.beam_model.bc_info.free_dofs)
    iw = torch.as_tensor((free % 3 == 1).astype(float))
    n = len(free)

    def ff(x, t):
        q, v = x[..., :n], x[..., n:]
        t = torch.as_tensor(t, dtype=q.dtype)
        return iw * (-K_W * q - C_W * v + AMP * torch.sin(OMEGA * t)[..., None])

    return ff


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


def collectives_case(mesh, **_):
    """Every collective on every axis of the mesh: ring ``ppermute`` both
    ways, a partial perm, ``psum``, ``all_gather`` and ``axis_index``."""
    out = {}
    rank = torch.distributed.get_rank()
    dev = col.world_device()
    envs = torch.arange(5.0, device=dev)
    for name in mesh.mesh_dim_names:
        ax = col.MeshAxis(mesh, name)
        x = torch.tensor([float(rank), 10.0 * ax.index, 1.0], dtype=torch.float64, device=dev)
        out[name] = dict(
            index=col.axis_index(ax), size=ax.size, ranks=list(ax.ranks),
            right=col.ppermute(x, ax, col.right_perm(ax.size)),
            left=col.ppermute(x, ax, col.left_perm(ax.size)),
            first_only=col.ppermute(x, ax, [(0, ax.size - 1)]),
            psum=col.psum(x, ax), gather=col.all_gather(x, ax),
            env_block=col.env_block(envs, ax),
            gathered_envs=col.gather_env_blocks(col.env_block(envs, ax), ax, 5),
        )
    return out


def batched_rollout_case(mesh, csv, x0, kw, **_):
    model = port_model(csv)
    res = tpar.batched_rollout(model, x0, kw.pop("t_final"), kw.pop("dt"), mesh=mesh,
                               **kw)
    local = res.ys.to_local()
    return dict(ts=res.ts, ys=res.ys, local_shape=tuple(local.shape),
                placements=str(res.ys.placements),
                stats=tpar.sweep_statistics(res.ys))


def dryrun_case(mesh, **_):
    from continuum_robot_tpu_torch.parallel import dryrun

    return dryrun._dryrun_rank(torch.distributed.get_world_size())


def spike_span_case(mesh, csv, x_red, u_red, frames, substeps, **_):
    """The fixed-step SPIKE gen-alpha ("thomas") span of a batch, reduced."""
    from continuum_robot_tpu_torch.parallel import facade

    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    x = torch.as_tensor(x_red, device=col.world_device())
    xn = tpar.reduced_to_node_layout(model, x, beam.n_nodes)
    roll = tpar.build_spatial_genalpha(beam, 1e-4, n_newton=2, local_solver="thomas")
    _, xs = roll(xn, frames, u=facade._node_force(model, u_red, beam.n_nodes, xn),
                 substeps=substeps)
    return facade._node_frames_to_reduced(model, xs)


def fail_on_rank(rank):
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"planted failure on rank {rank}")
    return rank


def sleep_case(seconds):
    import time

    time.sleep(seconds)


def const_force(t):
    return 0.0


def mesh_error_case(mesh, **_):
    try:
        tpar.make_mesh({"dp": 3, "sp": 5}, device=col.world_device())
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Explicit spatial tier
# ---------------------------------------------------------------------------


def rhs_case(mesh, csv, x, forces=None, cg_iters=40, cg_tol=None, with_nf=False,
             fluid_density=None, gravity=None, **_):
    model = port_model(csv, forces)
    beam = spatial_beam(model, mesh)
    rhs = tpar.build_spatial_rhs(beam, cg_iters=cg_iters, cg_tol=cg_tol,
                                 fluid_density=fluid_density, gravity=gravity,
                                 node_force=node_force if with_nf else None)
    return rhs(0.0, torch.as_tensor(x))


def rhs_info_case(mesh, csv, x, cg_iters, cg_tol, **_):
    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    rhs = tpar.build_spatial_rhs(beam, cg_iters=cg_iters, cg_tol=cg_tol, with_info=True)
    out, info = rhs(0.0, torch.as_tensor(x))
    return dict(out=out, info=info)


def spatial_rollout_case(mesh, csv, x0, kw, **_):
    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    x = tpar.reduced_to_node_layout(model, torch.as_tensor(x0), beam.n_nodes)
    out = tpar.spatial_rollout(beam, x, **kw)
    return dict(ts=out[0], xs=out[1], stats=out[2] if len(out) > 2 else None)


# ---------------------------------------------------------------------------
# SPIKE and the implicit engines
# ---------------------------------------------------------------------------


def spike_case(mesh, csv, r, **_):
    """SPIKE solves of the BC-masked mass operator with each local solver."""
    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    sp = beam.sp
    S, Np = sp.size, beam.n_nodes
    m = Np // S
    mdiag, moff = assembly.mass_block_tridiagonal(beam.arrays)
    mdiag, moff = np.asarray(mdiag)[:Np], np.asarray(moff)[: Np - 1]
    z33 = np.zeros((1, 3, 3))
    mlow = np.concatenate([z33, np.swapaxes(moff, -1, -2)])
    mup = np.concatenate([moff, z33])
    mask = np.asarray(beam.free_mask, float)
    llm = np.vstack([np.zeros(3), mask[m - 1::m][: S - 1]])
    rfm = np.vstack([mask[m::m][: S - 1], np.zeros(3)])
    t = lambda a: beam.local(torch.as_tensor(a), 0)  # noqa: E731
    md, ml, mu = si.mask_aligned_blocks(t(mdiag), t(mlow), t(mup), t(mask),
                                        torch.as_tensor(llm[sp.index]),
                                        torch.as_tensor(rfm[sp.index]))
    out = {}
    for solver in si.LOCAL_SOLVERS:
        prep = si.spike_prepare(md, ml, mu, sp, solver)
        out[solver] = beam.gather(si.spike_solve(prep, t(r), sp))
    return out


def genalpha_case(mesh, csv, x_node, u_node, dt, n_frames, substeps, n_newton=2,
                  forces=None, engine_kw=None, with_nf=False, chunk_at=None, **_):
    model = port_model(csv, forces)
    beam = spatial_beam(model, mesh)
    kw = dict(engine_kw or {})
    if with_nf:
        kw["node_force"] = node_force
    roll = tpar.build_spatial_genalpha(beam, dt, rho_inf=0.8, n_newton=n_newton, **kw)
    ts, xs = roll(torch.as_tensor(x_node), n_frames, u=torch.as_tensor(u_node),
                  substeps=substeps)
    out = dict(ts=ts, xs=xs)
    if chunk_at is not None:
        # Exact continuation: the carry of a first chunk fed back as x0.
        t1, xs1, carry = roll(torch.as_tensor(x_node), chunk_at, u=torch.as_tensor(u_node),
                              substeps=substeps, return_carry=True)
        t0 = float(t1[-1])
        t2, xs2 = roll(carry, n_frames - chunk_at, u=torch.as_tensor(u_node),
                       substeps=substeps, t0=t0)
        out["chunked"] = torch.cat([xs1, xs2[1:]])
        out["chunked_ts"] = torch.cat([t1, t2[1:]])
    return out


def adaptive_case(mesh, csv, x_node, u_node, t_eval, engine, forces=None,
                  engine_kw=None, with_nf=False, rtol=1e-6, atol=1e-9, **_):
    model = port_model(csv, forces)
    beam = spatial_beam(model, mesh)
    kw = dict(engine_kw or {})
    if with_nf:
        kw["node_force"] = node_force
    build = (tpar.build_spatial_genalpha_adaptive if engine == "genalpha"
             else tpar.build_spatial_sdirk3)
    roll = build(beam, **kw)
    xs, stats = roll(torch.as_tensor(x_node), t_eval,
                     u=None if u_node is None else torch.as_tensor(u_node),
                     rtol=rtol, atol=atol)
    return dict(xs=xs, stats=stats[:5])


def simulate_sharded_case(mesh, csv, x0, kw, forces=None, with_nf=False,
                          also_chunk=None, consistent=False, **_):
    model = port_model(csv, forces, consistent)
    kw = dict(kw)
    if with_nf:
        kw["node_force"] = node_force
    res = tpar.simulate_sharded(model, torch.as_tensor(x0), mesh=mesh, **kw)
    out = dict(ts=res.ts, ys=res.ys, stats=None if res.stats is None else (
        dict(res.stats) if isinstance(res.stats, dict) else res.stats[:5]))
    if also_chunk is not None:
        res_c = tpar.simulate_sharded(model, torch.as_tensor(x0), mesh=mesh,
                                      chunk=also_chunk, **kw)
        out["chunked"] = res_c.ys
        out["chunked_stats"] = res_c.stats[:5]
    return out


def error_contracts_case(mesh, csv, calls, **_):
    """Each call's exception type and message (None when it runs)."""
    model = port_model(csv)
    n = model.n_pos_states
    out = []
    for kw in calls:
        kw = dict(kw)
        x0 = kw.pop("x0", np.zeros(2 * n))
        try:
            tpar.simulate_sharded(model, x0, 1e-4, 1e-4, mesh, **kw)
            out.append(None)
        except (ValueError, NotImplementedError, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# Modal tier
# ---------------------------------------------------------------------------


def modal_rom_case(mesh, csv, eta0, u_red, dt, n_frames, substeps, n_newton=2,
                   n_modes=None, rayleigh=None, forces=None, adaptive_t=None,
                   ecsw=None, **_):
    model = port_model(csv, forces)
    eng = tpar.build_spatial_modal_rom(model, mesh, dt, n_modes=n_modes, rayleigh=rayleigh)
    u_m = None if u_red is None else eng.ms.project_force_host(u_red)
    eta = torch.as_tensor(eta0)
    out = {}
    ts, etas, etads = eng.rollout_frames(eta, torch.zeros_like(eta), u_m, n_frames,
                                         substeps=substeps, n_newton=n_newton)
    out.update(ts=ts, etas=etas, etads=etads)
    if adaptive_t is not None:
        e2, ed2, st = eng.rollout_adaptive(eta, torch.zeros_like(eta), u_m, adaptive_t,
                                           n_newton=n_newton)
        out.update(ad_etas=e2, ad_etads=ed2, ad_stats=st[:5])
    if ecsw is not None:
        red = eng.apply_ecsw(np.asarray(ecsw["sel"]), np.asarray(ecsw["xi"]),
                             train_tau=ecsw["tau"])
        out["rho"] = red.ecsw_residual(etas[-1])
        tsg, eg, edg, guard = red.rollout_frames_guarded(
            eta, torch.zeros_like(eta), u_m, n_frames, substeps=substeps, n_newton=n_newton)
        out.update(g_etas=eg, g_max=guard["max_residual"], g_flag=guard["flagged"])
    return out


def modal_transforms_case(mesh, csv, x_node, u_node, kind="rom", **_):
    model = port_model(csv)
    build = tpar.build_spatial_modal_rom if kind == "rom" else tpar.build_spatial_modal
    eng = build(model, mesh, 1e-4)
    eta, etad = eng.to_modal(torch.as_tensor(x_node))
    out = dict(eta=eta, etad=etad, Np=eng.n_nodes)
    if kind == "rom":
        out["f"] = eng.project_force(torch.as_tensor(u_node))
    qs, vs = eng.physical_frames(eta[None], etad[None])
    out.update(qs=qs, vs=vs, q_local=tuple(qs.to_local().shape))
    return out


def simulate_case(csv, x0, kw, **_):
    """The port's single-device ``simulate()``: a reference one rank runs."""
    kw = dict(kw)
    t_final, dt = kw.pop("t_final"), kw.pop("dt")
    res = tcrt.simulate(port_model(csv), x0, t_final, dt, device="cpu", **kw)
    return dict(ts=res.ts, ys=res.ys, stats=res.stats)


def run_cases(specs: dict) -> dict:
    """Rank entry: run every case of ``specs`` (name -> case dict), one
    mesh per distinct axis-size dict, in the order given. A case with a
    ``rank`` instead of a ``mesh`` is a single-device reference: that rank
    alone runs it, after the sharded cases."""
    meshes = {}
    out = {}
    for name, spec in specs.items():
        if "rank" in spec:
            continue
        key = tuple(spec["mesh"].items())
        if key not in meshes:
            meshes[key] = tpar.make_mesh(dict(spec["mesh"]), device=col.world_device())
        fn = globals()[spec["case"]]
        out[name] = fn(meshes[key], **{k: v for k, v in spec.items()
                                       if k not in ("case", "mesh")})
    for name, spec in specs.items():
        if spec.get("rank") == torch.distributed.get_rank():
            out[name] = globals()[spec["case"]](**{k: v for k, v in spec.items()
                                                   if k not in ("case", "rank")})
    return out


# ---------------------------------------------------------------------------
# Modal tier: the sharded engines against the single-device engine they
# split (built in the same rank, same basis)
# ---------------------------------------------------------------------------


def rom_engine_case(mesh, csv, x_red, u_red, basis=None, n_modes=None, rayleigh=None,
                    n_frames=4, substeps=3, n_newton=2, adaptive_t=None, solo=False,
                    forces=None, **_):
    """Frames (and adaptive frames) of the sharded ROM and of its own
    single-device engine ``eng.ms``; the transforms against the host."""
    model = port_model(csv, forces)
    eng = tpar.build_spatial_modal_rom(model, mesh, 1e-4, rho_inf=0.5, n_modes=n_modes,
                                       rayleigh=rayleigh, basis=basis)
    ms = eng.ms
    n = x_red.shape[-1] // 2
    x = torch.as_tensor(x_red)
    eta, etad = ms.to_modal(x[..., :n], x[..., n:])
    u_m = None if u_red is None else ms.project_force_host(u_red)
    out = dict(n_modes=eng.n_modes, eta=eta)
    _, out["etas"], out["etads"] = eng.rollout_frames(eta, etad, u_m, n_frames,
                                                      substeps=substeps, n_newton=n_newton)
    _, out["etas1"], out["etads1"] = ms.rollout_frames(eta, etad, u_m, n_frames,
                                                       substeps=substeps, n_newton=n_newton)
    xn = tpar.reduced_to_node_layout(model, x, eng.n_nodes)
    out["eta_sh"], out["etad_sh"] = eng.to_modal(xn)
    if u_red is not None:
        u_node = tpar.reduced_to_node_layout(model, torch.as_tensor(np.r_[u_red, 0 * u_red]),
                                             eng.n_nodes)[0]
        out["f_sh"], out["f_host"] = eng.project_force(u_node), u_m
    qs, vs = eng.physical_frames(out["etas"], out["etads"])
    out["qs"], out["q_local"] = qs, tuple(qs.to_local().shape)
    out["q_ref"] = ms.from_modal(out["etas"], out["etads"])[0]
    if adaptive_t is not None:
        kw = dict(rtol=1e-5, atol=1e-8, n_newton=n_newton)
        e, ed, st = eng.rollout_adaptive(eta, etad, u_m, adaptive_t, **kw)
        out.update(ad=e, ad_d=ed, ad_stats=st[:5])
        if solo:  # the batch's rows alone (per-env control)
            out["ad_solo"] = [eng.rollout_adaptive(eta[b], etad[b], u_m, adaptive_t, **kw)
                              for b in range(eta.shape[0])]
        else:
            e1, ed1, st1 = ms.rollout_adaptive(eta, etad, u_m, adaptive_t, **kw)
            out.update(ad1=e1, ad1_d=ed1, ad1_stats=st1[:5])
    return out


def ecsw_case(mesh, csv, u_red, u_bad, n_modes, **_):
    """Sharded ECSW: training, the sharded guard against the single-device
    one, guarded and plain stepping."""
    model = port_model(csv)
    eng = tpar.build_spatial_modal_rom(model, mesh, 1e-4, rho_inf=0.5, n_modes=n_modes)
    ms = eng.ms
    u_m = ms.project_force_host(u_red)
    z = torch.zeros((1, n_modes), dtype=torch.float64)
    _, etas_tr, _ = ms.rollout_frames(z, z, u_m, 20, substeps=10, n_newton=2)
    snaps = etas_tr[::2, 0, :].numpy()
    red, info = eng.hyper_reduce(snaps, tau=1e-3, return_info=True)
    probe = torch.stack([torch.as_tensor(snaps[-1]), 50.0 * torch.as_tensor(snaps[-1])])
    eta0, z1 = torch.as_tensor(snaps[-1]), torch.zeros(n_modes, dtype=torch.float64)
    g = red.rollout_frames_guarded(eta0, z1, u_m, 4, substeps=5)
    g1 = red.ms.rollout_frames_guarded(eta0, z1, u_m, 4, substeps=5)
    bad = red.rollout_frames_guarded(z1, z1, ms.project_force_host(u_bad), 10, substeps=10)
    te = np.linspace(0.0, 5e-4, 3)
    return dict(
        hyper=red.is_hyper_reduced, n_sampled=info["n_sampled"],
        rho=red.ecsw_residual(probe), rho1=red.ms.ecsw_residual(probe),
        g_etas=g[1], g1_etas=g1[1], g_max=g[3]["max_residual"],
        g1_max=g1[3]["max_residual"], g_flag=g[3]["flagged"], bad_flag=bad[3]["flagged"],
        plain=red.rollout_frames(eta0, z1, u_m, 3, substeps=2)[1],
        plain1=red.ms.rollout_frames(eta0, z1, u_m, 3, substeps=2)[1],
        ad=red.rollout_adaptive(eta0, z1, u_m, te, rtol=1e-6, atol=1e-12)[0],
        ad1=red.ms.rollout_adaptive(eta0, z1, u_m, te, rtol=1e-6, atol=1e-12)[0],
    )


def modal_linear_case(mesh, csv, x_red, u_red, **_):
    model = port_model(csv)
    lm = tpar.build_spatial_modal(model, mesh, 1e-4, rayleigh=(0.1, 1e-7))
    n = x_red.shape[-1] // 2
    x = torch.as_tensor(x_red)
    xn = tpar.reduced_to_node_layout(model, x, lm.n_nodes)
    eta, etad = lm.to_modal(xn)
    eta0, etad0 = lm.ms.to_modal(x[:n], x[n:])
    _, es, eds = lm.rollout_frames(eta, etad, lm.ms.project_force_host(u_red), 3, substeps=2)
    qs, _ = lm.physical_frames(es, eds)
    return dict(eta=eta, eta0=eta0, etad=etad, etad0=etad0, qs=qs,
                q_ref=lm.ms.from_modal(es[-1], eds[-1])[0])


def modal_contracts_case(mesh, csv_mixed6, **_):
    """Registry forces: reduced closures ride the sharded ROM, others and
    the consistent element raise."""
    from continuum_robot_tpu_torch.models.abstractions import AbstractForce

    class OpaqueForce(AbstractForce):
        def compute_forces(self, x, t):
            return torch.zeros(x.shape[:-1] + (x.shape[-1] // 2,), dtype=x.dtype) + 1e-3

        def is_enabled(self):
            return True

    out = {}
    model = port_model(csv_mixed6)
    model.force_registry.register(OpaqueForce())
    try:
        tpar.build_spatial_modal_rom(model, mesh, 1e-4)
    except ValueError as e:
        out["opaque"] = str(e)
    try:
        tpar.build_spatial_modal_rom(port_model(csv_mixed6, consistent=True), mesh, 1e-4)
    except ValueError as e:
        out["consistent"] = str(e)
    forced = port_model(csv_mixed6, dict(enable_gravity_effects=True,
                                         gravity_vector=[0.0, -9.81, 0.0]))
    sm = tpar.build_spatial_modal_rom(forced, mesh, 1e-4, rho_inf=0.5)
    z = torch.zeros(sm.n_modes, dtype=torch.float64)
    out["ext"] = sm.ms.ext_modal is not None
    out["moved"] = float(sm.rollout_frames(z, z, None, 2, substeps=2)[1][-1].abs().max())
    return out


# ---------------------------------------------------------------------------
# The differentiable-parameter path: collectives' derivatives and traced
# arrays= through the sharded implicit engines
# ---------------------------------------------------------------------------


def collectives_grad_case(mesh, **_):
    """Each collective's backward and tangent on the ``sp`` axis. Every
    rank's loss is its own term of a global sum, so rank k's gradient is the
    global sum's derivative in its ``x_k``; the test holds each to its
    closed form."""
    import torch.autograd.forward_ad as fwAD

    ax = col.MeshAxis(mesh, "sp")
    k, S = ax.index, ax.size
    dev = col.world_device()

    def vec(*v):
        return torch.tensor(v, dtype=torch.float64, device=dev)

    x = vec(k + 1.0, 2.0 * k - 3.0).requires_grad_()
    w = vec(3.0 * k + 1.0, 0.5 - k)
    W = torch.stack([vec(r + 10.0 * k, r * k - 1.0) for r in range(S)])
    out = {}
    terms = {
        "ppermute": lambda z: (w * col.ppermute(z, ax, col.right_perm(S))).sum(),
        "psum": lambda z: (w * col.psum(z, ax)).sum(),
        "all_gather": lambda z: (W * col.all_gather(z, ax)).sum(),
    }
    for name, term in terms.items():
        out[name] = torch.autograd.grad(term(x), x)[0]
    # A loss every rank computes alike, from a gathered result, of an input
    # every rank holds alike: the whole gradient on every rank.
    a = torch.tensor(1.5, dtype=torch.float64, device=dev, requires_grad=True)
    ramp = torch.arange(1.0, 2 * S + 1, dtype=torch.float64, device=dev)
    block = col.replicated_in(ramp * a, ax)[2 * k:2 * k + 2] ** 2
    out["boundary"] = torch.autograd.grad((col.gather_out(block, ax, 0) * ramp).sum(), a)[0]
    tangent = vec(0.25 * k + 1.0, -1.0)
    with fwAD.dual_level():
        xd = fwAD.make_dual(x.detach(), tangent)
        for name, fn in (("ppermute", lambda z: col.ppermute(z, ax, col.right_perm(S))),
                         ("psum", lambda z: col.psum(z, ax)),
                         ("all_gather", lambda z: col.all_gather(z, ax))):
            out[name + "_jvp"] = fwAD.unpack_dual(fn(xd)).tangent
    out["w"], out["W"], out["x"], out["t"] = w, W, x.detach(), tangent
    return out


def _traced_arrays(beam, **scaled):
    """``beam.arrays`` as float64 tensors on this rank's device, fields in
    ``scaled`` multiplied by the given factors (tensors keep their graph)."""
    import dataclasses

    dev = col.world_device()
    fields = {f.name: torch.as_tensor(np.asarray(getattr(beam.arrays, f.name)), device=dev)
              for f in dataclasses.fields(beam.arrays)}
    for name, s in scaled.items():
        fields[name] = s * fields[name]
    return type(beam.arrays)(**fields)


def _tip_setup(csv, mesh):
    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    tip = beam.n_nodes_real - 1
    u = np.zeros((beam.n_nodes, 3))
    u[tip, 1] = 0.05
    x0 = torch.zeros((2, beam.n_nodes, 3), dtype=torch.float64, device=col.world_device())
    return beam, tip, torch.as_tensor(u, device=x0.device), x0


def traced_genalpha_case(mesh, csv, frames, substeps, fluid=None, gravity=None, **_):
    """The fixed-step SPIKE rollout with ``arrays=beam.arrays`` as tensors
    and with the baked constants."""
    beam, tip, u, x0 = _tip_setup(csv, mesh)
    roll = tpar.build_spatial_genalpha(beam, 1e-4, rho_inf=0.8, n_newton=1,
                                       fluid_density=fluid, gravity=gravity)
    _, baked = roll(x0, frames, u=u, substeps=substeps)
    _, traced = roll(x0, frames, u=u, substeps=substeps, arrays=_traced_arrays(beam))
    return dict(baked=baked, traced=traced)


def traced_grad_case(mesh, csv, field, frames, substeps, h, **_):
    """d(loss)/d(scale of ``field``) by autograd through the SPIKE rollout,
    and its central difference (step ``h``)."""
    beam, tip, u, x0 = _tip_setup(csv, mesh)
    roll = tpar.build_spatial_genalpha(beam, 1e-4, rho_inf=0.8, n_newton=1)

    def loss(s):
        _, xs = roll(x0, frames, u=u, substeps=substeps,
                     arrays=_traced_arrays(beam, **{field: s}))
        return xs[-1, 0, tip].sum() * 1e3

    s = torch.tensor(1.0, dtype=torch.float64, device=x0.device, requires_grad=True)
    value = loss(s)
    g, = torch.autograd.grad(value, s)
    with torch.no_grad():
        fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    return dict(g=g, fd=fd, value=value.detach())


def traced_jvp_case(mesh, csv, engine, t_eval, h, **_):
    """d(tip)/d(modulus scale) by forward mode (``torch.autograd.forward_ad``)
    through an error-controlled sharded engine, and its central difference."""
    import torch.autograd.forward_ad as fwAD

    beam, tip, u, x0 = _tip_setup(csv, mesh)
    build = (tpar.build_spatial_genalpha_adaptive if engine == "genalpha"
             else tpar.build_spatial_sdirk3)
    roll = build(beam, **(dict(rho_inf=0.9, n_newton=2) if engine == "genalpha"
                          else dict(n_newton=2)))

    def tip_at_end(s):
        xs, stats = roll(x0, t_eval, u=u, rtol=1e-7, atol=1e-10,
                         arrays=_traced_arrays(beam, elastic_modulus=s))
        return xs[-1, 0, tip, 1] * 1e3, stats

    one = torch.tensor(1.0, dtype=torch.float64, device=x0.device)
    with fwAD.dual_level():
        out, stats = tip_at_end(fwAD.make_dual(one, torch.ones_like(one)))
        value, g = fwAD.unpack_dual(out)
    fd = (tip_at_end(1.0 + h)[0] - tip_at_end(1.0 - h)[0]) / (2 * h)
    return dict(g=g, fd=fd, value=value, accepted=stats.n_accepted)


def facade_arrays_case(mesh, csv, **_):
    """``simulate_sharded`` of the fixed-step and the adaptive gen-alpha
    (``chunk=``) with ``arrays=`` the padded beam's arrays as tensors, and
    without."""
    model = port_model(csv)
    beam = spatial_beam(model, mesh)
    n = model.n_pos_states
    x0 = np.zeros(2 * n)
    x0[n - 2] = 1e-4
    u = np.zeros(n)
    u[-2] = 0.05
    out = {}
    for method, kw in (("generalized_alpha", dict(substeps=2)),
                       ("generalized_alpha_adaptive", dict(chunk=1, rtol=1e-4))):
        out[method] = [tpar.simulate_sharded(model, x0, 2e-4, 1e-4, mesh, method=method, u=u,
                                             arrays=arrays, **kw).ys
                       for arrays in (None, _traced_arrays(beam))]
    return out

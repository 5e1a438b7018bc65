"""The port's ROM basis tier against the JAX package: augmentation, the
consistent element, the ECSW guard, basis and sample files, ``carry_dtype``.

Both packages built from one CSV, float64 on the CPU:

* ``static_vectors`` and ``modal_derivatives`` bases equal the JAX
  package's (1e-8 of their scale) and keep ``|W^T M V - I|`` and the
  diagonal of ``W^T K0 V``; the modal-derivative ROM beats plain
  truncation against the full-order run (``TestStaticAugmentation``'s
  workload); a 64-segment parity beam adds no mode, with the JAX
  package's warning;
* the consistent element's augmented ROM and its trajectories (1e-10);
* ``ecsw_residual`` on the JAX package's trained sample (1e-10), flagging
  out-of-envelope states, and ``rollout_frames_guarded``;
* ``.npz`` files written by either package load in the other bit for bit,
  and a reapplied sample reproduces the trained engine's rollout exactly;
* ``carry_dtype`` (``TestScanUnroll``), with a bf16 carry held to the JAX
  package's (1e-10), and the refusal messages.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch as tcrt
import continuum_robot_tpu_torch.models as tm
import helpers
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch.models import simulate as ts

torch.set_num_threads(1)

TOL = 1e-10
BASIS_TOL = 1e-8


def pair(n_el, consistent=False):
    csv = helpers.write_beam_csv(["nonlinear"] * n_el, include_fluid=False)
    out = (jm.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent),
           tm.DynamicEulerBernoulliBeam(csv, use_consistent_nonlinear=consistent))
    os.unlink(csv)
    return out


def scaled(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def tip(n, amp):
    u = np.zeros(n)
    u[-2] = amp
    return u


def mk(tb):
    free = tb.beam_model.bc_info.free_dofs
    M = np.asarray(tb.beam_model.M.toarray(), np.float64)
    K0 = ts.reduce_matrix_dense(tb.beam_model.arrays, free,
                                use_consistent=tb.use_consistent_nonlinear)
    return M, K0


# -- augmentation ---------------------------------------------------------------

AUGMENT = {
    "static": (False, dict(static_vectors="tip")),
    "modal_derivatives": (False, dict(modal_derivatives=3)),
    "consistent": (True, dict(modal_derivatives=3)),
}


@pytest.mark.parametrize("case", list(AUGMENT))
def test_augmented_basis_matches_jax(case):
    consistent, kw = AUGMENT[case]
    jb, tb = pair(8, consistent)
    n = tb.n_pos_states
    if kw.get("static_vectors") == "tip":
        kw = dict(static_vectors=tip(n, 1.0))
    jms = js.make_modal_rom(jb, 1e-3, n_modes=10, **kw)
    ms = ts.make_modal_rom(tb, 1e-3, n_modes=10, device="cpu", **kw)
    assert ms.n_modes == jms.n_modes > 10
    assert scaled(ms.Phi, jms.Phi) <= BASIS_TOL and scaled(ms.PhiW, jms.PhiW) <= BASIS_TOL
    M, K0 = mk(tb)
    m = ms.n_modes
    np.testing.assert_allclose(ms.PhiW.T @ M @ ms.Phi, np.eye(m), atol=1e-8)
    K0r = ms.PhiW.T @ K0 @ ms.Phi
    assert np.abs(K0r - np.diag(np.diag(K0r))).max() < 1e-6 * np.abs(np.diag(K0r)).max()
    if consistent:
        assert ms.lam is None and jms.lam is None
    else:
        np.testing.assert_allclose(np.diag(K0r), ms.lam, rtol=1e-9)
    assert (ms.Sinv_diag is None) == (jms.Sinv_diag is None)


@pytest.fixture(scope="module")
def augmentation_workload():
    """``TestStaticAugmentation``'s workload: 8 von Karman segments, a 2 N
    tip load, 0.1 s of 1 ms frames x 10 substeps; the full-order
    generalized-alpha run of the JAX package and its 10-mode ROMs."""
    jb, tb = pair(8)
    n = tb.n_pos_states
    kw = dict(t_final=0.1, dt=1e-3, u=tip(n, 2.0), substeps=10, n_newton=2, rho_inf=0.7)
    full = np.asarray(js.simulate(jb, np.zeros(2 * n), method="generalized_alpha", **kw).ys)
    md = np.asarray(js.simulate(jb, np.zeros(2 * n), method="modal_rom", n_modes=10,
                                modal_derivatives=3, **kw).ys)
    return tb, kw, full, md


def test_modal_derivatives_beat_plain_truncation(augmentation_workload):
    tb, kw, y_full, y_md_jax = augmentation_workload
    n = tb.n_pos_states
    plain = ts.simulate(tb, np.zeros(2 * n), method="modal_rom", n_modes=10,
                        device="cpu", **kw).ys.numpy()
    md = ts.simulate(tb, np.zeros(2 * n), method="modal_rom", n_modes=10,
                     modal_derivatives=3, device="cpu", **kw).ys.numpy()
    assert scaled(md, y_md_jax) <= TOL
    tip_full = y_full[:, n - 2]
    scale = np.abs(tip_full).max()
    err_plain = np.abs(plain[:, n - 2] - tip_full).max() / scale
    err_md = np.abs(md[:, n - 2] - tip_full).max() / scale
    assert err_md < 0.2 * err_plain
    assert err_md < 2e-2


def test_large_parity_mesh_adds_no_mode():
    """At 64 segments the parity element's membrane band is complex: the
    augmentation leaves the basis as it was and says why, in the JAX
    package's words."""
    jb, tb = pair(64)
    msgs = []
    for make, model, kw in ((js.make_modal_rom, jb, {}),
                            (ts.make_modal_rom, tb, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ms = make(model, 1e-4, n_modes=24, modal_derivatives=3, **kw)
        assert ms.n_modes == 24
        msgs.append([str(x.message) for x in w if "augmentation" in str(x.message)])
    assert msgs[1] and msgs[1] == msgs[0]
    assert "added no modes" in msgs[1][0]


def test_consistent_rom_trajectory_matches_jax():
    jb, tb = pair(8, consistent=True)
    n = tb.n_pos_states
    kw = dict(t_final=0.01, dt=1e-3, u=tip(n, 2.0), substeps=10, n_newton=2,
              rho_inf=0.7, method="modal_rom", n_modes=10, modal_derivatives=3)
    ref = js.simulate(jb, np.zeros(2 * n), **kw)
    got = ts.simulate(tb, np.zeros(2 * n), device="cpu", **kw)
    assert scaled(got.ys, ref.ys) <= TOL


# -- the ECSW guard ---------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """``TestEcswGuard``'s engine: 40 segments, 24 modes, trained in the JAX
    package (tip force 3 N, 30 frames x 20 substeps, snapshots [::3], tau
    1e-3); the port applies the same basis and sample."""
    jb, tb = pair(40)
    jms = js.make_modal_rom(jb, 1e-4, rho_inf=0.5, n_modes=24)
    ms = ts.make_modal_rom(tb, 1e-4, rho_inf=0.5, basis=(jms.Phi, jms.PhiW), device="cpu")
    u_m = jms.project_force_host(tip(tb.n_pos_states, 3.0))
    z = np.zeros((1, 24))
    _, etas, _ = jms.rollout_frames(z, z, u_m, 30, substeps=20, n_newton=2)
    snaps = np.asarray(etas[::3, 0, :])
    jred = jms.hyper_reduce(snaps, tau=1e-3)
    red = ms.apply_ecsw(jred.sampled_params["sel"], jred.sampled_params["xi"],
                        train_tau=1e-3)
    return jms, ms, jred, red, snaps, u_m, tb


def test_ecsw_residual_matches_jax_and_flags(trained):
    jms, ms, jred, red, snaps, *_ = trained
    rng = np.random.default_rng(1)
    amp = float(np.abs(snaps).max())
    inside = snaps[-3:]
    outside = rng.normal(size=(5, 24)) * amp / np.sqrt(24)
    for states in (inside, outside):
        got = red.ecsw_residual(states)
        assert got.shape == (states.shape[0],)
        assert scaled(got, jred.ecsw_residual(states)) <= TOL
    assert float(red.ecsw_residual(inside).max()) < 0.05
    assert float(red.ecsw_residual(outside).max()) > 0.2


def test_guarded_rollout_flags_out_of_envelope(trained):
    jms, ms, jred, red, _, u_m, tb = trained
    z = np.zeros((1, 24))
    ts_, e_in, _, guard = red.rollout_frames_guarded(z, z, u_m, 5, substeps=10, n_newton=1)
    _, e_ref, _, g_ref = jred.rollout_frames_guarded(z, z, u_m, 5, substeps=10, n_newton=1)
    assert e_in.shape == (6, 1, 24) and scaled(e_in, e_ref) <= TOL
    assert scaled(guard["max_residual"], g_ref["max_residual"]) <= TOL
    assert guard["guard_tol"] == g_ref["guard_tol"] == pytest.approx(1e-2)
    assert not bool(guard["flagged"].any())
    _, e_plain, _ = red.rollout_frames(z, z, u_m, 5, substeps=10, n_newton=1)
    assert torch.equal(e_in, e_plain)  # the audit does not touch the stepping
    u2 = np.zeros(ms.Phi.shape[0])
    u2[1] = 3.0
    _, _, _, guard_out = red.rollout_frames_guarded(
        z, z, ms.project_force_host(u2), 10, substeps=10, n_newton=1)
    assert bool(guard_out["flagged"].any())


# -- files -------------------------------------------------------------------------


def test_files_load_in_either_package(trained, tmp_path):
    jms, ms, jred, red, _, u_m, tb = trained
    # Written by the JAX package, loaded by the port, and the reverse.
    for writer, reader, tag in ((jms, ts, "j"), (ms, js, "t")):
        V, W = reader.load_basis(writer.save_basis(str(tmp_path / f"{tag}_basis.npz")))
        np.testing.assert_array_equal(V, ms.Phi)
        np.testing.assert_array_equal(W, ms.PhiW)
    for writer, reader, tag in ((jred, ts, "j"), (red, js, "t")):
        sel, xi, tau = reader.load_ecsw(writer.save_ecsw(str(tmp_path / f"{tag}_ecsw.npz")))
        np.testing.assert_array_equal(sel, red.sampled_params["sel"])
        np.testing.assert_array_equal(xi, red.sampled_params["xi"])
        assert tau == 1e-3
    with np.load(tmp_path / "t_ecsw.npz") as f, np.load(tmp_path / "j_ecsw.npz") as g:
        assert sorted(f.files) == sorted(g.files) == ["n_modes", "sel", "train_tau", "xi"]
        assert int(f["n_modes"]) == 24
    # The deployment path: basis and sample from disk reproduce the trained
    # engine's rollout bit for bit, with bit-equal operators.
    ms2 = ts.make_modal_rom(tb, 1e-4, rho_inf=0.5, device="cpu",
                            basis=tcrt.load_basis(str(tmp_path / "t_basis.npz")))
    for name in ("Phi", "PhiW", "PhiTM", "Sinv", "lam", "Phi_planar", "PhiW_planar"):
        np.testing.assert_array_equal(getattr(ms2, name), getattr(ms, name))
    red2 = ms2.apply_ecsw(*tcrt.load_ecsw(str(tmp_path / "t_ecsw")))
    assert red2.guard_train_tau == red.guard_train_tau
    eta0 = torch.zeros((2, 24), dtype=torch.float64)
    eta0[:, 0] = 1e-3
    for a, b in zip(red.rollout(eta0, 0 * eta0, u_m, 50), red2.rollout(eta0, 0 * eta0, u_m, 50)):
        assert torch.equal(a, b)
    assert torch.isfinite(red2.ecsw_residual(eta0)).all()


@pytest.mark.cuda
def test_files_from_jax_drive_the_kernels_on_the_card(trained, tmp_path):
    """Files the JAX package wrote rebuild the engine on the card: the
    loaded sample's fused gathered span (the CUDA ROM kernels) is bit for
    bit the span of the engine given the same basis and sample directly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    jms, _, jred, _, _, u_m, tb = trained
    basis = ts.load_basis(jms.save_basis(str(tmp_path / "basis.npz")))
    sample = ts.load_ecsw(jred.save_ecsw(str(tmp_path / "ecsw.npz")))
    kw = dict(rho_inf=0.5, device="cuda", dtype=torch.float32)
    direct = ts.make_modal_rom(tb, 1e-4, basis=(jms.Phi, jms.PhiW), **kw).apply_ecsw(
        jred.sampled_params["sel"], jred.sampled_params["xi"], train_tau=1e-3)
    loaded = ts.make_modal_rom(tb, 1e-4, basis=basis, **kw).apply_ecsw(*sample)
    eta = torch.zeros((64, 24), dtype=torch.float32, device="cuda")
    eta[:, 0] = torch.linspace(5e-4, 1e-3, 64, device="cuda")
    u32 = np.asarray(u_m, np.float32)
    spans = [engine.make_pallas_rollout()(eta, 0 * eta, u32, 100, n_newton=1)
             for engine in (direct, loaded)]
    assert all(torch.equal(a, b) for a, b in zip(*spans))
    assert all(bool(torch.isfinite(x).all()) for x in spans[1])


# -- carry_dtype -----------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    jb, tb = pair(6)
    ms = ts.make_modal_rom(tb, 1e-4, rho_inf=0.7, device="cpu")
    n = tb.n_pos_states
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.normal(scale=1e-6, size=(4, n)))
    eta, etad = ms.to_modal(q, torch.zeros_like(q))
    return ms, eta, etad, ms.project_force_host(tip(n, 0.1)), jb


def test_carry_dtype_same_dtype_is_neutral(small):
    """37 = 4 x 9 + 1 steps: the chunked loop and its remainder tail."""
    ms, eta, etad, u_m, _ = small
    base = ms.rollout(eta, etad, u_m, 37, n_newton=2)
    out = ms.rollout(eta, etad, u_m, 37, n_newton=2, unroll=4, carry_dtype=torch.float64)
    for a, b in zip(out, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-18)


def test_bf16_carry_tracks_float32(small):
    ms, eta, etad, u_m, _ = small
    eta, etad = eta.float(), etad.float()
    base = ms.rollout(eta, etad, u_m, 200, n_newton=1)
    out = ms.rollout(eta, etad, u_m, 200, n_newton=1, unroll=8, carry_dtype=torch.bfloat16)
    for a, b in zip(out, base):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        a, b = a.double(), b.double()
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 0.05


def test_bf16_carry_matches_jax(small):
    """The JAX package's engine on the same basis, float64 steps with a bf16
    carry, 37 = 4 x 9 + 1 steps: both round to nearest even at the same
    points (once per chunk, then the tail), so the states agree far below
    one bf16 ulp; a different downcast point or tail order would not."""
    ms, eta, etad, u_m, jb = small
    jms = js.make_modal_rom(jb, 1e-4, rho_inf=0.7,
                            basis=(np.asarray(ms.Phi), np.asarray(ms.PhiW)))
    kw = dict(n_newton=2, unroll=4)
    ref = jms.rollout(eta.numpy(), etad.numpy(), u_m, 37,
                      carry_dtype=jnp.bfloat16, **kw)
    got = ms.rollout(eta, etad, u_m, 37, carry_dtype=torch.bfloat16, **kw)
    plain = ms.rollout(eta, etad, u_m, 37, **kw)
    for a, b, c in zip(got, ref, plain):
        assert a.dtype == torch.float64
        assert scaled(a, b) <= TOL
        assert scaled(c, b) > 1e3 * TOL  # the bf16 rounding is visible


# -- refusals --------------------------------------------------------------------


def test_refusals_match_jax(trained, tmp_path):
    jms, ms, jred, red, _, _, tb = trained
    z = np.zeros((1, 24))
    cases = [
        (lambda e: e.ecsw_residual(z), "hyper-reduce"),
        (lambda e: e.rollout_frames_guarded(z, z, None, 1), "hyper-reduced"),
        (lambda e: e.save_ecsw(str(tmp_path / "nope.npz")), "hyper-reduced"),
        (lambda e: e.apply_ecsw(np.array([99]), np.array([1.0])), "subset"),
        (lambda e: e.apply_ecsw(np.array([1]), np.array([-1.0])), "positive"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError) as ej:
            call(jms)
        with pytest.raises(ValueError, match=word) as et:
            call(ms)
        assert str(et.value) == str(ej.value)
    for basis, word in (((ms.Phi, 2.0 * ms.PhiW), "biorthonormal"),
                        ((ms.Phi[:-3], ms.PhiW[:-3]), "do not match")):
        with pytest.raises(ValueError, match=word):
            ts.make_modal_rom(tb, 1e-4, basis=basis, device="cpu")

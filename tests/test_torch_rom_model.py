"""The port's nonlinear model layer and modal-ROM set-up against the JAX package.

Same NumPy inputs through both packages, float64 on the CPU: the von
Kármán element planes and forces (rtol 1e-12), the global, reduced and
planar internal forces (rtol 1e-12), the zero-state tangent K0
(1e-12 max|K0|), and ``make_modal_rom`` with a shared basis (rtol 1e-12)
and with its own eigensolve on each branch (eigenvalues rtol 1e-9, bases
after canonical signs 1e-8). Also: entry points default to the card, and
the parts of the ROM tier that once raised now run.
"""

import numpy as np
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu.models import assembly as ja
from continuum_robot_tpu.models import elements as je
from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.models import assembly as ta
from continuum_robot_tpu_torch.models import elements as te
from continuum_robot_tpu_torch.models import simulate as ts
from tests import helpers

torch.set_num_threads(1)

N_EL, DT, RHO = 8, 1e-4, 0.5
CSV = {"nonlinear": helpers.nonlinear_csv, "mixed": helpers.mixed_csv}


def _close(a, b, rtol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def beams():
    out = {}
    for kind, fn in CSV.items():
        csv = fn(N_EL, include_fluid=False)
        out[kind] = (jm.DynamicEulerBernoulliBeam(csv),
                     tm.DynamicEulerBernoulliBeam(csv))
    return out


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_element_planes_match(kind):
    rng = np.random.default_rng(11)
    E = 7
    q = rng.normal(scale=1e-2, size=(3, E, 6))
    L, Em = rng.uniform(0.02, 0.3, E), rng.uniform(1e9, 2e11, E)
    I, A = rng.uniform(1e-12, 1e-9, E), rng.uniform(1e-6, 1e-4, E)
    mask = rng.uniform(size=E) > 0.5
    planes = [q[..., k] for k in range(6)] + [L, Em * I, Em * A]
    conv = torch.tensor if kind == "torch" else np.asarray
    for name in ("nonlinear_correction_planes", "nonlinear_linear_planes",
                 "nonlinear_force_planes", "linear_force_planes"):
        ref = getattr(je, name)(*planes)
        out = getattr(te, name)(*map(conv, planes))
        for a, b in zip(out, ref):
            _close(a, b, 1e-12)
    _close(te.nonlinear_internal_force(conv(q), L, Em, I, A),
           je.nonlinear_internal_force(q, L, Em, I, A), 1e-12)
    out = te.element_internal_force(conv(q), L, Em, I, A, mask)
    assert isinstance(out, torch.Tensor if kind == "torch" else np.ndarray)
    _close(out, je.element_internal_force(q, L, Em, I, A, mask), 1e-12)


@pytest.mark.parametrize("beam", sorted(CSV))
def test_internal_forces_match(beams, beam):
    jb, tb = beams[beam]
    ja_, ta_ = jb.beam_model.arrays, tb.beam_model.arrays
    bc = tb.beam_model.bc_info
    rng = np.random.default_rng(12)
    n_full, n_red = bc.n_dofs_full, tb.n_pos_states
    q_full = rng.normal(scale=1e-2, size=(2, n_full))
    q_red = rng.normal(scale=1e-2, size=(2, n_red))
    _close(ta.internal_force_full(ta_, torch.tensor(q_full)),
           ja.internal_force_full(ja_, q_full), 1e-12)
    k_j = ja.make_reduced_internal_force(ja_, bc.free_dofs, n_full)
    _close(ta.make_reduced_internal_force(ta_, bc.free_dofs, n_full)(
        torch.tensor(q_red)), k_j(q_red), 1e-12)
    _close(ta.make_reduced_internal_force_np(ta_, bc.free_dofs, n_full)(q_red[0]),
           ja.make_reduced_internal_force_np(ja_, bc.free_dofs, n_full)(q_red[0]),
           1e-12)
    # the facade's reduced stiffness function: NumPy in, NumPy out
    out = tb.beam_model.stiffness_func(q_red)
    assert isinstance(out, np.ndarray)
    _close(out, jb.beam_model.stiffness_func(q_red), 1e-12)
    q_p = rng.normal(scale=1e-2, size=(2, 3, N_EL + 1))
    _close(ta.make_planar_internal_force(ta_)(torch.tensor(q_p)),
           ja.make_planar_internal_force(ja_)(q_p), 1e-12)
    sl, node_sl = ta.nonlinear_support(ta_)
    assert (sl, node_sl) == ja.nonlinear_support(ja_)
    q_w = q_p[..., node_sl]
    _close(ta.make_planar_correction_force(ta_, element_slice=sl)(torch.tensor(q_w)),
           ja.make_planar_correction_force(ja_, element_slice=sl)(q_w), 1e-12)
    np.testing.assert_array_equal(ta.planar_permutation(5), ja.planar_permutation(5))


@pytest.mark.parametrize("beam", sorted(CSV))
def test_reduce_matrix_dense_matches(beams, beam):
    jb, tb = beams[beam]
    free = tb.beam_model.bc_info.free_dofs
    ref = js.reduce_matrix_dense(jb.beam_model.arrays, free, False)
    out = ts.reduce_matrix_dense(tb.beam_model.arrays, free, False)
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(out - out.T).max() > 1e-3 * np.abs(out).max()  # parity tangent


@pytest.mark.parametrize("rayleigh", [None, (0.5, 1e-6)])
@pytest.mark.parametrize("beam", sorted(CSV))
def test_make_modal_rom_shared_basis(beams, beam, rayleigh):
    jb, tb = beams[beam]
    ms = js.make_modal_rom(jb, DT, rho_inf=RHO, n_modes=12, rayleigh=rayleigh)
    port = ts.make_modal_rom(tb, DT, rho_inf=RHO, rayleigh=rayleigh,
                             basis=(ms.Phi, ms.PhiW), device="cpu")
    for name in ("lam", "Sinv", "Sinv_diag", "Phi_planar", "PhiW_planar",
                 "PhiTM", "cdamp"):
        ref = getattr(ms, name)
        if ref is None:
            assert getattr(port, name) is None
        else:
            _close(getattr(port, name), ref, 1e-12)
    assert set(port.window_params) == set(ms.window_params)
    for key, ref in ms.window_params.items():
        np.testing.assert_array_equal(port.window_params[key], ref)


@pytest.mark.parametrize("branch, beam, n_modes", [
    ("dense_eig", "nonlinear", 12),
    ("dense_eig", "mixed", None),
    ("sparse_arnoldi", "nonlinear", 6),
    ("symmetric", "linear", 9),
])
def test_make_modal_rom_own_eigensolve(beams, branch, beam, n_modes):
    if beam == "linear":
        csv = helpers.linear_csv(N_EL, include_fluid=False)
        jb, tb = jm.DynamicEulerBernoulliBeam(csv), tm.DynamicEulerBernoulliBeam(csv)
    else:
        jb, tb = beams[beam]
    ms = js.make_modal_rom(jb, DT, rho_inf=RHO, n_modes=n_modes)
    port = ts.make_modal_rom(tb, DT, rho_inf=RHO, n_modes=n_modes, device="cpu")
    np.testing.assert_allclose(port.lam, ms.lam, rtol=1e-9)
    for name in ("Phi", "PhiW"):
        np.testing.assert_allclose(getattr(port, name), getattr(ms, name),
                                   rtol=0, atol=1e-8)
    assert (port.Sinv_diag is None) == (ms.Sinv_diag is None)
    assert (port.planar_correction is None) == (beam == "linear")


def _entry_points(model, rom_model):
    return {
        "simulate": lambda: ts.simulate(model, np.zeros(2 * model.n_pos_states),
                                        1e-3, 1e-3, method="modal"),
        "make_modal_genalpha": lambda: ts.make_modal_genalpha(model, DT),
        "make_modal_rollout_fn": lambda: ts.make_modal_rollout_fn(model, DT, 1),
        "make_modal_rom": lambda: ts.make_modal_rom(rom_model, DT, n_modes=4),
        "ModalGenAlpha": lambda: ts.ModalGenAlpha(
            np.eye(2), np.eye(2), np.ones(2), 0.8, DT),
        "convert.modal_engine_from_numpy": lambda: convert.modal_engine_from_numpy(
            np.eye(2), np.eye(2), np.ones(2), 0.8, DT),
        "convert.modal_rom_engine_from_numpy":
            lambda: convert.modal_rom_engine_from_numpy(
                np.eye(24), np.eye(24), np.eye(24), np.eye(24), np.ones(24),
                0.8, DT, rom_model),
    }


ENTRY_POINTS = sorted(_entry_points(None, None))


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(beams, monkeypatch, entry):
    """Without a device argument an entry point runs on the card; with no
    card it raises instead of carrying on on the CPU."""
    csv = helpers.linear_csv(3, include_fluid=False)
    model = tm.DynamicEulerBernoulliBeam(csv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(model, beams["nonlinear"][1])[entry]()
    assert ts.resolve_device("cpu") == torch.device("cpu")


def test_rom_tier_parts_run(beams, tmp_path):
    """The parts of the ROM tier that raised before they were ported now
    build and run (tests/test_torch_rom_forces.py, _adaptive.py and
    _basis.py hold them to the JAX package)."""
    _, tb = beams["nonlinear"]
    aug = ts.make_modal_rom(tb, DT, n_modes=4, static_vectors=np.ones(24),
                            device="cpu")
    assert aug.n_modes >= 4
    user = ts.make_modal_rom(tb, DT, n_modes=4, forces_func=lambda x, t: x[..., :24],
                             device="cpu")
    assert user.external_force is not None and user.ext_modal is None
    fluid = tm.DynamicEulerBernoulliBeam(
        helpers.nonlinear_csv(3, path=str(tmp_path / "f.csv")),
        tm.ForceParams(enable_fluid_effects=True, fluid_density=1000.0),
    )
    assert ts.make_modal_rom(fluid, DT, device="cpu").ext_modal is not None
    consistent = tm.DynamicEulerBernoulliBeam(
        helpers.nonlinear_csv(3, path=str(tmp_path / "c.csv")),
        use_consistent_nonlinear=True,
    )
    assert ts.make_modal_rom(consistent, DT, device="cpu").lam is None
    x0 = np.zeros(2 * tb.n_pos_states)
    res = ts.simulate(tb, x0, 1e-3, 1e-3, method="modal_rom_adaptive", device="cpu")
    assert res.ys.shape == (2, 2 * tb.n_pos_states)
    port = ts.make_modal_rom(tb, DT, n_modes=4, device="cpu")
    out = port.rollout(np.zeros(4), np.zeros(4), None, 2, carry_dtype=torch.float16)
    assert out[0].dtype == torch.float64

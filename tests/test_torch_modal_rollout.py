"""Modal kernels of the PyTorch port against the JAX Pallas kernels.

On the CPU each wrapper in ``continuum_robot_tpu_torch/ops/cuda`` runs its
plain PyTorch version; these tests hold that arithmetic to the Pallas
kernels run in interpret mode at tiny ragged sizes (float64,
``atol = 1e-12 * scale``; float32 in ``tests/test_torch_modal_fma.py``).
The CUDA kernels themselves are held to the plain versions on the card by
the ``cuda``-marked test here and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from continuum_robot_tpu.models.simulate import ModalGenAlpha as JaxModal
from continuum_robot_tpu.ops.pallas import modal_rollout as jk
from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import modal_rollout as tk

torch.set_num_threads(1)

B, M = 3, 11  # ragged against the Pallas tiles below
H, RHO = 1e-4, 0.8
PALLAS = dict(tile=128, mode_tile=8, interpret=True)


def _coeffs(damped, seed=0):
    rng = np.random.default_rng(seed)
    lam = np.sort(10.0 ** rng.uniform(0.0, 10.0, M))
    cdamp = 0.5 + 1e-6 * lam if damped else None
    eng = JaxModal(np.zeros((1, M)), np.zeros((M, 1)), lam, RHO, H, cdamp)
    eta = rng.normal(scale=1e-4, size=(B, M))
    etad = rng.normal(scale=1e-4, size=(B, M))
    u = rng.normal(scale=1e-2, size=M)
    return eng, lam, eng.winv64(), cdamp, u, eta, etad


def _close(port, ref):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12 * scale)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("damped", [False, True])
def test_mode_coeffs_match(damped):
    _, lam, winv, cdamp, *_ = _coeffs(damped)
    ref = jk.mode_coeffs(lam, winv, RHO, cdamp)
    for port in (tk.mode_coeffs(lam, winv, RHO, cdamp),
                 tk.mode_coeffs(_t(lam), _t(winv), RHO,
                                None if cdamp is None else _t(cdamp))):
        for a, b in zip(port, ref):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("damped", [False, True])
@pytest.mark.parametrize("with_force", [False, True])
def test_modal_steps_match_fused_modal_steps(damped, with_force):
    _, lam, winv, cdamp, u, eta, etad = _coeffs(damped)
    u = u if with_force else None
    ref = jk.fused_modal_steps(lam, winv, u, eta, etad, None, steps=13, h=H,
                               rho_inf=RHO, cdamp=cdamp, unroll=4, **PALLAS)
    port = tk.modal_steps_plain(lam, winv, u, _t(eta), _t(etad), None,
                                steps=13, h=H, rho_inf=RHO, cdamp=cdamp)
    _close(port, ref)


@pytest.mark.parametrize("damped", [False, True])
def test_modal_frames_match_fused_modal_frames(damped):
    _, lam, winv, cdamp, u, eta, etad = _coeffs(damped, seed=1)
    ref = jk.fused_modal_frames(lam, winv, u, eta, etad, n_frames=3,
                                substeps=4, h=H, rho_inf=RHO, cdamp=cdamp,
                                unroll=2, **PALLAS)
    port = tk.modal_frames_plain(lam, winv, u, _t(eta), _t(etad), n_frames=3,
                                 substeps=4, h=H, rho_inf=RHO, cdamp=cdamp)
    assert port[0].shape == (4, B, M)
    _close(port, ref)


@pytest.mark.parametrize("damped", [False, True])
def test_affine_steps_match_fused_affine_steps(damped):
    eng, lam, _, cdamp, u, eta, etad = _coeffs(damped, seed=2)
    P, b = eng._power_map(8, u)
    a0 = -lam * eta + u
    ref = jk.fused_affine_steps(P, b, eta, etad, a0, apps=5, unroll=2, **PALLAS)
    port = tk.affine_steps_plain(P, b, _t(eta), _t(etad), _t(a0), apps=5)
    _close(port, ref)


def test_cpu_tensors_never_build(monkeypatch):
    """A CPU tensor runs the plain version: no build, no launch, same bits."""

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    tk.reset_launch_counts()
    eng, lam, winv, cdamp, u, eta, etad = _coeffs(True, seed=3)
    e, ed = _t(eta), _t(etad)
    kw = dict(h=H, rho_inf=RHO, cdamp=cdamp)
    for a, b in zip(tk.modal_steps(lam, winv, u, e, ed, steps=5, **kw),
                    tk.modal_steps_plain(lam, winv, u, e, ed, steps=5, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(tk.modal_frames(lam, winv, u, e, ed, 2, 3, **kw),
                    tk.modal_frames_plain(lam, winv, u, e, ed, 2, 3, **kw)):
        assert torch.equal(a, b)
    P, bv = eng._power_map(4, u)
    for a, b in zip(tk.affine_steps(P, bv, e, ed, ed, apps=3),
                    tk.affine_steps_plain(P, bv, e, ed, ed, apps=3)):
        assert torch.equal(a, b)
    drive = (_t(lam), _t(u), _t(cdamp), P, bv, e, ed, 3, P, bv)
    for a, b in zip(tk.affine_drive(*drive), tk.affine_drive_plain(*drive)):
        assert torch.equal(a, b)
    frames = (_t(lam), _t(u), _t(cdamp), np.stack([P, P]), np.stack([bv, bv]), e, ed, (2, 1))
    for a, b in zip(tk.affine_frames(*frames), tk.affine_frames_plain(*frames)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in tk.KERNELS] == [0, 0, 0, 0, 0]


def test_build_without_nvcc_raises(monkeypatch):
    """Without a CUDA compiler the build raises; nothing falls back."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("modal_rollout")


def test_state_checks():
    e = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="share"):
        tk.affine_steps(np.zeros((4, 3, 3)), np.zeros((4, 3)), e, e[:1], e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.affine_steps(np.zeros((4, 3, 3)), np.zeros((4, 3)),
                        *(e.to("meta"),) * 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_bit_equal_to_plain_on_card(cuda_device, dtype):
    eng, lam, winv, cdamp, u, eta, etad = _coeffs(True, seed=4)
    e = torch.tensor(eta, dtype=dtype, device=cuda_device)
    ed = torch.tensor(etad, dtype=dtype, device=cuda_device)
    for cd in (None, cdamp):
        kw = dict(h=H, rho_inf=RHO, cdamp=cd)
        for a, b in zip(tk.modal_steps(lam, winv, u, e, ed, steps=17, **kw),
                        tk.modal_steps_plain(lam, winv, u, e, ed, steps=17, **kw)):
            assert torch.equal(a, b)
        for a, b in zip(tk.modal_frames(lam, winv, u, e, ed, 3, 5, **kw),
                        tk.modal_frames_plain(lam, winv, u, e, ed, 3, 5, **kw)):
            assert torch.equal(a, b)
    P, bv = eng._power_map(64, u)
    for a, b in zip(tk.affine_steps(P, bv, e, ed, ed, apps=7),
                    tk.affine_steps_plain(P, bv, e, ed, ed, apps=7)):
        assert torch.equal(a, b)
    Pr, br = eng._power_map(9, u)
    lam_t, u_t, cd_t = (torch.tensor(x, dtype=dtype, device=cuda_device)
                        for x in (lam, u, cdamp))
    for cd, rem in ((None, (None, None)), (cd_t, (Pr, br))):
        drive = (lam_t, u_t, cd, P, bv, e, ed, 7, *rem)
        for a, b in zip(tk.affine_drive(*drive), tk.affine_drive_plain(*drive)):
            assert torch.equal(a, b)
    # the frames drive: one run, and a two-run schedule with a run index
    for cd, maps, counts in ((None, ([P], [bv]), (4,)), (cd_t, ([P, Pr], [bv, br]), (3, 2))):
        frames = (lam_t, u_t, cd, np.stack(maps[0]), np.stack(maps[1]), e, ed, counts)
        for a, b in zip(tk.affine_frames(*frames), tk.affine_frames_plain(*frames)):
            assert torch.equal(a, b)

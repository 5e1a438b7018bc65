"""The ROM span's tensor-core basis transforms (``rom_expand``,
``rom_project``): the 3-pass TF32 split and its plain parts.

On the CPU: the split helper (``tf32_split``: both halves TF32, their sum
``x`` to ``2^-21``), the 3-pass product emulated in float32 against the
float64 product (``2e-6`` of its scale), ``project_splits`` for the kernel's
128 x 128 tile, and the CPU operators (no halves, no build; the twins'
``torch.matmul`` unchanged). On the card only: each kernel against its
plain twin (float32 ``torch.matmul``) at the main path's and ragged shapes
to ``1e-4`` of the output's scale (the per-launch limit of
``chip_smoke.py``) and against the float64 product to ``2e-6`` of its
scale, pad columns filled with NaN that reach no output, and two launches
that agree bit for bit.
"""

import dataclasses

import helpers
import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu_torch.models import simulate as ts
from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

torch.set_num_threads(1)

PIECE_MAX = 1e-4  # one launch against its twin, x max|twin| (chip_smoke.ROM_PIECE_MAX)
# One launch against the float64 product, x its max: the CPU emulation's
# limit. Measured on an H100: at most 4.0e-7; with the operand's lo half
# dropped 1.3e-4 and more; with one accumulator over K up to 1.1e-5.
F64_MAX = 2e-6


def test_tf32_split_halves():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.uniform(-20, 20, 4000),
                        [0.0, -0.0, 1.0, -3.5, 1e-30]]).astype(np.float32)
    # ties: the 13 dropped bits exactly half an ulp round away from zero
    tie = (np.float32(1.0).view(np.int32) | 0x1000).view(np.float32)
    x = np.concatenate([x, [tie, -tie]]).astype(np.float32)
    hi, lo = rk.tf32_split(torch.tensor(x))
    for half in (hi, lo):
        assert half.dtype == torch.float32
        assert not (half.view(torch.int32) & 0x1FFF).any()
    h, lw = hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)
    assert np.all(np.abs(h + lw - x) <= 2.0**-21 * np.abs(x))
    assert np.all(np.abs(h - x) <= 2.0**-11 * np.abs(x))
    assert h[-2] == np.float32(1.0 + 2.0**-10) and h[-1] == -h[-2]


@pytest.mark.parametrize("B,m,N", [(5, 12, 27), (7, 13, 246), (33, 64, 300)])
def test_three_pass_product_emulated(B, m, N):
    """``A_hi B_hi + A_hi B_lo + A_lo B_hi`` in float32 (each TF32 product
    exact in float32) against the float64 product."""
    rng = np.random.default_rng(B)
    a = rng.normal(size=(B, m)).astype(np.float32)
    b = rng.normal(size=(m, N)).astype(np.float32)
    (ah, al), (bh, bl) = rk.tf32_split(torch.tensor(a)), rk.tf32_split(torch.tensor(b))
    out = (ah @ bh + ah @ bl + al @ bh).numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(out - ref).max() <= 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_sm,B,m,N,splits", [
    (132, 4096, 256, 3003, 2),  # the main path: 64 tiles x 2 slices
    (132, 4096, 256, 246, 1),   # ECSW: too short to split
    (132, 5, 12, 27, 1),
    (132, 4096, 13, 3003, 4),   # 32 tiles
    (132, 128, 128, 40000, 132),
    (8, 4096, 256, 3003, 1),    # more tiles than SMs
])
def test_project_splits_new_tile(monkeypatch, n_sm, B, m, N, splits):
    monkeypatch.setattr(rk, "_sm_count", lambda device: n_sm)
    assert rk.project_splits(B, m, N, "cuda:0") == splits


def test_cpu_operators_build_no_halves(monkeypatch):
    def no_build(*_):
        raise AssertionError("the CPU operators reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    beam = tm.DynamicEulerBernoulliBeam(helpers.nonlinear_csv(6, include_fluid=False))
    ms = ts.make_modal_rom(beam, 1e-4, rho_inf=0.5, n_modes=8, device="cpu",
                           dtype=torch.float32)
    fused = ms.make_pallas_rollout()
    eta = torch.tensor(np.random.default_rng(1).normal(scale=1e-2, size=(3, 8)),
                       dtype=torch.float32)
    op = fused.operators(eta)
    assert op.split is None
    np.testing.assert_array_equal(op.phiT.numpy(),
                                  np.asarray(ms.Phi_planar, np.float64).T.astype(np.float32))
    x = rk.rom_expand(op, eta)
    assert torch.equal(x, eta @ op.phiT)
    assert torch.equal(rk.rom_project(op, x), (x @ op.w)[None])
    with pytest.raises(ValueError, match="basis halves"):
        rk._split(op)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operators(m, N, device, seed=0):
    rng = np.random.default_rng(seed)
    phiT = torch.tensor(rng.normal(size=(m, N)), dtype=torch.float32, device=device)
    w = torch.tensor(rng.normal(size=(N, m)), dtype=torch.float32, device=device)
    z = torch.zeros(1, device=device)
    return rk.ROMOperators(phiT=phiT, w=w, lam=z, u=z, cd=None, sinv=z, sinvT=None,
                           L=z, D=z, A=z, mask=z, gathered=False, sc=(0.0,) * 9,
                           split=rk.split_basis(phiT, w))


def _scaled(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [27, 246, 3003])
@pytest.mark.parametrize("m", [12, 13, 256])
@pytest.mark.parametrize("B", [5, 4096])
def test_tensor_core_gemms_match_plain_on_card(cuda_device, B, m, N):
    op = _operators(m, N, cuda_device)
    rng = np.random.default_rng(B + m + N)
    eta_af = torch.tensor(rng.normal(size=(B, m)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=cuda_device)
    rk.reset_launch_counts()
    x = rk.rom_expand(op, eta_af)
    partials = rk.rom_project(op, g)
    assert rk.rom_expand.launches == 1 and rk.rom_project.launches == 1
    assert x.shape == (B, N) and partials.shape[1:] == (B, m)
    twin = (_scaled(x, rk.rom_expand_plain(op, eta_af)),
            _scaled(partials.sum(0), rk.rom_project_plain(op, g)[0]))
    f64 = (_scaled(x.double(), eta_af.double() @ op.phiT.double()),
           _scaled(partials.sum(0).double(), g.double() @ op.w.double()))
    assert max(twin) <= PIECE_MAX and max(f64) <= F64_MAX, (twin, f64)


@pytest.mark.cuda
def test_pad_columns_never_read_on_card(cuda_device):
    """NaN in every pad column (operands and basis halves) reaches no
    output."""
    B, N = 300, 3003
    op13, op12 = _operators(13, N, cuda_device), _operators(12, N, cuda_device)
    for half in op13.split.phi + op13.split.wt + op12.split.phi + op12.split.wt:
        rows, cols = half.shape
        pitch = half.stride(0)
        half.as_strided((rows, pitch), (pitch, 1))[:, cols:] = float("nan")
    rng = np.random.default_rng(3)

    def poisoned(rows, cols):
        buf = torch.full((rows, rk._pad4(cols)), float("nan"), device=cuda_device)
        view = buf[:, :cols]
        view.copy_(torch.tensor(rng.normal(size=(rows, cols)), dtype=torch.float32))
        return view

    eta_af, g = poisoned(B, 12), poisoned(B, N)
    x = rk.rom_expand(op12, eta_af)
    partials = rk.rom_project(op13, g)
    assert torch.isfinite(x).all() and torch.isfinite(partials).all()
    assert _scaled(x.double(), eta_af.double() @ op12.phiT.double()) <= F64_MAX
    assert _scaled(partials.sum(0).double(), g.double() @ op13.w.double()) <= F64_MAX
    # the correction kernel reads the padded rows of x and writes padded g
    n_el = N // 3 - 1
    ones = torch.ones(n_el, device=cuda_device)
    coef = torch.tensor(rk.correction_table(0.25 * np.ones(n_el), np.ones(n_el),
                                            np.ones(n_el)), dtype=torch.float32,
                        device=cuda_device)
    opc = dataclasses.replace(op12, L=0.25 * ones, D=ones, A=ones, mask=ones, coef=coef)
    x = x / x.abs().max() * 1e-3
    xp = poisoned(B, N)
    xp.copy_(x)
    gc = rk.rom_correction_window(opc, xp)
    assert gc.stride(0) == rk._pad4(N)
    ref = rk.rom_correction_window_plain(opc, x.contiguous())
    assert torch.isfinite(gc).all() and _scaled(gc, ref) <= 1e-5


@pytest.mark.cuda
def test_tensor_core_gemms_deterministic_on_card(cuda_device):
    B, m, N = 4096, 256, 3003
    op = _operators(m, N, cuda_device)
    rng = np.random.default_rng(7)
    eta_af = torch.tensor(rng.normal(size=(B, m)), dtype=torch.float32, device=cuda_device)
    x = rk.rom_expand(op, eta_af)
    assert torch.equal(rk.rom_expand(op, eta_af), x)
    assert torch.equal(rk.rom_project(op, x), rk.rom_project(op, x))

"""The fused ROM span's precision tiers and its dense Newton update.

On the CPU: ``FusedROMRollout.prepare`` records the transforms' tier
(``nl_precision`` normalised; "highest" is the float32 tier, every other
tier the 3xTF32 one), every tier takes the plain twins and matches the JAX
package's fused kernel at "highest" in interpret mode (``5e-6 x`` each
output's scale, as ``test_torch_rom_fused.py``); the dense Newton twin,
which now takes the project's partials, equals the composition it replaces
(``rom_update_plain``'s dense branch, then the product) bit for bit; an
undamped dense-``Sinv`` span matches the JAX package; the "highest"
tier's K-major, row-padded bases (built by the host function the card path
uses); the float32 project's slice count; the step
scalars' C array built once. On the card only: the float32 expand and
project within ``1e-6`` of the float32 twin's scale (both sides' float32
roundoff) and ``2e-6`` of the float64 product's at ragged shapes (every
edge of the ring and the scheduler: more units than SMs, 1, 2 and more
slices), two launches equal bit for bit, pad columns filled with NaN that
reach no output, a "highest" span launching them and no tensor-core
kernel, and the fused dense Newton kernel against its twin within ``1e-4``
of each output's scale (``chip_smoke.py``'s per-launch limit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk
from test_torch_rom_engine import _engines, _inputs, beams  # noqa: F401  (a fixture)

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
TIERS = (None, "highest", "HIGHEST", "high", "default")
# One float32 launch against the float32 twin (torch.matmul), x its scale.
# Both sides carry float32 roundoff in their own summation order: on an H100
# the kernel reads up to 6.4e-7 of the float64 product's scale on these
# random operands (a sequential sum over K) and the twin differs from it by
# up to 7.1e-7 where cuBLAS picks another algorithm (B = 5, m = 13, N = 27);
# at the main path's shapes the two agree bit for bit (chip_smoke.py phase
# 12 holds them to 5e-7 there).
F32_TWIN_MAX = 1e-6
F64_MAX = 2e-6       # one launch against the float64 product, x its scale
PIECE_MAX = 1e-4     # chip_smoke.ROM_PIECE_MAX


def _abs_close(port, ref, bound):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=bound * (np.abs(b).max() + 1e-30))


_JAX_REFS = {}


def _jax_ref(beams, dense: bool, n_newton: int):
    """The JAX fused kernel (interpret mode, "highest") over 20 steps; the
    engines and inputs it ran on."""
    key = (dense, n_newton)
    ms, port = _engines(beams, "nonlinear")
    if dense:
        ms = dataclasses.replace(ms, Sinv_diag=None)
        port = dataclasses.replace(port, Sinv_diag=None)
    eta, _, um = _inputs(ms, beams["nonlinear"][1], 3e-2, dtype=np.float32)
    etad = np.zeros_like(eta)
    if key not in _JAX_REFS:
        _JAX_REFS[key] = ms.make_pallas_rollout(tile=128)(
            jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um), 20, n_newton=n_newton,
            precision=HIGHEST, nl_precision=HIGHEST, interpret=True,
        )
    return port, (eta, etad, um), _JAX_REFS[key]


@pytest.mark.parametrize("tier", TIERS)
def test_prepare_records_tier_and_matches_jax(beams, monkeypatch, tier):
    def no_build(*_):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    port, (eta, etad, um), ref = _jax_ref(beams, dense=False, n_newton=2)
    fused = port.make_pallas_rollout()
    op = fused.prepare(torch.tensor(eta), torch.tensor(etad), um, nl_precision=tier)[0]
    want = tier.lower() if isinstance(tier, str) else tier
    assert op.nl_precision == want
    assert rk._highest(op) == (want == "highest")
    assert op.split is None  # CPU operators: no TF32 halves in any tier
    rk.reset_launch_counts()
    out = fused(torch.tensor(eta), torch.tensor(etad), um, 20, n_newton=2,
                nl_precision=tier)
    assert [fn.launches for fn in rk.KERNELS] == [0] * len(rk.KERNELS)
    _abs_close(out, ref, 5e-6)


def test_dense_span_matches_jax(beams):
    """An undamped dense-``Sinv`` span (one Newton iteration) on the CPU."""
    port, (eta, etad, um), ref = _jax_ref(beams, dense=True, n_newton=1)
    out = port.make_pallas_rollout()(torch.tensor(eta), torch.tensor(etad), um, 20,
                                     n_newton=1, nl_precision="highest")
    _abs_close(out, ref, 5e-6)


def _random_op(m, rng, dtype, damped):
    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(scale=scale, size=shape), dtype=dtype)

    return rk.ROMOperators(
        phiT=t(m, 9), w=t(9, m), lam=t(m).abs() * 1e4, u=t(m), cd=t(m).abs() if damped
        else None, sinv=None, sinvT=t(m, m, scale=1e-3), L=t(2), D=t(2), A=t(2),
        mask=t(2), gathered=False, sc=rk.step_scalars(1e-4, 0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("damped", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_newton_dense_plain_is_the_old_composition(dtype, damped, last):
    """``rom_newton_dense_plain`` on the partials equals the residual of the
    old ``rom_update_plain`` dense branch followed by the old product."""
    rng = np.random.default_rng(3)
    m, Bn = 13, 6
    op = _random_op(m, rng, dtype, damped)
    partials = torch.tensor(rng.normal(size=(3, Bn, m)), dtype=dtype)
    state = [torch.tensor(rng.normal(size=(Bn, m)), dtype=dtype) for _ in range(4)]
    gm = partials[0] + partials[1] + partials[2]  # slice order
    r = rk._residual(op, gm, *state)
    old = rk._finish(op, state[3] - r @ op.sinvT, *state[:3], last)
    new = rk.rom_newton_dense_plain(op, partials, *state, last)
    old, new = (old, new) if last else ((old,), (new,))
    assert len(old) == len(new) == (3 if last else 1)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    # and the CPU wrapper is the twin
    out = rk.rom_newton_dense(op, partials, *state, last)
    for a, b in zip(out if last else (out,), new):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_sm,B_,m,N,splits", [
    (132, 4096, 256, 3003, 4),   # the main path: 64 tiles x 4 slices, two rounds
    (132, 4096, 256, 246, 1),    # ECSW: too short to split
    (132, 5, 12, 27, 1),
    (8, 4096, 256, 3003, 1),
])
def test_project_splits_f32(monkeypatch, n_sm, B_, m, N, splits):
    monkeypatch.setattr(rk, "_sm_count", lambda device: n_sm)
    assert rk.project_splits_f32(B_, m, N, "cuda:0") == splits


@pytest.mark.parametrize("m,N", [(12, 27), (13, 129), (37, 27), (256, 3003)])
@pytest.mark.parametrize("tf32", [False, True])
def test_k_major_bases_padded(m, N, tf32):
    """``k_major_bases``, as ``split_basis`` builds the card's operators, on
    CPU tensors: Phi and W^T K-major, row pitches a multiple of 4 floats,
    the pad columns outside the logical views; one unsplit part for
    "highest", the TF32 halves otherwise."""
    rng = np.random.default_rng(m + N)
    phiT = torch.tensor(rng.normal(size=(m, N)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(N, m)), dtype=torch.float32)
    phi, wt = rk.k_major_bases(phiT, w, tf32=tf32)
    assert len(phi) == len(wt) == (2 if tf32 else 1)
    for parts, ref in ((phi, phiT.T), (wt, w.T)):
        for part in parts:
            rows, cols = ref.shape
            assert part.shape == (rows, cols) and part.stride() == (rk._pad4(cols), 1)
            assert part.untyped_storage().nbytes() == 4 * rows * rk._pad4(cols)
        if tf32:
            for part, half in zip(parts, rk.tf32_split(ref)):
                assert torch.equal(part, half)
        else:
            assert torch.equal(parts[0], ref)


def test_step_scalars_c_array_built_once():
    op = _random_op(5, np.random.default_rng(0), torch.float32, False)
    assert list(op.csc) == pytest.approx(op.sc, rel=1e-6)
    assert dataclasses.replace(op, u=op.lam).csc is op.csc


def test_highest_wrappers_take_the_twins_on_cpu():
    rng = np.random.default_rng(1)
    op = dataclasses.replace(_random_op(7, rng, torch.float32, False),
                             nl_precision="highest")
    eta_af = torch.tensor(rng.normal(size=(4, 7)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(4, 9)), dtype=torch.float32)
    rk.reset_launch_counts()
    for fn in (rk.rom_expand, rk.rom_expand_f32):
        assert torch.equal(fn(op, eta_af), eta_af @ op.phiT)
    for fn in (rk.rom_project, rk.rom_project_f32):
        assert torch.equal(fn(op, g), (g @ op.w)[None])
    assert [f.launches for f in rk.KERNELS] == [0] * len(rk.KERNELS)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scaled(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def _highest_op(m, N, device, rng):
    phiT = torch.tensor(rng.normal(size=(m, N)), dtype=torch.float32, device=device)
    w = torch.tensor(rng.normal(size=(N, m)), dtype=torch.float32, device=device)
    z = torch.zeros(1, device=device)
    return rk.ROMOperators(phiT=phiT, w=w, lam=z, u=z, cd=None, sinv=z, sinvT=None, L=z,
                           D=z, A=z, mask=z, gathered=False, sc=(0.0,) * 9,
                           split=rk.split_basis(phiT, w, tf32=False), nl_precision="highest")


# Ragged shapes reach every edge of the ring and the scheduler: a partial
# row or column tile, K not a multiple of the 32-deep slice, more units than
# SMs (the expand at B = 4096, N = 3003: 768 units; the project at 4096 x
# 256 x 3003: 256), S = 1 (N = 27, 129), 2 (4096 x 256 x 600), 4 (4096 x
# 256 x 3003), 8 (4096 x 12, 13 or 37 x 3003) and 11 (B = 5 or 129, N =
# 3003) slices.
@pytest.mark.cuda
@pytest.mark.parametrize("N", [27, 129, 600, 3003])
@pytest.mark.parametrize("m", [12, 13, 37, 256])
@pytest.mark.parametrize("B_", [5, 129, 4096])
def test_float32_gemms_on_card(cuda_device, B_, m, N):
    rng = np.random.default_rng(B_ + m + N)
    op = _highest_op(m, N, cuda_device, rng)
    phiT, w = op.phiT, op.w
    eta_af = torch.tensor(rng.normal(size=(B_, m)), dtype=torch.float32, device=cuda_device)
    g = rk._padded_empty(B_, N, eta_af)
    g.copy_(torch.tensor(rng.normal(size=(B_, N)), dtype=torch.float32))
    rk.reset_launch_counts()
    x = rk.rom_expand(op, eta_af)
    partials = rk.rom_project(op, g)
    counts = {f.__name__: f.launches for f in rk.KERNELS}
    assert counts["rom_expand_f32"] == counts["rom_project_f32"] == 1
    assert counts["rom_expand"] == counts["rom_project"] == 0
    assert partials.shape == (rk.project_splits_f32(B_, m, N, cuda_device), B_, m)
    twin = (_scaled(x, eta_af @ phiT), _scaled(partials.sum(0), g @ w))
    f64 = (_scaled(x.double(), eta_af.double() @ phiT.double()),
           _scaled(partials.sum(0).double(), g.double() @ w.double()))
    assert max(twin) <= F32_TWIN_MAX and max(f64) <= F64_MAX, (twin, f64)


@pytest.mark.cuda
def test_float32_gemms_deterministic_on_card(cuda_device):
    B_, m, N = 4096, 256, 3003
    rng = np.random.default_rng(11)
    op = _highest_op(m, N, cuda_device, rng)
    eta_af = torch.tensor(rng.normal(size=(B_, m)), dtype=torch.float32, device=cuda_device)
    x = rk.rom_expand_f32(op, eta_af)
    assert torch.equal(rk.rom_expand_f32(op, eta_af), x)
    assert torch.equal(rk.rom_project_f32(op, x), rk.rom_project_f32(op, x))


@pytest.mark.cuda
def test_float32_pad_columns_never_read_on_card(cuda_device):
    """NaN in every pad column (operands and unsplit bases) reaches no
    output."""
    B_, N = 300, 3003
    rng = np.random.default_rng(5)
    op13, op12 = _highest_op(13, N, cuda_device, rng), _highest_op(12, N, cuda_device, rng)
    for part in op13.split.phi + op13.split.wt + op12.split.phi + op12.split.wt:
        rows, cols = part.shape
        pitch = part.stride(0)
        part.as_strided((rows, pitch), (pitch, 1))[:, cols:] = float("nan")

    def poisoned(rows, cols):
        buf = torch.full((rows, rk._pad4(cols)), float("nan"), device=cuda_device)
        view = buf[:, :cols]
        view.copy_(torch.tensor(rng.normal(size=(rows, cols)), dtype=torch.float32))
        return view

    eta_af, g = poisoned(B_, 12), poisoned(B_, N)
    x = rk.rom_expand_f32(op12, eta_af)
    partials = rk.rom_project_f32(op13, g)
    assert torch.isfinite(x).all() and torch.isfinite(partials).all()
    assert _scaled(x.double(), eta_af.double() @ op12.phiT.double()) <= F64_MAX
    assert _scaled(partials.sum(0).double(), g.double() @ op13.w.double()) <= F64_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["highest", None])
def test_span_tier_launches_on_card(beams, cuda_device, tier):
    ms, port = _engines(beams, "mixed", (0.5, 1e-6))
    fused = port.make_pallas_rollout()
    eta, etad, um = _inputs(ms, beams["mixed"][1], 3e-2, dtype=np.float32)
    op, e, ed, a0, _ = fused.prepare(torch.tensor(eta, device=cuda_device),
                                     torch.tensor(etad, device=cuda_device), um,
                                     nl_precision=tier)
    assert len(op.split.phi) == len(op.split.wt) == (1 if tier == "highest" else 2)
    rk.reset_launch_counts()
    out = rk.rom_steps(op, e, ed, a0, 50, n_newton=2)
    counts = {f.__name__: f.launches for f in rk.KERNELS}
    f32, tc = ("rom_expand_f32", "rom_project_f32"), ("rom_expand", "rom_project")
    on, off = (f32, tc) if tier == "highest" else (tc, f32)
    assert all(counts[k] == 100 for k in on) and not any(counts[k] for k in off)
    ref = rk.rom_steps_plain(op, e, ed, a0, 50, n_newton=2)
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= 5e-6 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 13, 256, 300])
@pytest.mark.parametrize("B_", [5, 4096])
@pytest.mark.parametrize("last", [False, True])
def test_newton_dense_kernel_on_card(cuda_device, B_, m, last):
    rng = np.random.default_rng(B_ + m)
    ops = _random_op(m, rng, torch.float32, damped=True)
    sinvT = rk._padded_empty(m, m, ops.sinvT.to(cuda_device))  # as the card's upload
    sinvT.copy_(ops.sinvT)
    op = dataclasses.replace(ops, lam=ops.lam.to(cuda_device), u=ops.u.to(cuda_device),
                             cd=ops.cd.to(cuda_device), sinvT=sinvT)
    partials = torch.tensor(rng.normal(size=(2, B_, m)), dtype=torch.float32,
                            device=cuda_device)
    state = [torch.tensor(rng.normal(size=(B_, m)), dtype=torch.float32, device=cuda_device)
             for _ in range(4)]
    rk.reset_launch_counts()
    out = rk.rom_newton_dense(op, partials, *state, last)
    assert rk.rom_newton_dense.launches == 1
    ref = rk.rom_newton_dense_plain(op, partials, *state, last)
    out, ref = (out, ref) if last else ((out,), (ref,))
    for a, b in zip(out, ref):
        assert _scaled(a, b) <= PIECE_MAX
    # a1 aliasing etadd, as on a step's first iteration
    alias = rk.rom_newton_dense(op, partials, *state[:3], state[2], last)
    ref = rk.rom_newton_dense_plain(op, partials, *state[:3], state[2], last)
    for a, b in zip(alias if last else (alias,), ref if last else (ref,)):
        assert _scaled(a, b) <= PIECE_MAX

"""The ROM span's von Kármán correction kernels (``rom_correction_window``,
``rom_correction_gathered``) and their per-element factor table.

The kernels evaluate ``elements.nonlinear_correction_planes`` as a
polynomial in the six node states whose 17 per-element factors (``A/15``,
``A/(20L)``, ``(36/35) A/L^3``, ... each times the mask) are formed once in
float64 by ``rom_rollout.correction_table`` and read from a float32 table.

On the CPU: the table as ``FusedROMRollout.operators`` builds it for the
window and for an ECSW sample; the coefficient form, written here in the
kernel's order (``correction`` in ``csrc/rom_rollout.cu``), against the
port's and the JAX package's ``nonlinear_correction_planes`` in float64 to
``1e-12`` of each slot's scale, and in float32 within 1.5x the float32
twin's own error against float64; ragged element counts, masked (hybrid)
elements, padded ECSW rows (``L = 1, A = 0``: exact zeros) and a spread of
element lengths; the window kernel's thread map (31 nodes a warp, the
shuffles) emulated in NumPy against the twin. On the card only: each
kernel against its twin at ragged shapes (``1e-4`` of the scale, the
per-launch limit of ``chip_smoke.py``) and against float64, two launches
bit-equal, pad columns untouched, and no launch without the table.
"""

import dataclasses

import helpers
import numpy as np
import pytest
import torch

import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu.models import elements as je
from continuum_robot_tpu_torch.models import elements as te
from continuum_robot_tpu_torch.models import simulate as ts
from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

torch.set_num_threads(1)

PIECE_MAX = 1e-4  # one launch against its twin, x max|twin| (chip_smoke.ROM_PIECE_MAX)
F32_RATIO_MAX = 1.5  # float32 error of the factor form over the twin's, against float64
SCALES = (1e-4, 1e-3, 1e-2, 1e-4, 1e-3, 1e-2)  # u, w, theta of each node


def coefficient_form(c, u1, w1, t1, u2, w2, t2):
    """The six slots ``(g1, g3, g4, g2, g5, g6)`` from the factor table's
    rows ``c`` and the node states, term by term as the kernel forms them."""
    dw = w1 - w2
    du = u1 - u2
    s = t1 + t2
    t1t2 = t1 * t2
    tsq = t1 * t1 + t2 * t2
    dw2 = dw * dw
    dw3 = dw2 * dw
    t1c, t2c = t1 * t1 * t1, t2 * t2 * t2
    t112, t122 = t1 * t1 * t2, t1 * t2 * t2
    g1 = (-c[0] * tsq + c[1] * t1t2 + c[2] * (s * u2) + c[3] * (s * dw)
          - c[4] * (u2 * dw) - c[4] * dw2)
    g2 = c[0] * tsq - c[1] * t1t2 - c[3] * (s * dw) + c[4] * dw2
    g3 = (c[5] * (t1c + t2c) - c[6] * (t1t2 * s) + c[7] * (tsq * dw) + c[3] * (du * s)
          - c[8] * (s * dw2) - c[9] * (du * dw) + c[10] * dw3)
    g4 = (c[11] * t1c - c[14] * t112 + c[12] * t122 - c[13] * t2c
          + c[6] * (dw * (t1 * t1 - 2.0 * t1t2 - t2 * t2)) - c[15] * (t1 * du)
          + c[1] * (t2 * du) + c[7] * (t1 * dw2) + c[3] * (du * dw) - c[16] * dw3)
    g6 = (-c[13] * t1c + c[12] * t112 - c[14] * t122 + c[11] * t2c
          + c[6] * (dw * (-t1 * t1 - 2.0 * t1t2 + t2 * t2)) + c[1] * (t1 * du)
          - c[15] * (t2 * du) + c[7] * (t2 * dw2) + c[3] * (du * dw) - c[16] * dw3)
    return g1, g3, g4, g2, -g3, g6


def _elements(E, rng, case):
    """``(L, A, mask)`` of ``E`` elements: a spread of lengths and
    stiffnesses; "hybrid" masks some, "padded" ends in ECSW pad rows."""
    L = rng.uniform(0.02, 0.3, E)
    A = rng.uniform(1e5, 1e7, E)
    mask = np.ones(E)
    if case == "hybrid":
        mask = (rng.uniform(size=E) > 0.3).astype(np.float64)
    if case == "padded":
        pad = E // 3 + 1
        L[-pad:], A[-pad:], mask[-pad:] = 1.0, 0.0, 0.0
    return L, A, mask


def _states(B, E, rng):
    return [rng.normal(scale=sc, size=(B, E)) for sc in SCALES]


def _masked_planes(planes_fn, xs, L, A, mask, conv):
    g = planes_fn(*map(conv, xs), *map(conv, (L, np.ones_like(L), A)))
    return [conv(mask) * gi for gi in g]


def _scaled(out, ref) -> float:
    """The largest ``max|out_k - ref_k| / max|ref_k|`` over the slots."""
    errs = []
    for o, r in zip(out, ref):
        o, r = (np.asarray(v, np.float64) for v in (o, r))
        scale = np.abs(r).max()
        errs.append(np.abs(o - r).max() / scale if scale else np.abs(o).max())
    return max(errs)


def test_table_rows_are_the_factors():
    rng = np.random.default_rng(0)
    L, A, mask = _elements(9, rng, "hybrid")
    c = rk.correction_table(L, A, mask)
    assert c.shape == (rk.CORRECTION_FACTORS, 9) and c.dtype == np.float64
    a = A * mask
    want = [a / 15, a / 30, a / (20 * L), a / (10 * L), 0.6 * a / L**2, a / 280,
            3 * a / 280, 9 / 70 * a / L, 27 / 70 * a / L**2, 1.2 * a / L**2,
            36 / 35 * a / L**3, a * L / 35, a * L / 140, a * L / 280, 3 * a * L / 280,
            2 / 15 * a, 9 / 70 * a / L**2]
    np.testing.assert_allclose(c, np.stack(want), rtol=1e-15, atol=0)
    assert not c[:, mask == 0].any()


@pytest.mark.parametrize("layout", ["window", "gathered"])
@pytest.mark.parametrize("csv", ["nonlinear", "mixed"])
def test_operators_table_is_the_host_table(layout, csv):
    """The table ``FusedROMRollout.operators`` uploads on the card, built on
    the CPU by the same host function from the window's or the sample's
    parameters; the CPU operators carry none and the wrappers take the
    twins."""
    make = helpers.nonlinear_csv if csv == "nonlinear" else helpers.mixed_csv
    beam = tm.DynamicEulerBernoulliBeam(make(8, include_fluid=False))
    ms = ts.make_modal_rom(beam, 1e-4, rho_inf=0.5, n_modes=8, device="cpu",
                           dtype=torch.float32)
    if layout == "gathered":
        ms = ms.apply_ecsw(np.array([0, 2, 3]), np.ones(3))
    fused = ms.make_pallas_rollout()
    params = ms.sampled_params if layout == "gathered" else ms.window_params
    L, A = params["length"], params["EA"]
    mask = np.asarray(params["nonlinear_mask"], np.float64)
    table = rk.correction_table(L, A, mask)
    E = 3 if layout == "gathered" else fused.ms.Phi_planar.shape[0] // 3 - 1
    assert table.shape == (rk.CORRECTION_FACTORS, E)
    assert np.array_equal(table, rk.correction_table(fused._host["L"], fused._host["A"],
                                                     fused._host["mask"]))
    assert np.array_equal((table == 0).all(0), mask == 0)
    rng = np.random.default_rng(1)
    eta = torch.tensor(rng.normal(scale=1e-3, size=(3, 8)), dtype=torch.float32)
    op = fused.operators(eta)
    assert op.coef is None
    x = torch.tensor(rng.normal(scale=1e-3, size=(3, op.n_rows)), dtype=torch.float32)
    rk.reset_launch_counts()
    assert torch.equal(rk.rom_correction(op, x), rk._plain_correction(op, x))
    assert rk.rom_correction_window.launches == rk.rom_correction_gathered.launches == 0
    # the table's float64 form gives the twin's slots on these parameters
    p = x.double().reshape(3, 6 if layout == "gathered" else 3, -1)
    blocks = (p.unbind(1) if layout == "gathered"
              else (p[:, 0, :-1], p[:, 1, :-1], p[:, 2, :-1],
                    p[:, 0, 1:], p[:, 1, 1:], p[:, 2, 1:]))
    ref = _masked_planes(te.nonlinear_correction_planes, [b.numpy() for b in blocks],
                         L, A, mask, torch.tensor)
    out = coefficient_form(torch.tensor(table)[:, None, :], *blocks)
    assert _scaled(out, ref) <= 1e-12


@pytest.mark.parametrize("E", [1, 7, 33, 1000])
@pytest.mark.parametrize("case", ["uniform", "hybrid", "padded"])
def test_coefficient_form_float64(E, case):
    """The factor form in float64 against the port's and the JAX package's
    ``nonlinear_correction_planes`` (masked), to 1e-12 of each slot's
    scale; padded rows give exact zeros."""
    rng = np.random.default_rng(E)
    L, A, mask = _elements(E, rng, case)
    xs = _states(5, E, rng)
    c = rk.correction_table(L, A, mask)
    out = coefficient_form(torch.tensor(c)[:, None, :], *map(torch.tensor, xs))
    port = _masked_planes(te.nonlinear_correction_planes, xs, L, A, mask, torch.tensor)
    jax = _masked_planes(je.nonlinear_correction_planes, xs, L, A, mask, np.asarray)
    assert _scaled(out, port) <= 1e-12 and _scaled(out, jax) <= 1e-12
    dead = mask == 0
    for g in out:
        assert not g[:, torch.tensor(dead)].any()


def _rms(out, ref) -> float:
    """The largest root-mean-square error over the slots, each over its
    slot's ``max|ref_k|``."""
    return max(float(np.sqrt(np.mean((np.asarray(o, np.float64) - np.asarray(r)) ** 2))
                     / np.abs(np.asarray(r)).max()) for o, r in zip(out, ref))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["uniform", "hybrid", "padded"])
def test_coefficient_form_float32_error(seed, case):
    """In float32, with the table rounded once from float64, the factor
    form's largest error against the float64 planes is within 1.5x the
    float32 twin's own (the twin: ``nonlinear_correction_planes`` in
    float32 times the mask), and its RMS error is no larger than the
    twin's. Both are a few float32 roundings of the scale, so the ratio of
    their largest errors is the ratio of two extremes of a roundoff
    distribution: 256 envs x 1000 elements give each slot enough samples
    for it to settle; over a few dozen envs single draws can pass 1.5
    while the RMS error stays below the twin's."""
    rng = np.random.default_rng(100 + seed)
    E = 1000
    L, A, mask = _elements(E, rng, case)
    xs = _states(256, E, rng)
    ref = _masked_planes(te.nonlinear_correction_planes, xs, L, A, mask, torch.tensor)

    def f32(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32)

    twin = _masked_planes(te.nonlinear_correction_planes, xs, L, A, mask, f32)
    out = coefficient_form(f32(rk.correction_table(L, A, mask))[:, None, :], *map(f32, xs))
    twin_err, err = _scaled(twin, ref), _scaled(out, ref)
    assert 0 < twin_err < 1e-5
    assert err <= F32_RATIO_MAX * twin_err, (err, twin_err)
    assert _rms(out, ref) <= _rms(twin, ref)


def _window_thread_map(x, c):
    """The window kernel's thread map in NumPy (float64): warps of 32
    lanes, lane l of warp wx holding node n = 31 wx + l and element n, node
    n + 1 from lane l + 1 (lane 31 loads it), node-2 slots to lane l + 1,
    lane 0 writing only in the first warp."""
    B, N = x.shape
    n_sub = N // 3
    n_el = n_sub - 1
    p = x.reshape(B, 3, n_sub)
    g = np.full((B, 3, n_sub), np.nan)
    for wx in range(max(-(-n_el // 31), 1)):
        n = 31 * wx + np.arange(32)
        has_node, has_el = n < n_sub, n < n_el
        own = np.where(has_node[None, None], p[:, :, np.minimum(n, n_sub - 1)], 0.0)
        nxt = np.zeros_like(own)
        nxt[:, :, :31] = own[:, :, 1:]                       # __shfl_down_sync
        if has_el[31]:
            nxt[:, :, 31] = p[:, :, n[31] + 1]              # lane 31's own load
        cw = np.zeros((rk.CORRECTION_FACTORS, 32))
        cw[:, has_el] = c[:, n[has_el]]
        sl = coefficient_form(cw[:, None, :], *own.transpose(1, 0, 2), *nxt.transpose(1, 0, 2))
        for q in range(3):
            prev = np.concatenate([sl[3 + q][:, :1], sl[3 + q][:, :31]], axis=1)  # __shfl_up_sync
            mine = np.where(has_el, sl[q], 0.0)
            val = np.where(n > 0, mine + prev, mine)
            writes = has_node & ((np.arange(32) > 0) | (wx == 0))
            g[:, q, n[writes]] = val[:, writes]
    return g.reshape(B, N)


@pytest.mark.parametrize("n_sub", [1, 2, 31, 32, 33, 63, 64, 94])
def test_window_thread_map_emulated(n_sub):
    """Every node written once, each as the twin sums it."""
    rng = np.random.default_rng(n_sub)
    n_el = n_sub - 1
    L, A, mask = _elements(max(n_el, 1), rng, "hybrid")
    L, A, mask = L[:n_el], A[:n_el], mask[:n_el]
    x = np.concatenate(_states(3, n_sub, rng)[:3], axis=1)
    g = _window_thread_map(x, rk.correction_table(L, A, mask))
    assert not np.isnan(g).any()
    op = rk.ROMOperators(phiT=None, w=None, lam=None, u=None, cd=None, sinv=None,
                         sinvT=None, L=torch.tensor(L), D=torch.ones(n_el, dtype=torch.float64),
                         A=torch.tensor(A), mask=torch.tensor(mask), gathered=False,
                         sc=(0.0,) * 9)
    ref = rk.rom_correction_window_plain(op, torch.tensor(x)).numpy()
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_op(L, A, mask, gathered, dev):
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    return rk.ROMOperators(phiT=None, w=None, lam=None, u=None, cd=None, sinv=None,
                           sinvT=None, L=t(L), D=t(np.ones_like(L)), A=t(A), mask=t(mask),
                           gathered=gathered, sc=(0.0,) * 9,
                           coef=t(rk.correction_table(L, A, mask)))


def _poisoned_rows(x, dev):
    """``x`` in a buffer whose rows are padded with NaN (4-float pitch)."""
    B, N = x.shape
    buf = torch.full((B, rk._pad4(N) + 4), float("nan"), device=dev)
    view = buf[:, :N]
    view.copy_(torch.tensor(x, dtype=torch.float32))
    return view


def _check_on_card(op, x, dev, kern, plain, n_per_row):
    rk.reset_launch_counts()
    g = kern(op, x)
    assert kern.launches == 1 and g.shape == x.shape
    assert torch.isfinite(g).all()
    twin = plain(op, x.contiguous())
    op64 = dataclasses.replace(op, L=op.L.double(), D=op.D.double(), A=op.A.double(),
                               mask=op.mask.double(), coef=None)
    f64 = plain(op64, x.double().contiguous())
    assert _scaled([g.cpu()], [twin.cpu()]) <= PIECE_MAX
    assert _scaled([g.cpu()], [f64.cpu()]) <= 2e-6
    assert torch.equal(kern(op, x), g)  # two launches, bit for bit
    # the pad columns of the output are never written
    B, N = x.shape
    out = torch.full((B, rk._pad4(N) + 4), float("nan"), device=dev)
    rk._launch(kern.__name__, x, B, N // n_per_row, x.data_ptr(), x.stride(0),
               op.coef.data_ptr(), out.data_ptr(), out.stride(0))
    assert torch.equal(out[:, :N], g) and torch.isnan(out[:, N:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [2, 31, 32, 33, 63, 1001])
@pytest.mark.parametrize("B", [1, 3, 4096])
def test_window_kernel_on_card(cuda_device, B, n_sub):
    rng = np.random.default_rng(B + n_sub)
    op = _card_op(*_elements(n_sub - 1, rng, "hybrid"), False, cuda_device)
    x = _poisoned_rows(np.concatenate(_states(B, n_sub, rng)[:3], axis=1), cuda_device)
    _check_on_card(op, x, cuda_device, rk.rom_correction_window,
                   rk.rom_correction_window_plain, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 41, 300])
@pytest.mark.parametrize("B", [1, 3, 4096])
def test_gathered_kernel_on_card(cuda_device, B, s):
    rng = np.random.default_rng(B + s)
    op = _card_op(*_elements(s, rng, "padded" if s > 1 else "hybrid"), True, cuda_device)
    x = _poisoned_rows(np.concatenate(_states(B, s, rng), axis=1), cuda_device)
    _check_on_card(op, x, cuda_device, rk.rom_correction_gathered,
                   rk.rom_correction_gathered_plain, 6)


@pytest.mark.cuda
def test_no_launch_without_the_table_on_card(cuda_device):
    rng = np.random.default_rng(5)
    op = _card_op(*_elements(10, rng, "uniform"), False, cuda_device)
    x = torch.zeros((2, 33), device=cuda_device)
    rk.reset_launch_counts()
    for bad in (None, op.coef[:, :9]):
        with pytest.raises(ValueError, match="factor table"):
            rk.rom_correction_window(dataclasses.replace(op, coef=bad), x)
    assert rk.rom_correction_window.launches == 0

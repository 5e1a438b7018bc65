"""Block-tridiagonal algebra of the PyTorch port against the JAX package.

``continuum_robot_tpu_torch/ops/banded.py`` is held to
``continuum_robot_tpu/ops/banded.py`` on the random systems of
``tests/test_banded.py`` (float64, relative tolerance 1e-12): inverse
blocks, matvec, Thomas factor and solve, cyclic reduction and the boundary
masking, for NumPy and torch inputs and per-environment (batched) factors.
The kernel's plain version ``banded.btd_solve`` is also held to the Pallas
kernel ``btd_solve_pallas`` in interpret mode at the shapes of
``tests/test_pallas.py``; the CUDA kernel itself is held to the plain
version bit for bit by the ``cuda``-marked test here and by
``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from continuum_robot_tpu.ops import banded as jb
from continuum_robot_tpu.ops.pallas import btd_solve_pallas
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.ops import banded as tb
from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb

RTOL = 1e-12


def _close(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _system(n, seed=0, sym=False):
    # Imported here: the card-only test below runs where ``tests`` may name
    # another package.
    from tests.test_banded import random_btd

    rng = np.random.default_rng(seed)
    diag, lower, upper, dense = random_btd(rng, n, sym=sym)
    return rng, (diag, lower, upper), dense


def _jax_factors(bands):
    return jb.btd_factor(*(jnp.asarray(x) for x in bands))


def test_inv33_numpy_and_torch():
    m = np.random.default_rng(0).normal(size=(17, 3, 3)) + 4 * np.eye(3)
    ref = np.asarray(jb.inv33(jnp.asarray(m)))
    out_np = tb.inv33(m)
    assert isinstance(out_np, np.ndarray)
    _close(out_np, ref)
    _close(tb.inv33(torch.tensor(m)), ref)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_btd_matvec(as_tensor):
    rng, bands, dense = _system(9, seed=1)
    x = rng.normal(size=(4, 9, 3))
    ref = np.asarray(jb.btd_matvec(*(jnp.asarray(b) for b in bands), jnp.asarray(x)))
    args = [torch.tensor(a) for a in (*bands, x)] if as_tensor else [*bands, x]
    _close(tb.btd_matvec(*args), ref)
    _close(ref.reshape(4, -1), x.reshape(4, -1) @ dense.T)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_factor_and_solve(sym, as_tensor):
    rng, bands, dense = _system(9, seed=2, sym=sym)
    b = rng.normal(size=(5, 9, 3))
    jf = _jax_factors(bands)
    args = [torch.tensor(a) for a in bands] if as_tensor else bands
    tf = tb.btd_factor(*args)
    for a, r in zip(tf, jf):
        assert isinstance(a, torch.Tensor) == as_tensor
        _close(a, r)
    x = tb.btd_solve(tf, torch.tensor(b) if as_tensor else b)
    _close(x, jb.btd_solve(jf, jnp.asarray(b)))
    x = np.asarray(x)
    for k in range(5):
        np.testing.assert_allclose(x[k].ravel(), np.linalg.solve(dense, b[k].ravel()),
                                   rtol=1e-9, atol=1e-12)


def test_per_environment_factors():
    """Batched factors (one system per env, as full Newton builds them)
    solve each env against its own system."""
    from tests.test_banded import random_btd

    rng = np.random.default_rng(3)
    systems = [random_btd(rng, 6) for _ in range(4)]
    bands = [torch.tensor(np.stack([s[i] for s in systems])) for i in range(3)]
    b = rng.normal(size=(4, 6, 3))
    x = tb.btd_solve(tb.btd_factor(*bands), torch.tensor(b)).numpy()
    for k, s in enumerate(systems):
        np.testing.assert_allclose(x[k].ravel(), np.linalg.solve(s[3], b[k].ravel()),
                                   rtol=1e-9, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _cr_case(n):
    """A system of ``n`` nodes, rhs and the JAX package's CR solution."""
    rng, bands, _ = _system(n, seed=4 + n)
    b = rng.normal(size=(3, n, 3))
    jf = jb.btd_cr_factor(*(jnp.asarray(x) for x in bands))
    return bands, b, (int(jf["n"]), int(jf["m_pad"])), np.asarray(
        jb.btd_cr_solve(jf, jnp.asarray(b)))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 13])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_cyclic_reduction(n, as_tensor):
    bands, b, sizes, ref = _cr_case(n)
    args = [torch.tensor(a) for a in bands] if as_tensor else bands
    tf = tb.btd_cr_factor(*args)
    assert (tf["n"], tf["m_pad"]) == sizes
    _close(tb.btd_cr_solve(tf, torch.tensor(b) if as_tensor else b), ref)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_apply_bc(as_tensor):
    rng, bands, _ = _system(5, seed=6)
    mask = np.ones((5, 3), bool)
    mask[0] = False
    mask[3, 1] = False
    ref = jb.btd_apply_bc(*bands, mask)
    args = [torch.tensor(a) for a in bands] if as_tensor else bands
    for a, r in zip(tb.btd_apply_bc(*args, mask), ref):
        _close(a, r)


@pytest.mark.parametrize("n_nodes,batch", [(7, 4), (13, 10), (5, 3)])
def test_plain_twin_matches_pallas_kernel(n_nodes, batch):
    """The kernel's plain version against the Pallas kernel (interpret
    mode), fed the same JAX factorization."""
    rng, bands, dense = _system(n_nodes)
    jf = _jax_factors(bands)
    rhs = rng.normal(size=(batch, n_nodes, 3))
    ref = np.asarray(btd_solve_pallas(jf, jnp.asarray(rhs), tile=4, interpret=True))
    tf = convert.btd_factors_from_numpy(*(np.asarray(f) for f in jf), device="cpu")
    x = kb.btd_solve(tf, torch.tensor(rhs))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-10, atol=1e-12)
    for k in range(batch):
        np.testing.assert_allclose(x[k].numpy().ravel(),
                                   np.linalg.solve(dense, rhs[k].ravel()),
                                   rtol=1e-8, atol=1e-10)


def test_cpu_tensors_never_build(monkeypatch):
    """A CPU tensor runs the plain version: no build, no launch, same bits."""

    def no_build(*_):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    kb.reset_launch_counts()
    rng, bands, _ = _system(6, seed=7)
    f = tb.btd_factor(*(torch.tensor(a) for a in bands))
    rhs = torch.tensor(rng.normal(size=(2, 3, 6, 3)))
    assert torch.equal(kb.btd_solve(f, rhs), tb.btd_solve(f, rhs))
    assert kb.btd_solve.launches == 0


def test_kernel_wrapper_checks():
    f = tb.btd_factor(*(torch.tensor(a) for a in _system(4)[1]))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kb.btd_solve(tuple(x.to("meta") for x in f), torch.zeros(2, 4, 3, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_nodes,batch", [(13, 5), (130, 70), (1, 3)])
def test_kernel_bit_equal_to_plain_on_card(cuda_device, dtype, n_nodes, batch):
    rng = np.random.default_rng(8)
    d = rng.normal(size=(n_nodes, 3, 3))
    bands = (d + np.swapaxes(d, -1, -2) + 10 * np.eye(3),
             0.3 * rng.normal(size=(n_nodes - 1, 3, 3)),
             0.3 * rng.normal(size=(n_nodes - 1, 3, 3)))
    f = tuple(torch.tensor(np.asarray(x), dtype=dtype, device=cuda_device)
              for x in tb.btd_factor(*bands))
    rhs = torch.tensor(rng.normal(size=(batch, n_nodes, 3)), dtype=dtype, device=cuda_device)
    kb.reset_launch_counts()
    out = kb.btd_solve(f, rhs)
    assert kb.btd_solve.launches == 1
    assert torch.equal(out, tb.btd_solve(f, rhs))


def test_packed_factors_hold_the_same_blocks():
    """The kernel's packed factors: the same nine values per 3x3 block, each
    row padded by a zero; node 0's forward block and node N-1's upper block
    zero."""
    for n in (1, 2, 9):
        f = tb.btd_factor(*(torch.tensor(a) for a in _system(n, seed=n)[1]))
        p = kb.pack_factors(f)
        assert isinstance(p, tuple) and all(a is b for a, b in zip(p, f))
        assert kb.pack_factors(p) is p
        fwd, bwd = p.fwd.reshape(n, 3, 4), p.bwd.reshape(n, 2, 3, 4)
        assert fwd.is_contiguous() and bwd.is_contiguous()
        for blocks in (fwd, bwd[:, 0], bwd[:, 1]):
            assert not blocks[..., 3].any()
        assert torch.equal(fwd[1:, :, :3], f[1]) and not fwd[0].any()
        assert torch.equal(bwd[:, 0, :, :3], f[0])
        assert torch.equal(bwd[:-1, 1, :, :3], f[2]) and not bwd[-1, 1].any()


def test_padded_pitch_rows_solve_the_same():
    """Right-hand sides in rows of a padded pitch (as the implicit operator
    hands them to the kernel) give the same solution, bit for bit; the
    kernel reads such rows in place and copies others."""
    rng, bands, _ = _system(7, seed=9)
    f = kb.pack_factors(tb.btd_factor(*(torch.tensor(a) for a in bands)))
    rhs = torch.tensor(rng.normal(size=(5, 7, 3)))
    buf = torch.full((5, kb.padded_width(21)), float("nan"), dtype=torch.float64)
    padded = buf[:, :21].copy_(rhs.reshape(5, 21)).reshape(5, 7, 3)
    assert padded.stride() == (24, 3, 1)
    assert torch.equal(kb.btd_solve(f, padded), kb.btd_solve(f, rhs))
    assert kb._kernel_rows(padded.reshape(5, 21))
    assert not kb._kernel_rows(rhs.reshape(5, 21))  # pitch 21: copied
    assert not kb._kernel_rows(rhs[-1:].reshape(1, 21))  # no room for 24
    assert kb._kernel_rows(torch.zeros(1, 24)[:, :21])


def test_operator_pads_the_kernels_rows(monkeypatch):
    """``make_newmark_operator(linear_solver="pallas")`` hands the solve
    rows padded to a multiple of 4 elements and packed factors; its solves
    equal "btd"'s bit for bit."""
    import helpers
    import continuum_robot_tpu_torch.models as tm
    from continuum_robot_tpu_torch.models import simulate as ts

    beam = tm.DynamicEulerBernoulliBeam(helpers.nonlinear_csv(6, include_fluid=False))
    seen = []
    real = kb.btd_solve

    def spy(factors, rhs):
        seen.append((type(factors), rhs.stride()))
        return real(factors, rhs)

    monkeypatch.setattr(kb, "btd_solve", spy)
    rng = np.random.default_rng(10)
    r = torch.tensor(rng.normal(size=(4, beam.n_pos_states)))
    out = ts.make_newmark_operator(beam, dt=1e-4, linear_solver="pallas",
                                   device="cpu").solve(None, 0.0)(r)
    n_full = 3 * (beam.n_pos_states // 3 + 1)
    assert seen == [(kb.BTDFactors, (kb.padded_width(n_full), 3, 1))]
    ref = ts.make_newmark_operator(beam, dt=1e-4, linear_solver="btd",
                                   device="cpu").solve(None, 0.0)(r)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_ragged_shapes_bit_equal_on_card(cuda_device, dtype, padded):
    """B across the 32-env blocks, N across the chunk (64 nodes in float32,
    32 in float64) and the main path's 1001 nodes, rows of either pitch."""
    chunk = 64 if dtype == torch.float32 else 32
    rng = np.random.default_rng(12)
    for n in (1, 2, chunk - 1, chunk + 1, 1001):
        d = rng.normal(size=(n, 3, 3))
        bands = (d + np.swapaxes(d, -1, -2) + 10 * np.eye(3),
                 0.3 * rng.normal(size=(n - 1, 3, 3)), 0.3 * rng.normal(size=(n - 1, 3, 3)))
        f = kb.pack_factors(tuple(torch.tensor(np.asarray(x), dtype=dtype, device=cuda_device)
                                  for x in tb.btd_factor(*bands)))
        for b in (1, 31, 33, 4096):
            rhs = torch.tensor(rng.normal(size=(b, n, 3)), dtype=dtype, device=cuda_device)
            if padded:
                buf = torch.full((b, kb.padded_width(3 * n)), float("nan"), dtype=dtype,
                                 device=cuda_device)
                rhs = buf[:, :3 * n].copy_(rhs.reshape(b, -1)).reshape(b, n, 3)
            kb.reset_launch_counts()
            out = kb.btd_solve(f, rhs)
            assert kb.btd_solve.launches == 1
            assert torch.equal(out, tb.btd_solve(f, rhs)), (n, b)

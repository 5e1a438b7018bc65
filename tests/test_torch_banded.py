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

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


# ---------------------------------------------------------------------------
# The solve's derivatives: the plain adjoint and tangent, the adjoint
# kernel's source on the host, and the autograd Function around the kernels
# ---------------------------------------------------------------------------


def _grad_system(n, batch, seed, batched=False):
    """Random factors (requiring grad), right-hand sides and a cotangent."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batched else ()
    d = rng.normal(size=lead + (n, 3, 3))
    bands = (d + np.swapaxes(d, -1, -2) + 8 * np.eye(3),
             0.4 * rng.normal(size=lead + (n - 1, 3, 3)),
             0.4 * rng.normal(size=lead + (n - 1, 3, 3)))
    f = tuple(t.detach().requires_grad_()
              for t in tb.btd_factor(*(torch.tensor(x) for x in bands)))
    b = torch.tensor(rng.normal(size=(batch, n, 3)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(batch, n, 3)))
    return f, b, g


def _autograd_vjp(f, b, g):
    x = tb.btd_solve(f, b)
    grads = torch.autograd.grad(x, (*f, b), g, allow_unused=True)
    return [torch.zeros_like(t) if r is None else r for r, t in zip(grads, (*f, b))]


@pytest.mark.parametrize("n,batch,batched", [(7, 5, False), (1, 3, False), (2, 4, False),
                                             (9, 3, True)])
def test_btd_solve_adjoint_equals_autograd(n, batch, batched):
    """``banded.btd_solve_adjoint`` (the adjoint kernel's plain version and
    the factor reductions) is autograd's derivative of the plain sweep, for
    factors shared by the batch and per environment (float64, 1e-12)."""
    f, b, g = _grad_system(n, batch, seed=n + batch, batched=batched)
    ref = _autograd_vjp(f, b, g)
    with torch.no_grad():
        x = tb.btd_solve(f, b)
        out = tb.btd_solve_adjoint(tuple(t.detach() for t in f), b.detach(), x, g)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        if r.numel():
            _close(o, r)


@pytest.mark.parametrize("n,batched", [(7, False), (1, False), (6, True)])
def test_btd_solve_tangent_equals_forward_ad(n, batched):
    """``banded.btd_solve_tangent_rhs`` and one more solve give forward AD's
    tangent of the plain sweep (float64, 1e-12)."""
    import torch.autograd.forward_ad as fwAD

    f, b, _ = _grad_system(n, 4, seed=3 * n, batched=batched)
    f, b = tuple(t.detach() for t in f), b.detach()
    rng = np.random.default_rng(n)
    tangents = [torch.tensor(rng.normal(size=t.shape)) for t in (*f, b)]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t, d) for t, d in zip((*f, b), tangents)]
        ref = fwAD.unpack_dual(tb.btd_solve(tuple(duals[:3]), duals[3])).tangent
    x = tb.btd_solve(f, b)
    out = tb.btd_solve(f, tb.btd_solve_tangent_rhs(f, x, tangents[:3], tangents[3]))
    _close(out, ref)


def _host_adjoint_source() -> str:
    """The adjoint of ``csrc/btd_solve.cu`` as host C++: the source's
    arithmetic (between its "arithmetic: begin" and "arithmetic: end"
    marks: the rounding helpers, the node steps, the sweeps and the
    adjoint's schedule and jobs), :data:`HOST_RING` in place of the
    kernel's barriers and bulk copies, and the source's C entries."""
    from pathlib import Path

    src = (Path(kb.__file__).parent / "csrc" / "btd_solve.cu").read_text()

    def block(start, end):
        i = src.index(start)
        return src[i:src.index(end, i)]

    return "\n".join([
        HOST_SHIM, "namespace {",
        block("// ---- arithmetic: begin", "// ---- arithmetic: end"),
        HOST_RING, "}  // namespace", 'extern "C" {',
        block("int btd_solve_adjoint_launch(", "const char* cuda_error_string"), "}",
    ])


# Just enough of CUDA for the host compiler: the vector types, and the _rn
# intrinsics rounding each operation (volatile: no contraction).
HOST_SHIM = r"""
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __forceinline__ inline
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
#define RN(name, T, op) inline T name(T a, T b) { volatile T r = a op b; return r; }
RN(__fmul_rn, float, *) RN(__fadd_rn, float, +) RN(__fsub_rn, float, -)
RN(__dmul_rn, double, *) RN(__dadd_rn, double, +) RN(__dsub_rn, double, -)
"""

# The kernel's roles, one after another: for each block of 32 rows, each job
# in order on a ring of slots that starts as NaN; the loads and stores are
# the kernel's copies as memcpy, and each lane sweeps in turn (role 0 on the
# ascending jobs, then role 1), its chains carried from job to job.
HOST_RING = r"""
template <typename T>
void host_adjoint(const AdjArgs<T>& a) {
  const AdjPlan<T> plan(a.N);
  std::vector<T> ring(kAdjSlots * AdjSlot<T>::kElems);
  auto copy = [](auto* dst, const auto* src, uint32_t n) { std::memcpy(dst, src, n); };
  for (int env0 = 0; env0 < a.B; env0 += kEnvs) {
    const int nb = min(kEnvs, a.B - env0);
    std::fill(ring.begin(), ring.end(), std::numeric_limits<T>::quiet_NaN());
    T chain[2][kEnvs][3] = {};
    for (int j = 0; j < plan.jobs(); ++j) {
      T* const slot = ring.data() + plan.slot(j) * AdjSlot<T>::kElems;
      adjoint_loads(a, plan, env0, nb, j, slot, copy);
      for (int l = 0; l < nb; ++l) {
        T* const y = chain[0][l];
        T* const c = chain[1][l];
        if (plan.up(j)) adjoint_sweep<0>(plan, j, slot, l, y[0], y[1], y[2]);
        adjoint_sweep<1>(plan, j, slot, l, c[0], c[1], c[2]);
      }
      adjoint_stores(a, plan, env0, nb, j, slot, copy);
    }
  }
}

template <typename T>
int launch_adjoint(const AdjArgs<T>& a, cudaStream_t) {
  host_adjoint(a);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_adjoint(tmp_path_factory):
    """The adjoint's source built by the host C++ compiler."""
    import ctypes
    import shutil
    import subprocess

    out = tmp_path_factory.mktemp("btd_adjoint_host")
    (out / "adjoint.cpp").write_text(_host_adjoint_source())
    cxx = shutil.which("c++") or shutil.which("g++")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    "-o", str(out / "adjoint.so"), str(out / "adjoint.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "adjoint.so"))
    for name in ("btd_solve_adjoint_launch", "btd_solve_adjoint_geometry"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES["btd_solve"][name], ctypes.c_int
    return lib


def _host_launch_adjoint(lib):
    """``_launch_adjoint`` on CPU tensors through the host-built adjoint: the
    wrapper's operands, rows and pitches as on the card."""
    def launch(packed, b, g):
        args, outs = kb._adjoint_operands(packed, b, g)
        assert lib.btd_solve_adjoint_launch(*kb._pointers(args), None) == 0
        kb.btd_solve_adjoint.launches += 1
        return outs

    return launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch", [(1, 3), (2, 33), (13, 5), (70, 40)])
def test_adjoint_kernel_source_equals_plain(host_adjoint, dtype, n, batch):
    """The adjoint kernel's source, built for the host, computes the plain
    version's three sweeps bit for bit (float32 and float64; rows past a
    32-row block)."""
    f, b, g = _grad_system(n, batch, seed=n)
    f = tuple(t.detach().to(dtype) for t in f)
    b, g = b.detach().to(dtype), g.to(dtype)
    got = _host_launch_adjoint(host_adjoint)(kb.pack_factors(f).packed(), b, g)
    for o, r in zip(got, tb.btd_adjoint_sweeps(f, b, g)):
        assert torch.equal(o, r)


def _padded(x, width):
    """``(B, N, 3)`` ``x`` in rows of ``width`` elements (NaN in the pad)."""
    buf = torch.full((x.shape[0], width), float("nan"), dtype=x.dtype)
    return buf[:, :x[0].numel()].copy_(x.reshape(x.shape[0], -1)).view(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edge", ["C-1", "C", "C+1", "resident+1"])
def test_adjoint_kernel_chunk_edges(host_adjoint, dtype, edge):
    """The host-built adjoint at a chunk's ragged edges (N = C - 1, C, C + 1
    for the source's chunk of C nodes) and one node past the resident chunks
    (N = slots x C + 1: chunk 0 loads its s back), at 45 rows (a block and a
    ragged 13) and at 1, with ``b`` in padded rows (read in place) and ``g``
    dense (copied), padded (read in place) and shared by the batch (one row
    of pitch 0): the plain sweeps bit for bit."""
    code = kb._DTYPE_CODES[dtype]
    chunk, slots = (host_adjoint.btd_solve_adjoint_geometry(code, w) for w in (0, 1))
    n = {"C-1": chunk - 1, "C": chunk, "C+1": chunk + 1, "resident+1": slots * chunk + 1}[edge]
    launch = _host_launch_adjoint(host_adjoint)
    for batch in (45, 1):
        f, b, g = _grad_system(n, batch, seed=n + batch)
        f = tuple(t.detach().to(dtype) for t in f)
        b, g = b.detach().to(dtype), g.to(dtype)
        packed = kb.pack_factors(f).packed()
        b_in = _padded(b, kb.padded_width(3 * n) + 8)
        shared = g[0].expand(b.shape)
        for g_in, ref_g, ld_g in ((g, g, kb.padded_width(3 * n)),
                                  (_padded(g, kb.padded_width(3 * n) + 4), g,
                                   kb.padded_width(3 * n) + 4),
                                  (shared, shared, 0)):
            args, _ = kb._adjoint_operands(packed, b_in, g_in)
            assert args[8].data_ptr() == b_in.data_ptr()  # b read in place
            if batch > 1:
                assert args[3:5] == (kb.padded_width(3 * n) + 8, ld_g)
            got = launch(packed, b_in, g_in)
            for o, r in zip(got, tb.btd_adjoint_sweeps(f, b, ref_g)):
                assert torch.equal(o, r)


@pytest.fixture
def function_on_host(host_adjoint, monkeypatch):
    """The autograd Function around the kernels on CPU tensors: the forward
    launch is the plain sweep from the packed blocks, the adjoint launch
    the host-built kernel."""
    def solve(packed, rhs):
        fwd, bwd = packed
        n = rhs.shape[-2]
        factors = (bwd[:, :12].reshape(n, 3, 4)[..., :3], fwd[1:].reshape(n - 1, 3, 4)[..., :3],
                   bwd[:-1, 12:].reshape(n - 1, 3, 4)[..., :3])
        kb.btd_solve.launches += 1
        return tb.btd_solve(factors, rhs)

    monkeypatch.setattr(kb, "_launch_solve", solve)
    monkeypatch.setattr(kb, "_launch_adjoint", _host_launch_adjoint(host_adjoint))
    kb.reset_launch_counts()


def _apply(f, b):
    return kb._Solve.apply(*f, b, kb.BTDFactors(tuple(t.detach() for t in f)))


@pytest.mark.parametrize("n", [1, 6])
def test_solve_function_vjp_and_jvp(function_on_host, n):
    """The Function's backward (one adjoint launch) and tangent (one more
    solve) equal autograd and forward AD of the plain sweep (float64,
    1e-12), also under ``torch.utils.checkpoint``."""
    import torch.autograd.forward_ad as fwAD

    f, b, g = _grad_system(n, 5, seed=11 * n)
    ref = _autograd_vjp(f, b, g)
    x = _apply(f, b)
    assert kb.btd_solve.launches == 1
    grads = torch.autograd.grad(x, (*f, b), g, allow_unused=True)
    assert kb.btd_solve_adjoint.launches == 1
    for o, r in zip(grads, ref):
        if r.numel():
            _close(o, r)
    ck = torch.utils.checkpoint.checkpoint(_apply, f, b, use_reentrant=False)
    for o, r in zip(torch.autograd.grad(ck, (*f, b), g, allow_unused=True), ref):
        if r.numel():
            _close(o, r)
    rng = np.random.default_rng(n)
    tangents = [torch.tensor(rng.normal(size=t.shape)) for t in (*f, b)]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t.detach(), d) for t, d in zip((*f, b), tangents)]
        want = fwAD.unpack_dual(tb.btd_solve(tuple(duals[:3]), duals[3])).tangent
        got = fwAD.unpack_dual(_apply(duals[:3], duals[3])).tangent
    _close(got, want)


def test_element_params_keep_the_graph():
    """Tensor fields pass through ``assembly.element_params`` with their
    graph (no NumPy round trip); host arrays are uploaded as before."""
    from continuum_robot_tpu_torch.models import assembly as ta
    from continuum_robot_tpu_torch.models.config import BeamArrays

    E = torch.tensor([7e10, 8e10], dtype=torch.float64, requires_grad=True)
    arrays = BeamArrays(length=np.array([0.1, 0.2]), elastic_modulus=E,
                        moment_inertia=np.array([1e-10, 2e-10]), density=np.ones(2),
                        cross_area=np.ones(2) * 1e-5, wetted_area=np.zeros(2),
                        drag_coef=np.zeros(2), nonlinear_mask=np.array([False, True]))
    L, E_t, I, A, nl = ta.element_params(arrays, torch.zeros(1, dtype=torch.float32))
    assert E_t.dtype == torch.float32 and E_t.grad_fn is not None and nl.dtype == torch.bool
    assert L.dtype == torch.float32 and not L.requires_grad
    g, = torch.autograd.grad(E_t.sum(), E)
    assert torch.equal(g, torch.ones(2, dtype=torch.float64))
    q = torch.zeros((2, 6), dtype=torch.float64)
    diag, _, _ = ta.tangent_block_tridiagonal(arrays, q.reshape(-1)[:9],
                                              params=ta.element_params(arrays, q))
    assert diag.grad_fn is not None


def test_refuse_grad_asks_for_no_derivative():
    """The kernels without a derivative refuse an input that requires grad
    (with grad mode on) or carries a forward-mode tangent, and nothing
    else."""
    import torch.autograd.forward_ad as fwAD

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="modal_steps: the CUDA kernel has no derivative"):
        _build.refuse_grad("modal_steps", None, torch.ones(2), x)
    with torch.no_grad():
        _build.refuse_grad("modal_steps", x)
    _build.refuse_grad("modal_steps", x.detach(), None, 1.0)
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.ones(3), torch.ones(3))
        with torch.no_grad(), pytest.raises(RuntimeError, match="rom_expand"):
            _build.refuse_grad("rom_expand", d)
        _build.refuse_grad("rom_expand", torch.ones(3))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_card(cuda_device):
    """On the card the modal, ROM and fused kernels raise, naming the
    kernel, when an input requires grad: a kernel launched through raw
    pointers would return a result without a graph. btd_solve instead
    differentiates (its Function)."""
    from continuum_robot_tpu_torch.ops.cuda import fused_rollout as kf
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as km
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as kr

    dev = cuda_device
    eta = torch.zeros(2, 4, device=dev, requires_grad=True)
    lam = torch.ones(4, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="modal_steps"):
        km.modal_steps(lam, lam, None, eta, eta.detach(), eta.detach())
    with pytest.raises(RuntimeError, match="rom_expand"):
        kr.rom_expand(None, eta)
    x = torch.zeros(2, 9, dtype=torch.float64, device=dev, requires_grad=True)
    mats = tuple(torch.eye(3, dtype=torch.float64, device=dev) for _ in range(3))
    with pytest.raises(RuntimeError, match="fused_gen_alpha_steps"):
        kf.fused_gen_alpha_steps(mats, torch.zeros(3), torch.zeros(3), x, 1, 1e-3)
    f, _, _ = _grad_system(5, 3, seed=5)
    f = tuple(t.detach().to(dev).requires_grad_() for t in f)
    kb.reset_launch_counts()
    rhs = torch.ones(3, 5, 3, dtype=torch.float64, device=dev)
    torch.autograd.grad(kb.btd_solve(f, rhs).sum(), f[0])
    assert kb.btd_solve.launches == 1 and kb.btd_solve_adjoint.launches == 1

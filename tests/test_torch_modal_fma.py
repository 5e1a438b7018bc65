"""The modal kernels' float32 rounding: one rounding a multiply-add.

In float32 the CUDA modal kernels compute every multiply-add as one fused
multiply-add (``__fmaf_rn``), and their plain twins round the same way
through ``madd`` (``continuum_robot_tpu_torch/ops/cuda/modal_rollout.py``).
These tests hold ``madd`` to the exactly rounded value of ``x * y + z``
(``fractions.Fraction``, nearest float32, ties to even), the float32 twins to
the JAX Pallas kernels in interpret mode (``atol = 5e-6 * scale``, the bound
the JAX package's tests set for float32), and the float64 twins to the
first port's arithmetic bit for bit (float64 keeps one rounding an
operation). The kernels themselves meet the twins on the card
(``tests/test_torch_modal_rollout.py``, ``chip_smoke.py``); here the
kernel source itself, built by the host C++ compiler with every block and
thread run in turn, meets them too.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from continuum_robot_tpu.ops.pallas import modal_rollout as jk
from test_torch_modal_rollout import H, M, PALLAS, RHO, _coeffs, _t
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.models import simulate as ts
from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import modal_rollout as tk

torch.set_num_threads(1)

F32_ATOL = 5e-6  # x max|JAX kernel output|: the JAX package's float32 bound


def _nearest_f32(x: Fraction) -> np.float32:
    """The float32 nearest to ``x``, ties to the even significand."""
    f = np.float32(float(x))  # within one float32 ulp of the answer
    cands = (f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def _exact_madd(x, y, z) -> np.ndarray:
    return np.array([_nearest_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(x, y, z)], np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_madd_rounds_float32_once():
    """Seeded triples, half of them cancelling to ~1e-6 of the product, and
    triples whose product lies next to a halfway point, where rounding the
    float64 sum to float32 rounds twice and misses."""
    rng = np.random.default_rng(0)
    n = 4000
    x = rng.normal(size=n).astype(np.float32)
    y = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    z[::2] = (-(x[::2].astype(np.float64) * y[::2])
              * (1 + rng.normal(scale=1e-6, size=n // 2))).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: halfway between two float32 values
    k = np.arange(1, 33, dtype=np.float64)
    scale = 2.0 ** rng.integers(-20, 21, k.size)
    a = np.float32(1 + 2.0**-12)
    hx = (a * scale).astype(np.float32)
    hy = np.full(k.size, a, np.float32)
    hz = (np.where(k % 2, 1, -1) * k * 2.0**-80 * scale).astype(np.float32)
    for xs, ys, zs in ((x, y, z), (hx, hy, hz)):
        got = tk.madd(torch.tensor(xs), torch.tensor(ys), torch.tensor(zs))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(_exact_madd(xs, ys, zs)))
    # the crafted triples tell the two roundings apart: the test can fail
    twice = (hx.astype(np.float64) * hy + hz).astype(np.float32)
    assert (_bits(twice) != _bits(_exact_madd(hx, hy, hz))).sum() >= k.size // 2
    one = torch.tensor([a])
    assert float(tk.madd(one, one, torch.tensor([np.float32(2.0**-80)]))) == 1 + 2**-11 + 2**-23
    assert float(tk.madd(one, one, torch.tensor([np.float32(-2.0**-80)]))) == 1 + 2**-11


def test_madd_float64_is_product_then_sum():
    rng = np.random.default_rng(1)
    x, y, z = (torch.tensor(rng.normal(size=64)) for _ in range(3))
    assert torch.equal(tk.madd(x, y, z), x * y + z)
    assert torch.equal(tk.madd(0.25, y, z), 0.25 * y + z)


def _f32_close(port, ref):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=F32_ATOL * (np.abs(b).max() + 1e-30))


def _f32(*xs):
    return [np.asarray(x, np.float32) for x in xs]


@pytest.mark.parametrize("damped", [False, True])
def test_float32_steps_and_frames_match_pallas(damped):
    _, lam, winv, cdamp, u, eta, etad = _coeffs(damped, seed=5)
    e, ed = _f32(eta, etad)
    kw = dict(h=H, rho_inf=RHO, cdamp=cdamp)
    ref = jk.fused_modal_steps(lam, winv, u, e, ed, None, steps=13, unroll=4, **kw, **PALLAS)
    _f32_close(tk.modal_steps_plain(lam, winv, u, torch.tensor(e), torch.tensor(ed), None,
                                    steps=13, **kw), ref)
    ref = jk.fused_modal_frames(lam, winv, u, e, ed, n_frames=3, substeps=4, unroll=2,
                                **kw, **PALLAS)
    _f32_close(tk.modal_frames_plain(lam, winv, u, torch.tensor(e), torch.tensor(ed),
                                     n_frames=3, substeps=4, **kw), ref)


@pytest.mark.parametrize("damped", [False, True])
def test_float32_affine_and_drive_match_pallas(damped):
    eng, lam, _, cdamp, u, eta, etad = _coeffs(damped, seed=6)
    e, ed = _f32(eta, etad)
    P, b = eng._power_map(8, u)
    Pr, br = eng._power_map(3, u)
    a0 = -lam.astype(np.float32) * e + u.astype(np.float32)
    if damped:
        a0 = a0 - cdamp.astype(np.float32) * ed
    ref = jk.fused_affine_steps(P, b, e, ed, a0, apps=5, unroll=2, **PALLAS)
    _f32_close(tk.affine_steps_plain(P, b, *map(torch.tensor, (e, ed, a0)), apps=5), ref)
    ref = jk.fused_affine_steps(Pr, br, *ref, apps=1, **PALLAS)
    port = tk.affine_drive_plain(torch.tensor(lam, dtype=torch.float32),
                                 torch.tensor(u, dtype=torch.float32),
                                 None if cdamp is None else torch.tensor(cdamp, dtype=torch.float32),
                                 P, b, torch.tensor(e), torch.tensor(ed), 5, Pr, br)
    _f32_close(port, ref)


@pytest.mark.parametrize("damped", [False, True])
def test_float64_twins_keep_first_port_bits(damped):
    """float64: the same bits as one rounding an operation in the first
    port's order (``gen_alpha_step``; the affine rows left to right, then
    the offset)."""
    eng, lam, winv, cdamp, u, eta, etad = _coeffs(damped, seed=7)
    e, ed = _t(eta), _t(etad)
    kw = dict(h=H, rho_inf=RHO, cdamp=cdamp)
    cols, p4 = tk._coeff_cols(lam, winv, u, cdamp, RHO, e)
    sc = tk.step_scalars(H, RHO, torch.float64)
    s = (e, ed, tk.initial_accel(lam, u, cdamp, e, ed))
    qs = [e]
    for _ in range(12):
        s = tk.gen_alpha_step(*s, p4, cols, sc)
        qs.append(s[0])
    for a, b in zip(tk.modal_steps_plain(lam, winv, u, e, ed, steps=12, **kw), s):
        assert torch.equal(a, b)
    frames = tk.modal_frames_plain(lam, winv, u, e, ed, n_frames=3, substeps=4, **kw)[0]
    assert torch.equal(frames, torch.stack(qs[::4]))

    P, bv = (torch.tensor(x) for x in eng._power_map(8, u))
    s = (e, ed, tk.initial_accel(lam, u, cdamp, e, ed))
    for _ in range(5):
        q, v, a = s
        s = tuple(P[:, i, 0] * q + P[:, i, 1] * v + P[:, i, 2] * a + bv[:, i] for i in range(3))
    for x, y in zip(tk.affine_steps_plain(P, bv, e, ed, tk.initial_accel(lam, u, cdamp, e, ed),
                                          apps=5), s):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_drive_twin_is_power_drive_sequence(dtype):
    """``affine_drive_plain`` is ``rollout_power``'s former drive: the
    initial acceleration, ``apps`` applications, the remainder map."""
    eng, lam, _, cdamp, u, eta, etad = _coeffs(True, seed=8)
    e, ed = (torch.tensor(x, dtype=dtype) for x in (eta, etad))
    lam_t, u_t, cd_t = (torch.tensor(x, dtype=dtype) for x in (lam, u, cdamp))
    PK, bK = eng._power_map(16, u)
    Pr, br = eng._power_map(5, u)
    s = (e, ed, tk.initial_accel(lam_t, u_t, cd_t, e, ed))
    s = tk.affine_steps_plain(PK, bK, *s, apps=7)
    s = tk.affine_steps_plain(Pr, br, *s, apps=1)
    for use_pallas in (True, False):  # CPU state: both run the twin
        out = ts._power_drive(lam_t, cd_t, u_t, PK, bK, Pr, br, e, ed, apps=7,
                              use_pallas=use_pallas)
        for x, y in zip(out, s):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frames_twin_is_power_frames_sequence(dtype):
    """``affine_frames_plain``, and through it ``rollout_frames_power`` on
    CPU state, is the former frames drive: the initial acceleration, then
    one ``affine_steps_plain`` application of the frame's map a frame, the
    frames stacked; for a constant force and for a schedule whose break
    falls inside a frame (three runs: before, the crossing frame, after)."""
    _, lam, _, cdamp, u, eta, etad = _coeffs(True, seed=10)
    eng = convert.modal_engine_from_numpy(np.zeros((1, M)), np.zeros((M, 1)), lam, RHO, H,
                                          cdamp, device="cpu")
    e, ed = (torch.tensor(x, dtype=dtype) for x in (eta, etad))
    lam_t, u_t, cd_t = (torch.tensor(x, dtype=dtype) for x in (lam, u, cdamp))
    pwc = ts.PiecewiseConstant((9.5 * H,), np.stack([u, -0.5 * u]))
    for force, runs in ((u, [(*eng._power_map(4, u), 5)]),
                        (pwc, eng._pwc_frame_runs(pwc, 5, 4, 0.0))):
        s = (e, ed, tk.initial_accel(lam_t, u_t, cd_t, e, ed))
        qs, vs = [e], [ed]
        for P, b, c in runs:
            for _ in range(c):
                s = tk.affine_steps_plain(P, b, *s, apps=1)
                qs.append(s[0])
                vs.append(s[1])
        twin = tk.affine_frames_plain(lam_t, u_t, cd_t, np.stack([r[0] for r in runs]),
                                      np.stack([r[1] for r in runs]), e, ed,
                                      [r[2] for r in runs])
        engine = eng.rollout_frames_power(e, ed, force, 5, substeps=4)[1:]
        for x, y, ref in zip(twin, engine, (torch.stack(qs), torch.stack(vs))):
            assert torch.equal(x, ref) and torch.equal(y, ref)
    assert [r[2] for r in runs] == [2, 1, 2]


def test_frames_envs_by_batch(host_kernels):
    """The frames kernel's envs a thread, chosen by its launcher (the
    host-built source on a card of 132 SMs): 4 where the grid still gives
    each SM two blocks (the main path's 4096 envs), 2 for the 64 envs of
    ``simulate``'s frames at 3000 modes (188 blocks at 4, 376 at 2), and
    never outside its instances."""
    sms = ctypes.c_int.in_dll(host_kernels, "host_sms")
    sms.value = 132
    try:
        assert host_kernels.modal_frames_envs(4096, 3000) == 4
        assert host_kernels.modal_frames_envs(64, 3000) == 2
        assert host_kernels.modal_frames_envs(1, 1) == 1
        for B in (1, 5, 64, 100, 150, 1000, 4096, 65536):
            assert host_kernels.modal_frames_envs(B, 37) in (1, 2, 4)
    finally:
        sms.value = 1


# Just enough of CUDA for the host compiler: each launch runs its blocks and
# threads one after another (the modal kernels share no memory between
# threads), the _rn intrinsics round each operation (volatile, no
# contraction), __fmaf_rn is fmaf. One SM holding one block makes the affine
# grid a single row of blocks, so its threads walk several env groups;
# host_sms sets the SM count the launchers read.
HOST_CUDA = r"""
#include <cmath>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaDevAttrMultiProcessorCount, cudaErrorInvalidValue };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
static dim3 blockIdx, threadIdx, blockDim, gridDim;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
extern "C" { int host_sms = 1; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = host_sms; return 0; }
template <typename K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) { *n = 1; return 0; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
#define RN(name, T, op) inline T name(T a, T b) { volatile T r = a op b; return r; }
RN(__fmul_rn, float, *) RN(__fadd_rn, float, +) RN(__fsub_rn, float, -)
RN(__dmul_rn, double, *) RN(__dadd_rn, double, +) RN(__dsub_rn, double, -)
template <typename F, typename... A>
void host_launch(dim3 g, dim3 b, F f, A... args) {
  gridDim = g; blockDim = b;
  for (unsigned by = 0; by < g.y; ++by) for (unsigned bx = 0; bx < g.x; ++bx)
    for (unsigned ty = 0; ty < b.y; ++ty) for (unsigned tx = 0; tx < b.x; ++tx) {
      blockIdx = dim3(bx, by); threadIdx = dim3(tx, ty); f(args...);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/modal_rollout.cu`` built by the host C++ compiler (its C
    interface unchanged), each ``kernel<<<grid, block, 0, stream>>>(args)``
    a ``host_launch``."""
    src = (Path(tk.__file__).parent / "csrc" / "modal_rollout.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", HOST_CUDA)
    src, launches = re.subn(r"(\w+<[^<>]*>)<<<(.*?), (.*?), 0, stream>>>\(",
                            r"host_launch(\2, \3, [&](auto... xs) { \1(xs...); }, ", src,
                            flags=re.S)
    assert launches == 4  # launch_steps, launch_frames, launch_affine, launch_affine_frames
    out = tmp_path_factory.mktemp("modal_host")
    (out / "modal_rollout.cpp").write_text(src)
    cxx = shutil.which("c++") or shutil.which("g++")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    "-o", str(out / "modal_rollout.so"), str(out / "modal_rollout.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "modal_rollout.so"))
    for name, argtypes in _build._SIGNATURES["modal_rollout"].items():
        getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, ctypes.c_int
    lib.cuda_error_string.argtypes, lib.cuda_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


@pytest.fixture
def on_host_kernels(host_kernels, monkeypatch):
    """The wrappers launch the host-built kernels on CPU tensors."""
    monkeypatch.setattr(_build, "library", lambda name: host_kernels)
    monkeypatch.setattr(tk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(tk, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    tk.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_source_on_host_equals_plain(on_host_kernels, dtype):
    """The wrappers launch the host-built kernels on CPU tensors: every
    kernel and entry equals its plain twin bit for bit, damped or not, at
    ragged sizes (envs not a multiple of a thread's envs, modes not of a
    warp's), with 150 envs walked 8 groups a row; the frames kernel with
    each envs a thread it has (and the batch's choice), the frames drive
    with one map and with a two-run schedule."""
    rng = np.random.default_rng(9)
    for B, m in ((5, 37), (150, 3)):
        lam = np.sort(10.0 ** rng.uniform(0.0, 12.0, m))
        e, ed = (torch.tensor(rng.normal(scale=1e-6, size=(B, m)), dtype=dtype)
                 for _ in range(2))
        u = rng.normal(scale=1e-3, size=m)
        for cd in (None, 0.5 + 1e-6 * lam):
            eng = convert.modal_engine_from_numpy(np.zeros((1, m)), np.zeros((m, 1)), lam,
                                                  RHO, H, cd, device="cpu")
            kw = dict(h=H, rho_inf=RHO, cdamp=cd)
            args = (lam, eng.winv64(), u, e, ed)
            for a, b in zip(tk.modal_steps(*args, steps=9, **kw),
                            tk.modal_steps_plain(*args, steps=9, **kw)):
                assert torch.equal(a, b)
            frames = tk.modal_frames_plain(*args, 3, 4, **kw)
            for envs in (1, 2, 4, 0):  # each instance, then the batch's choice
                for a, b in zip(tk.modal_frames(*args, 3, 4, envs=envs, **kw), frames):
                    assert torch.equal(a, b)
            P, bv = eng._power_map(8, u)
            Pr, br = eng._power_map(3, u)
            a0 = tk.initial_accel(lam, u, cd, e, ed)
            for a, b in zip(tk.affine_steps(P, bv, e, ed, a0, apps=5),
                            tk.affine_steps_plain(P, bv, e, ed, a0, apps=5)):
                assert torch.equal(a, b)
            consts = [None if x is None else torch.tensor(x, dtype=dtype) for x in (lam, u, cd)]
            for rem in ((None, None), (Pr, br)):
                drive = (*consts, P, bv, e, ed, 4, *rem)
                for a, b in zip(tk.affine_drive(*drive), tk.affine_drive_plain(*drive)):
                    assert torch.equal(a, b)
            for maps, counts in ((([P], [bv])), (4,)), (([P, Pr], [bv, br]), (3, 2)):
                fr = (*consts, np.stack(maps[0]), np.stack(maps[1]), e, ed, counts)
                for a, b in zip(tk.affine_frames(*fr), tk.affine_frames_plain(*fr)):
                    assert torch.equal(a, b)
    assert [f.launches for f in tk.KERNELS] == [4, 16, 4, 8, 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frame_drives_launch_once_on_host_kernels(on_host_kernels, dtype):
    """Through the host-built kernels, ``rollout_frames_pallas`` is one
    ``modal_frames`` launch and ``rollout_frames_power`` one
    ``affine_frames`` launch (constant force and schedule), no
    ``affine_steps``; each equal bit for bit to the engine on the twins."""
    _, lam, _, cdamp, u, eta, etad = _coeffs(True, seed=12)
    eng = convert.modal_engine_from_numpy(np.zeros((1, M)), np.zeros((M, 1)), lam, RHO, H,
                                          cdamp, device="cpu")
    e, ed = (torch.tensor(x, dtype=dtype) for x in (eta, etad))
    pwc = ts.PiecewiseConstant((9.5 * H,), np.stack([u, -0.5 * u]))
    runs = (("rollout_frames_pallas", u), ("rollout_frames_power", u),
            ("rollout_frames_power", pwc))
    outs = []
    for name, force in runs:
        before = [f.launches for f in tk.KERNELS]
        outs.append(getattr(eng, name)(e, ed, force, 5, substeps=4))
        launched = {f.__name__: f.launches - n for f, n in zip(tk.KERNELS, before)}
        kernel = "modal_frames" if name == "rollout_frames_pallas" else "affine_frames"
        assert launched == {k: int(k == kernel) for k in launched}, (name, launched)
    with pytest.MonkeyPatch.context() as mp:  # the same calls on the twins
        mp.setattr(tk, "_on_cuda", lambda *t: False)
        for (name, force), out in zip(runs, outs):
            for a, b in zip(out, getattr(eng, name)(e, ed, force, 5, substeps=4)):
                assert torch.equal(a, b)

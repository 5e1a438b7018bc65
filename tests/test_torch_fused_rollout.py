"""The fused small-beam generalized-α path of the PyTorch port against the
JAX package.

``ops/cuda/fused_rollout``: the plain twin of the CUDA kernel, the rollout
``fused_rollout`` and ``drag_coefficient_vector``, on the reference's
6-segment linear Nitinol cantilever in water (float64, CPU; both packages
fed one host operator set through ``convert.fused_operators_from_numpy``).

Two references in the JAX package, two tolerances:

* its own float64 recurrence, ``integrators.generalized_alpha_step`` on a
  dense operator with the same M, K, J^-1 and drag, and
  ``simulate(method="generalized_alpha")``: 1e-12 of each state
  component's scale;
* its fused TPU kernel in interpret mode: 1e-6 of the scale. That kernel
  asks its matrix products for float32 outputs
  (``preferred_element_type=jnp.float32``), so in float64 it carries
  float32 roundoff (2e-7 of the scale measured here); the port's float64
  kernel and twin keep float64 throughout.

The thread map of the CUDA kernel (which instance serves an n, which
thread computes which environment and row) is emulated in NumPy. The
card-only tests hold both entries of the CUDA kernel, the per-call steps
and the whole rollout's frames, to their plain twins bit for bit.
"""

import ctypes
import importlib
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
from continuum_robot_tpu.models import simulate as jsim
from continuum_robot_tpu.ops import integrators as jint
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.ops.cuda import fused_rollout as tfr

jfr = importlib.import_module("continuum_robot_tpu.ops.pallas.fused_rollout")

EXACT = 1e-12  # float64 recurrence against float64 recurrence
JAX_KERNEL = 1e-6  # against the JAX kernel's float32 matrix-product outputs
H, RHO_INF = 5e-5, 0.8
WATER = dict(enable_fluid_effects=True, fluid_density=1000.0)


@pytest.fixture(scope="module")
def beams():
    from tests import helpers  # inside: a site-packages `tests` can shadow the repo's

    csv = helpers.linear_csv()
    return (jcrt.DynamicEulerBernoulliBeam(csv, jcrt.ForceParams(**WATER)),
            tcrt.DynamicEulerBernoulliBeam(csv, tcrt.ForceParams(**WATER)))


def _scaled_err(out, ref, n_parts):
    """Largest ``max|out - ref| / max|ref|`` over the ``n_parts`` equal
    slices of the last axis (q, v[, a]), each against its own scale."""
    out, ref = np.asarray(out), np.asarray(ref)
    return max(float(np.abs(o - r).max() / np.abs(r).max())
               for o, r in zip(np.split(out, n_parts, -1), np.split(ref, n_parts, -1)))


@pytest.fixture(scope="module")
def step_case(beams):
    """The beam's host operators at step H, a nonzero u, and 5 states with
    velocities large enough that drag is a leading term."""
    M, K, Jinv, _ = tfr.fused_host_operators(beams[1], H, RHO_INF)
    n = M.shape[0]
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(scale=1e-3, size=(5, n)),
                        rng.normal(scale=0.3, size=(5, n)),
                        rng.normal(scale=10.0, size=(5, n))], axis=-1)
    return M, K, Jinv, tfr.drag_coefficient_vector(beams[1]), rng.normal(scale=0.1, size=n), x


def _plain_steps(case, steps, n_newton):
    M, K, Jinv, c, u, x = case
    mats, cd, ut = convert.fused_operators_from_numpy(M, K, Jinv, c, u, device="cpu")
    return tfr.fused_gen_alpha_steps_plain(mats, cd, ut, torch.tensor(x), steps, H,
                                           rho_inf=RHO_INF, n_newton=n_newton)


@pytest.mark.parametrize("n_newton", [1, 2])
def test_plain_steps_match_jax_generalized_alpha_step(step_case, n_newton):
    """The twin's recurrence is the JAX package's generalized-α step with
    prefactored modified Newton, on the same dense operators."""
    M, K, Jinv, c, u, x = step_case
    n = M.shape[0]
    Mj, Kj, Jj, cj = (jnp.asarray(a) for a in (M, K, Jinv, c))
    op = jint.NewmarkOperator(
        mass_apply=lambda a: a @ Mj.T,
        internal_force=lambda q: q @ Kj.T,
        external_force=lambda xs, t: -cj * xs[..., n:] * jnp.abs(xs[..., n:]),
        solve=lambda q, cc, a=1.0: (lambda r: r @ Jj.T),
        tangent_frozen=True,
    )
    q, v, a = (jnp.asarray(x[:, k * n:(k + 1) * n]) for k in range(3))
    for _ in range(7):
        q, v, a = jint.generalized_alpha_step(op, 0.0, q, v, a, H, u=jnp.asarray(u),
                                              rho_inf=RHO_INF, n_newton=n_newton)
    ref = np.concatenate([np.asarray(q), np.asarray(v), np.asarray(a)], axis=-1)
    assert _scaled_err(_plain_steps(step_case, 7, n_newton), ref, 3) <= EXACT


@pytest.mark.parametrize("n_newton", [1, 2])
def test_plain_steps_match_jax_fused_kernel(step_case, n_newton):
    M, K, Jinv, c, u, x = step_case
    ref = jfr.fused_gen_alpha_steps((M, K, Jinv), c, u, jnp.asarray(x), steps=7, h=H,
                                    rho_inf=RHO_INF, n_newton=n_newton, tile=4,
                                    interpret=True)
    out = _plain_steps(step_case, 7, n_newton)
    assert out.shape == ref.shape
    assert _scaled_err(out, ref, 3) <= JAX_KERNEL


def test_kernel_dispatch_on_cpu(step_case):
    """A CPU tensor takes the plain twin and launches nothing."""
    M, K, Jinv, c, u, x = step_case
    tfr.reset_launch_counts()
    out = tfr.fused_gen_alpha_steps((M, K, Jinv), c, u, torch.tensor(x), 3, H,
                                    tile=4, interpret=True)
    frames = tfr.fused_gen_alpha_frames((M, K, Jinv), c, u, torch.tensor(x), 1, 3, H)
    assert [k.launches for k in tfr.KERNELS] == [0, 0]
    assert torch.equal(out, _plain_steps(step_case, 3, 2))
    assert torch.equal(frames[-1], out[:, : 2 * M.shape[0]])


def test_frames_twin_is_the_per_frame_loop(step_case):
    """The frames twin's frames are the per-frame loop of the steps twin,
    and its last frame is one span of all the steps: cutting a span into
    frames changes no rounding."""
    M, K, Jinv, c, u, x = step_case
    n = M.shape[0]
    mats, cd, ut = convert.fused_operators_from_numpy(M, K, Jinv, c, u, device="cpu")
    xt = torch.tensor(x)
    ys = tfr.fused_gen_alpha_frames_plain(mats, cd, ut, xt, 3, 4, H, rho_inf=RHO_INF)
    assert ys.shape == (4, x.shape[0], 2 * n)
    state, loop = xt, [xt[:, : 2 * n]]
    for _ in range(3):
        state = tfr.fused_gen_alpha_steps_plain(mats, cd, ut, state, 4, H, rho_inf=RHO_INF)
        loop.append(state[:, : 2 * n])
    assert torch.equal(ys, torch.stack(loop))
    whole = tfr.fused_gen_alpha_steps_plain(mats, cd, ut, xt, 12, H, rho_inf=RHO_INF)
    assert torch.equal(ys[-1], whole[:, : 2 * n])


@pytest.fixture(scope="module")
def geometry_lib(tmp_path_factory):
    """The kernel's thread map, ``csrc/fused_geometry.h``, built alone by the
    host C++ compiler: the C query the CUDA library exports, from the same
    text."""
    header = Path(tfr.__file__).parent / "csrc" / "fused_geometry.h"
    so = tmp_path_factory.mktemp("geometry") / "libfused_geometry.so"
    cxx = shutil.which("c++") or shutil.which("g++")
    subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(header),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fused_gen_alpha_geometry.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.fused_gen_alpha_geometry.restype = ctypes.c_int
    return lib


def _covered(geo: dict, n: int, B: int) -> np.ndarray:
    """How many times the kernel's thread map ``geo`` computes each (env,
    row) of ``B`` environments of ``n`` DOFs: ``(B, n)`` counts."""
    count = np.zeros((B, n), np.int64)
    if geo["instance"] == "rows":  # thread t: row t % n of env group t // n
        blk = np.arange(geo["blocks"])[:, None, None]
        t = np.arange(geo["threads"])
        g, i = t // n, t % n
        e = np.arange(geo["envs"])[:, None]
        env = blk * geo["groups"] * geo["envs"] + g * geo["envs"] + e
        row = np.broadcast_to(i, env.shape)
        live = (g < geo["groups"]) & (env < B)
    else:  # warp w: env w of the block; lane l: rows l, l + 32, ... (axis k)
        blk = np.arange(geo["blocks"])[:, None, None, None]
        k = np.arange(geo["rows"])[:, None, None]
        w = np.arange(geo["groups"])[:, None]
        shape = (geo["blocks"], geo["rows"], geo["groups"], 32)
        env = np.broadcast_to(blk * geo["groups"] + w, shape)
        row = np.broadcast_to(np.arange(32) + 32 * k, shape)
        live = (env < B) & (row < n)
    np.add.at(count, (env[live], row[live]), 1)
    return count


# The documented reach of the two instances (csrc/fused_rollout.cu): the rows
# instance up to n = 36 in float and 24 in double, the lanes instance past it
# up to one block's shared memory (232448 bytes), n = 135 and 94.
ROWS_MAX = {torch.float32: 36, torch.float64: 24}
LANES_MAX = {torch.float32: 135, torch.float64: 94}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 13, 18, 36, 135])
def test_thread_map_covers_every_env_row_once(geometry_lib, n, dtype):
    """The kernel's (row, env group) map and its choice of instance: every
    (env, row) computed exactly once, rows-instance blocks within 256
    threads and ragged only in their tail, the lanes instance only where
    the rows do not fit in registers, and an n neither serves refused."""
    if n > LANES_MAX[dtype]:  # n = 135 in double: beyond one block
        with pytest.raises(ValueError, match="shared memory"):
            tfr.launch_geometry(n, dtype, 5, geometry_lib)
        return
    itemsize = 4 if dtype == torch.float32 else 8
    for B in (1, 5, 37, 4097):
        geo = tfr.launch_geometry(n, dtype, B, geometry_lib)
        assert geo["instance"] == ("rows" if n <= ROWS_MAX[dtype] else "lanes")
        if geo["instance"] == "rows":
            assert geo["threads"] <= 256 and geo["threads"] - geo["groups"] * n < 32
            assert geo["np"] % 3 == 0 and n <= geo["np"] < n + 3
        else:
            assert geo["rows"] <= (5 if dtype == torch.float32 else 3)
        assert 0 < geo["smem"] <= 232448 and geo["smem"] % itemsize == 0
        assert (_covered(geo, n, B) == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_thread_map_reach_of_each_instance(geometry_lib, dtype):
    """Each instance's last n is served by it and the next n by the next
    instance, or by none: the query refuses n = 0 and an n past the lanes
    instance's shared memory."""
    def instance(n):
        return tfr.launch_geometry(n, dtype, 7, geometry_lib)["instance"]

    assert instance(ROWS_MAX[dtype]) == "rows"
    assert instance(ROWS_MAX[dtype] + 1) == "lanes"
    assert instance(LANES_MAX[dtype]) == "lanes"
    for n in (0, LANES_MAX[dtype] + 1):
        with pytest.raises(ValueError, match="shared memory"):
            tfr.launch_geometry(n, dtype, 7, geometry_lib)


@pytest.fixture(scope="module")
def pallas_case(beams):
    """``tests/test_pallas.py``'s fused-rollout case: 3 envs, tip force."""
    n = beams[0].n_pos_states
    x0 = np.zeros((3, 2 * n))
    x0[:, n - 2] = [1e-4, 5e-4, 1e-3]
    u = np.zeros(n)
    u[-2] = 0.05
    kw = dict(t_final=0.02, dt=0.001, u=u, substeps=20)
    ts, ys = tfr.fused_rollout(beams[1], x0, device="cpu", **kw)
    return x0, kw, ts, ys


def test_fused_rollout_matches_jax_fused_rollout(beams, pallas_case):
    x0, kw, ts, ys = pallas_case
    ts_j, ys_j = jfr.fused_rollout(beams[0], x0, tile=4, interpret=True, **kw)
    assert ys.shape == ys_j.shape == (21, 3, x0.shape[1])
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_j), rtol=1e-15)
    assert _scaled_err(ys, ys_j, 2) <= JAX_KERNEL
    assert torch.isfinite(ys).all() and not torch.allclose(ys[:, 0], ys[:, 2])


def test_fused_rollout_frames_unchanged_on_cpu(beams, pallas_case):
    """One frames launch in place of a launch a frame: on the CPU the
    rollout's frames are those of the per-frame loop of the steps twin
    that it ran before, bit for bit."""
    x0, kw, _, ys = pallas_case
    beam = beams[1]
    h = kw["dt"] / kw["substeps"]
    M, K, Jinv, Minv = tfr.fused_host_operators(beam, h, RHO_INF)
    n = M.shape[0]
    xt = torch.tensor(x0)
    mats, c, u = convert.fused_operators_from_numpy(
        M, K, Jinv, tfr.drag_coefficient_vector(beam), kw["u"], device="cpu")
    q0, v0 = xt[:, :n], xt[:, n:]
    f0 = u - q0 @ mats[1].mT - c * v0 * v0.abs()
    x = torch.cat([q0, v0, f0 @ torch.tensor(Minv).mT], dim=-1)
    frames = [xt]
    for _ in range(round(kw["t_final"] / kw["dt"])):
        x = tfr.fused_gen_alpha_steps_plain(mats, c, u, x, kw["substeps"], h)
        frames.append(x[:, : 2 * n])
    assert torch.equal(ys, torch.stack(frames))


def test_fused_rollout_matches_simulate(beams, pallas_case):
    """The fused rollout is the implicit integrator's recurrence with drag:
    held to the JAX package's and the port's ``simulate``."""
    x0, kw, _, ys = pallas_case
    ref_j = np.asarray(jsim.simulate(beams[0], x0, method="generalized_alpha",
                                     rho_inf=RHO_INF, **kw).ys)
    ref_t = tcrt.simulate(beams[1], x0, method="generalized_alpha", rho_inf=RHO_INF,
                          device="cpu", **kw).ys
    assert _scaled_err(ys, ref_j, 2) <= EXACT
    assert _scaled_err(ys, ref_t, 2) <= EXACT


def test_drag_coefficient_vector(beams):
    from tests import helpers

    jc, tc = jfr.drag_coefficient_vector(beams[0]), tfr.drag_coefficient_vector(beams[1])
    np.testing.assert_array_equal(tc, jc)
    assert (tc > 0).sum() == 6  # the six free nodes' w rows
    dry = tcrt.DynamicEulerBernoulliBeam(helpers.linear_csv())
    assert not tfr.drag_coefficient_vector(dry).any()


def test_nonlinear_beam_raises():
    from tests import helpers

    csv = helpers.mixed_csv()
    x0 = np.zeros((1, 36))
    with pytest.raises(ValueError) as ej:
        jfr.fused_rollout(jcrt.DynamicEulerBernoulliBeam(csv), x0, 0.002, 0.001)
    with pytest.raises(ValueError) as et:
        tfr.fused_rollout(tcrt.DynamicEulerBernoulliBeam(csv), x0, 0.002, 0.001,
                          device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("entry", ["fused_rollout", "batched_rollout", "convert"])
def test_entry_points_default_to_the_card(beams, step_case, monkeypatch, entry):
    """Without a device argument the entry points run on the card; with no
    card they raise instead of carrying on on the CPU."""
    from continuum_robot_tpu_torch.parallel import batched_rollout

    x0 = np.zeros((2, 2 * beams[1].n_pos_states))
    calls = {
        "fused_rollout": lambda: tfr.fused_rollout(beams[1], x0, 0.002, 0.001),
        "batched_rollout": lambda: batched_rollout(beams[1], x0, 0.002, 0.001,
                                                   method="generalized_alpha"),
        "convert": lambda: convert.fused_operators_from_numpy(*step_case[:5]),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _random_case(n, B, dtype, dev):
    """Well-conditioned random operators, drag, a force and states."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(3, n, n)) / np.sqrt(n)
    M = A[0] @ A[0].T + np.eye(n)
    K = 1e3 * (A[1] @ A[1].T)
    Jinv = np.linalg.inv(M + 1e-3 * K)
    mats, c, u = convert.fused_operators_from_numpy(
        M, K, Jinv, rng.uniform(0.0, 3.0, n), rng.normal(size=n), device=dev, dtype=dtype)
    return mats, c, u, torch.tensor(rng.normal(size=(B, 3 * n)), dtype=dtype, device=dev)


# (n, B): the rows instance (n <= 36 in float, 24 in double) and the lanes
# instance past it, ragged env groups and blocks, the main shape's n = 18.
CARD_CASES = [(13, 5), (36, 37), (18, 4097), (24, 33), (37, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", CARD_CASES)
def test_kernel_bit_equal_to_plain_on_card(cuda_device, dtype, n, B):
    mats, c, u, x = _random_case(n, B, dtype, cuda_device)
    tfr.reset_launch_counts()
    out = tfr.fused_gen_alpha_steps(mats, c, u, x, 9, 1e-3, rho_inf=0.7, n_newton=2)
    assert tfr.fused_gen_alpha_steps.launches == 1
    ref = tfr.fused_gen_alpha_steps_plain(mats, c, u, x, 9, 1e-3, rho_inf=0.7, n_newton=2)
    assert torch.isfinite(out).all() and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", CARD_CASES)
def test_frames_kernel_bit_equal_to_plain_on_card(cuda_device, dtype, n, B):
    """The whole-rollout launch against the frames twin and against a
    launch of the steps kernel a frame, bit for bit."""
    mats, c, u, x = _random_case(n, B, dtype, cuda_device)
    kw = dict(rho_inf=0.7, n_newton=2)
    tfr.reset_launch_counts()
    ys = tfr.fused_gen_alpha_frames(mats, c, u, x, 3, 4, 1e-3, **kw)
    assert tfr.fused_gen_alpha_frames.launches == 1 and tfr.fused_gen_alpha_steps.launches == 0
    assert torch.equal(ys, tfr.fused_gen_alpha_frames_plain(mats, c, u, x, 3, 4, 1e-3, **kw))
    state = x
    for f in range(1, 4):
        state = tfr.fused_gen_alpha_steps(mats, c, u, state, 4, 1e-3, **kw)
        assert torch.equal(ys[f], state[:, : 2 * n])


@pytest.mark.cuda
def test_fused_rollout_on_card_matches_cpu(cuda_device):
    import pandas as pd  # no `tests` helpers: the card's site-packages may shadow them

    L, r, n_el = 0.25, 0.005, 6
    beam = tcrt.DynamicEulerBernoulliBeam(pd.DataFrame({
        "length": [L] * n_el, "elastic_modulus": [75e9] * n_el,
        "moment_inertia": [np.pi * r**4 / 4] * n_el, "density": [6450.0] * n_el,
        "cross_area": [np.pi * r**2] * n_el, "type": ["linear"] * n_el,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n_el - 1),
        "wetted_area": [2 * np.pi * r * L] * n_el, "drag_coef": [0.82] * n_el,
    }), tcrt.ForceParams(**WATER))
    n = beam.n_pos_states
    x0 = np.zeros((64, 2 * n))
    x0[:, n - 2] = np.random.default_rng(0).normal(scale=1e-3, size=64)
    tfr.reset_launch_counts()
    _, ys = tfr.fused_rollout(beam, x0, 0.01, 0.001, device=cuda_device)
    # the whole rollout is one launch
    assert [k.launches for k in tfr.KERNELS] == [0, 1]
    _, ys_cpu = tfr.fused_rollout(beam, x0, 0.01, 0.001, device="cpu")
    assert _scaled_err(ys.cpu(), ys_cpu, 2) <= EXACT

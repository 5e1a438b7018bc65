"""The port's fused ROM rollout and ``simulate(method="modal_rom")`` against
the JAX package.

The float32 plain twin of the CUDA kernels (what a CPU tensor runs) against
the JAX kernel in interpret mode, as ``tests/test_pallas.py`` runs it, at
amplitudes where the correction force is leading order, to ``5e-6 x`` each
output's scale over 20 steps: the bound of the JAX package's own kernel
test. Window, hybrid, damped with a dense Newton solve, and the ECSW
gathered layout; the wrapper's contracts and CPU dispatch; and, on the card
only, the CUDA kernels' spans: the float32 tier against its float32 twin,
the 3xTF32 tier against a float64 twin span. ``simulate`` with
engine "xla" (the float64 plain stepper) to 1e-10 relative, and with engine
"pallas" (float32) to ``5e-6 x`` the state scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from continuum_robot_tpu.models import simulate as js
from continuum_robot_tpu_torch.models import simulate as ts
from continuum_robot_tpu_torch.ops.cuda import _build
from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk
from test_torch_rom_engine import (  # noqa: F401  (beams: a fixture)
    B, DT, M, RHO, _engines, _inputs, _reduced, _snapshots, beams,
)

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST


def _abs_close(port, ref, bound):
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=bound * (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("case", ["nonlinear", "mixed", "damped_dense",
                                  "gathered"])
def test_fused_plain_matches_pallas_interpret(beams, case):
    """The float32 plain twin of the CUDA kernels against the JAX Pallas
    kernel in interpret mode, as tests/test_pallas.py runs it."""
    beam = "mixed" if case == "mixed" else "nonlinear"
    ms, port = _engines(beams, beam, (0.5, 1e-6) if case == "damped_dense" else None)
    if case == "damped_dense":  # the dense (m, m) Newton solve
        ms = dataclasses.replace(ms, Sinv_diag=None)
        port = dataclasses.replace(port, Sinv_diag=None)
    if case == "gathered":
        (ms, _), (port, _) = _reduced(beams, beam)
    eta, _, um = _inputs(ms, beams[beam][1], 3e-2, dtype=np.float32)
    etad = np.zeros_like(eta)
    ref = ms.make_pallas_rollout(tile=128)(
        jnp.asarray(eta), jnp.asarray(etad), jnp.asarray(um), 20, n_newton=2,
        precision=HIGHEST, nl_precision=HIGHEST, interpret=True,
    )
    fused = port.make_pallas_rollout()
    out = fused(torch.tensor(eta), torch.tensor(etad), um, 20, n_newton=2,
                nl_precision="highest")
    assert all(x.dtype == torch.float32 for x in out)
    _abs_close(out, ref, 5e-6)
    # frames: the same span, one frame per 5 steps
    _, etas, etads = fused.frames(torch.tensor(eta), torch.tensor(etad), um, 4,
                                  substeps=5, n_newton=2)
    assert etas.shape == (5, B, M)
    _abs_close((etas[-1], etads[-1]), out[:2], 1e-6)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_simulate_modal_rom_matches(beams, engine):
    jb, tb = beams["nonlinear"]
    rng = np.random.default_rng(4)
    n = tb.n_pos_states
    x0 = np.zeros((3, 2 * n))
    x0[:, :n] = rng.normal(scale=1e-4, size=(3, n))
    u = np.zeros(n)
    u[-2] = 0.1
    kw = dict(method="modal_rom", u=u, substeps=5, rho_inf=RHO, n_modes=M,
              n_newton=1, engine=engine)
    ref = js.simulate(jb, x0, 2e-3, 5e-4, **kw)
    out = ts.simulate(tb, x0, 2e-3, 5e-4, device="cpu", **kw)
    ys_ref = np.asarray(ref.ys)
    assert tuple(out.ys.shape) == ys_ref.shape == (5, 3, 2 * n)
    np.testing.assert_allclose(out.ts.numpy(), np.asarray(ref.ts), rtol=1e-15)
    bound = 1e-10 if engine == "xla" else 5e-6
    assert out.ys.dtype == (torch.float64 if engine == "xla" else torch.float32)
    assert np.abs(out.ys.numpy() - ys_ref).max() <= bound * np.abs(ys_ref).max()


def test_fused_contracts_and_cpu_dispatch(beams, monkeypatch):
    """CPU tensors take the plain twins (no build, no launch); bad inputs
    raise; a dt change keeps the engine's diagonal Newton solve."""

    def no_build(*_):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    ms, port = _engines(beams, "nonlinear")
    fused = port.make_pallas_rollout(tile=128, chunk=7)
    eta = torch.zeros((2, M), dtype=torch.float32)
    rk.reset_launch_counts()
    out = fused(eta, eta, None, 3)
    assert all(torch.equal(x, torch.zeros_like(eta)) for x in out)
    assert [fn.launches for fn in rk.KERNELS] == [0] * 9
    with pytest.raises(ValueError, match="precision"):
        fused(eta, eta, None, 1, nl_precision="bf16")
    with pytest.raises(ValueError, match="constant"):
        fused(eta, eta, lambda t: None, 1)
    with pytest.raises(ValueError, match="n_newton"):
        fused(eta, eta, None, 1, n_newton=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rk.rom_alpha_point(None, *(eta.to("meta"),) * 4)
    half = port.with_dt(DT / 2)
    np.testing.assert_allclose(half.Sinv_diag, ms.with_dt(DT / 2).Sinv_diag,
                               rtol=1e-14)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# The 3xTF32 tier's bound against a float64 span. PERF.md section 2 states
# each tier's error a launch as a fraction of the output's scale: the
# 3xTF32 transforms lie up to 1.8e-6 off the float32 twin (the expand; the
# project 4.4e-7), the float32 tier 1.426e-7 off it, which is the size of
# float32 roundoff itself (two float32 sums of the same terms in two orders
# differ by about as much as each differs from the exact sum). Both spans
# carry their launches' errors through the same dynamics, so their errors
# against a float64 span grow alike, each in proportion to its error a
# launch: the kernel's is at most the twin's plus the 3xTF32 excess, so
# kernel <= (1 + 1.8e-6 / 1.426e-7) x twin.
TF32_SPAN_K = 1.0 + 1.8e-6 / 1.426e-7


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["window", "gathered", "dense", "window-3xtf32",
                                  "gathered-3xtf32", "dense-3xtf32"])
def test_rom_kernels_match_plain_on_card(beams, cuda_device, case):
    """50 steps of the CUDA kernels from one seeded start. The float32
    tier (``nl_precision="highest"``, the counterpart of the JAX kernel
    test's HIGHEST) against the float32 twin at that test's 5e-6 x scale;
    the 3xTF32 tier (the default) against a float64 twin span from the same
    start, at most ``TF32_SPAN_K`` times the float32 twin span's error."""
    layout, _, tier = case.partition("-")
    ms, port = _engines(beams, "mixed", (0.5, 1e-6))
    if layout == "gathered":
        port = port.hyper_reduce(_snapshots(ms, beams["mixed"][1]), tau=1e-3)
    if layout == "dense":
        port = dataclasses.replace(port, Sinv_diag=None)
    fused = port.make_pallas_rollout()
    eta, etad, um = _inputs(ms, beams["mixed"][1], 3e-2, dtype=np.float32)
    e = torch.tensor(eta, device=cuda_device)
    ed = torch.tensor(etad, device=cuda_device)
    op = fused.operators(e, um, None if tier else "highest")
    a0 = port.initial_accel(e, ed, op.u)
    out = rk.rom_steps(op, e, ed, a0, 50, n_newton=2)
    ref = rk.rom_steps_plain(op, e, ed, a0, 50, n_newton=2)
    if not tier:
        for a, b in zip(out, ref):
            assert float((a - b).abs().max()) <= 5e-6 * float(b.abs().max())
        return
    exact = rk.rom_steps_plain(fused.operators(e.double(), um), e.double(), ed.double(),
                               a0.double(), 50, n_newton=2)
    for a, b, x in zip(out, ref, exact):
        twin = float((b.double() - x).abs().max())
        assert float((a.double() - x).abs().max()) <= TF32_SPAN_K * twin

"""The port's roofline accounting and profiling helpers against the JAX package.

``utils.roofline``: the utilization arithmetic on the same numbers (the
port's ceiling keys mapped to the JAX package's), ``program_cost`` and
``scan_program_cost`` of matrix products (both count 2mkn FLOPs a product),
the ``fma_chain`` probe's wrapper on CPU tensors (its plain twin) and the
probes' refusal without a card. ``utils.profiling``: ``StepMeter``'s report
keys, ``trace`` on the CPU and without a card, and ``compile_time_breakdown``
without a card. The card-only parts (the kernel, the measured ceilings) run
in ``chip_smoke.py`` phases 50-51.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from continuum_robot_tpu.utils import profiling as jprofiling
from continuum_robot_tpu.utils import roofline as jroofline
from continuum_robot_tpu_torch import utils as tutils
from continuum_robot_tpu_torch.utils import profiling as tprofiling
from continuum_robot_tpu_torch.utils import roofline as troofline

CEILINGS = {"f32_flops": 5.1e13, "tf32_flops": 3.7e14, "fma_f32_flops": 6.2e13,
            "hbm_bytes_per_sec": 3.1e12}
# The port's precision tiers and the JAX package's that stand where they stand.
TIERS = {"f32": "f32", "tf32": "bf16", "fma": "vpu"}


def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


def jax_ceilings():
    return {troofline.JAX_KEYS[k]: v for k, v in CEILINGS.items()}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("flops, nbytes, wall", [
    (3.3e12, 4.1e11, 0.21),    # compute-bound on every tier's ceiling
    (1.7e9, 2.9e12, 1.3),      # memory-bound
    (7.0e11, 0.0, 0.05),       # no byte count
])
def test_utilization_matches_jax(tier, flops, nbytes, wall):
    got = troofline.utilization(flops, nbytes, wall, CEILINGS, precision_tier=tier)
    want = jroofline.utilization(flops, nbytes, wall, jax_ceilings(),
                                 precision_tier=TIERS[tier])
    assert set(got) == set(want)
    assert got["bound"] == want["bound"]
    for key in ("flops_per_sec", "hbm_gbps", "roofline_frac", "frac_compute",
                "frac_memory"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-15, err_msg=key)


def test_utilization_without_bytes_counts_none_as_zero():
    got = troofline.utilization(1e12, None, 0.5, CEILINGS, "fma")
    want = jroofline.utilization(1e12, 0.0, 0.5, jax_ceilings(), "vpu")
    assert got == want


def test_ceiling_keys_name_the_jax_keys():
    assert set(troofline.JAX_KEYS) == set(CEILINGS)
    assert set(troofline.JAX_KEYS.values()) == {
        "mxu_f32_flops", "mxu_bf16_flops", "vpu_f32_flops", "hbm_bytes_per_sec"}
    assert set(troofline.TIER_KEYS.values()) <= set(CEILINGS)


@pytest.mark.parametrize("m, k, n", [(5, 7, 3), (64, 33, 17)])
def test_program_cost_of_a_product_matches_jax(m, k, n):
    rng = np.random.default_rng(m)
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    got = troofline.program_cost(torch.matmul, torch.as_tensor(a), torch.as_tensor(b))
    want = jroofline.program_cost(jnp.matmul, a, b)
    assert got["flops"] == want["flops"] == 2 * m * k * n
    assert got["bytes"] is None


def test_scan_program_cost_scales_one_step():
    rng = np.random.default_rng(2)
    c, x = rng.normal(size=(6, 9)), rng.normal(size=(9, 9))
    got = troofline.scan_program_cost(torch.matmul, torch.as_tensor(c),
                                      torch.as_tensor(x), 11)
    want = jroofline.scan_program_cost(jnp.matmul, c, x, 11)
    assert got["flops"] == want["flops"] == 11 * 2 * 6 * 9 * 9


def test_program_cost_is_none_without_counted_flops():
    # Elementwise work is not priced by the counter (the JAX module returns
    # None for work its analyser cannot see): callers pass analytic counts.
    assert troofline.program_cost(torch.sin, torch.ones(8)) is None


def test_fma_chain_on_cpu_is_its_twin():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(37, generator=gen, dtype=torch.float32)
    before = troofline.fma_chain.launches
    y = troofline.fma_chain(x, 5, 1e-7)
    assert troofline.fma_chain.launches == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(y.numpy(), troofline.fma_chain_plain(x, 5, 1e-7).numpy())
    z = x.clone()
    assert troofline.fma_chain(z, 5, 1e-7, out=z) is z
    np.testing.assert_array_equal(z.numpy(), y.numpy())
    # Each link is y * y + eps rounded once: a float64 chain rounded to
    # float32 at every link agrees to an ulp a link.
    ref = x.double()
    for _ in range(5):
        ref = (ref * ref + float(np.float32(1e-7))).float().double()
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=5 * 2.0**-23, atol=0)
    with pytest.raises(TypeError):
        troofline.fma_chain(x.double(), 5, 1e-7)
    with pytest.raises(TypeError):
        troofline.fma_chain(x.reshape(1, -1), 5, 1e-7)


@pytest.mark.parametrize("probe", [
    lambda: troofline.measure_matmul_ceiling(64, "highest"),
    lambda: troofline.measure_matmul_ceiling(64, "tf32"),
    lambda: troofline.measure_hbm_ceiling(1),
    lambda: troofline.measure_vpu_ceiling(1, chain=4),
    lambda: troofline.measure_ceilings(quick=True),
], ids=["matmul_highest", "matmul_tf32", "hbm", "fma", "all"])
def test_measurements_raise_without_a_card(probe):
    no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        probe()


def test_matmul_precision_is_checked():
    with pytest.raises(ValueError):
        troofline.measure_matmul_ceiling(64, "bf16")


def test_step_meter_report_matches_jax():
    x = torch.ones(4, dtype=torch.float64)
    meter = tprofiling.StepMeter(n_steps=20, n_envs=8)
    out = meter.measure(lambda v: v * 2.0, x, repeats=3)
    assert torch.equal(out, 2.0 * x)
    jmeter = jprofiling.StepMeter(n_steps=20, n_envs=8)
    jmeter.measure(lambda v: v * 2.0, jnp.ones(4), repeats=3)
    rep, jrep = meter.report(), jmeter.report()
    assert list(rep) == list(jrep)
    assert rep["compile_s"] > 0 and rep["run_s"] > 0
    assert rep["env_steps_per_sec"] == pytest.approx(8 * rep["steps_per_sec"], rel=1e-15)
    assert tutils.StepMeter is tprofiling.StepMeter
    assert tutils.trace is tprofiling.trace
    assert tutils.compile_time_breakdown is tprofiling.compile_time_breakdown


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path), device="cpu") as path:
        torch.ones(16).sum()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_and_breakdown_raise_without_a_card(tmp_path):
    no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        with tprofiling.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="CUDA"):
        tprofiling.compile_time_breakdown(lambda: None)

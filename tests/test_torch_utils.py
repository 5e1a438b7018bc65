"""The utilities of the PyTorch port against the JAX package.

Energies and run metrics, the divergence guards and the batch-consistency
check, modal analysis, and checkpoints (a dict state written by either
package loads in the other, leaf for leaf): both packages fed the same
seeded NumPy inputs (float64, CPU).
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuum_robot_tpu as jcrt
import continuum_robot_tpu_torch as tcrt
import helpers
from continuum_robot_tpu import utils as jutils
from continuum_robot_tpu.utils import metrics as jmetrics
from continuum_robot_tpu.utils import modal as jmodal
from continuum_robot_tpu_torch import utils as tutils
from continuum_robot_tpu_torch.utils import metrics as tmetrics
from continuum_robot_tpu_torch.utils import modal as tmodal

CONFIGS = {
    "linear": ["linear"] * 4,
    "nonlinear": ["nonlinear"] * 4,
    "mixed": ["linear"] * 2 + ["nonlinear"] * 2,
}


def models(name):
    csv = helpers.write_beam_csv(CONFIGS[name])
    jm = jcrt.DynamicEulerBernoulliBeam(csv)
    tm = tcrt.DynamicEulerBernoulliBeam(csv)
    os.unlink(csv)
    return jm, tm


def scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


class _Result(NamedTuple):
    ts: object
    ys: object


@pytest.mark.parametrize("name", list(CONFIGS))
def test_energies_and_metrics_match_jax(name):
    jm, tm = models(name)
    n = jm.n_pos_states
    rng = np.random.default_rng(6)
    ys = rng.normal(scale=1e-2, size=(7, 3, 2 * n))
    ts = np.arange(7) * 1e-3
    jk, js = jmetrics.make_energy_fns(jm)
    tk, ts_fn = tmetrics.make_energy_fns(tm)
    y = torch.tensor(ys)
    # (jitted: one XLA compile each, where op-by-op dispatch compiles every op)
    assert scaled(tk(y[..., n:]).numpy(), jax.jit(jk)(jnp.asarray(ys[..., n:]))) <= 1e-12
    assert scaled(ts_fn(y[..., :n]).numpy(), jax.jit(js)(jnp.asarray(ys[..., :n]))) <= 1e-12
    got = tmetrics.run_metrics(tm, tcrt.SimulationResult(ts=torch.tensor(ts), ys=y))
    ref = jmetrics.run_metrics(jm, _Result(ts, ys))
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-300), k
        else:
            assert got[k] == v, k
    t_got, tip_got = tmetrics.tip_trajectory(tcrt.SimulationResult(ts=torch.tensor(ts), ys=y))
    t_ref, tip_ref = jmetrics.tip_trajectory(_Result(ts, ys))
    np.testing.assert_array_equal(t_got, t_ref)
    np.testing.assert_array_equal(tip_got, tip_ref)


def test_metrics_flag_a_non_finite_run():
    jm, tm = models("linear")
    n = jm.n_pos_states
    ys = np.zeros((3, 2 * n))
    ys[1, 0] = 1e-3
    ys[2, 3] = np.nan
    got = tmetrics.run_metrics(tm, _Result(np.arange(3.0), torch.tensor(ys)))
    ref = jmetrics.run_metrics(jm, _Result(np.arange(3.0), ys))
    assert got["finite"] is False and ref["finite"] is False
    assert got["energy_initial"] == ref["energy_initial"] == 0.0


@pytest.mark.parametrize("n_modes", [None, 4])
def test_modal_analysis_matches_jax(n_modes):
    jm, tm = models("linear")
    fj, pj = jmodal.modal_analysis(jm, n_modes)
    ft, pt = tmodal.modal_analysis(tm, n_modes)
    assert scaled(ft, fj) <= 1e-12
    # Mass-normalized shapes up to each mode's sign.
    signs = np.sign(np.sum(pt * pj, axis=0))
    assert scaled(pt * signs, pj) <= 1e-10
    args = (helpers.LENGTH * 4, helpers.E_MOD, helpers.M_INERTIA, helpers.DENSITY,
            helpers.CROSS_AREA)
    np.testing.assert_array_equal(tmodal.analytic_cantilever_frequencies(*args),
                                  jmodal.analytic_cantilever_frequencies(*args))


# -- guards ------------------------------------------------------------------


def test_divergence_flags_match_jax():
    x = np.array([[1.0, 2.0], [np.nan, 0.0], [1e9, 0.0], [-2e3, 1.0], [np.inf, 1.0]])
    got = tutils.divergence_flags(torch.tensor(x), limit=1e3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jutils.divergence_flags(x, limit=1e3)))
    np.testing.assert_array_equal(got, [False, True, True, True, True])


@pytest.mark.parametrize("batched", [False, True])
def test_step_with_guard_freezes_as_jax(batched):
    """A diverged env keeps its last good state, healthy envs continue, and
    the running max matches the JAX package's."""
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 4))

    def bad_step(xp, lib):
        def step(x):
            out = x * 1.5 + 1.0
            if lib is torch:
                return out.index_put((torch.tensor([1]),), torch.tensor(np.inf, dtype=out.dtype))
            return out.at[1].set(jnp.inf)
        return step

    tg = tutils.step_with_guard(bad_step(None, torch), limit=1e3)
    jg = jutils.step_with_guard(bad_step(None, jnp), limit=1e3)
    x_t = torch.tensor(x0)
    x_j = jnp.asarray(x0)
    shape = (3,) if batched else ()
    if not batched:
        x_t, x_j = x_t[0], x_j[0]
        tg = tutils.step_with_guard(lambda x: x * 1.5 + 1.0, limit=10.0)
        jg = jutils.step_with_guard(lambda x: x * 1.5 + 1.0, limit=10.0)
    h_t, h_j = tutils.init_health(x_t, shape), jutils.init_health(x_j, shape)
    for _ in range(6):
        x_t, h_t = tg(x_t, h_t)
        x_j, h_j = jg(x_j, h_j)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(h_t.diverged.numpy(), np.asarray(h_j.diverged))
    np.testing.assert_array_equal(h_t.max_abs.numpy(), np.asarray(h_j.max_abs))
    assert bool(h_t.diverged.any())
    assert torch.isfinite(x_t).all()


def test_guard_rhs_zeroes_non_finite():
    g = tutils.guard_rhs(lambda t, x, u=None: x / x)  # NaN at zero
    x = torch.tensor([0.0, 2.0, -1.0])
    np.testing.assert_array_equal(g(0.0, x).numpy(), [0.0, 1.0, 1.0])


@pytest.mark.parametrize("consistent", [True, False])
def test_verify_batch_consistency(consistent):
    x = torch.tensor(np.random.default_rng(2).normal(size=(4, 8)))
    if consistent:
        assert tutils.verify_batch_consistency(lambda z: z * 2 + 1, x) < 1e-15
        return

    def bad(z):  # behaves differently for batched input
        return z * (3.0 if z.dim() == 2 else 2.0)

    with pytest.raises(RuntimeError, match="summation order"):
        tutils.verify_batch_consistency(bad, x)


def test_verify_batch_consistency_of_row_sums():
    """The small beams' dense products (``dynamics.dense_apply`` row sums,
    what the RHS applies M^-1 with) are batch-invariant: deviation 0."""
    from continuum_robot_tpu_torch.models.dynamics import dense_apply

    rng = np.random.default_rng(3)
    m = torch.tensor(rng.normal(size=(36, 36)))
    x = torch.tensor(rng.normal(size=(64, 36)))
    assert tutils.verify_batch_consistency(lambda z: dense_apply(m, z), x, rtol=0.0,
                                           n_check=4) == 0.0


# -- checkpoints -------------------------------------------------------------


class Carry(NamedTuple):
    q: object
    v: object


def _state(lib):
    """A nested state whose dict keys are not in sorted order."""
    arr = torch.tensor if lib == "port" else jnp.asarray
    return {"v": arr(np.ones(4)), "q": arr(np.arange(6.0)),
            "carry": Carry(arr(np.full(2, 3.0)), None),
            "hist": [arr(np.arange(3) * 2.0), arr(np.eye(2))]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    meta = {"n_envs": 4, "dt": 1e-3}
    if writer == "jax":
        jutils.save_checkpoint(path, _state("jax"), t=0.25, rng_key=jnp.asarray([0, 7]),
                               meta=meta)
        state, t, key, got_meta = tutils.load_checkpoint(path, treedef_like=_state("port"))
        np.testing.assert_array_equal(key, [0, 7])
    else:
        tutils.save_checkpoint(path, _state("port"), t=0.25, rng_key=np.asarray([0, 7]),
                               meta=meta)
        state, t, key, got_meta = jutils.load_checkpoint(path, treedef_like=_state("jax"))
        np.testing.assert_array_equal(key, [0, 7])
    assert t == 0.25 and int(got_meta["n_envs"]) == 4 and float(got_meta["dt"]) == 1e-3
    want = _state("port")
    # Each loader rebuilds a dict in its own order: the port in the
    # like-structure's, jax.tree_util in sorted order.
    assert list(state) == (list(want) if writer == "jax" else sorted(want))
    for k in ("v", "q"):
        np.testing.assert_array_equal(np.asarray(state[k]), want[k].numpy())
    np.testing.assert_array_equal(np.asarray(state["carry"].q), want["carry"].q.numpy())
    assert state["carry"].v is None
    for a, b in zip(state["hist"], want["hist"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if writer == "jax":
        assert isinstance(state["q"], torch.Tensor)


def test_checkpoint_generator_and_leaves(tmp_path):
    path = str(tmp_path / "ckpt")
    gen = torch.Generator().manual_seed(123)
    torch.rand(5, generator=gen)
    state = (torch.arange(4.0), {"b": torch.ones(2), "a": torch.zeros(3)})
    tutils.save_checkpoint(path, state, t=1.5, rng_key=gen)
    restored, t, gen2, meta = tutils.load_checkpoint(path, treedef_like=state)
    assert t == 1.5 and meta == {}
    assert torch.equal(torch.rand(4, generator=gen2), torch.rand(4, generator=gen))
    assert torch.equal(restored[0], state[0]) and list(restored[1]) == ["b", "a"]
    assert torch.equal(restored[1]["a"], state[1]["a"])
    leaves, _, key, _ = tutils.load_checkpoint(path)
    assert key is not None and [x.shape for x in leaves] == [(4,), (3,), (2,)]
    _, _, jkey, _ = jutils.load_checkpoint(path)  # the JAX package ignores it
    assert jkey is None

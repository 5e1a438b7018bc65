"""Model build of the PyTorch port against the JAX package.

The same CSV or DataFrame goes through both packages: element matrices,
the reduced K and M, the DOF bookkeeping and the ``ValueError`` contracts
must agree (matrices to 1e-15 relative).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import continuum_robot_tpu.models as jm
import continuum_robot_tpu_torch.models as tm
from continuum_robot_tpu.models import assembly as j_assembly
from continuum_robot_tpu.models import elements as j_elements
from continuum_robot_tpu.models.config import beam_arrays_from_dataframe as j_arrays
from continuum_robot_tpu_torch import convert
from continuum_robot_tpu_torch.models import assembly as t_assembly
from continuum_robot_tpu_torch.models import elements as t_elements
from continuum_robot_tpu_torch.models.config import beam_arrays_from_dataframe as t_arrays
from tests import helpers

torch.set_num_threads(1)

TOL = 1e-15


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _element_params(n=5):
    rng = np.random.default_rng(7)
    return (
        rng.uniform(0.01, 0.3, n),  # length
        rng.uniform(1e9, 2e11, n),  # elastic modulus
        rng.uniform(1e-12, 1e-9, n),  # moment of inertia
        rng.uniform(1e3, 9e3, n),  # density
        rng.uniform(1e-6, 1e-4, n),  # cross area
    )


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_element_matrices(kind):
    L, E, I, rho, A = _element_params()
    Kj = np.asarray(j_elements.linear_stiffness_matrix(L, E, I, A))
    Mj = np.asarray(j_elements.consistent_mass_matrix(L, rho, A))
    if kind == "torch":
        L, E, I, rho, A = (torch.tensor(x) for x in (L, E, I, rho, A))
    Kt = t_elements.linear_stiffness_matrix(L, E, I, A)
    Mt = t_elements.consistent_mass_matrix(L, rho, A)
    assert isinstance(Kt, torch.Tensor if kind == "torch" else np.ndarray)
    assert Kt.shape == Kj.shape == (5, 6, 6)
    assert _rel(Kt, Kj) <= TOL
    assert _rel(Mt, Mj) <= TOL


def test_element_matrices_scalar_broadcast():
    """Scalar properties broadcast against one tensor argument."""
    L = torch.tensor([0.25, 0.1], dtype=torch.float64)
    Kt = t_elements.linear_stiffness_matrix(L, 75e9, 4.9e-10, 7.9e-5)
    Kj = np.asarray(j_elements.linear_stiffness_matrix(L.numpy(), 75e9, 4.9e-10, 7.9e-5))
    assert Kt.dtype == torch.float64 and _rel(Kt, Kj) <= TOL


def _beam_csv(tmp_path, types, bcs=None, fluid=True):
    return helpers.write_beam_csv(
        types, bcs, include_fluid=fluid, path=str(tmp_path / "beam.csv")
    )


BEAMS = {
    "linear_fixed": (["linear"] * 4, None),
    "linear_pinned_ends": (["linear"] * 7, ["PINNED"] + ["NONE"] * 5 + ["PINNED"]),
    "mixed_fixed": (["linear"] * 3 + ["nonlinear"] * 3, None),
}


@pytest.mark.parametrize("source", ["csv", "dataframe"])
@pytest.mark.parametrize("beam", sorted(BEAMS))
def test_reduced_matrices_and_bookkeeping(tmp_path, beam, source):
    types, bcs = BEAMS[beam]
    csv = _beam_csv(tmp_path, types, bcs)
    arg = csv if source == "csv" else pd.read_csv(csv)
    jb = jm.DynamicEulerBernoulliBeam(arg)
    tb = tm.DynamicEulerBernoulliBeam(arg)

    assert tb.n_pos_states == jb.n_pos_states
    jbc, tbc = jb.beam_model.bc_info, tb.beam_model.bc_info
    np.testing.assert_array_equal(tbc.free_mask, jbc.free_mask)
    np.testing.assert_array_equal(tbc.free_dofs, jbc.free_dofs)
    assert tbc.constrained_dofs == jbc.constrained_dofs
    assert sorted(tb.constrained_dofs) == sorted(jb.constrained_dofs)
    assert tb.get_state_mapping() == jb.get_state_mapping()
    assert ([t.value for t in tb.beam_model.get_segment_types()]
            == [t.value for t in jb.beam_model.get_segment_types()])

    assert _rel(tb.beam_model.get_mass_matrix(), jb.beam_model.get_mass_matrix()) <= TOL
    if "nonlinear" in types:
        with pytest.raises(ValueError) as ej:
            jb.beam_model.get_stiffness_matrix()
        with pytest.raises(ValueError) as et:
            tb.beam_model.get_stiffness_matrix()
        assert str(et.value) == str(ej.value)
    else:
        assert _rel(tb.beam_model.get_stiffness_matrix(),
                    jb.beam_model.get_stiffness_matrix()) <= TOL


def test_block_tridiagonal_mass_on_torch(tmp_path):
    """The block-tridiagonal mass takes torch parameter arrays too."""
    df = pd.read_csv(_beam_csv(tmp_path, ["linear"] * 5))
    ja = j_arrays(df, dtype=np.float64)
    ta = t_arrays(df)
    ta_torch = dataclasses.replace(
        ta, **{f: torch.tensor(getattr(ta, f))
               for f in ("length", "density", "cross_area")}
    )
    dj, oj = j_assembly.mass_block_tridiagonal(ja)
    dt, ot = t_assembly.mass_block_tridiagonal(ta_torch)
    assert isinstance(dt, torch.Tensor)
    assert _rel(dt, dj) <= TOL and _rel(ot, oj) <= TOL
    M = t_assembly.dense_mass_matrix(ta)
    free = np.arange(3, M.shape[0])
    np.testing.assert_array_equal(
        t_assembly.reduce_matrix(torch.tensor(M), free).numpy(),
        np.asarray(j_assembly.reduce_matrix(M, free)),
    )


def test_beam_arrays_from_numpy(tmp_path):
    df = pd.read_csv(_beam_csv(tmp_path, ["linear"] * 2 + ["nonlinear"] * 2))
    ja = j_arrays(df, dtype=np.float64)
    ta = convert.beam_arrays_from_numpy(
        **{f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}
    )
    ref = t_arrays(df)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ta, f.name), getattr(ref, f.name))


def _bad_frames():
    n = 3
    base = pd.DataFrame({
        "length": [helpers.LENGTH] * n,
        "elastic_modulus": [helpers.E_MOD] * n,
        "moment_inertia": [helpers.M_INERTIA] * n,
        "density": [helpers.DENSITY] * n,
        "cross_area": [helpers.CROSS_AREA] * n,
        "type": ["linear"] * n,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [helpers.WETTED_AREA] * n,
        "drag_coef": [helpers.DRAG_COEF] * n,
    })
    cases = {}
    cases["missing_column"] = (base.drop(columns=["type"]), None)
    df = base.copy()
    df.loc[1, "type"] = "quadratic"
    cases["invalid_type"] = (df, None)
    df = base.copy()
    df.loc[2, "boundary_condition"] = "CLAMPED"
    cases["invalid_bc"] = (df, None)
    df = base.copy()
    df.loc[0, "length"] = -0.1
    cases["nonpositive_length"] = (df, None)
    fluid = dict(enable_fluid_effects=True, fluid_density=1000.0)
    cases["fluid_missing_columns"] = (
        base.drop(columns=["wetted_area", "drag_coef"]), fluid
    )
    df = base.copy()
    df.loc[1, "drag_coef"] = -0.5
    cases["fluid_negative_drag"] = (df, fluid)
    df = base.copy()
    df.loc[1, "wetted_area"] = -0.5
    cases["fluid_negative_wetted_area"] = (df, fluid)
    return cases


BAD = _bad_frames()


@pytest.mark.parametrize("case", sorted(BAD))
def test_value_error_contracts(case):
    df, fluid = BAD[case]
    kw_j = {} if fluid is None else {"force_params": jm.ForceParams(**fluid)}
    kw_t = {} if fluid is None else {"force_params": tm.ForceParams(**fluid)}
    with pytest.raises(ValueError) as ej:
        jm.DynamicEulerBernoulliBeam(df, **kw_j)
    with pytest.raises(ValueError) as et:
        tm.DynamicEulerBernoulliBeam(df, **kw_t)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kwargs", [
    dict(enable_fluid_effects=True, fluid_density=0.0),
    dict(gravity_vector=[0.0, -9.81]),
])
def test_force_params_contracts(kwargs):
    with pytest.raises(ValueError) as ej:
        jm.ForceParams(**kwargs)
    with pytest.raises(ValueError) as et:
        tm.ForceParams(**kwargs)
    assert str(et.value) == str(ej.value)


def test_properties_contracts(tmp_path):
    df = pd.read_csv(_beam_csv(tmp_path, ["linear"] * 2))
    pj = jm.create_properties_from_dataframe(df, 1)
    pt = tm.create_properties_from_dataframe(df, 1)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    for mod in (jm, tm):
        with pytest.raises(IndexError):
            mod.create_properties_from_dataframe(df, 2)
        with pytest.raises(ValueError, match="Density"):
            mod.Properties(0.1, 1e9, 1e-9, 0.0, 1e-5, 0, "linear")


def test_force_registration_and_aggregate(tmp_path):
    """Fluid and gravity register as in the JAX package; their aggregate
    equals the JAX package's; the empty aggregate is the zero force."""
    csv = _beam_csv(tmp_path, ["linear"] * 4)
    fp = dict(enable_fluid_effects=True, fluid_density=1000.0,
              enable_gravity_effects=True)
    jb = jm.DynamicEulerBernoulliBeam(csv, jm.ForceParams(**fp))
    tb = tm.DynamicEulerBernoulliBeam(csv, tm.ForceParams(**fp))
    assert len(tb.force_registry) == len(jb.force_registry) == 2
    jf, tf = (b.force_registry.get_registered_forces()[0] for b in (jb, tb))
    for key in ("w_vel_indices", "w_pos_indices", "drag_factors"):
        np.testing.assert_array_equal(tf.fluid_coefficients[key],
                                      jf.fluid_coefficients[key])
    x = np.random.default_rng(3).normal(scale=0.1, size=(2, 2 * tb.n_pos_states))
    agg = tb.force_registry.create_aggregated_function()(torch.tensor(x))
    ref = np.asarray(jb.force_registry.create_aggregated_function()(x))
    assert agg.shape == ref.shape == (2, tb.n_pos_states)
    assert _rel(agg, ref) <= 1e-14
    empty = tm.ForceRegistry().create_aggregated_function()(torch.tensor(x))
    assert empty.shape == (2, tb.n_pos_states) and not empty.any()

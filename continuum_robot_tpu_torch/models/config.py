"""Beam configuration: CSV/DataFrame -> parameter arrays + force parameters.

Counterpart of ``continuum_robot_tpu/models/config.py``. Two tiers: (1) a
CSV/DataFrame parameter table with one row per segment, and (2) a
:class:`ForceParams` dataclass for force toggles.

:class:`BeamArrays` holds the per-element parameters as host NumPy arrays;
host setup (assembly, eigensolves) runs in float64 from them.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field
from typing import List, Union

import numpy as np
import pandas as pd

from .abstractions import (
    BoundaryConditionType,
    ElementType,
    boundary_conditions_from_dataframe,
    dofs_constrained_by,
    validate_beam_dataframe,
)


@dataclasses.dataclass(frozen=True)
class BeamArrays:
    """Per-element parameter arrays, shape ``(n_elements,)`` each."""

    length: np.ndarray
    elastic_modulus: np.ndarray
    moment_inertia: np.ndarray
    density: np.ndarray
    cross_area: np.ndarray
    wetted_area: np.ndarray
    drag_coef: np.ndarray
    nonlinear_mask: np.ndarray  # bool array

    @property
    def n_elements(self) -> int:
        return self.length.shape[-1]

    @property
    def EI(self):
        return self.elastic_modulus * self.moment_inertia

    @property
    def EA(self):
        return self.elastic_modulus * self.cross_area

    @property
    def rhoA(self):
        return self.density * self.cross_area

    @property
    def segment_mass(self):
        return self.density * self.cross_area * self.length


def beam_arrays_from_dataframe(df: pd.DataFrame, dtype=np.float64) -> BeamArrays:
    """Flatten a validated parameter table into :class:`BeamArrays`.

    Optional fluid columns default to zero when absent (they are only read
    when fluid effects are enabled).
    """
    n = len(df)

    def col(name):
        if name in df.columns:
            return np.asarray(df[name].to_numpy(dtype=float), dtype=dtype)
        return np.zeros((n,), dtype=dtype)

    nonlinear = np.asarray(
        df["type"].str.lower().to_numpy() == ElementType.NONLINEAR.value
    )
    return BeamArrays(
        length=col("length"),
        elastic_modulus=col("elastic_modulus"),
        moment_inertia=col("moment_inertia"),
        density=col("density"),
        cross_area=col("cross_area"),
        wetted_area=col("wetted_area"),
        drag_coef=col("drag_coef"),
        nonlinear_mask=nonlinear,
    )


def load_beam_dataframe(
    parameters: Union[str, pathlib.Path, pd.DataFrame],
) -> pd.DataFrame:
    """Load a parameter table from a CSV path or copy a DataFrame."""
    if isinstance(parameters, (str, pathlib.Path)):
        try:
            return pd.read_csv(parameters)
        except FileNotFoundError:
            raise FileNotFoundError(f"Parameter file {parameters} not found")
    if isinstance(parameters, pd.DataFrame):
        return parameters.copy()
    raise TypeError("Parameters must be filepath or pandas DataFrame")


@dataclass
class ForceParams:
    """Unified force configuration.

    Gravity auto-disables when the vector is ~zero; enabling fluid effects
    requires a positive fluid density.
    """

    fluid_density: float = 0.0
    enable_fluid_effects: bool = False
    gravity_vector: List[float] = field(default_factory=lambda: [0.0, -9.81, 0.0])
    enable_gravity_effects: bool = False

    def __post_init__(self):
        self.gravity_vector = np.array(self.gravity_vector, dtype=float)
        if np.allclose(self.gravity_vector, [0.0, 0.0, 0.0]):
            self.enable_gravity_effects = False
        if len(self.gravity_vector) != 3:
            raise ValueError(
                "gravity_vector must have exactly 3 components [gx, gy, gz]"
            )
        if self.enable_fluid_effects and self.fluid_density <= 0:
            raise ValueError(
                "fluid_density must be positive when fluid effects are enabled"
            )

    def __bool__(self) -> bool:
        return self.enable_fluid_effects or self.enable_gravity_effects

    def get_gravity_vector(self) -> np.ndarray:
        return self.gravity_vector.copy()

    def set_gravity_vector(self, gravity_vector: List[float]) -> None:
        if len(gravity_vector) != 3:
            raise ValueError(
                "gravity_vector must have exactly 3 components [gx, gy, gz]"
            )
        self.gravity_vector = np.array(gravity_vector, dtype=float)
        if np.allclose(self.gravity_vector, [0.0, 0.0, 0.0]):
            self.enable_gravity_effects = False


@dataclass(frozen=True)
class BCInfo:
    """Host-side boundary-condition bookkeeping: the kept (free) DOFs."""

    n_nodes: int
    constrained_dofs: tuple  # sorted tuple of removed global DOF indices
    free_dofs: np.ndarray  # sorted int array of kept global DOF indices

    @property
    def n_dofs_full(self) -> int:
        return 3 * self.n_nodes

    @property
    def n_free(self) -> int:
        return len(self.free_dofs)

    @property
    def free_mask(self) -> np.ndarray:
        m = np.zeros(self.n_dofs_full, dtype=bool)
        m[self.free_dofs] = True
        return m


def make_bc_info(n_elements: int, conditions: dict) -> BCInfo:
    """Build :class:`BCInfo` from a node->BoundaryConditionType dict.

    Rejects node indices out of range and constraining every DOF.
    """
    n_nodes = n_elements + 1
    constrained = set()
    for node_idx, bc_type in conditions.items():
        if node_idx < 0 or node_idx >= n_nodes:
            raise ValueError(f"Node index {node_idx} out of range [0, {n_nodes - 1}]")
        constrained.update(dofs_constrained_by(bc_type, node_idx))

    all_dofs = set(range(3 * n_nodes))
    free = sorted(all_dofs - constrained)
    if not free:
        raise ValueError("Cannot constrain all degrees of freedom")
    return BCInfo(
        n_nodes=n_nodes,
        constrained_dofs=tuple(sorted(constrained)),
        free_dofs=np.asarray(free, dtype=np.int32),
    )


__all__ = [
    "BeamArrays",
    "BCInfo",
    "ForceParams",
    "beam_arrays_from_dataframe",
    "boundary_conditions_from_dataframe",
    "load_beam_dataframe",
    "make_bc_info",
    "validate_beam_dataframe",
    "BoundaryConditionType",
]

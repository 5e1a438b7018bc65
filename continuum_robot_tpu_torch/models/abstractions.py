"""Core types and interfaces of the continuum-robot model layer.

Counterpart of ``continuum_robot_tpu/models/abstractions.py``:
``ElementType``, ``BoundaryConditionType``, a validated ``Properties``
record, the abstract segment / beam / force / input-handler interfaces,
``create_properties_from_dataframe`` and the DataFrame validation helpers.

These are configuration-time objects. The compute path never touches
per-segment Python objects: element parameters are flattened into arrays
(``models/config.py``) and consumed by the batched element functions
(``models/elements.py``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import pandas as pd


class ElementType(Enum):
    """Supported finite-element formulations."""

    LINEAR = "linear"
    NONLINEAR = "nonlinear"


class BoundaryConditionType(Enum):
    """Supported nodal boundary conditions.

    FIXED constrains ``{u, w, phi}``; PINNED constrains ``{u, w}`` and
    leaves rotation free.
    """

    FIXED = "fixed"
    PINNED = "pinned"


@dataclass
class Properties:
    """Validated per-segment property record (optional fluid fields)."""

    length: float
    elastic_modulus: float
    moment_inertia: float
    density: float
    cross_area: float
    segment_id: int
    element_type: str

    wetted_area: Optional[float] = None
    drag_coef: Optional[float] = None

    def __post_init__(self):
        if self.length <= 0:
            raise ValueError(f"Length must be positive, got {self.length}")
        if self.elastic_modulus <= 0:
            raise ValueError(
                f"Elastic modulus must be positive, got {self.elastic_modulus}"
            )
        if self.moment_inertia <= 0:
            raise ValueError(
                f"Moment of inertia must be positive, got {self.moment_inertia}"
            )
        if self.density <= 0:
            raise ValueError(f"Density must be positive, got {self.density}")
        if self.cross_area <= 0:
            raise ValueError(f"Cross area must be positive, got {self.cross_area}")

        valid_types = {t.value for t in ElementType}
        if self.element_type.lower() not in valid_types:
            raise ValueError(f"Invalid element type: {self.element_type}")

    def get_element_type(self) -> ElementType:
        return ElementType(self.element_type.lower())

    def has_fluid_properties(self) -> bool:
        return self.wetted_area is not None and self.drag_coef is not None


@dataclass
class AssemblyContext:
    """Context for segment assembly (kept for API compatibility)."""

    global_dof_offset: int
    node_start: int
    node_end: int


class ISegment(ABC):
    """Unified segment interface — 3 DOF per node ``[u, w, theta]``."""

    def __init__(self, properties: Properties):
        self.properties = properties
        self.segment_id = properties.segment_id

    @abstractmethod
    def get_mass_matrix(self):
        """Return the 6x6 local mass matrix ``[u1, w1, t1, u2, w2, t2]``."""

    @abstractmethod
    def get_stiffness_func(self):
        """Return a 6x6 stiffness matrix (linear) or state->force callable."""

    @abstractmethod
    def get_element_type(self) -> ElementType:
        """Return the element type."""

    def validate_properties(self) -> None:
        """Validation happens in ``Properties.__post_init__``."""

    def get_properties(self) -> Properties:
        return self.properties


class ISegmentFactory(ABC):
    """Segment factory interface."""

    @abstractmethod
    def create_segment(self, properties: Properties) -> ISegment:
        """Create the appropriate segment type from properties."""

    @abstractmethod
    def detect_element_type(self, properties: Properties) -> ElementType:
        """Detect element type from properties."""


class IBeam(ABC):
    """Unified beam interface."""

    def __init__(self, segments):
        self.segments = segments

    @abstractmethod
    def assemble_mass_matrix(self):
        """Assemble the global mass matrix."""

    @abstractmethod
    def create_stiffness_function(self):
        """Create the global stiffness function."""

    @abstractmethod
    def apply_boundary_conditions(self, boundary_conditions) -> None:
        """Apply boundary conditions to the beam."""

    @abstractmethod
    def get_constrained_dofs(self):
        """Return the list of constrained DOF indices."""


class AbstractForce(ABC):
    """State-dependent force component interface.

    ``compute_forces`` receives the full (reduced) state ``[positions,
    velocities]`` and the time, and returns a force vector over the
    *position* DOFs.
    """

    @abstractmethod
    def compute_forces(self, x, t):
        """Compute the force vector for state ``x`` at time ``t``."""

    @abstractmethod
    def is_enabled(self) -> bool:
        """Return True if this force component is enabled."""


class AbstractInputHandler(ABC):
    """Input-processing component interface.

    ``compute_input`` returns a *modification* (delta) added to the
    aggregate input.
    """

    @abstractmethod
    def compute_input(self, x, r, t):
        """Compute an input modification for state ``x``, reference ``r``, time ``t``."""

    @abstractmethod
    def is_enabled(self) -> bool:
        """Return True if this input handler is enabled."""


def create_properties_from_dataframe(df: pd.DataFrame, segment_id: int) -> Properties:
    """Build a :class:`Properties` record from one DataFrame row."""
    if segment_id >= len(df):
        raise IndexError(f"Segment ID {segment_id} exceeds DataFrame length {len(df)}")

    row = df.iloc[segment_id]
    kwargs = dict(
        length=float(row["length"]),
        elastic_modulus=float(row["elastic_modulus"]),
        moment_inertia=float(row["moment_inertia"]),
        density=float(row["density"]),
        cross_area=float(row["cross_area"]),
        segment_id=segment_id,
        element_type=str(row["type"]),
    )
    if "wetted_area" in df.columns:
        kwargs["wetted_area"] = float(row["wetted_area"])
    if "drag_coef" in df.columns:
        kwargs["drag_coef"] = float(row["drag_coef"])
    return Properties(**kwargs)


def validate_beam_dataframe(df: pd.DataFrame, require_bc: bool = False) -> None:
    """Validate a beam parameter table.

    Required columns present, all numeric entries positive, element types in
    the supported set, and (when ``require_bc``) boundary-condition labels in
    {FIXED, PINNED, NONE}.
    """
    required = [
        "length",
        "elastic_modulus",
        "moment_inertia",
        "density",
        "cross_area",
        "type",
    ]
    if require_bc:
        required = required + ["boundary_condition"]

    if not all(col in df.columns for col in required):
        if require_bc:
            raise ValueError(f"CSV must contain columns: {', '.join(required)}")
        raise ValueError(f"DataFrame must contain columns: {', '.join(required)}")

    numeric_cols = [
        "length",
        "elastic_modulus",
        "moment_inertia",
        "density",
        "cross_area",
    ]
    if (df[numeric_cols].to_numpy(dtype=float) <= 0).any():
        raise ValueError("All numeric parameters must be positive")

    valid_types = {t.value for t in ElementType}
    invalid = set(df["type"].str.lower()) - valid_types
    if invalid:
        raise ValueError(f"Invalid element types: {invalid}")

    if require_bc:
        valid_bcs = {"FIXED", "PINNED", "NONE"}
        invalid_bcs = set(df["boundary_condition"]) - valid_bcs
        if invalid_bcs:
            raise ValueError(f"Invalid boundary conditions: {invalid_bcs}")


def boundary_conditions_from_dataframe(
    df: pd.DataFrame,
) -> dict[int, BoundaryConditionType]:
    """Extract the node->BC mapping from the ``boundary_condition`` column.

    Row i labels node i, "NONE" rows impose nothing, and constraining every
    node is rejected.
    """
    conditions: dict[int, BoundaryConditionType] = {}
    for i, bc in enumerate(df["boundary_condition"]):
        if bc == "FIXED":
            conditions[i] = BoundaryConditionType.FIXED
        elif bc == "PINNED":
            conditions[i] = BoundaryConditionType.PINNED
    if len(conditions) == len(df) + 1:
        raise ValueError("Cannot constrain all nodes with boundary conditions")
    return conditions


def dofs_constrained_by(bc_type: BoundaryConditionType, node_idx: int) -> list[int]:
    """Global DOF indices removed by a boundary condition at ``node_idx``.

    FIXED removes ``{u, w, phi}``; PINNED removes ``{u, w}``.
    """
    base = 3 * node_idx
    if bc_type == BoundaryConditionType.FIXED:
        return [base, base + 1, base + 2]
    if bc_type == BoundaryConditionType.PINNED:
        return [base, base + 1]
    raise ValueError(f"Unsupported boundary condition type: {bc_type}")

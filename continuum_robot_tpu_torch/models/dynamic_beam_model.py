"""Dynamic beam model facade: CSV/DataFrame -> validated beam + force registry.

Counterpart of ``continuum_robot_tpu/models/dynamic_beam_model.py``:
construction from a CSV path or DataFrame with the boundary-condition
column, parameter validation (including the conditional fluid columns) and
its ``ValueError`` contracts, the state mapping with ``d*_dt`` velocity
parameters, and force auto-registration from :class:`ForceParams`.

The ODE right-hand side (``build_rhs`` / ``create_system_func`` /
``create_input_func``) is not ported yet; the modal engine
(``models/simulate.py``) needs only the beam's K and M.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Union

import pandas as pd

from .abstractions import (
    BoundaryConditionType,
    ElementType,
    boundary_conditions_from_dataframe,
)
from .config import ForceParams
from .euler_bernoulli_beam import EulerBernoulliBeam
from .forces import FluidDragForce, ForceRegistry, GravityForce, InputRegistry


class DynamicEulerBernoulliBeam:
    """Dynamic Euler-Bernoulli beam model (host-side construction)."""

    def __init__(
        self,
        filename: Union[str, pathlib.Path, pd.DataFrame],
        force_params: ForceParams = None,
        use_consistent_nonlinear: bool = False,
    ):
        self.force_params = force_params or ForceParams()
        self.use_consistent_nonlinear = use_consistent_nonlinear

        if isinstance(filename, pd.DataFrame):
            self.params = filename.copy()
        else:
            self.params = pd.read_csv(filename)
        self._validate_parameters()

        self.boundary_conditions = self._process_boundary_conditions()

        self.beam_model = EulerBernoulliBeam(
            self.params, use_consistent_nonlinear=use_consistent_nonlinear
        )
        self.beam_model.apply_boundary_conditions(self.boundary_conditions)

        self.constrained_dofs = self.beam_model.get_constrained_dofs()

        self.force_registry = ForceRegistry()
        self.input_registry = InputRegistry()

        self._initialize_state_mapping()
        self._auto_register_forces()

    # -- validation ----------------------------------------------------------

    def _validate_parameters(self) -> None:
        required_cols = [
            "length",
            "elastic_modulus",
            "moment_inertia",
            "density",
            "cross_area",
            "type",
            "boundary_condition",
        ]
        if self.force_params.enable_fluid_effects:
            required_cols.extend(["wetted_area", "drag_coef"])

        if not all(col in self.params.columns for col in required_cols):
            raise ValueError(f"CSV must contain columns: {', '.join(required_cols)}")

        valid_types = {t.value for t in ElementType}
        invalid_types = set(self.params["type"].str.lower()) - valid_types
        if invalid_types:
            raise ValueError(f"Invalid element types: {invalid_types}")

        valid_bcs = {"FIXED", "PINNED", "NONE"}
        invalid_bcs = set(self.params["boundary_condition"]) - valid_bcs
        if invalid_bcs:
            raise ValueError(f"Invalid boundary conditions: {invalid_bcs}")

        if self.force_params.enable_fluid_effects:
            if self.force_params.fluid_density <= 0:
                raise ValueError("Fluid density must be positive")
            if (self.params["drag_coef"] < 0).any():
                raise ValueError("Drag coefficients cannot be negative")
            if (self.params["wetted_area"] < 0).any():
                raise ValueError("Wetted areas cannot be negative")

    # -- state mapping -------------------------------------------------------

    def _initialize_state_mapping(self):
        self.state_to_node_param = {}
        self.node_param_to_state = {}

        pos_mapping = self.beam_model.dof_to_node_param
        n_dofs = len(pos_mapping)

        for dof_idx, (param, node) in pos_mapping.items():
            self.state_to_node_param[dof_idx] = (param, node)
            self.node_param_to_state[(param, node)] = dof_idx

        for dof_idx, (param, node) in pos_mapping.items():
            vel_idx = dof_idx + n_dofs
            vel_param = f"d{param}_dt"
            self.state_to_node_param[vel_idx] = (vel_param, node)
            self.node_param_to_state[(vel_param, node)] = vel_idx

        self._original_state_to_node_param = self.state_to_node_param.copy()
        self._original_node_param_to_state = self.node_param_to_state.copy()

    def get_state_to_node_param(self, state_idx):
        if state_idx not in self.state_to_node_param:
            raise KeyError(f"Invalid state index: {state_idx}")
        return self.state_to_node_param[state_idx]

    def get_state_index(self, node_idx, param):
        if (param, node_idx) not in self.node_param_to_state:
            raise KeyError(f"Invalid node/parameter combination: ({node_idx}, {param})")
        return self.node_param_to_state[(param, node_idx)]

    def get_state_mapping(self):
        return self.state_to_node_param.copy()

    def get_node_param_mapping(self):
        return self.node_param_to_state.copy()

    @property
    def n_pos_states(self) -> int:
        return len(self.state_to_node_param) // 2

    # -- boundary conditions / forces ---------------------------------------

    def _process_boundary_conditions(self) -> Dict[int, BoundaryConditionType]:
        return boundary_conditions_from_dataframe(self.params)

    def _auto_register_forces(self) -> None:
        if self.force_params.enable_fluid_effects:
            fluid_force = FluidDragForce(
                fluid_data=self.params[["wetted_area", "drag_coef"]],
                state_mapping=self.state_to_node_param,
                fluid_density=self.force_params.fluid_density,
                enabled=True,
            )
            self.force_registry.register(fluid_force)

        if self.force_params.enable_gravity_effects:
            gravity_force = GravityForce(
                beam_params=self.params[["density", "cross_area", "length"]],
                gravity_vector=self.force_params.get_gravity_vector(),
                enabled=True,
            )
            self.force_registry.register(gravity_force)

"""Force components and the force / input registries.

Counterpart of ``continuum_robot_tpu/models/forces.py``. The registries and
their aggregation algebra (enabled-check at registration *and* evaluation,
sum of enabled components, zero-vector fallback) are ported on torch
tensors. ``FluidDragForce`` and ``GravityForce`` keep their constructors
and host-side precomputation; evaluating them is not ported yet and raises
``NotImplementedError``. The modal engine refuses registered forces anyway
(exact superposition holds only for the linear beam).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .abstractions import AbstractForce, AbstractInputHandler
from .decorators import zero_force


class FluidDynamicsParams:
    """Legacy fluid parameter container."""

    def __init__(self, fluid_density: float = 0.0, enable_fluid_effects: bool = False):
        self.fluid_density = fluid_density
        self.enable_fluid_effects = enable_fluid_effects

    def __bool__(self) -> bool:
        return self.enable_fluid_effects


class FluidDragForce(AbstractForce):
    """Quadratic transverse drag ``F_w = -1/2 rho C_d A_w v_w |v_w|``.

    The per-node drag factors and the reduced-state gather/scatter indices
    are precomputed on the host. Drag applies only at nodes whose ``w`` and
    ``dw_dt`` both survive constraint reduction, the last node reusing the
    last segment's wetted area and drag coefficient.
    """

    def __init__(self, fluid_data, state_mapping, fluid_density, enabled=True):
        self.fluid_data = fluid_data
        self.state_mapping = state_mapping
        self.fluid_density = fluid_density
        self.enabled = enabled
        self.fluid_coefficients = None
        if self.is_enabled():
            self._precompute_fluid_coefficients()

    def is_enabled(self) -> bool:
        return self.enabled

    def _precompute_fluid_coefficients(self) -> None:
        wetted = np.asarray(self.fluid_data["wetted_area"], dtype=float)
        drag = np.asarray(self.fluid_data["drag_coef"], dtype=float)
        wetted = np.append(wetted, wetted[-1])
        drag = np.append(drag, drag[-1])
        n_nodes = len(wetted)

        node_to_vel = {}
        node_to_pos = {}
        for idx, (param, node) in self.state_mapping.items():
            if param == "dw_dt" and node < n_nodes:
                node_to_vel[node] = idx
            elif param == "w" and node < n_nodes:
                node_to_pos[node] = idx

        vel_idx, pos_idx, factors = [], [], []
        for node in sorted(set(node_to_vel) & set(node_to_pos)):
            vel_idx.append(node_to_vel[node])
            pos_idx.append(node_to_pos[node])
            factors.append(0.5 * self.fluid_density * drag[node] * wetted[node])

        self.fluid_coefficients = {
            "w_vel_indices": np.asarray(vel_idx, dtype=np.int32),
            "w_pos_indices": np.asarray(pos_idx, dtype=np.int32),
            "drag_factors": np.asarray(factors, dtype=float),
            "n_pos_states": len(self.state_mapping) // 2,
        }

    def compute_forces(self, x, t):
        raise NotImplementedError("fluid drag evaluation is not yet ported")


class GravityForce(AbstractForce):
    """Deformation-aware distributed gravity (constructor and segment masses)."""

    def __init__(
        self,
        beam_params,
        gravity_vector: Optional[List[float]] = None,
        enabled: bool = True,
    ):
        self.beam_params = beam_params
        self.gravity_vector = np.array(
            gravity_vector if gravity_vector is not None else [0.0, -9.81, 0.0]
        )
        self.enabled = enabled
        if len(self.gravity_vector) != 3:
            raise ValueError(
                "Gravity vector must have exactly 3 components [gx, gy, gz]"
            )
        self._precompute_segment_masses()

    def _precompute_segment_masses(self):
        if not self.enabled:
            self._segment_masses = []
            return
        self._segment_masses = [
            float(row["density"] * row["cross_area"] * row["length"])
            for _, row in self.beam_params.iterrows()
        ]

    def compute_forces(self, x, t):
        raise NotImplementedError("gravity evaluation is not yet ported")

    def is_enabled(self) -> bool:
        return self.enabled

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = enabled

    def set_gravity_vector(self, gravity_vector: List[float]) -> None:
        if len(gravity_vector) != 3:
            raise ValueError(
                "Gravity vector must have exactly 3 components [gx, gy, gz]"
            )
        self.gravity_vector = np.array(gravity_vector)

    def get_gravity_vector(self) -> np.ndarray:
        return self.gravity_vector.copy()


class ForceRegistry:
    """Runtime-composable force list."""

    def __init__(self):
        self._forces: List[AbstractForce] = []

    def register(self, force_instance: AbstractForce) -> None:
        if force_instance.is_enabled():
            self._forces.append(force_instance)

    def unregister(self, force_instance: AbstractForce) -> bool:
        if force_instance in self._forces:
            self._forces.remove(force_instance)
            return True
        return False

    def clear(self) -> None:
        self._forces.clear()

    def get_registered_forces(self) -> List[AbstractForce]:
        return self._forces.copy()

    def create_aggregated_function(self) -> Callable:
        """Sum of enabled components; zero-vector fallback when empty.

        The enabled-check happens at every evaluation, so disabling a
        registered force takes effect immediately.
        """

        def aggregate_forces(x, t: float = 0.0):
            total = None
            for force in self._forces:
                if force.is_enabled():
                    contrib = torch.as_tensor(force.compute_forces(x, t))
                    total = contrib if total is None else total + contrib
            if total is None:
                return zero_force(x)
            return total

        return aggregate_forces

    def __len__(self) -> int:
        return len(self._forces)

    def __contains__(self, force_instance: AbstractForce) -> bool:
        return force_instance in self._forces


class InputRegistry:
    """Runtime-composable input-handler list."""

    def __init__(self):
        self._input_handlers: List[AbstractInputHandler] = []

    def register(self, input_handler: AbstractInputHandler) -> None:
        if input_handler.is_enabled():
            self._input_handlers.append(input_handler)

    def unregister(self, input_handler: AbstractInputHandler) -> bool:
        if input_handler in self._input_handlers:
            self._input_handlers.remove(input_handler)
            return True
        return False

    def clear(self) -> None:
        self._input_handlers.clear()

    def get_registered_handlers(self) -> List[AbstractInputHandler]:
        return self._input_handlers.copy()

    def create_aggregated_function(self) -> Callable:
        """``u + sum(handler deltas)``."""

        def aggregate_input_processing(x, u, t: float = 0.0):
            total = torch.as_tensor(u)
            for handler in self._input_handlers:
                if handler.is_enabled():
                    total = total + torch.as_tensor(handler.compute_input(x, u, t))
            return total

        return aggregate_input_processing

    def __len__(self) -> int:
        return len(self._input_handlers)

    def __contains__(self, input_handler: AbstractInputHandler) -> bool:
        return input_handler in self._input_handlers

"""Euler-Bernoulli beam facade over the batched element matrices.

Counterpart of ``continuum_robot_tpu/models/euler_bernoulli_beam.py``:
construction from CSV/DataFrame, global mass assembly (``scipy.sparse`` on
the host), the global internal-force function (linear, nonlinear and hybrid
elements), FIXED/PINNED boundary conditions with DOF removal, the
bidirectional DOF mapping, and the dense linear stiffness matrix. Host
setup runs in NumPy float64.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Dict, List, Union

import numpy as np
import pandas as pd
import torch
from scipy import sparse

from . import assembly
from .abstractions import (
    BoundaryConditionType,
    ElementType,
    IBeam,
    validate_beam_dataframe,
)
from .config import BCInfo, beam_arrays_from_dataframe, load_beam_dataframe, make_bc_info
from .segments import segments_from_dataframe


def _state(x):
    """Tensors pass through; anything else becomes a float64 NumPy array."""
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x, np.float64)


class EulerBernoulliBeam(IBeam):
    """Hybrid linear/nonlinear beam with the reference-compatible API."""

    def __init__(
        self,
        parameters: Union[str, pathlib.Path, pd.DataFrame],
        use_consistent_nonlinear: bool = False,
    ):
        """Initialize from CSV path or DataFrame.

        Args:
            parameters: path or DataFrame with columns ``length,
                elastic_modulus, moment_inertia, density, cross_area, type``.
            use_consistent_nonlinear: select the variationally consistent
                (energy-gradient) nonlinear element for the nonlinear
                segments (``assembly.internal_force_full(...,
                use_consistent=True)``; its symmetric tangent puts the ROM
                on the ``eigh`` branch).
        """
        self.parameters = load_beam_dataframe(parameters)
        validate_beam_dataframe(self.parameters)

        self.use_consistent_nonlinear = use_consistent_nonlinear
        self.arrays = beam_arrays_from_dataframe(self.parameters)
        self.segments = segments_from_dataframe(self.parameters)
        super().__init__(self.segments)

        self.M = None
        self.stiffness_func = None

        self._initialize_dof_mapping()

        self._boundary_conditions: Dict[int, BoundaryConditionType] = {}
        self._boundary_conditions_applied = False
        self._constrained_dofs: set = set()
        self._bc_info: BCInfo = make_bc_info(self.n_elements, {})

        self.assemble_mass_matrix()
        self.stiffness_func = self.create_stiffness_function()

    # -- basic geometry ----------------------------------------------------

    @property
    def n_elements(self) -> int:
        return len(self.parameters)

    @property
    def n_nodes(self) -> int:
        return self.n_elements + 1

    @property
    def n_dofs_full(self) -> int:
        return 3 * self.n_nodes

    # -- DOF mapping -------------------------------------------------------

    def _initialize_dof_mapping(self):
        self.dof_to_node_param = {}
        self.node_param_to_dof = {}
        for node in range(self.n_nodes):
            for off, param in enumerate(("u", "w", "phi")):
                self.dof_to_node_param[3 * node + off] = (param, node)
                self.node_param_to_dof[(param, node)] = 3 * node + off
        self._original_dof_to_node_param = self.dof_to_node_param.copy()
        self._original_node_param_to_dof = self.node_param_to_dof.copy()

    def _update_dof_mapping(self):
        if not self._boundary_conditions_applied:
            return
        new_d2np, new_np2d = {}, {}
        for new_idx, old_idx in enumerate(self._bc_info.free_dofs):
            param_node = self._original_dof_to_node_param[int(old_idx)]
            new_d2np[new_idx] = param_node
            new_np2d[param_node] = new_idx
        self.dof_to_node_param = new_d2np
        self.node_param_to_dof = new_np2d

    def get_dof_to_node_param(self, dof_idx: int):
        if dof_idx not in self.dof_to_node_param:
            raise KeyError(f"Invalid DOF index: {dof_idx}")
        return self.dof_to_node_param[dof_idx]

    def get_dof_index(self, node_idx: int, param: str):
        if (param, node_idx) not in self.node_param_to_dof:
            raise KeyError(f"Invalid node/parameter combination: ({node_idx}, {param})")
        return self.node_param_to_dof[(param, node_idx)]

    # -- assembly ----------------------------------------------------------

    def assemble_mass_matrix(self):
        """Assemble the global consistent mass matrix (sparse CSR, host)."""
        self.M = sparse.csr_matrix(assembly.dense_mass_matrix(self.arrays))
        return self.M

    def create_stiffness_function(self) -> Callable:
        """Global stiffness function ``q -> k(q)`` in full coordinates.

        NumPy in, NumPy out (host float64); a tensor gives a tensor on its
        own device and dtype.
        """
        arrays = self.arrays
        use_consistent = self.use_consistent_nonlinear

        def global_stiffness_function(x):
            return assembly.internal_force_full(
                arrays, _state(x), use_consistent=use_consistent
            )

        return global_stiffness_function

    # -- boundary conditions -------------------------------------------------

    def apply_boundary_conditions(
        self, conditions: Dict[int, BoundaryConditionType]
    ) -> None:
        if self.M is None or self.stiffness_func is None:
            raise RuntimeError(
                "Matrices must be created before applying boundary conditions"
            )

        merged = dict(self._boundary_conditions)
        for node_idx, bc_type in conditions.items():
            if bc_type not in (
                BoundaryConditionType.FIXED,
                BoundaryConditionType.PINNED,
            ):
                raise ValueError(f"Unsupported boundary condition type: {bc_type}")
            merged[node_idx] = bc_type

        bc_info = make_bc_info(self.n_elements, merged)  # validates node range

        self._boundary_conditions = merged
        self._bc_info = bc_info
        self._constrained_dofs = set(bc_info.constrained_dofs)
        self._unconstrained_dofs = list(map(int, bc_info.free_dofs))
        self._boundary_conditions_applied = True

        full_M = assembly.dense_mass_matrix(self.arrays)
        self.M = sparse.csr_matrix(assembly.reduce_matrix(full_M, bc_info.free_dofs))
        k_red = assembly.make_reduced_internal_force(
            self.arrays,
            bc_info.free_dofs,
            self.n_dofs_full,
            use_consistent=self.use_consistent_nonlinear,
        )

        def stiffness_with_boundary(x_reduced):
            return k_red(_state(x_reduced))

        self.stiffness_func = stiffness_with_boundary
        self._update_dof_mapping()

    def clear_boundary_conditions(self) -> None:
        if self.M is None or self.stiffness_func is None:
            raise RuntimeError(
                "Matrices must be created before clearing boundary conditions"
            )
        self.assemble_mass_matrix()
        self.stiffness_func = self.create_stiffness_function()
        self._boundary_conditions = {}
        self._constrained_dofs = set()
        self._bc_info = make_bc_info(self.n_elements, {})
        self._boundary_conditions_applied = False
        self.dof_to_node_param = self._original_dof_to_node_param.copy()
        self.node_param_to_dof = self._original_node_param_to_dof.copy()

    def get_boundary_conditions(self) -> Dict[int, BoundaryConditionType]:
        return self._boundary_conditions.copy()

    def has_boundary_conditions(self) -> bool:
        return self._boundary_conditions_applied

    def get_constrained_dofs(self) -> List[int]:
        return list(self._constrained_dofs)

    @property
    def bc_info(self) -> BCInfo:
        """Boundary-condition bookkeeping (free DOFs)."""
        return self._bc_info

    # -- accessors ---------------------------------------------------------

    def get_mass_matrix(self) -> np.ndarray:
        if self.M is None:
            raise RuntimeError("Mass matrix not yet created")
        return self.M.toarray()

    def get_stiffness_function(self) -> Callable:
        if self.stiffness_func is None:
            raise RuntimeError("Stiffness function not yet created")
        return self.stiffness_func

    def get_length(self) -> float:
        return float(self.parameters["length"].sum())

    def get_segment_count(self) -> int:
        return self.n_elements

    def get_segment_types(self) -> List[ElementType]:
        return [
            ElementType.NONLINEAR if bool(m) else ElementType.LINEAR
            for m in np.asarray(self.arrays.nonlinear_mask)
        ]

    def is_hybrid(self) -> bool:
        return len(set(self.get_segment_types())) > 1

    # -- linear-only stiffness matrix ----------------------------------------

    def get_stiffness_matrix(self) -> np.ndarray:
        """Dense global K for purely linear beams (with BC reduction)."""
        if self.M is None:
            raise RuntimeError(
                "Mass matrix must be assembled before extracting stiffness matrix"
            )
        types = self.get_segment_types()
        for i, t in enumerate(types):
            if t != ElementType.LINEAR:
                raise ValueError(
                    f"Cannot extract stiffness matrix from beam with nonlinear segments. "
                    f"Segment {i} is {t.value}. "
                    "Stiffness matrix is only valid for purely linear beams."
                )
        full = assembly.dense_linear_stiffness_matrix(self.arrays)
        if self._boundary_conditions_applied:
            return assembly.reduce_matrix(full, self._bc_info.free_dofs)
        return full

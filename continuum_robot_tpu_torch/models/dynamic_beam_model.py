"""Dynamic beam model facade: CSV/DataFrame -> validated beam + force registry.

Counterpart of ``continuum_robot_tpu/models/dynamic_beam_model.py``:
construction from a CSV path or DataFrame with the boundary-condition
column, parameter validation (including the conditional fluid columns) and
its ``ValueError`` contracts, the state mapping with ``d*_dt`` velocity
parameters, force auto-registration from :class:`ForceParams`, and the ODE
right-hand side: ``create_system_func`` / ``create_input_func`` /
``get_dynamic_system`` (the reference-style API with its input checks) and
``build_rhs`` (the batched ``rhs(t, x, u)`` the explicit and adaptive
integrators step; ``models/dynamics.py``).

There is no JIT: the system function evaluates the force registry's
aggregate at every call, so enabling or disabling a force takes effect
immediately, as the JAX package's per-enabled-set compile cache arranges.
The RHS's internal force is the element force's exact cubic
(:func:`assembly.make_polynomial_internal_force`) for beams of up to
:data:`POLY_MAX_ELEMENTS` elements, the elementwise planes beyond; NumPy
states go to the device the system was created for (``device``; None:
the card).
"""

from __future__ import annotations

import pathlib
from typing import Callable, Dict, Union

import numpy as np
import pandas as pd
import torch

from . import assembly, dynamics
from .abstractions import (
    BoundaryConditionType,
    ElementType,
    boundary_conditions_from_dataframe,
)
from .config import ForceParams
from .euler_bernoulli_beam import EulerBernoulliBeam
from .forces import FluidDragForce, ForceRegistry, GravityForce, InputRegistry

# Largest beam whose RHS evaluates the polynomial contraction. On the H100
# it beat the element planes at every size measured, 6 to 24 von Karman
# elements at 1 and 4096 envs (4.9-11.2 against 20.2-26.8 ms a Dopri5
# trial; chip_compare.py --sections adaptive); its temporaries grow as
# envs x DOFs x monomials (72 x 748 float64, 431 KB an env, at 24).
POLY_MAX_ELEMENTS = 24


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

        self._mass_inverse = None  # (apply, host M^-1), built on first use
        self._k_red_fn = None
        self.system_func = None
        self.input_func = None

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

    # -- system construction (JAX package dynamic_beam_model.py:204-323) ------

    @property
    def M_inv(self) -> np.ndarray:
        """The reduced-mass inverse, host float64 (computed on first use)."""
        return self._mass_inverse_pair()[1]

    def _mass_inverse_pair(self):
        if self._mass_inverse is None:
            self._mass_inverse = dynamics.make_mass_inverse_apply(
                self.beam_model.M.toarray())
        return self._mass_inverse

    def _m_inv_apply(self, f):
        return self._mass_inverse_pair()[0](f)

    def _internal_force(self) -> Callable:
        """Reduced internal force ``k(q)``, built on the first call.

        Called when the system or the RHS is built, never from inside the
        RHS: the polynomial table comes from nested ``torch.func.jacfwd``
        calls read back to NumPy, which fail under a caller's transform
        (``jacfwd`` of a step of a model whose RHS has not run yet).
        """
        if self._k_red_fn is None:
            bm = self.beam_model
            free, cons = bm.bc_info.free_dofs, self.use_consistent_nonlinear
            if len(bm.arrays.length) <= POLY_MAX_ELEMENTS:
                self._k_red_fn = assembly.make_polynomial_internal_force(
                    bm.arrays, free, use_consistent=cons)
            else:
                self._k_red_fn = assembly.make_reduced_internal_force(
                    bm.arrays, free, bm.n_dofs_full, use_consistent=cons)
        return self._k_red_fn

    @staticmethod
    def _as_state(x, device):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), device=device)

    def create_system_func(self, forces_func: Callable = None, jit_compile: bool = True,
                           device=None) -> None:
        """Create the autonomous dynamics ``system(x, t=0.0) -> dx/dt``.

        ``forces_func(x, t)`` defaults to the registry aggregate, which
        checks each force's enabled flag at every call. ``jit_compile`` is
        accepted for the JAX signature; nothing is compiled. A NumPy ``x``
        goes to ``device`` (None: the card); a tensor keeps its own.
        """
        del jit_compile
        from .simulate import resolve_device

        device = resolve_device(device)
        if forces_func is None:
            forces_func = self.force_registry.create_aggregated_function()
        base = dynamics.build_system_fn(self._internal_force(), self._m_inv_apply,
                                       forces_func)

        def system(x, t=0.0):
            return base(self._as_state(x, device), t)

        self.system_func = system

    def create_input_func(self, device=None) -> None:
        """Create ``input_func(x, u, t) -> [0; M^-1 u]`` with validation.

        Dimension contracts match the reference (``dynamic_beam_model.py:294-328``):
        ``x`` and ``u`` NumPy arrays or tensors, 1-D, ``len(u)`` the
        position DOFs. NumPy inputs go to ``device`` (None: the card).
        """
        from .simulate import resolve_device

        device = resolve_device(device)
        core = dynamics.build_input_fn(self._m_inv_apply)

        def input_function(x, u, t: float = 0.0):
            if not isinstance(x, (np.ndarray, torch.Tensor)) or not isinstance(
                u, (np.ndarray, torch.Tensor)
            ):
                raise ValueError("State and input must be numpy arrays")
            if x.ndim != 1 or u.ndim != 1:
                raise ValueError("State and input must be 1D arrays")
            n = x.shape[-1] // 2
            if u.shape[-1] != n:
                raise ValueError(
                    f"Input vector length {u.shape[-1]} must match position DOFs {n}. "
                    f"Expected {n}, got {u.shape[-1]}"
                )
            x_t = self._as_state(x, device)
            return core(x_t, self._as_state(u, x_t.device), t)

        self.input_func = input_function

    def get_system_func(self) -> Callable:
        if self.system_func is None:
            raise RuntimeError("System function not yet created")
        return self.system_func

    def get_dynamic_system(self) -> Callable:
        """Complete ``(t, x, u) -> dx/dt`` (u: vector or callable of t)."""
        if self.system_func is None or self.input_func is None:
            raise RuntimeError("System and input functions must be created first")

        def dynamic_system(t, x, u):
            force = u(t) if callable(u) else u
            return self.system_func(x, t) + self.input_func(x, force, t)

        return dynamic_system

    def build_rhs(self, forces_func: Callable = None) -> Callable:
        """Batched ``rhs(t, x, u)`` for the integrators.

        No input checks; broadcasts over leading batch axes and runs on the
        state tensor's device and dtype. ``forces_func`` defaults to the
        registry aggregate.
        """
        if forces_func is None:
            forces_func = self.force_registry.create_aggregated_function()
        system = dynamics.build_system_fn(self._internal_force(), self._m_inv_apply,
                                         forces_func)
        input_fn = dynamics.build_input_fn(self._m_inv_apply)
        return dynamics.build_rhs(system, input_fn)

"""Force components and the force / input registries.

Counterpart of ``continuum_robot_tpu/models/forces.py``. The registries and
their aggregation algebra (enabled-check at registration *and* evaluation,
sum of enabled components, zero-vector fallback) are ported on torch
tensors. ``FluidDragForce`` and ``GravityForce`` precompute their index
plans on the host and evaluate as plain torch on the state's device and
dtype, batched over any leading axes, keeping the reference quirks of the
JAX package (gravity's reduced-index plan, drag only where ``w`` and
``dw_dt`` survive reduction; PARITY.md). The modal engine refuses
registered forces (exact superposition holds only for the linear beam);
the implicit integrators take them through the registry aggregate, and the
modal ROM through each force's reduced closure (``make_reduced_modal``:
the force projected onto the ROM bases from their restricted rows).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .abstractions import AbstractForce, AbstractInputHandler
from .decorators import zero_force


def _rows_on(*arrays):
    """``like -> tuple of tensors``: host float64 ``arrays`` on ``like``'s
    device and dtype, uploaded once per device and dtype."""
    uploads = {}

    def get(like):
        key = (like.device, like.dtype)
        if key not in uploads:
            uploads[key] = tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                                 for a in arrays)
        return uploads[key]

    return get


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
        self._plan_cache = {}
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
        """``-factors * v_w * |v_w|`` scattered to the ``w`` positions, over
        the position DOFs of ``x`` (``(..., 2n)``)."""
        x = torch.as_tensor(x)
        n_pos = x.shape[-1] // 2
        out = x.new_zeros(*x.shape[:-1], n_pos)
        if not self.is_enabled() or self.fluid_coefficients is None:
            return out
        vel, pos, factors = self._device_plan(x)
        v = x[..., vel]
        out[..., pos] = -factors * v * v.abs()
        return out

    def _device_plan(self, like):
        """The gather/scatter indices and drag factors on ``like``'s device
        (factors in its dtype), uploaded once per device and dtype."""
        key = (like.device, like.dtype)
        if key not in self._plan_cache:
            c = self.fluid_coefficients
            self._plan_cache[key] = (
                torch.as_tensor(c["w_vel_indices"], dtype=torch.long, device=like.device),
                torch.as_tensor(c["w_pos_indices"], dtype=torch.long, device=like.device),
                torch.as_tensor(c["drag_factors"], dtype=like.dtype, device=like.device),
            )
        return self._plan_cache[key]

    def make_reduced_modal(self, Phi, PhiW):
        """Reduced-basis drag closure for the modal ROM's split path.

        Drag reads velocities at the wetted ``w`` rows and writes forces at
        the same nodes' ``w`` rows, so its modal projection is ``W_out^T
        d(Phi_v etad)`` with ``Phi_v``/``W_out`` the wetted rows of the
        bases (built once on the host in float64): equal to ``PhiW^T
        compute_forces(x, t)`` at ``x = [Phi eta; Phi etad]``.

        Returns ``(eta, etad, t, precision=None) -> (..., m)`` on the
        tensors' device and dtype (``precision`` is accepted and unused:
        the products are true float32 or float64), or None when the basis
        does not match this force's state mapping. Enablement is read at
        each call.
        """
        if self.fluid_coefficients is None:
            return None
        c = self.fluid_coefficients
        Phi = np.asarray(Phi, np.float64)
        PhiW = np.asarray(PhiW, np.float64)
        if Phi.shape[0] != c["n_pos_states"]:
            return None
        m = Phi.shape[1]
        vel_rows = np.asarray(c["w_vel_indices"], np.int64) - c["n_pos_states"]
        if vel_rows.size == 0:
            return lambda eta, etad, t, precision=None: eta.new_zeros(*eta.shape[:-1], m)
        rows = _rows_on(
            np.ascontiguousarray(Phi[vel_rows]),  # Phi_v (k, m)
            np.ascontiguousarray(PhiW[np.asarray(c["w_pos_indices"])]),  # W_out (k, m)
            np.asarray(c["drag_factors"], np.float64),
        )

        def reduced(eta, etad, t, precision=None):
            if not self.is_enabled():
                return etad.new_zeros(*eta.shape[:-1], m)
            Pv, Wo, factors = rows(etad)
            v = etad @ Pv.T
            return (-factors * v * v.abs()) @ Wo

        return reduced


class GravityForce(AbstractForce):
    """Deformation-aware distributed gravity.

    Per segment: rotate the global ``(gx, gy)`` by the segment's average
    nodal rotation into local axial/transverse components, then split half
    the segment weight onto each end node's ``u``/``w`` DOFs, vectorized
    over segments with a precomputed (per reduced-state size) index plan.
    """

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
        self._index_cache = {}
        self._plan_cache = {}

    def _precompute_segment_masses(self):
        if not self.enabled:
            self._segment_masses = []
            return
        self._segment_masses = [
            float(row["density"] * row["cross_area"] * row["length"])
            for _, row in self.beam_params.iterrows()
        ]

    def _indices_for(self, n_pos: int):
        """Static reduced-coordinate index plan for a given state size.

        Replicates the reference's bounds-checked reduced indexing (the JAX
        package's ``GravityForce._indices_for``): segment ``i`` reads
        rotations at ``3i+2``/``3(i+1)+2`` and loads ``3i``, ``3i+1``,
        ``3(i+1)``, ``3(i+1)+1``, each only where it is below ``n_pos``.
        """
        if n_pos in self._index_cache:
            return self._index_cache[n_pos]
        n_seg = len(self._segment_masses)

        phi_a = np.zeros(n_seg, dtype=np.int64)
        phi_b = np.zeros(n_seg, dtype=np.int64)
        wa = np.zeros(n_seg)
        wb = np.zeros(n_seg)
        for i in range(n_seg):
            s_idx, e_idx = 3 * i + 2, 3 * (i + 1) + 2
            s_ok, e_ok = s_idx < n_pos, e_idx < n_pos
            if s_ok and e_ok:
                phi_a[i], phi_b[i], wa[i], wb[i] = s_idx, e_idx, 0.5, 0.5
            elif s_ok:
                phi_a[i], wa[i] = s_idx, 1.0
            elif e_ok:
                phi_b[i], wb[i] = e_idx, 1.0
            # else both weights stay 0 -> phi_avg = 0

        seg_ids, targets, comps = [], [], []
        for i in range(n_seg):
            for tgt, comp in ((3 * i, 0), (3 * i + 1, 1), (3 * (i + 1), 0),
                              (3 * (i + 1) + 1, 1)):
                if tgt < n_pos:
                    seg_ids.append(i)
                    targets.append(tgt)
                    comps.append(comp)

        plan = {
            "phi_a": phi_a,
            "phi_b": phi_b,
            "wa": wa,
            "wb": wb,
            "seg_ids": np.asarray(seg_ids, dtype=np.int64),
            "targets": np.asarray(targets, dtype=np.int64),
            "axial_sel": np.asarray(comps, dtype=np.int64) == 0,
            "masses": np.asarray(self._segment_masses),
        }
        self._index_cache[n_pos] = plan
        return plan

    def _device_plan(self, n_pos: int, like):
        """:meth:`_indices_for` as tensors on ``like``'s device (weights and
        masses in its dtype), uploaded once per size, device and dtype."""
        key = (n_pos, like.device, like.dtype)
        if key not in self._plan_cache:
            plan = self._indices_for(n_pos)
            floats = ("wa", "wb", "masses")
            self._plan_cache[key] = {
                k: torch.as_tensor(v, dtype=like.dtype if k in floats else None,
                                   device=like.device)
                for k, v in plan.items()
            }
        return self._plan_cache[key]

    def compute_forces(self, x, t):
        """Per segment: rotate ``(gx, gy)`` by the averaged nodal rotation
        into axial and transverse components and put half the segment
        weight on each end node's ``u``/``w`` rows (scatter-add)."""
        x = torch.as_tensor(x)
        n_pos = x.shape[-1] // 2
        if not self._segment_masses:
            raise RuntimeError(
                "Cannot compute gravity forces: beam instance does not have "
                "segments available or segment masses were not pre-computed."
            )
        plan = self._device_plan(n_pos, x)
        positions = x[..., :n_pos]
        gx, gy = float(self.gravity_vector[0]), float(self.gravity_vector[1])

        phi_avg = (plan["wa"] * positions[..., plan["phi_a"]]
                   + plan["wb"] * positions[..., plan["phi_b"]])
        cos_phi = torch.cos(phi_avg)
        sin_phi = torch.sin(phi_avg)
        masses = plan["masses"]
        f_axial = (cos_phi * gx + sin_phi * gy) * masses * 0.5
        f_trans = (-sin_phi * gx + cos_phi * gy) * masses * 0.5

        vals = torch.where(plan["axial_sel"], f_axial[..., plan["seg_ids"]],
                           f_trans[..., plan["seg_ids"]])
        out = x.new_zeros(*x.shape[:-1], n_pos)
        return out.index_add_(-1, plan["targets"], vals)

    def make_reduced_modal(self, Phi, PhiW):
        """Reduced-basis gravity closure for the modal ROM's split path.

        The averaged rotation of a segment is linear in ``q``, so
        ``phi_avg = G_in eta`` with ``G_in`` the weighted ``phi_a``/``phi_b``
        rows of ``Phi``; the test-basis rows grouped by segment fold the
        scatter into ``WA^T f_axial + WT^T f_trans``. Built once on the host
        in float64 from :meth:`_indices_for`'s plan, so the reference's
        reduced-index quirk carries over: equal to ``PhiW^T
        compute_forces(x, t)``.

        Returns ``(eta, etad, t, precision=None) -> (..., m)``, or None
        without segment masses. The gravity vector and enablement are read
        at each call.
        """
        if not self._segment_masses:
            return None
        Phi = np.asarray(Phi, np.float64)
        PhiW = np.asarray(PhiW, np.float64)
        plan = self._indices_for(Phi.shape[0])
        G_in = (plan["wa"][:, None] * Phi[plan["phi_a"]]
                + plan["wb"][:, None] * Phi[plan["phi_b"]])  # (n_seg, m)
        n_seg, m = len(self._segment_masses), Phi.shape[1]
        WA = np.zeros((n_seg, m))
        WT = np.zeros((n_seg, m))
        ax = np.asarray(plan["axial_sel"])
        np.add.at(WA, plan["seg_ids"][ax], PhiW[plan["targets"][ax]])
        np.add.at(WT, plan["seg_ids"][~ax], PhiW[plan["targets"][~ax]])
        rows = _rows_on(G_in, WA, WT, np.asarray(plan["masses"], np.float64))

        def reduced(eta, etad, t, precision=None):
            if not self.is_enabled():
                return eta.new_zeros(*eta.shape[:-1], m)
            gx, gy = float(self.gravity_vector[0]), float(self.gravity_vector[1])
            Gi, WAt, WTt, mass = rows(eta)
            phi_avg = eta @ Gi.T
            cos_phi = torch.cos(phi_avg)
            sin_phi = torch.sin(phi_avg)
            f_ax = (cos_phi * gx + sin_phi * gy) * mass * 0.5
            f_tr = (-sin_phi * gx + cos_phi * gy) * mass * 0.5
            return f_ax @ WAt + f_tr @ WTt

        return reduced

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

"""Per-run metrics: energies, tip trajectory, drift diagnostics.

Counterpart of ``continuum_robot_tpu/utils/metrics.py``. The physical
diagnostics are reductions on tensors, on the rollout's device:

* kinetic energy ``1/2 v^T M v`` via the block-tridiagonal mass matvec,
* strain energy via the *consistent* element energy (defined even for a
  rollout of the reference-parity element, which is not variational: for
  that element "energy drift" is a diagnostic, not a conservation law),
* the tip trajectory with the reference's ``sol.y[n_pos+1::3]`` convention
  (``example_utilities.py:196``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import assembly, elements
from ..ops import banded


def make_energy_fns(model):
    """``kinetic(v_red)`` and ``strain(q_red)`` on tensors (any leading
    axes; the operators go to the argument's device and dtype on first
    use there)."""
    arrays = model.beam_model.arrays
    bc = model.beam_model.bc_info
    free = bc.free_dofs
    n_full = bc.n_dofs_full
    n_nodes = bc.n_nodes
    mask_nodes = bc.free_mask.reshape(n_nodes, 3)

    m_diag, m_off = assembly.mass_block_tridiagonal(arrays)
    m_lower = np.swapaxes(np.asarray(m_off), -1, -2)
    host = dict(zip(("md", "ml", "mu"), banded.btd_apply_bc(
        np.asarray(m_diag), m_lower, np.asarray(m_off), mask_nodes)))
    # Linear elements carry the quadratic energy 1/2 q^T K q: the von
    # Karman energy would report spurious "drift" of the order of the
    # neglected cubic terms.
    host["Ke"] = elements.linear_stiffness_matrix(
        arrays.length, arrays.elastic_modulus, arrays.moment_inertia, arrays.cross_area)
    host["nl"] = np.asarray(arrays.nonlinear_mask, bool)
    host.update(L=arrays.length, E=arrays.elastic_modulus, I=arrays.moment_inertia,
                A=arrays.cross_area)
    uploads = {}

    def consts(x):
        key = (x.device, x.dtype)
        if key not in uploads:
            uploads[key] = {
                k: torch.as_tensor(np.asarray(v), device=x.device,
                                   dtype=torch.bool if np.asarray(v).dtype == bool else x.dtype)
                for k, v in host.items()}
        return uploads[key]

    def kinetic(v_red):
        c = consts(v_red)
        v_nodes = assembly.pad_to_full(v_red, free, n_full).reshape(
            *v_red.shape[:-1], n_nodes, 3
        )
        mv = banded.btd_matvec(c["md"], c["ml"], c["mu"], v_nodes)
        return 0.5 * torch.sum(mv * v_nodes, dim=(-1, -2))

    def strain(q_red):
        c = consts(q_red)
        q_full = assembly.pad_to_full(q_red, free, n_full)
        q6 = assembly.gather_element_states(q_full)
        e_nl = elements.element_strain_energy(q6, c["L"], c["E"], c["I"], c["A"])
        e_lin = 0.5 * torch.einsum("...ei,eij,...ej->...e", q6, c["Ke"], q6)
        e = torch.where(c["nl"], e_nl, e_lin)
        return torch.sum(e, dim=-1)

    return kinetic, strain


def run_metrics(model, result) -> Dict[str, float]:
    """Summary metrics of a :class:`SimulationResult`, computed on the
    device of its ``ys`` and read back as Python numbers."""
    ys = result.ys
    if not isinstance(ys, torch.Tensor):
        ys = torch.as_tensor(np.asarray(ys))
    n = ys.shape[-1] // 2
    kinetic, strain = make_energy_fns(model)
    total = kinetic(ys[..., n:]) + strain(ys[..., :n])
    tip = ys[..., n - 2]
    out = {
        "tip_final": float(tip[-1:].reshape(-1)[0]),
        "tip_abs_max": float(tip.abs().max()),
        "energy_initial": float(total.reshape(-1)[0]),
        "energy_final": float(total[-1:].reshape(-1)[0]),
        "energy_max": float(total.max()),
        "n_frames": int(ys.shape[0]),
        "finite": bool(torch.isfinite(ys).all()),
    }
    e0 = max(abs(out["energy_max"]), 1e-300)
    out["energy_drift_rel"] = (out["energy_final"] - out["energy_initial"]) / e0
    return out


def tip_trajectory(result):
    """Tip transverse displacement over time (the reference's extraction),
    as host arrays ``(ts, tip)``."""
    ys = result.ys
    ys = ys.detach().cpu().numpy() if isinstance(ys, torch.Tensor) else np.asarray(ys)
    ts = result.ts
    ts = ts.detach().cpu().numpy() if isinstance(ts, torch.Tensor) else np.asarray(ts)
    n = ys.shape[-1] // 2
    return ts, ys[..., n - 2]

"""Numerical-health guards: NaN and divergence detection inside rollouts.

Counterpart of ``continuum_robot_tpu/utils/checks.py``. The reference has no
failure detection (a diverging simulation returns garbage); here health is
tracked as data, on the device, with no host read a step:

* :func:`divergence_flags`: per-env boolean health folded through a
  rollout; once an env trips (non-finite or out-of-bound state) it stays
  flagged and its state stops updating (freeze semantics), so one bad env
  cannot poison a 4096-env batch.
* :func:`guard_rhs`: wraps an ``rhs`` so non-finite outputs become zeros.
* :func:`verify_batch_consistency`: a batched step against the same step
  per env.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class HealthState(NamedTuple):
    diverged: torch.Tensor  # bool, per leading batch shape
    max_abs: torch.Tensor  # running max |state| (diagnostic)


def init_health(x: torch.Tensor, batch_shape=()) -> HealthState:
    return HealthState(
        diverged=torch.zeros(batch_shape, dtype=torch.bool, device=x.device),
        max_abs=torch.zeros(batch_shape, dtype=x.dtype, device=x.device),
    )


def divergence_flags(x: torch.Tensor, limit: float = 1e3) -> torch.Tensor:
    """Per-env divergence indicator: non-finite or |state| beyond ``limit``."""
    bad = ~torch.all(torch.isfinite(x), dim=-1)
    big = torch.amax(x.abs(), dim=-1) > limit
    return bad | big


def step_with_guard(step_fn: Callable, limit: float = 1e3) -> Callable:
    """Wrap ``x -> x_next`` so diverged envs freeze instead of spreading NaN."""

    def guarded(x, health: HealthState):
        x_next = step_fn(x)
        newly_bad = divergence_flags(x_next, limit)
        diverged = health.diverged | newly_bad
        keep = diverged[..., None] if x.dim() > diverged.dim() else diverged
        x_out = torch.where(keep, x, x_next)
        max_abs = torch.maximum(health.max_abs, torch.amax(x_out.abs(), dim=-1))
        return x_out, HealthState(diverged=diverged, max_abs=max_abs)

    return guarded


def verify_batch_consistency(
    step_fn: Callable, x_batch, rtol: float = 1e-4, n_check: int = 2
) -> float:
    """Cross-check a batched step against per-env execution of the same fn.

    Returns the max relative deviation; raises RuntimeError above ``rtol``.
    Run once after building a new rollout configuration on a new device.
    """
    x_batch = x_batch if isinstance(x_batch, torch.Tensor) else torch.as_tensor(
        np.asarray(x_batch))
    out_b = step_fn(x_batch)
    worst = 0.0
    idx = np.linspace(0, x_batch.shape[0] - 1, min(n_check, x_batch.shape[0]))
    for k in idx.astype(int):
        out_k = step_fn(x_batch[k])
        scale = float(out_k.abs().max()) or 1.0
        dev = float((out_b[k] - out_k).abs().max()) / scale
        worst = max(worst, dev)
    if worst > rtol:
        raise RuntimeError(
            f"Batched execution deviates from per-env by {worst:.3e} "
            f"(> {rtol:.1e}): a library product may pick its summation order "
            "(its kernel, split-K, tiling) by the batch size; keep small dense "
            "products batch-invariant (models/dynamics.dense_apply row sums) "
            "or widen rtol to the roundoff such an order change costs."
        )
    return worst


def guard_rhs(rhs: Callable) -> Callable:
    """Zero out non-finite RHS outputs (keeps integrators from exploding)."""

    def guarded(t, x, u=None):
        dx = rhs(t, x, u)
        return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

    return guarded

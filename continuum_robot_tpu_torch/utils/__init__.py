"""Utilities: timing on the card, numerical guards, checkpoints, metrics
(``utils.metrics``) and modal analysis (``utils.modal``)."""

from .checks import (
    HealthState,
    divergence_flags,
    guard_rhs,
    init_health,
    step_with_guard,
    verify_batch_consistency,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .profiling import cuda_event_times, force_completion

__all__ = [
    "HealthState",
    "cuda_event_times",
    "divergence_flags",
    "force_completion",
    "guard_rhs",
    "init_health",
    "load_checkpoint",
    "save_checkpoint",
    "step_with_guard",
    "verify_batch_consistency",
]

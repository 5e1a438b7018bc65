"""Utilities: timing and tracing on the card, numerical guards,
checkpoints, metrics (``utils.metrics``), modal analysis (``utils.modal``)
and measured ceilings and utilization (``utils.roofline``)."""

from .checks import (
    HealthState,
    divergence_flags,
    guard_rhs,
    init_health,
    step_with_guard,
    verify_batch_consistency,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .profiling import (
    StepMeter,
    compile_time_breakdown,
    cuda_event_times,
    force_completion,
    trace,
)

__all__ = [
    "HealthState",
    "StepMeter",
    "compile_time_breakdown",
    "cuda_event_times",
    "divergence_flags",
    "force_completion",
    "guard_rhs",
    "init_health",
    "load_checkpoint",
    "save_checkpoint",
    "step_with_guard",
    "trace",
    "verify_batch_consistency",
]

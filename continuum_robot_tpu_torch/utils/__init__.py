"""Utilities: completion and timing on the card."""

from .profiling import cuda_event_times, force_completion

__all__ = ["cuda_event_times", "force_completion"]

"""Decorator-based force/input composition API.

Counterpart of ``continuum_robot_tpu/models/decorators.py``:
``force_component`` / ``input_component`` class decorators plus the free
aggregation helpers, on torch tensors. The registry API
(``models/forces.py``) is the primary path.
"""

from __future__ import annotations

from functools import wraps
from typing import Callable, List

import torch

from .abstractions import AbstractForce, AbstractInputHandler


def force_component(*force_classes: AbstractForce):
    """Attach force component classes to a ``create_system_func`` method."""

    def decorator(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(self, *args, **kwargs):
            if not hasattr(self, "_force_components"):
                self._force_components = []
            for force_class in force_classes:
                if hasattr(force_class, "__call__"):
                    force_instance = force_class(self)
                    if force_instance.is_enabled():
                        self._force_components.append(force_instance)
            return func(self, *args, **kwargs)

        return wrapper

    return decorator


def input_component(*input_classes: AbstractInputHandler):
    """Attach input handler classes to a ``create_input_func`` method."""

    def decorator(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(self, *args, **kwargs):
            if not hasattr(self, "_input_components"):
                self._input_components = []
            for input_class in input_classes:
                if hasattr(input_class, "__call__"):
                    input_instance = input_class(self)
                    if input_instance.is_enabled():
                        self._input_components.append(input_instance)
            return func(self, *args, **kwargs)

        return wrapper

    return decorator


def zero_force(x: torch.Tensor) -> torch.Tensor:
    """Zero force over the position DOFs of state ``x`` (``(..., 2n)``)."""
    return x.new_zeros((*x.shape[:-1], x.shape[-1] // 2))


def create_forces_function(force_components: List[AbstractForce]) -> Callable:
    """Aggregate a component list into ``forces(x, t)`` (sum of enabled).

    ``x`` is a tensor; the zero vector is returned when nothing is enabled.
    """

    def forces(x, t: float = 0.0):
        total = None
        for comp in force_components:
            if comp.is_enabled():
                contrib = torch.as_tensor(comp.compute_forces(x, t))
                total = contrib if total is None else total + contrib
        if total is None:
            return zero_force(x)
        return total

    return forces


def create_input_processor(input_components: List[AbstractInputHandler]) -> Callable:
    """Chain input components into ``process_input(x, u, t)``."""

    def process_input(x, u, t: float = 0.0):
        processed = torch.as_tensor(u)
        for comp in input_components:
            if comp.is_enabled():
                processed = comp.process_input(x, processed, t)
        return processed

    return process_input

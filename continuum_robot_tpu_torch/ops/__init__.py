"""Numerical operators: block-tridiagonal algebra (``banded``), the
explicit, adaptive and implicit integrators (``integrators``), the exact
exponential propagator (``exponential``), the CARE solver (``care``) and
the CUDA kernels (``cuda``)."""

from . import banded, care, cuda, exponential, integrators

__all__ = ["banded", "care", "cuda", "exponential", "integrators"]

"""Numerical operators: block-tridiagonal algebra (``banded``), the
explicit, adaptive and implicit integrators (``integrators``), the exact
exponential propagator (``exponential``) and the CUDA kernels (``cuda``)."""

from . import banded, cuda, exponential, integrators

__all__ = ["banded", "cuda", "exponential", "integrators"]

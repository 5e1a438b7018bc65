"""Numerical operators: block-tridiagonal algebra (``banded``), the
implicit integrators (``integrators``) and the CUDA kernels (``cuda``)."""

from . import banded, cuda, integrators

__all__ = ["banded", "cuda", "integrators"]

"""Numerical operators: the CUDA kernels of the modal engine."""

from . import cuda

__all__ = ["cuda"]

"""Control layer: LQR design, LQG and Kalman estimation, the extended
Kalman filter and state-feedback handlers."""

from .ekf import EKFState, make_discrete_step, make_ekf, run_ekf
from .full_state_linear import FullStateLinear
from .lqg import (
    LinearQuadraticEstimator,
    LinearQuadraticGaussian,
    output_matrix,
)
from .lqr import LinearQuadraticRegulator

__all__ = [
    "EKFState",
    "FullStateLinear",
    "make_discrete_step",
    "make_ekf",
    "run_ekf",
    "LinearQuadraticEstimator",
    "LinearQuadraticGaussian",
    "LinearQuadraticRegulator",
    "output_matrix",
]

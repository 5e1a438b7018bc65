"""continuum-robot-tpu on PyTorch and CUDA: the port for NVIDIA Hopper.

A second package beside the JAX one (``continuum_robot_tpu``), which stays
the reference. It holds the model build (CSV/DataFrame -> linear,
nonlinear von Kármán or hybrid Euler-Bernoulli beam, host float64), the
linear modal generalized-α engine (:class:`ModalGenAlpha`), the
nonlinear modal-ROM engine (:class:`ModalROMGenAlpha`, with reduced
external forces, basis augmentation, ECSW hyper-reduction and its guard,
error-controlled stepping, and basis and sample files), the full-order implicit Newmark and generalized-α
integrators (:func:`make_newmark_operator`, ``ops/integrators``) with
registered fluid drag and gravity, the model's ODE right-hand side with the
explicit RK4 and adaptive Dopri5 integrators, the adaptive implicit
generalized-α and SDIRK3 engines, the exact exponential propagator
(``ops/exponential``), the fused small-beam rollout
(``ops/cuda/fused_rollout``), single-device batched rollouts
(``parallel``), the control layer (``control``: LQR, LQG, the extended
Kalman filter; the CARE solver in ``ops/care``) and the utilities
(``utils``: energies, health guards, checkpoints, modal analysis).
Their fused drives and the block-tridiagonal solve run as hand-written
CUDA kernels (``ops/cuda``) on the card and as plain PyTorch twins on the
CPU.
Entry points run on the card unless the caller passes ``device="cpu"``.

Precision policy: importing the package turns TF32 off for float32 matmuls
and convolutions. Reduced-precision matmul inputs were a correctness cliff
for operators at stiffness ~1e9 (docs/design.md, Precision); the basis
transforms here are large float32 matmuls and must stay true float32.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .control import FullStateLinear, LinearQuadraticRegulator  # noqa: E402
from .models import (  # noqa: E402
    BoundaryConditionType,
    DynamicEulerBernoulliBeam,
    ElementType,
    EulerBernoulliBeam,
    ForceParams,
    GravityForce,
    IBeam,
    ISegment,
    Properties,
)
from .models.simulate import (  # noqa: E402
    ModalGenAlpha,
    ModalROMGenAlpha,
    PiecewiseConstant,
    SimulationResult,
    load_basis,
    load_ecsw,
    make_modal_genalpha,
    make_modal_rom,
    make_newmark_operator,
    simulate,
)
from .ops.integrators import (  # noqa: E402
    AdaptiveStats,
    NewmarkOperator,
    adaptive_drive,
    dopri5_step,
    generalized_alpha_step,
    integrate_adaptive,
    integrate_fixed,
    integrate_generalized_alpha,
    integrate_generalized_alpha_adaptive,
    integrate_newmark,
    integrate_sdirk3_adaptive,
    newmark_step,
    rk4_step,
    sdirk3_step,
)

__version__ = "0.1.0"

__all__ = [
    "AdaptiveStats",
    "BoundaryConditionType",
    "DynamicEulerBernoulliBeam",
    "ElementType",
    "EulerBernoulliBeam",
    "ForceParams",
    "FullStateLinear",
    "GravityForce",
    "IBeam",
    "ISegment",
    "LinearQuadraticRegulator",
    "ModalGenAlpha",
    "ModalROMGenAlpha",
    "NewmarkOperator",
    "PiecewiseConstant",
    "Properties",
    "SimulationResult",
    "__version__",
    "adaptive_drive",
    "dopri5_step",
    "generalized_alpha_step",
    "integrate_adaptive",
    "integrate_fixed",
    "integrate_generalized_alpha",
    "integrate_generalized_alpha_adaptive",
    "integrate_newmark",
    "integrate_sdirk3_adaptive",
    "load_basis",
    "load_ecsw",
    "make_modal_genalpha",
    "make_modal_rom",
    "make_newmark_operator",
    "newmark_step",
    "rk4_step",
    "sdirk3_step",
    "simulate",
]

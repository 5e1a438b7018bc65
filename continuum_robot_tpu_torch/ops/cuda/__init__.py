"""Hand-written CUDA kernels for Hopper (sm_90a) with plain PyTorch twins.

``modal_rollout``: the linear modal gen-α kernels; ``rom_rollout``: the
fused modal-ROM gen-α kernels; ``btd_solve``: the block-tridiagonal solve
of the implicit integrators; ``fused_rollout``: the fused small-beam gen-α
steps with quadratic drag. Importing this package builds nothing; the
kernels are compiled on first use by a CUDA tensor (``_build.py``).
"""

from .modal_rollout import (
    affine_steps,
    affine_steps_plain,
    modal_frames,
    modal_frames_plain,
    modal_steps,
    modal_steps_plain,
    mode_coeffs,
    reset_launch_counts,
)

__all__ = [
    "affine_steps",
    "affine_steps_plain",
    "modal_frames",
    "modal_frames_plain",
    "modal_steps",
    "modal_steps_plain",
    "mode_coeffs",
    "reset_launch_counts",
]

"""Full-state feedback input handler.

Counterpart of ``continuum_robot_tpu/control/full_state_linear.py``
(reference ``control/full_state_linear.py:5-64``): an
:class:`AbstractInputHandler` computing ``u = K (r - x)`` with the same
dimension-validation contracts, and :meth:`FullStateLinear.feedback`, the
unchecked form that broadcasts over leading batch axes for rollouts
(``simulate(forces_func=...)``, the integrators).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.abstractions import AbstractInputHandler
from ..models.dynamics import dense_apply


class FullStateLinear(AbstractInputHandler):
    """State-feedback input: ``compute_input(x, r, t) = K (r - x)``.

    The gain stays a host array and goes to a tensor's device and dtype on
    first use there. NumPy ``x`` and ``r`` go to ``device`` (None: the
    card); tensors keep their own.
    """

    def __init__(self, gain_matrix, enabled: bool = True, device=None):
        gain_matrix = np.asarray(gain_matrix)
        if gain_matrix.ndim != 2:
            raise ValueError("Gain matrix must be a 2D array.")
        self.gain_matrix = gain_matrix
        self.enabled = enabled
        self.device = device
        self._uploads = {}

    def _gain(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._uploads:
            self._uploads[key] = torch.as_tensor(self.gain_matrix, dtype=like.dtype,
                                                 device=like.device)
        return self._uploads[key]

    def _tensor(self, v, like=None) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        if like is not None:
            return torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)
        from ..models.simulate import resolve_device

        return torch.as_tensor(np.asarray(v), device=resolve_device(self.device))

    def compute_input(self, x, r, t):
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        r = r if isinstance(r, torch.Tensor) else np.asarray(r)
        if r.ndim != 1:
            raise ValueError("Input vector r must be a 1D array.")
        if x.ndim != 1:
            raise ValueError("State vector x must be a 1D array.")
        if x.shape[0] != r.shape[0]:
            raise ValueError(
                "State vector and refrence vector must have the same length."
            )
        if self.gain_matrix.shape[1] != x.shape[0]:
            raise ValueError(
                "Gain matrix column dimension must match state vector length."
            )
        x = self._tensor(x)
        return self._gain(x) @ (self._tensor(r, x) - x)

    def feedback(self, x: torch.Tensor, r) -> torch.Tensor:
        """``K (r - x)`` over leading batch axes of ``x`` (no validation);
        ``r`` is a tensor, an array or a scalar that broadcasts against
        ``x``."""
        err = self._tensor(r, x) - x
        return dense_apply(self._gain(x), err)

    def is_enabled(self) -> bool:
        return self.enabled

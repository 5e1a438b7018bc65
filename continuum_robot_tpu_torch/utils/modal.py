"""Modal analysis: natural frequencies and mode shapes of linear beams.

Counterpart of ``continuum_robot_tpu/utils/modal.py``, a host computation:
the generalized symmetric eigenproblem ``K phi = omega^2 M phi`` on the
reduced operators (float64, a set-up computation like the LQR design), and
the reference example harness's analytic cantilever formula
(``example_utilities.py:208-240``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def modal_analysis(model, n_modes: int = None) -> Tuple[np.ndarray, np.ndarray]:
    """Natural frequencies [Hz] and mass-normalized mode shapes.

    ``model``: a :class:`DynamicEulerBernoulliBeam` with a purely linear
    (or linearizable) configuration. Returns ``(freqs (m,), modes (n, m))``
    in reduced coordinates, sorted ascending.
    """
    from scipy.linalg import eigh

    K = model.beam_model.get_stiffness_matrix()
    M = model.beam_model.get_mass_matrix()
    w2, phi = eigh(K, M)
    w2 = np.maximum(w2, 0.0)
    freqs = np.sqrt(w2) / (2 * np.pi)
    if n_modes is not None:
        freqs, phi = freqs[:n_modes], phi[:, :n_modes]
    return freqs, phi


def analytic_cantilever_frequencies(
    length, elastic_modulus, moment_inertia, density, cross_area, n_modes=4
):
    """Euler-Bernoulli cantilever closed form (reference parity,
    ``example_utilities.py:208-240``)."""
    beta_L = [0.596864 * np.pi, 1.49418 * np.pi, 2.50025 * np.pi, 3.49999 * np.pi]
    out = [
        (bl**2)
        * np.sqrt(
            elastic_modulus * moment_inertia / (density * cross_area * length**4)
        )
        / (2 * np.pi)
        for bl in beta_L[:n_modes]
    ]
    return np.asarray(out)

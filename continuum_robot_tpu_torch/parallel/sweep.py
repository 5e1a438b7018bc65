"""Parameter sweeps over traced beam configurations: not yet ported.

The JAX package's ``continuum_robot_tpu/parallel/sweep.py`` is the
differentiable-parameter path (``jax.grad`` through batched
``BeamArrays``). It comes in the next slice of the port, together with the
traced ``arrays=`` of the sharded engines and
``integrate_generalized_alpha(remat=True)``; until then every entry point
here raises ``NotImplementedError``.
"""

from __future__ import annotations

from .spatial_implicit import NEXT_SLICE


def _not_ported(name: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(f"parallel.sweep.{name}: {NEXT_SLICE}")

    entry.__name__ = name
    entry.__doc__ = f"The JAX package's ``sweep.{name}``: not yet ported (raises)."
    return entry


tile_arrays = _not_ported("tile_arrays")
override_arrays = _not_ported("override_arrays")
make_parametric_rhs = _not_ported("make_parametric_rhs")
parametric_rollout = _not_ported("parametric_rollout")
make_traced_genalpha_operator = _not_ported("make_traced_genalpha_operator")
parametric_modal_rom_rollout = _not_ported("parametric_modal_rom_rollout")
parametric_genalpha_rollout = _not_ported("parametric_genalpha_rollout")

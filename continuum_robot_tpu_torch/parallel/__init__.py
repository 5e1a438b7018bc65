"""Batched rollouts on one device (the single-device half of the JAX
package's parallel layer; meshes and spatial sharding are not ported)."""

from .rollout import batched_rollout, build_rollout_fn, sweep_statistics

__all__ = ["batched_rollout", "build_rollout_fn", "sweep_statistics"]

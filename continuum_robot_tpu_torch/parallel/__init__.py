"""Parallel layer: device meshes, batched and mesh-sharded rollouts, spatial
sharding of one beam's nodes, and parameter sweeps differentiable in the
physical parameters (``sweep.py``; traced ``arrays=`` on the sharded
implicit engines and ``simulate_sharded``).

Every rank of a ``torch.distributed`` world runs the same program
(``collectives.py``: the runtime, ``mesh.py``: ``DeviceMesh`` helpers);
entry points take and return global arrays, the same on every rank.
"""

from .collectives import destroy_process_group, init_process_group, launch
from .dryrun import dryrun_multichip
from .facade import simulate_sharded
from .mesh import batch_sharding, make_mesh, replicated
from .rollout import batched_rollout, build_rollout_fn, sweep_statistics
from .spatial import (
    SpatialBeam,
    build_spatial_rhs,
    make_spatial_beam,
    reduced_to_node_layout,
    spatial_rollout,
)
from .spatial_implicit import (
    build_spatial_genalpha,
    build_spatial_genalpha_adaptive,
    build_spatial_sdirk3,
    spike_prepare,
    spike_solve,
)
from .spatial_modal import (
    SpatialModal,
    SpatialModalROM,
    build_spatial_modal,
    build_spatial_modal_rom,
)
from .sweep import (
    make_parametric_rhs,
    make_traced_genalpha_operator,
    override_arrays,
    parametric_genalpha_rollout,
    parametric_modal_rom_rollout,
    parametric_rollout,
    tile_arrays,
)

__all__ = [
    "SpatialBeam",
    "SpatialModal",
    "SpatialModalROM",
    "batch_sharding",
    "batched_rollout",
    "build_rollout_fn",
    "build_spatial_genalpha",
    "build_spatial_genalpha_adaptive",
    "build_spatial_modal",
    "build_spatial_modal_rom",
    "build_spatial_rhs",
    "build_spatial_sdirk3",
    "destroy_process_group",
    "dryrun_multichip",
    "init_process_group",
    "launch",
    "make_mesh",
    "make_parametric_rhs",
    "make_spatial_beam",
    "make_traced_genalpha_operator",
    "override_arrays",
    "parametric_genalpha_rollout",
    "parametric_modal_rom_rollout",
    "parametric_rollout",
    "reduced_to_node_layout",
    "replicated",
    "simulate_sharded",
    "spatial_rollout",
    "spike_prepare",
    "spike_solve",
    "sweep_statistics",
    "tile_arrays",
]

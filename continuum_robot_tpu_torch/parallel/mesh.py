"""Device meshes over the ranks of a ``torch.distributed`` world.

Counterpart of ``continuum_robot_tpu/parallel/mesh.py``. The scaling axes:

* ``dp`` — data/environment parallelism: independent rollouts split over
  ranks;
* ``sp`` — spatial/beam-axis parallelism: the nodes of one long beam split
  over ranks, with a 3-DOF halo exchanged each step
  (``parallel/spatial.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the world's ranks (one rank a device); the JAX package's
``NamedSharding`` becomes DTensor placements (:func:`batch_sharding`,
:func:`replicated`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..models.simulate import resolve_device
from .collectives import init_process_group


def make_mesh(axis_sizes: Optional[dict] = None, device=None):
    """Build a ``DeviceMesh`` over the world's ranks.

    ``axis_sizes``: e.g. ``{"dp": 4, "sp": 2}``; defaults to a 1-D ``dp``
    mesh over every rank. ``device`` (None: the card) sets the mesh's device
    type, and with it the backend of a world this call opens when none is
    open (a one-rank world, :func:`collectives.init_process_group`).
    Every rank must call it, in the same order as its other collectives.

    On CUDA every dimension's NCCL communicator is opened here, by one
    one-element ``all_reduce`` on each: a ``batch_isend_irecv`` that is
    the first call on a group needs every rank of the group, and a
    :func:`collectives.ppermute` along a partial permutation has ranks that
    send and receive nothing.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        init_process_group(device)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"dp": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    if int(np.prod(sizes)) != world:
        raise ValueError(
            f"Mesh axes {axis_sizes} need {int(np.prod(sizes))} devices, "
            f"got {world}"
        )
    mesh = init_device_mesh(device.type, sizes, mesh_dim_names=names)
    if device.type == "cuda":
        one = torch.zeros(1, device=mesh_device(mesh))
        for name in names:
            dist.all_reduce(one, group=mesh.get_group(name))
    return mesh


def batch_sharding(mesh, axis: str = "dp") -> list:
    """DTensor placements that split the leading (environment) axis over
    ``axis`` and replicate over the mesh's other axes."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise KeyError(f"mesh has no axis {axis!r} (axes: {names})")
    return [Shard(0) if n == axis else Replicate() for n in names]


def replicated(mesh) -> list:
    """DTensor placements that replicate over every axis of ``mesh``."""
    return [Replicate() for _ in mesh.mesh_dim_names]


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)

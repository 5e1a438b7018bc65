"""The SPMD runtime of the parallel layer: process groups, mesh-axis
collectives and a launcher of rank processes.

The JAX package runs its sharded programs inside ``jax.shard_map`` over a
device ``Mesh``; the port runs one process per rank over
``torch.distributed`` and every rank executes the same Python program on
its own block. The JAX collectives map as:

* ``jax.lax.ppermute(x, axis, perm)`` -> :func:`ppermute`: one
  ``batch_isend_irecv`` on the axis's sub-group, the send and the receive
  posted together (so no two ranks can wait on each other's order); a
  pair whose peer is the rank itself is a local copy (gloo has no
  self-connection);
* ``jax.lax.psum`` -> :func:`psum` (``all_reduce``);
* ``jax.lax.all_gather`` -> :func:`all_gather` (``all_gather_single``),
  ordered by the position on the axis, whatever the sub-group's rank order;
* ``jax.lax.axis_index`` -> :func:`axis_index`.

The three collectives are ``torch.autograd.Function``s with the transposes
of the JAX package's ``shard_map``: a backward sends a cotangent along the
inverse permutation (``ppermute``), sums it over the axis (``psum``) or
reduce-scatters it (``all_gather``); a forward-mode tangent takes the
collective itself. A rank's cotangent of a value the ranks share is its
own part of the whole, so two boundary helpers close the convention: an
input every rank holds alike enters through :func:`replicated_in` (its
backward sums the ranks' parts: a gradient comes out whole on every rank)
and a result every rank returns alike leaves through :func:`gather_out`
(its backward keeps this rank's block). The NCCL and gloo paths are the
same.

A collective names its axis by a :class:`MeshAxis` (a ``DeviceMesh`` and one
of its dimension names). Every rank must issue the same collectives in the
same order: loops whose trip count depends on data stop on all-reduced
values only.

:func:`init_process_group` opens the world on a ``FileStore`` (no TCP port
to pick or collide on): NCCL for a CUDA device, gloo for the CPU, nothing
else; :func:`destroy_process_group` closes it. :func:`launch` runs a
function on N ranks, by default one a card over NCCL (``device="cpu"``: gloo
CPU ranks), forked from a server process that has imported the package
once, and returns their results, killing every rank after a time limit.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.simulate import resolve_device
from ..ops.cuda._build import _derivative_asked

# The temporary directory of the store init_process_group made itself (a
# world of size 1), removed by destroy_process_group.
_own_store_dir = None


def init_process_group(device=None, rank: int = 0, world_size: int = 1,
                       init_file: Optional[str] = None) -> str:
    """Open the default process group (once per process); returns its backend.

    ``device`` (None: the card, :func:`resolve_device`) picks the backend:
    NCCL for CUDA (bound to that device), gloo for the CPU. The ranks meet on
    a ``FileStore`` at ``init_file``, by default a new file in a temporary
    directory (enough for ``world_size=1``; N ranks must share one path),
    removed by :func:`destroy_process_group`. An already open group is kept
    when its backend matches and raises when not.
    """
    global _own_store_dir
    device = resolve_device(device)
    backends = {"cuda": "nccl", "cpu": "gloo"}
    if device.type not in backends:
        raise ValueError(f"the parallel layer runs on CUDA or the CPU, got {device}")
    backend = backends[device.type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"a {have} process group is open; the {device} layer needs {backend}"
            )
        return have
    if init_file is None:
        if world_size != 1:
            raise ValueError("ranks of a world larger than 1 must share init_file")
        _own_store_dir = tempfile.mkdtemp(prefix="crt_store_")
        init_file = os.path.join(_own_store_dir, "store")
    store = dist.FileStore(init_file, world_size)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, **kw)
    return backend


def world_device() -> torch.device:
    """The device of this rank's open world: its card under NCCL, else the
    CPU. A rank body passes it to :func:`mesh.make_mesh` and its tensors."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is open")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def destroy_process_group() -> None:
    """Close the default process group (if open) and remove the store
    directory that :func:`init_process_group` made for it."""
    global _own_store_dir
    if dist.is_initialized():
        dist.destroy_process_group()
    if _own_store_dir is not None:
        shutil.rmtree(_own_store_dir, ignore_errors=True)
        _own_store_dir = None


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One named dimension of a ``DeviceMesh``, seen from this rank.

    ``size`` is the dimension's length, ``index`` this rank's position on it,
    ``ranks`` the global ranks of the line through this rank (in position
    order) and ``group`` that line's process group. A mesh of None is the
    trivial axis of size 1 (no collective runs).
    """

    mesh: object
    name: str

    def __post_init__(self):
        if self.mesh is not None and self.name not in self._names:
            raise KeyError(f"mesh has no axis {self.name!r} (axes: {self._names})")

    @property
    def _names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names or ())

    @functools.cached_property
    def _dim(self) -> int:
        return self._names.index(self.name)

    @functools.cached_property
    def size(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.mesh.shape[self._dim])

    @functools.cached_property
    def index(self) -> int:
        return 0 if self.mesh is None else int(self.mesh.get_local_rank(self.name))

    @functools.cached_property
    def ranks(self) -> tuple:
        if self.mesh is None:
            return (0,)
        coord = list(self.mesh.get_coordinate())
        coord[self._dim] = slice(None)
        return tuple(int(r) for r in self.mesh.mesh[tuple(coord)].tolist())

    @functools.cached_property
    def group(self):
        return None if self.mesh is None else self.mesh.get_group(self.name)

    @functools.cached_property
    def _gather_order(self):
        """Rows of a group-ordered gather in position order (None: same)."""
        order = [dist.get_group_rank(self.group, r) for r in self.ranks]
        return None if order == list(range(self.size)) else order


def env_axis(mesh, node_axis: str) -> MeshAxis:
    """The axis an environment batch is split over beside the node axis
    ``node_axis``: the mesh's ``dp`` dimension, else the trivial axis."""
    if node_axis != "dp" and "dp" in tuple(mesh.mesh_dim_names or ()):
        return MeshAxis(mesh, "dp")
    return MeshAxis(None, "dp")


def axis_index(axis: MeshAxis) -> int:
    """This rank's position on ``axis`` (``jax.lax.axis_index``)."""
    return axis.index


def right_perm(n: int):
    """``ppermute`` pairs sending position k's payload to k+1 (a ring)."""
    return [(i, (i + 1) % n) for i in range(n)]


def left_perm(n: int):
    """``ppermute`` pairs sending position k's payload to k-1 (a ring)."""
    return [(i, (i - 1) % n) for i in range(n)]


def _ppermute(x: torch.Tensor, axis: MeshAxis, perm: Sequence) -> torch.Tensor:
    k = axis.index
    dst = [d for s, d in perm if s == k]
    src = [s for s, d in perm if d == k]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {list(perm)} is not a permutation")
    if not src and not dst:
        return torch.zeros_like(x)
    if dst == [k] and src == [k]:
        return x.clone()
    # NCCL sends and receives contiguous buffers only (empty_like would
    # keep a permuted layout); it also needs this rank's card set as the
    # current device, which init_process_group does.
    out = x.new_zeros(x.shape) if not src else x.new_empty(x.shape)
    ops = []
    if dst:
        if dst[0] == k:
            raise ValueError("a self-send needs a self-receive in the same perm")
        ops.append(dist.P2POp(dist.isend, x.contiguous(), axis.ranks[dst[0]], axis.group))
    if src:
        if src[0] == k:
            raise ValueError("a self-receive needs a self-send in the same perm")
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[src[0]], axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_reduce(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    return y


def _all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((axis.size * x.numel(),))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.reshape(-1), group=axis.group)
    out = out.reshape(axis.size, *x.shape)
    order = axis._gather_order
    return out if order is None else out[order]


def _reduce_scatter(g: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``g (size, ...)`` summed over the axis's ranks, this position's row
    (the transpose of :func:`_all_gather`): an all-reduce of the whole
    cotangent (gloo has no reduce-scatter), then the row."""
    return _all_reduce(g, axis)[axis.index]


# Autograd: every rank runs the same program, so every rank differentiates
# the same graph and issues the transposed collectives in the same order.
# The transposes are those of the JAX package's shard_map (a rank's
# cotangent of a value it shares is its own contribution, summed over the
# ranks): ppermute by the inverse permutation, psum by psum, all_gather by
# a reduce-scatter. A forward-mode tangent takes the same collective.


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, perm):
        return _ppermute(x, axis, perm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.perm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _PPermute.apply(g, ctx.axis, inverse), None, None

    @staticmethod
    def jvp(ctx, dx, _axis, _perm):
        return _ppermute(dx, ctx.axis, ctx.perm)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, dx, _axis):
        return _all_reduce(dx, ctx.axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _all_gather(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, dx, _axis):
        return _all_gather(dx, ctx.axis)


class _Replicated(torch.autograd.Function):
    """Identity forward; backward sums the cotangent over the axis (the
    JAX package's ``pvary``/``pbroadcast`` transpose): where a value that
    every rank holds alike enters the ranks' different work, each rank's
    cotangent is its part of the whole."""

    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, dx, _axis):
        return dx.view_as(dx)


class _GatherOut(torch.autograd.Function):
    """Every position's block concatenated along ``dim``, as a result every
    rank returns alike (a rollout's output): a loss computed from it is the
    same on every rank, so the backward keeps this rank's block of the
    cotangent (no message)."""

    @staticmethod
    def forward(x, axis, dim):
        return torch.cat(list(_all_gather(x, axis).unbind(0)), dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, ctx.dim = inputs
        ctx.block = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.block, ctx.block), None, None

    @staticmethod
    def jvp(ctx, dx, _axis, _dim):
        return torch.cat(list(_all_gather(dx, ctx.axis).unbind(0)), dim=ctx.dim)


def ppermute(x: torch.Tensor, axis: MeshAxis, perm: Sequence) -> torch.Tensor:
    """Send ``x`` along the ``(source, destination)`` pairs of ``perm``
    (positions on ``axis``); returns what this rank receives, zeros when no
    pair names it as destination (``jax.lax.ppermute``). Differentiable:
    the backward sends the cotangent along the inverse permutation, a
    tangent along ``perm``."""
    return _PPermute.apply(x, axis, tuple(perm))


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Sum over ``axis`` (``jax.lax.psum``): every rank gets the same value.
    Differentiable (backward and tangent: a ``psum``)."""
    if axis.size == 1:
        return x
    return _PSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``(size, *x.shape)``: every position's ``x``, in position order
    (``jax.lax.all_gather``). Differentiable: the backward is a
    reduce-scatter of the cotangent, a tangent is gathered."""
    if axis.size == 1:
        return x[None]
    return _AllGather.apply(x, axis)


def all_gather_cat(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """Every position's block of ``x`` concatenated along ``dim`` (a
    reduce-scatter in the backward, as :func:`all_gather`)."""
    if axis.size == 1:
        return x
    g = all_gather(x, axis)
    return torch.cat(list(g.unbind(0)), dim=dim)


def replicated_in(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x``, a value every rank of ``axis`` holds alike (an input), as it
    enters the ranks' different work: the backward sums the ranks'
    cotangents, so a gradient with respect to an input comes out whole, and
    the same, on every rank."""
    if axis.size == 1 or not _derivative_asked(x):
        return x
    return _Replicated.apply(x, axis)


def gather_out(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """:func:`all_gather_cat` for a result that every rank returns alike:
    the backward keeps this rank's block of the (same) cotangent."""
    if axis.size == 1:
        return x
    return _GatherOut.apply(x, axis, dim)


def env_chunk(n: int, axis: MeshAxis) -> int:
    """Environments a position of ``axis`` holds: ``ceil(n / size)``."""
    return -(-n // axis.size)


def env_block(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    """This rank's block of the environment axis ``dim`` of ``x``.

    Position k holds environments ``[k c, (k+1) c)``, ``c = ceil(n/size)``
    (the chunks of a DTensor ``Shard``); a block past the end is filled with
    copies of the last environment, so every position steps the same count
    and issues the same collectives. :func:`gather_env_blocks` drops them.
    """
    if axis.size == 1:
        return x
    n = x.shape[dim]
    c = env_chunk(n, axis)
    idx = torch.arange(axis.index * c, (axis.index + 1) * c, device=x.device)
    return replicated_in(x, axis).index_select(dim, idx.clamp(max=n - 1))


def gather_env_blocks(y: torch.Tensor, axis: MeshAxis, n: int, dim: int = 0) -> torch.Tensor:
    """The inverse of :func:`env_block`: every position's block along
    ``dim``, the fill dropped (``n`` environments)."""
    if axis.size == 1:
        return y
    return gather_out(y, axis, dim).narrow(dim, 0, n)


# ---------------------------------------------------------------------------
# Launcher: N ranks on a FileStore, one a card (NCCL) or on the CPU (gloo)
# ---------------------------------------------------------------------------


def _to_host(obj):
    """Tensors (DTensors gathered first) to NumPy, through containers."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        obj = obj.full_tensor()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(fn, rank, world_size, init_file, results, device_type, args, kwargs):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
            device = torch.device("cpu")
        else:  # rank r on card r; CUDA is first touched here, in the rank
            device = torch.device("cuda", rank)
            _share_host_threads(world_size)
        init_process_group(device, rank=rank, world_size=world_size, init_file=init_file)
        out = _to_host(fn(*args, **kwargs))
        results.put((rank, True, out))
    except Exception:  # report the failure to the parent, then exit
        results.put((rank, False, traceback.format_exc()))
    finally:
        destroy_process_group()


def _share_host_threads(world_size: int) -> None:
    """Give a card's rank its share of the host's cores for host work
    (torch's CPU ops, and the BLAS of a library it loads later, such as
    scipy's eigensolver): N ranks with every core each spin their thread
    pools against each other and slow every rank's host."""
    share = str(max(1, len(os.sched_getaffinity(0)) // world_size))
    torch.set_num_threads(int(share))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = share


def _stop_servers() -> None:
    """Stop and reap the fork server and the resource tracker that the
    launcher's first world started, so that no process outlives this one."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _start_fork_server(preload) -> None:
    """Start the fork server (once per process) with ``preload`` imported.

    Its ranks may open CUDA, so CUDA must not be initialised in it: the
    server runs with ``PYTORCH_NVML_BASED_CUDA_CHECK=1`` (so a
    ``torch.cuda.is_available()`` at import asks NVML, not the driver),
    and nothing it imports touches CUDA.
    """
    from multiprocessing import forkserver

    forkserver.set_forkserver_preload(preload)
    atexit.unregister(_stop_servers)
    atexit.register(_stop_servers)
    key, had = "PYTORCH_NVML_BASED_CUDA_CHECK", os.environ.get("PYTORCH_NVML_BASED_CUDA_CHECK")
    os.environ[key] = "1"
    try:
        forkserver.ensure_running()
    finally:
        if had is None:
            del os.environ[key]
        else:
            os.environ[key] = had


class World:
    """N ranks running one function (:func:`start`)."""

    def __init__(self, fn, n_ranks, args, kwargs, timeout, device=None):
        device = resolve_device(device)
        if device.type == "cuda":
            n_cards = torch.cuda.device_count()
            if n_cards < n_ranks:
                raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards, found {n_cards}")
            from ..ops.cuda import _build

            _build.build_all()  # once, here: not nvcc in every rank at once
        elif device.type != "cpu":
            raise ValueError(f"ranks run on CUDA cards or the CPU, got {device}")
        ctx = multiprocessing.get_context("forkserver")
        # The server imports these once; each rank is a fork of it.
        _start_fork_server([__name__, "torch.distributed.tensor", "torch._dynamo",
                            fn.__module__])
        self._name = getattr(fn, "__name__", str(fn))
        self._n = n_ranks
        self._tmp = tempfile.mkdtemp(prefix="crt_launch_")
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, n_ranks, os.path.join(self._tmp, "store"),
                              self._results, device.type, args, kwargs))
            for r in range(n_ranks)
        ]
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        """Stop every rank now (results are dropped)."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def result(self) -> list:
        """The ranks' results in rank order; kills every rank when one fails
        or the time limit passes (and raises), and when they are done."""
        n, procs, results = self._n, self._procs, self._results
        out = [None] * n
        done = set()
        try:
            while len(done) < n:
                if time.monotonic() > self._deadline:
                    raise TimeoutError(
                        f"{self._name} on {n} ranks did not finish within {self._timeout} s"
                    )
                try:
                    rank, ok, val = results.get(timeout=0.5)
                except queue_mod.Empty:
                    # A rank that died without reporting (killed, or failed
                    # before its first line ran) fails the world at once.
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead and results.empty():
                        time.sleep(1.0)
                        if results.empty():
                            raise RuntimeError(
                                f"rank {dead[0]} of {n} exited with code "
                                f"{procs[dead[0]].exitcode} without a result"
                            ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
                out[rank] = val
                done.add(rank)
            for p in procs:
                p.join(timeout=max(self._deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
            shutil.rmtree(self._tmp, ignore_errors=True)
        return out


def start(fn: Callable, n_ranks: int, *args, timeout: float = 120.0, device=None,
          **kwargs) -> World:
    """Start ``fn(*args, **kwargs)`` on ``n_ranks`` ranks and return at
    once; :meth:`World.result` collects (see :func:`launch`). The time
    limit counts from the start."""
    return World(fn, int(n_ranks), args, kwargs, timeout, device)


def launch(fn: Callable, n_ranks: int, *args, timeout: float = 120.0, device=None,
           **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on ``n_ranks`` ranks.

    ``device`` is resolved as :func:`resolve_device` resolves it: None
    means the cards, rank r on ``cuda:r`` over NCCL (it raises where there
    are fewer cards than ranks, or none); ``"cpu"`` gloo ranks on the CPU,
    one thread each. There is no fallback to the CPU. For cards the
    kernels are built here first, once. The ranks are forked from a
    ``multiprocessing`` fork server, a fresh process that imports this
    package and ``fn``'s module once (so a second world starts in a
    fraction of a second) and never touches CUDA; each rank opens the world
    on one ``FileStore`` in a temporary directory before it calls ``fn``
    (:func:`world_device` names its device). ``fn`` must be importable by
    name (a module-level function) and its module must not need JAX.
    Tensors in the results come back as NumPy arrays. Returns the results
    in rank order. A rank that raises or dies, or a world that has not
    finished after ``timeout`` seconds, kills every rank and raises
    (``RuntimeError`` with the rank's traceback, ``TimeoutError``).
    """
    return start(fn, n_ranks, *args, timeout=timeout, device=device, **kwargs).result()

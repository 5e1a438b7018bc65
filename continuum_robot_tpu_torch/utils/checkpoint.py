"""Checkpoint and resume for long sweeps (NumPy ``.npz``).

Counterpart of ``continuum_robot_tpu/utils/checkpoint.py``: a snapshot of
``(state, t, random state, metadata)`` as the flattened leaves of the state
plus scalars. The file layout is the JAX package's, and a checkpoint
written by either package loads in the other:

* leaves are numbered in ``jax.tree_util`` order: a dict's values by sorted
  key, a tuple's, list's or NamedTuple's in order, ``None`` holding none
  (``torch.utils._pytree`` keeps a dict's insertion order, so the port
  flattens with its own :func:`tree_leaves`);
* a JAX PRNG key (any array passed as ``rng_key``) is stored as it is under
  ``rng_key``; a ``torch.Generator`` is stored under keys of its own
  (``torch_rng_state``, ``torch_rng_device``), which the JAX package
  ignores.

The orbax path of the JAX package (``try_orbax_save`` / ``try_orbax_load``)
wraps a JAX-only library and has no counterpart: the ``.npz`` file is it.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, lists and tuples in ``jax.tree_util``
    order (dict keys sorted, ``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """``like``'s structure filled with ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return type(node)((k, filled[k]) for k in node)
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, state, t: float, rng_key=None, meta: Optional[dict] = None):
    """Snapshot a rollout: flattened leaves (tensors on any device, or
    arrays) + scalars. ``rng_key``: an array (a JAX key, kept as it is) or
    a ``torch.Generator`` (its state)."""
    leaves = tree_leaves(state)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["t"] = np.asarray(t)
    if isinstance(rng_key, torch.Generator):
        arrays["torch_rng_state"] = _host(rng_key.get_state())
        arrays["torch_rng_device"] = np.asarray(str(rng_key.device))
    elif rng_key is not None:
        arrays["rng_key"] = _host(rng_key)
    if meta:
        for k, v in meta.items():
            arrays[f"meta_{k}"] = _host(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, n_leaves=len(leaves), **arrays)
    return path


def load_checkpoint(path: str, treedef_like: Any = None, device=None):
    """Restore ``(state, t, rng_key, meta)``.

    ``state`` takes the structure of ``treedef_like`` when given, else it
    is a list of leaves. A leaf becomes a tensor on ``device`` when that is
    given, else on the device of the matching tensor leaf of
    ``treedef_like``; otherwise it stays a NumPy array. ``rng_key`` is the
    stored JAX key array, or a ``torch.Generator`` restored from a stored
    generator state, or None.
    """
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    n = int(data["n_leaves"])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    like_leaves = tree_leaves(treedef_like) if treedef_like is not None else [None] * n
    if len(like_leaves) != n:
        raise ValueError(f"checkpoint holds {n} leaves, the structure {len(like_leaves)}")
    for i, like in enumerate(like_leaves):
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else None)
        if dev is not None:
            leaves[i] = torch.as_tensor(leaves[i], device=dev)
    state = tree_unflatten(treedef_like, leaves) if treedef_like is not None else leaves
    t = float(data["t"])
    if "torch_rng_state" in data:
        rng_key = torch.Generator(device=str(data["torch_rng_device"]))
        rng_key.set_state(torch.as_tensor(data["torch_rng_state"]))
    else:
        rng_key = data["rng_key"] if "rng_key" in data else None
    meta = {
        k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")
    }
    return state, t, rng_key, meta

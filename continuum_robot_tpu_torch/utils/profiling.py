"""Completion and timing helpers for the card.

Counterpart of ``continuum_robot_tpu/utils/profiling.py``. PyTorch returns
from a CUDA call before the card finishes it, so a timed region ends in
:func:`force_completion` (``torch.cuda.synchronize``), and kernel times come
from CUDA events (:func:`cuda_event_times`). A measurement that finds no
card raises; it never falls back to the CPU.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def force_completion(out):
    """Wait until every CUDA tensor in ``out`` (nested tuples, lists, dicts)
    is computed; CPU results are complete already. Returns ``out``."""
    devices = {t.device for t in _leaves(out) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def cuda_event_times(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
                     device=None) -> List[float]:
    """Milliseconds of each of ``repeats`` calls of ``fn(*args)`` on the card.

    Each call is bracketed by CUDA events on the current stream after
    ``warmup`` untimed calls; the times are the card's, not the host's.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_times needs a CUDA device")
    device = torch.device(device or torch.cuda.current_device())
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize(device)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return times

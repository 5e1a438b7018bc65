"""Completion, timing and tracing helpers for the card.

Counterpart of ``continuum_robot_tpu/utils/profiling.py``. PyTorch returns
from a CUDA call before the card finishes it, so a timed region ends in
:func:`force_completion` (``torch.cuda.synchronize``), and kernel times come
from CUDA events (:func:`cuda_event_times`). :class:`StepMeter` splits a
first (cold) call from warm ones, :func:`trace` writes a ``torch.profiler``
trace, and :func:`compile_time_breakdown` splits the kernels' build from the
first and a warm call. A measurement that finds no card raises; it never
falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, List, Optional

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


@dataclasses.dataclass
class StepMeter:
    """Throughput meter separating the first (cold) call from warm ones.

    The JAX package's cold call compiles the program; here it builds the
    kernels a first CUDA call needs, uploads operators and warms PyTorch's
    caches. ``report()`` has the JAX package's keys: ``compile_s`` is the
    cold call's seconds, ``run_s`` a warm call's mean."""

    n_steps: int
    n_envs: int = 1
    compile_time: Optional[float] = None
    run_time: Optional[float] = None

    def measure(self, fn: Callable, *args, repeats: int = 1):
        """Time ``fn(*args)`` once cold and ``repeats`` times warm, each call
        ended by :func:`force_completion`; returns the last output."""
        t0 = time.perf_counter()
        out = force_completion(fn(*args))
        self.compile_time = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(repeats):
            out = force_completion(fn(*args))
        self.run_time = (time.perf_counter() - t0) / repeats
        return out

    @property
    def steps_per_sec(self) -> float:
        return self.n_steps / self.run_time if self.run_time else 0.0

    @property
    def env_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n_envs

    def report(self) -> dict:
        return {
            "compile_s": self.compile_time,
            "run_s": self.run_time,
            "steps_per_sec": self.steps_per_sec,
            "env_steps_per_sec": self.env_steps_per_sec,
        }


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block, CPU and CUDA
    activity, written as a Chrome/Perfetto trace (``chrome://tracing``,
    ui.perfetto.dev) into ``logdir``. Yields the trace file's path, which
    exists once the block has left. Raises without a card unless
    ``device="cpu"`` (CPU activity only)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace needs a CUDA device (pass device='cpu' for the CPU)")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def compile_time_breakdown(fn: Callable, *args) -> dict:
    """Split the kernels' build from the first and a warm call of ``fn(*args)``.

    The counterpart of the JAX package's ``jit(fn).lower`` / ``compile``
    split. Keys:

    * ``build_s``: ``{source: seconds}``, each CUDA source's ``nvcc`` wall
      time in :func:`ops.cuda._build.build_all` (0.0 for a library already
      built; the sources build in parallel). It stands where ``xla_compile_s``
      stood: the cost paid once for device code.
    * ``first_call_s``: the first call after the build, ended by
      :func:`force_completion`: loading the libraries, uploading operators
      and PyTorch's first-use costs. It stands where ``trace_s`` stood (the
      one-time host work before the program runs), and includes one run.
    * ``warm_call_s``: a second call, the steady state.
    """
    from ..ops.cuda import _build

    if not torch.cuda.is_available():
        raise RuntimeError("compile_time_breakdown needs a CUDA device and nvcc")
    _build.build_all()
    build_s = dict(_build.build_seconds)
    t0 = time.perf_counter()
    force_completion(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    force_completion(fn(*args))
    return {"build_s": build_s, "first_call_s": first,
            "warm_call_s": time.perf_counter() - t0}

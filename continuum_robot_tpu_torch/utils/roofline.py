"""Utilization accounting: ceilings measured on the card, program costs.

Counterpart of ``continuum_robot_tpu/utils/roofline.py``:

* :func:`measure_ceilings` times the card's rooflines with CUDA events:
  ``torch.matmul`` in true float32 and in TF32, an FMA chain in registers
  (the hand-written :func:`fma_chain` kernel) and a streaming read plus
  write of device memory. Each rate is marginal (:func:`_autoscale_rate`),
  so the per-call launch cost cancels.
* :func:`program_cost` counts a call's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` (PyTorch's own counts of
  its matmul-like operators); a call whose work is in hand-written kernels
  shows none, and the caller passes an analytic count instead.
* :func:`utilization` combines the two into achieved rates and the
  fraction of whichever measured ceiling binds.

An FMA counts as two FLOPs, as in the JAX module.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

# The JAX package's ceiling key that each of this card's keys replaces.
JAX_KEYS = {
    "f32_flops": "mxu_f32_flops",
    "tf32_flops": "mxu_bf16_flops",
    "fma_f32_flops": "vpu_f32_flops",
    "hbm_bytes_per_sec": "hbm_bytes_per_sec",
}
# utilization(precision_tier=...) -> the compute ceiling it is held to.
TIER_KEYS = {"f32": "f32_flops", "tf32": "tf32_flops", "fma": "fma_f32_flops"}


def _card(device=None) -> torch.device:
    """The card a probe runs on; raises without one (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probes need a CUDA device")
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the roofline probes measure a CUDA device, not {device}")
    return device


# ---------------------------------------------------------------------------
# fma_chain: the FMA-issue probe (csrc/roofline.cu) and its plain twin
# ---------------------------------------------------------------------------


def fma_chain_plain(x: torch.Tensor, chain: int, eps: float) -> torch.Tensor:
    """``chain`` links of ``y <- y*y + eps`` from ``y = x`` (float32), each
    rounded once as ``__fmaf_rn`` rounds (``modal_rollout.madd``)."""
    from ..ops.cuda.modal_rollout import madd

    y = x
    for _ in range(int(chain)):
        y = madd(y, y, torch.full_like(y, eps))
    return y


def fma_chain(x: torch.Tensor, chain: int, eps: float, out: torch.Tensor = None) -> torch.Tensor:
    """``fma_chain_plain`` by the CUDA kernel for a CUDA float32 tensor
    (``out`` may be ``x``: in place), the plain twin for a CPU one.
    ``fma_chain.launches`` counts the launches."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"fma_chain takes a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        y = fma_chain_plain(x, chain, eps)
        if out is None:
            return y
        return out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain takes a CPU or CUDA tensor, got {x.device}")
    from ..ops.cuda import _build

    _build.refuse_grad("fma_chain", x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fma_chain needs a contiguous, 16-byte aligned tensor")
    out = torch.empty_like(x) if out is None else out
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device \
            or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("fma_chain: out must be a contiguous, aligned tensor like x")
    lib = _build.library("roofline")
    with torch.cuda.device(x.device):
        rc = lib.fma_chain_launch(x.numel(), int(chain), float(eps), x.data_ptr(),
                                  out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0
KERNELS = (fma_chain,)


def reset_launch_counts() -> None:
    """Set every launch count of this module to 0."""
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _timed(fn, arg, device, reps: int = 2) -> float:
    """Best of ``reps`` seconds of one call of a warm ``fn(arg)``, by CUDA
    events around it."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            start.record()
            fn(arg)
            end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best


def _autoscale_rate(build, work_per_iter: float, device, iters0: int = 8,
                    min_wall: float = 0.5, rounds: int = 4) -> float:
    """Marginal rate of ``build(iters) -> (fn, arg)`` programs.

    The JAX module's method (``roofline.py:48``): grow ``iters`` until one
    call takes ``min_wall`` seconds (at most ``rounds`` growths), then time
    ``iters`` and ``2 * iters`` and return ``iters * work_per_iter / (wall2 -
    wall1)``; the fixed cost of a call (here the first launches' host
    dispatch ahead of the card) cancels.
    """
    iters, wall = iters0, 0.0
    for _ in range(rounds):
        fn, arg = build(iters)
        fn(arg)  # warm
        torch.cuda.synchronize(device)
        wall = _timed(fn, arg, device, reps=1)
        if wall >= min_wall:
            break
        scale = min(max(1.5 * min_wall / max(wall, 1e-4), 2.0), 64.0)
        iters = int(np.ceil(iters * scale))
    wall1 = _timed(fn, arg, device)
    fn2, arg2 = build(2 * iters)
    wall2 = _timed(fn2, arg2, device)
    return work_per_iter * iters / max(wall2 - wall1, 1e-6)


# ---------------------------------------------------------------------------
# Ceilings
# ---------------------------------------------------------------------------


def measure_matmul_ceiling(n: int = 4096, precision: str = "highest",
                           dtype: torch.dtype = torch.float32, min_wall: float = 0.5,
                           device=None) -> float:
    """Measured ``torch.matmul`` FLOP/s (2 n^3 a product) on the card.

    ``precision="highest"``: true float32 (TF32 off, the port's setting);
    ``"tf32"``: TF32 tensor cores, switched on for this probe only and
    restored after it. (The JAX tiers were the MXU's HIGHEST and DEFAULT.)
    A chain of ``iters`` dependent products ``c <- c @ a``, ``a`` scaled by
    ``1/sqrt(n)`` so the values stay bounded."""
    if precision not in ("highest", "tf32"):
        raise ValueError(f"precision is 'highest' or 'tf32', got {precision!r}")
    dev = _card(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = (torch.randn(n, n, generator=gen, dtype=torch.float64) / np.sqrt(n)).to(dev, dtype)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())

    def build(iters):
        def chain(x):
            c = x
            for _ in range(iters):
                c = torch.matmul(c, x)
            return c

        return chain, a

    try:
        torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
        torch.set_float32_matmul_precision("high" if precision == "tf32" else "highest")
        return _autoscale_rate(build, 2.0 * n**3, dev, min_wall=min_wall)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def measure_hbm_ceiling(mbytes: int = 512, min_wall: float = 0.5, device=None) -> float:
    """Measured device-memory streaming rate (bytes/s): ``x += 1`` in place
    over ``mbytes`` MiB of float32, one read and one write an element."""
    dev = _card(device)
    n = mbytes * 1024 * 1024 // 4
    x = torch.zeros(n, dtype=torch.float32, device=dev)

    def build(iters):
        def chain(v):
            for _ in range(iters):
                v.add_(1.0)
            return v

        return chain, x

    return _autoscale_rate(build, 2.0 * 4 * n, dev, min_wall=min_wall)


def measure_vpu_ceiling(mbytes: int = 64, chain: int = 256, min_wall: float = 0.5,
                        device=None) -> float:
    """Measured float32 FMA FLOP/s of the CUDA cores.

    The name is the JAX module's (its probe timed the TPU's vector unit).
    The probe is the :func:`fma_chain` kernel in place over ``mbytes`` MiB:
    ``chain`` dependent ``y <- fma(y, y, eps)`` an element in registers,
    one load and one store, each FMA counted as 2 FLOPs. Arithmetic
    intensity ``2 * chain / 8`` FLOPs a byte (64 at 256), far above the
    memory knee, so the rate is the FP32 units'."""
    dev = _card(device)
    n = mbytes * 1024 * 1024 // 4
    x = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    eps = 1e-7

    def build(iters):
        def run(y):
            for _ in range(iters):
                fma_chain(y, chain, eps, out=y)
            return y

        return run, x

    return _autoscale_rate(build, 2.0 * n * chain, dev, iters0=2, min_wall=min_wall)


def measure_ceilings(quick: bool = False, device=None) -> dict:
    """Every roofline of the card, measured. Keys, with the JAX package's
    key each replaces (:data:`JAX_KEYS`):

    * ``f32_flops``: ``torch.matmul`` in true float32 (``mxu_f32_flops``);
    * ``tf32_flops``: ``torch.matmul`` on the TF32 tensor cores
      (``mxu_bf16_flops``, the reduced-precision matmul tier);
    * ``fma_f32_flops``: the FMA chain on the CUDA cores
      (``vpu_f32_flops``);
    * ``hbm_bytes_per_sec``: streaming read plus write
      (``hbm_bytes_per_sec``).

    ``quick`` shrinks each probe's problem and its target wall time (0.15
    s instead of 0.5 s), as in the JAX module."""
    n = 2048 if quick else 4096
    mw = 0.15 if quick else 0.5
    return {
        "f32_flops": measure_matmul_ceiling(n, "highest", min_wall=mw, device=device),
        "tf32_flops": measure_matmul_ceiling(n, "tf32", min_wall=mw, device=device),
        "fma_f32_flops": measure_vpu_ceiling(16 if quick else 64, min_wall=mw, device=device),
        "hbm_bytes_per_sec": measure_hbm_ceiling(128 if quick else 512, min_wall=mw,
                                                 device=device),
    }


# ---------------------------------------------------------------------------
# Program costs and utilization
# ---------------------------------------------------------------------------


def program_cost(fn: Callable, *args) -> Optional[dict]:
    """FLOPs of one call ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the call runs once).

    Returns ``{"flops": float, "bytes": None}`` (there is no byte counter),
    or None when no FLOP is seen: the work is in hand-written kernels or in
    operators the counter does not price (elementwise ops), and callers
    supply analytic counts, as with the JAX module's custom calls."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = float(counter.get_total_flops())
    if flops <= 0.0:
        return None
    return {"flops": flops, "bytes": None}


def scan_program_cost(step_fn, carry, xs_elt, n_steps: int) -> Optional[dict]:
    """Cost of ``n_steps`` steps: one ``step_fn(carry, xs_elt)`` call's
    :func:`program_cost` times ``n_steps`` (bytes stay None)."""
    c = program_cost(step_fn, carry, xs_elt)
    if c is None:
        return None
    return {"flops": c["flops"] * n_steps, "bytes": None}


def utilization(flops: float, nbytes: Optional[float], wall_s: float, ceilings: dict,
                precision_tier: str = "f32") -> dict:
    """Achieved rates against measured ceilings (the JAX module's
    arithmetic and keys).

    ``precision_tier`` picks the compute ceiling (:data:`TIER_KEYS`):
    ``"f32"`` true-float32 matmul, ``"tf32"`` the TF32 tensor cores,
    ``"fma"`` the CUDA cores' FMA rate for elementwise recurrences.
    ``roofline_frac`` is the larger of the compute and the memory fraction:
    how close the program is to some limit of the card. ``nbytes`` None
    counts as 0."""
    key = TIER_KEYS.get(precision_tier, "f32_flops")
    nbytes = nbytes or 0.0
    flops_per_sec = flops / wall_s
    bytes_per_sec = nbytes / wall_s
    frac_compute = flops_per_sec / ceilings[key]
    frac_memory = bytes_per_sec / ceilings["hbm_bytes_per_sec"] if nbytes > 0 else 0.0
    bound = "compute" if frac_compute >= frac_memory else "memory"
    return {
        "flops_per_sec": flops_per_sec,
        "hbm_gbps": bytes_per_sec / 1e9,
        "roofline_frac": max(frac_compute, frac_memory),
        "bound": bound,
        "frac_compute": frac_compute,
        "frac_memory": frac_memory,
    }

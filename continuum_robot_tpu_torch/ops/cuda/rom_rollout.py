"""Fused modal-ROM generalized-alpha rollout: CUDA kernels and plain twins.

Counterpart of ``continuum_robot_tpu/ops/pallas/rom_rollout.py``. The TPU
kernel runs a whole span in VMEM, with both bases resident. On Hopper the
two bases (``2 x 3 n_sub x m`` float32, 6.2 MB at 1001 nodes and 256 modes)
do not fit a block's shared memory, so one modified-Newton iteration of one
step is a short sequence of hand-written kernels in ``csrc/rom_rollout.cu``
whose operands stay in the 50 MB L2:

===========================  =============================================
wrapper                      computes
===========================  =============================================
:func:`rom_alpha_point`      ``eta_af`` from ``(eta, etad, etadd, a1)``,
                             elementwise
:func:`rom_expand`           ``x = eta_af @ Phi_planar^T``, a 3xTF32
                             tensor-core GEMM (``wgmma``)
:func:`rom_correction_window`  the von Kármán correction of each window
                             element, masked, summed into node force
                             planes ``[u; w; theta]`` (no atomics), from
                             the operators' factor table
                             (:func:`correction_table`)
:func:`rom_correction_gathered`  the same on the ECSW sample's six
                             per-element-node blocks (no adjacency)
:func:`rom_project`          ``g @ PhiW_planar`` as ``S`` partial products
                             over slices of the long reduction, a 3xTF32
                             tensor-core GEMM (``wgmma``)
:func:`rom_update`           ``g_m`` = the partials summed in slice order;
                             the residual and the diagonal Newton update
                             (and the state update on the last iteration)
:func:`rom_newton_dense`     for a dense ``Sinv``: the same ``g_m`` and
                             residual ``r``, kept in shared memory, then
                             ``a1 - r @ Sinv^T`` and the same update, a
                             float32 FMA GEMM; one launch in place of
                             :func:`rom_update`'s
:func:`rom_expand_f32`,      the two transforms as float32 FFMA GEMMs on
:func:`rom_project_f32`      the same persistent TMA-fed body, for
                             ``nl_precision="highest"``
===========================  =============================================

Each wrapper has a plain PyTorch twin (``<wrapper>_plain``) with the same
arithmetic through ``torch.matmul`` and elementwise ops. A CPU tensor runs
the twin; a CUDA tensor launches the kernel (float32 only) or raises. Each
wrapper counts its launches in ``<wrapper>.launches``. On the card a wrapper
raises when an input requires grad or carries a tangent: the kernels have
no derivative (``_build.refuse_grad``). :func:`rom_steps`
and :func:`rom_frames` drive a span through the wrappers,
:func:`rom_steps_plain` and :func:`rom_frames_plain` through the twins.

Precision: ``nl_precision`` picks the tier of the two basis transforms,
as the JAX package's fused kernel does. "highest" is full float32 (the
JAX kernel's ``Precision.HIGHEST``): :func:`rom_expand` and
:func:`rom_project` hand over to :func:`rom_expand_f32` and
:func:`rom_project_f32`, float32 FMA GEMMs on the unsplit bases (no TF32,
no tensor cores), fed by the same persistent TMA ring as the tensor-core
kernels.
None, "high" and "default" run on the tensor cores as a 3-pass TF32 split,
the counterpart of the TPU kernel's bf16 hi/lo products (its "split" tier,
and more accurate than its "default", one bf16 pass): each operand x is
split into ``hi = tf32(x)`` (round to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and ``lo = tf32(x - hi)``, and ``A_hi B_hi + A_hi
B_lo + A_lo B_hi`` is summed in float32, each term accurate to about
``2^-21``. The bases are split once, where :class:`FusedROMRollout`
uploads them to the card for a tensor-core tier (:func:`split_basis`); the
per-step operand is split in the kernel; for "highest" the unsplit bases
are uploaded in the same K-major, row-padded layout (:func:`k_major_bases`).
The other kernels compute in
float32 FMAs for every tier (the JAX kernel's Newton dot is
``Precision.HIGHEST`` unless the caller asks for "default"). Kernel and
twin (float32 ``torch.matmul``) agree to about 1e-6 of each output's scale
for the tensor-core tier (1.8e-6 and 4.4e-7 for one launch of each at the
ROM main path's shapes on an H100, ``chip_smoke.py`` phase 12) and to
float32 roundoff for "highest", not bit for bit.

Layout: the GEMM kernels read their operands through TMA, which
needs 16-byte row pitches, so the kernel path keeps ``(B, N)`` node states
and forces in buffers whose rows are padded to a multiple of 4 floats and
hands out ``[:, :N]`` views; the pad columns are never read into a sum.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from ...models import elements

_PRECISIONS = (None, "highest", "high", "default")


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` of float32 ``x``: ``hi`` is ``x`` rounded to TF32 (to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and ``lo`` is
    ``x - hi`` rounded the same way; both float32 with their low 13 mantissa
    bits zero, and ``hi + lo = x`` to ``2^-22`` of ``|x|``."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _padded_empty(rows: int, cols: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(rows, cols)`` view of a buffer whose rows are
    padded to a multiple of 4 floats (the 16-byte pitch TMA reads)."""
    buf = torch.empty((rows, _pad4(cols)), dtype=like.dtype, device=like.device)
    return buf[:, :cols]


def tma_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if TMA can read it (unit column stride, a row pitch of a
    multiple of 4 floats, a 16-byte aligned base), else a copy into a padded
    buffer."""
    ok = (x.stride(1) == 1 and (x.stride(0) % 4 == 0 or x.shape[0] == 1)
          and x.data_ptr() % 16 == 0)
    if ok:
        return x
    out = _padded_empty(*x.shape, x)
    out.copy_(x)
    return out


def _pitch(x: torch.Tensor) -> int:
    """Row pitch in elements of a ``(rows, cols)`` tensor with unit column
    stride."""
    if x.stride(1) != 1:
        raise ValueError("the ROM kernels take rows with unit column stride")
    return x.stride(0) if x.shape[0] > 1 else _pad4(x.shape[1])


@dataclasses.dataclass(frozen=True)
class SplitBasis:
    """The bases in the K-major layouts the GEMM kernels read, with their TMA
    descriptors (built once per device and tier).

    ``phi``: parts of ``Phi (N, m)`` for the expand; ``wt``: parts of ``W^T
    (m, N)`` for the project. Two parts each, ``(hi, lo)``, for the 3xTF32
    kernels; one, the unsplit float32 basis, for the float32 ones
    ("highest"). Each part is a view of a buffer with rows padded to a
    multiple of 4 floats. ``maps``: the 128-byte tensor maps of ``phi +
    wt``, which point into these buffers.
    """

    phi: tuple
    wt: tuple
    maps: tuple

    @property
    def phi_maps(self) -> tuple:
        return self.maps[:len(self.phi)]

    @property
    def wt_maps(self) -> tuple:
        return self.maps[len(self.phi):]


def _tensor_map(half: torch.Tensor):
    buf = (ctypes.c_uint8 * 128)()
    lib = _build.library("rom_rollout")
    rows, cols = half.shape
    with torch.cuda.device(half.device):
        rc = lib.rom_tensor_map(ctypes.addressof(buf), half.data_ptr(), rows, cols,
                                _pitch(half))
    _build.check(lib, rc, "rom_tensor_map")
    return buf


def k_major_bases(phiT: torch.Tensor, w: torch.Tensor, tf32: bool = True):
    """``(phi, wt)``: the parts of ``Phi = phiT^T (N, m)`` and ``W^T (m, N)``
    as the GEMM kernels read them, K-major and each a view of a buffer with
    rows padded to a multiple of 4 floats: the TF32 halves ``(hi, lo)``
    (:func:`tf32_split`), or with ``tf32=False`` the unsplit basis alone."""

    def parts(x):
        out = []
        for part in tf32_split(x) if tf32 else (x,):
            buf = _padded_empty(*x.shape, x)
            buf.copy_(part)
            out.append(buf)
        return tuple(out)

    return parts(phiT.T), parts(w.T)


def split_basis(phiT: torch.Tensor, w: torch.Tensor, tf32: bool = True) -> SplitBasis:
    """The float32 bases ``phiT (m, N)`` and ``w (N, m)`` on the card as
    :func:`k_major_bases` lays them out, with their tensor maps."""
    phi, wt = k_major_bases(phiT, w, tf32)
    return SplitBasis(phi=phi, wt=wt, maps=tuple(map(_tensor_map, phi + wt)))


@dataclasses.dataclass(frozen=True)
class ROMOperators:
    """Device operators of one fused ROM rollout, in the state's dtype.

    ``phiT (m, N)`` and ``w (N, m)`` are the trial basis (transposed) and
    the test basis over ``N = 3 n_sub`` planar window rows or ``N = 6 s``
    gathered sample rows. ``sinv (m,)`` is the diagonal Newton inverse, or
    None with ``sinvT (m, m)`` the transposed dense one. ``L, D, A, mask
    (E,)``: element length, EI, EA and the nonlinear mask of the window
    (``E = n_sub - 1``) or of the sample (``E = s``). ``sc``: the step
    scalars ``(h, c_qp, c_vp, bh2, gh, af, 1-af, am, 1-am)``, and ``csc``
    the same as the C float array the kernels take (built once).
    ``nl_precision``: the transforms' tier, normalised ("highest" runs them
    in float32 on the card). ``split``: the bases as the GEMM kernels read
    them on the card (float32): their TF32 halves, or for "highest" the
    unsplit bases (:class:`SplitBasis`); None on the CPU. On the card a
    dense ``sinvT`` is a view of a row-padded buffer. ``coef``: on the card,
    the ``(CORRECTION_FACTORS, E)`` float32 table of the correction
    polynomial's per-element factors that the correction kernels read in
    place of ``L``, ``A`` and ``mask`` (:func:`correction_table`, rounded
    once from float64; coefficient-major, so a warp's loads coalesce); None
    on the CPU, whose twins use ``L``, ``A`` and ``mask``. Built from the
    operators' own parameters by :meth:`FusedROMRollout.operators`, so a
    caller that replaces ``L``, ``A`` or ``mask`` replaces ``coef`` too.
    """

    phiT: torch.Tensor
    w: torch.Tensor
    lam: torch.Tensor
    u: torch.Tensor
    cd: Optional[torch.Tensor]
    sinv: Optional[torch.Tensor]
    sinvT: Optional[torch.Tensor]
    L: torch.Tensor
    D: torch.Tensor
    A: torch.Tensor
    mask: torch.Tensor
    gathered: bool
    sc: tuple
    split: Optional[SplitBasis] = None
    coef: Optional[torch.Tensor] = None
    nl_precision: Optional[str] = None
    csc: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.csc is None:
            object.__setattr__(self, "csc", (ctypes.c_float * 9)(*self.sc))

    @property
    def n_rows(self) -> int:
        return self.phiT.shape[1]


CORRECTION_FACTORS = 17  # rows of correction_table


def correction_table(L, A, mask) -> np.ndarray:
    """The per-element factors of the von Kármán correction polynomial
    (``elements.nonlinear_correction_planes``), each times the element's
    mask: a ``(CORRECTION_FACTORS, E)`` float64 array from ``(E,)`` element
    lengths ``L``, membrane stiffnesses ``A = EA`` and masks, in the rows
    ``A/15, A/30, A/(20L), A/(10L), 0.6A/L^2, A/280, 3A/280, (9/70)A/L,
    (27/70)A/L^2, 1.2A/L^2, (36/35)A/L^3, AL/35, AL/140, AL/280, 3AL/280,
    (2/15)A, (9/70)A/L^2`` that ``csrc/rom_rollout.cu``'s ``correction``
    multiplies into the monomials. A masked element, or a padded one with
    ``A = 0``, has all-zero factors."""
    L, A, mask = (np.asarray(v, np.float64) for v in (L, A, mask))
    a = A * mask
    il = 1.0 / L
    il2 = il * il
    return np.stack([
        a / 15.0, a / 30.0, a * il / 20.0, a * il / 10.0, 0.6 * a * il2,
        a / 280.0, 3.0 * a / 280.0, (9.0 / 70.0) * a * il, (27.0 / 70.0) * a * il2,
        1.2 * a * il2, (36.0 / 35.0) * a * il2 * il,
        a * L / 35.0, a * L / 140.0, a * L / 280.0, 3.0 * a * L / 280.0,
        (2.0 / 15.0) * a, (9.0 / 70.0) * a * il2,
    ])


def step_scalars(h: float, rho_inf: float) -> tuple:
    """``(h, c_qp, c_vp, bh2, gh, af, 1-af, am, 1-am)`` of the gen-α step."""
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    gamma = 0.5 - am + af
    return (h, (0.5 - beta) * h * h, (1.0 - gamma) * h, beta * h * h,
            gamma * h, af, 1.0 - af, am, 1.0 - am)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _predict(op, eta, etad, etadd):
    h, c_qp, c_vp = op.sc[:3]
    return eta + h * etad + c_qp * etadd, etad + c_vp * etadd


def _eta_af(op, eta, eta_pred, a1):
    bh2, af, omaf = op.sc[3], op.sc[5], op.sc[6]
    return omaf * (eta_pred + bh2 * a1) + af * eta


def _residual(op, gm, eta, etad, etadd, a1):
    """``a_am + (lam eta_af + g_m) - u [+ cd etad_af]`` at ``a1``."""
    gh, af, omaf, am, omam = op.sc[4:]
    eta_pred, etad_pred = _predict(op, eta, etad, etadd)
    r = omam * a1 + am * etadd + (op.lam * _eta_af(op, eta, eta_pred, a1) + gm) - op.u
    if op.cd is not None:
        r = r + op.cd * (omaf * (etad_pred + gh * a1) + af * etad)
    return r


def _finish(op, a1n, eta, etad, etadd, last):
    """The new iterate, or on the last iteration the new state triple."""
    if not last:
        return a1n
    eta_pred, etad_pred = _predict(op, eta, etad, etadd)
    return eta_pred + op.sc[3] * a1n, etad_pred + op.sc[4] * a1n, a1n


def rom_alpha_point_plain(op, eta, etad, etadd, a1):
    """Plain twin of :func:`rom_alpha_point`."""
    return _eta_af(op, eta, _predict(op, eta, etad, etadd)[0], a1)


def rom_expand_plain(op, eta_af):
    """Plain twin of :func:`rom_expand`."""
    return eta_af @ op.phiT


def _slots(op, blocks):
    """The six masked correction slots of ``blocks = (u1, w1, t1, u2, w2, t2)``."""
    g = elements.nonlinear_correction_planes(*blocks, op.L, op.D, op.A)
    return [op.mask * gi for gi in g]


def rom_correction_window_plain(op, x):
    """Plain twin of :func:`rom_correction_window`."""
    B, N = x.shape
    p = x.reshape(B, 3, N // 3)
    g1, g3, g4, g2, g5, g6 = _slots(
        op, (p[:, 0, :-1], p[:, 1, :-1], p[:, 2, :-1],
             p[:, 0, 1:], p[:, 1, 1:], p[:, 2, 1:])
    )
    out = torch.zeros_like(p)
    for c, (own, nxt) in enumerate(((g1, g2), (g3, g5), (g4, g6))):
        out[:, c, :-1] = own
        out[:, c, 1:] += nxt
    return out.reshape(B, N)


def rom_correction_gathered_plain(op, x):
    """Plain twin of :func:`rom_correction_gathered`."""
    B, N = x.shape
    p = x.reshape(B, 6, N // 6)
    return torch.stack(_slots(op, p.unbind(1)), 1).reshape(B, N)


def rom_project_plain(op, g):
    """Plain twin of :func:`rom_project`: one slice, ``(1, B, m)``."""
    return (g @ op.w)[None]


def _partials_residual(op, partials, eta, etad, etadd, a1):
    """The residual at ``a1`` with ``g_m`` = the partials summed in slice
    order."""
    gm = partials[0]
    for part in partials[1:]:
        gm = gm + part
    return _residual(op, gm, eta, etad, etadd, a1)


def rom_update_plain(op, partials, eta, etad, etadd, a1, last):
    """Plain twin of :func:`rom_update`."""
    r = _partials_residual(op, partials, eta, etad, etadd, a1)
    return _finish(op, a1 - op.sinv * r, eta, etad, etadd, last)


def rom_newton_dense_plain(op, partials, eta, etad, etadd, a1, last):
    """Plain twin of :func:`rom_newton_dense`."""
    r = _partials_residual(op, partials, eta, etad, etadd, a1)
    return _finish(op, a1 - r @ op.sinvT, eta, etad, etadd, last)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cuda(x: torch.Tensor) -> bool:
    """True for CUDA float32 state, False for CPU; raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"ROM kernels take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA ROM kernels compute in float32, got {x.dtype}")
    return True


def _ptr(t) -> int:
    return 0 if t is None else t.contiguous().data_ptr()


_lib = None  # the loaded kernel library, after the first launch


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as an integer handle."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Launch ``<name>_launch`` on ``x``'s device and current stream. The
    host path is kept short, since a span is thousands of small launches:
    the library is looked up once, and the device is entered only when it
    is not the current one."""
    global _lib
    if _lib is None:
        _lib = _build.library("rom_rollout")
    fn = getattr(_lib, name + "_launch")
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc:
        _build.check(_lib, rc, name)


def _state_out(op, eta, last):
    """The update's outputs: the new iterate, or the new state triple (one
    allocation)."""
    return list(torch.empty((3 if last else 1, *eta.shape), dtype=eta.dtype,
                            device=eta.device).unbind(0))


def rom_alpha_point(op: ROMOperators, eta, etad, etadd, a1):
    """The alpha-point modal state ``eta_af = (1-af) (eta_pred + bh2 a1) +
    af eta`` of the Newton iterate ``a1``; all ``(B, m)``."""
    if not _on_cuda(eta):
        return rom_alpha_point_plain(op, eta, etad, etadd, a1)
    _build.refuse_grad("rom_alpha_point", eta, etad, etadd, a1)
    B, m = eta.shape
    out = torch.empty_like(eta)
    if B:
        _launch("rom_alpha_point", eta, B, m, _ptr(eta), _ptr(etad),
                _ptr(etadd), _ptr(a1), _ptr(out), op.csc)
        rom_alpha_point.launches += 1
    return out


def _split(op: ROMOperators, parts: int = 2) -> SplitBasis:
    """The operators' K-major bases in ``parts`` parts each (2: the TF32
    halves; 1: unsplit, for the float32 kernels)."""
    if op.split is None or len(op.split.phi) != parts:
        raise ValueError(f"the ROM GEMM kernels need the operators' basis halves in "
                         f"{parts} part(s) (FusedROMRollout.operators on the card)")
    return op.split


def _highest(op: ROMOperators) -> bool:
    return op.nl_precision == "highest"


def rom_expand(op: ROMOperators, eta_af):
    """``x = eta_af @ Phi^T``: ``(B, m) -> (B, N)`` node states (on the
    card a view of a row-padded buffer). The tensor-core kernel, or for
    ``nl_precision="highest"`` :func:`rom_expand_f32`."""
    if not _on_cuda(eta_af):
        return rom_expand_plain(op, eta_af)
    _build.refuse_grad("rom_expand", eta_af)
    if _highest(op):
        return rom_expand_f32(op, eta_af)
    B, m = eta_af.shape
    maps = _split(op).phi_maps
    x = _padded_empty(B, op.n_rows, eta_af)
    if B:
        a = tma_rows(eta_af)
        _launch("rom_expand", eta_af, B, m, op.n_rows, a.data_ptr(), _pitch(a),
                ctypes.addressof(maps[0]), ctypes.addressof(maps[1]),
                x.data_ptr(), _pitch(x))
        rom_expand.launches += 1
    return x


def _correction(name: str, op: ROMOperators, x, per_env: int, n_el: int):
    """Launch ``<name>`` on ``x``'s ``(B, per_env * n)`` rows with the
    operators' factor table of ``n_el`` elements."""
    B, N = x.shape
    coef = op.coef
    if coef is None or coef.shape != (CORRECTION_FACTORS, n_el):
        raise ValueError(f"the correction kernels need the operators' factor table of "
                         f"{n_el} elements (FusedROMRollout.operators on the card)")
    if x.stride(1) != 1:
        x = x.contiguous()
    g = _padded_empty(B, N, x)
    if B:
        _launch(name, x, B, N // per_env, x.data_ptr(), _pitch(x), coef.data_ptr(),
                g.data_ptr(), _pitch(g))
    return g


def rom_correction_window(op: ROMOperators, x):
    """Window correction: node force planes ``(B, 3 n_sub)`` from node state
    planes ``(B, 3 n_sub)``. Node i sums element i's node-1 slots and
    element i-1's node-2 slots; node 0 takes no node-2 slot and the last
    node no node-1 slot. On the card ``x`` may have padded rows and ``g``
    is a view of a row-padded buffer."""
    if not _on_cuda(x):
        return rom_correction_window_plain(op, x)
    _build.refuse_grad("rom_correction_window", x)
    g = _correction("rom_correction_window", op, x, 3, max(x.shape[1] // 3 - 1, 0))
    if x.shape[0]:
        rom_correction_window.launches += 1
    return g


def rom_correction_gathered(op: ROMOperators, x):
    """ECSW correction: the six masked slot blocks ``(B, 6 s)`` of the
    sampled elements from their gathered node states ``(B, 6 s)``, rows as
    in :func:`rom_correction_window`."""
    if not _on_cuda(x):
        return rom_correction_gathered_plain(op, x)
    _build.refuse_grad("rom_correction_gathered", x)
    g = _correction("rom_correction_gathered", op, x, 6, x.shape[1] // 6)
    if x.shape[0]:
        rom_correction_gathered.launches += 1
    return g


def rom_correction(op: ROMOperators, x):
    """The layout's correction kernel."""
    if op.gathered:
        return rom_correction_gathered(op, x)
    return rom_correction_window(op, x)


_TILE = 128  # rows and columns of the tensor-core kernels' output tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def project_splits(B: int, m: int, n_rows: int, device) -> int:
    """Slices of the project GEMM's reduction: output tiles (128 x 128)
    times slices fill the SMs in one wave of the persistent kernel (one
    block per SM), each slice at least 256 rows long."""
    tiles = -(-B // _TILE) * -(-m // _TILE)
    return max(1, min(n_rows // 256, _sm_count(device) // tiles))


def project_splits_f32(B: int, m: int, n_rows: int, device) -> int:
    """Slices of :func:`rom_project_f32`'s reduction: enough 128 x 128
    output tiles times slices to fill the SMs twice, each slice at least
    256 rows long.

    More than :func:`project_splits` gives, because a slice is one
    sequential float32 sum, whose roundoff grows with its length: at 4096 x
    256 x 3003 on an H100, on the card-only test's random operands, two
    slices of 1504 rows read 1.46e-6 of the output's scale off the float32
    twin (the test allows 1e-6), four slices of 768 rows 7.3e-7
    (``chip_compare.py --splits``). Four slices take two rounds of 24-slice
    units on 132 SMs, the slices an SM of one round of 47-slice units."""
    tiles = -(-B // _TILE) * -(-m // _TILE)
    return max(1, min(n_rows // 256, round(2 * _sm_count(device) / tiles)))


def rom_project(op: ROMOperators, g):
    """``g @ W`` as ``(S, B, m)`` partial products over ``S`` slices of the
    ``N``-long reduction (:func:`project_splits`); :func:`rom_update` sums
    them. The tensor-core kernel, or for ``nl_precision="highest"``
    :func:`rom_project_f32`."""
    if not _on_cuda(g):
        return rom_project_plain(op, g)
    _build.refuse_grad("rom_project", g)
    if _highest(op):
        return rom_project_f32(op, g)
    B, N = g.shape
    m = op.w.shape[1]
    maps = _split(op).wt_maps
    splits = project_splits(B, m, N, g.device)
    partials = torch.empty((splits, B, m), dtype=g.dtype, device=g.device)
    if B:
        a = tma_rows(g)
        _launch("rom_project", g, B, m, N, splits, a.data_ptr(), _pitch(a),
                ctypes.addressof(maps[0]), ctypes.addressof(maps[1]),
                partials.data_ptr())
        rom_project.launches += 1
    return partials


def rom_expand_f32(op: ROMOperators, eta_af):
    """:func:`rom_expand` in full float32 (``nl_precision="highest"``): a
    float32 FMA GEMM on the unsplit ``Phi`` (the operators' one-part
    :class:`SplitBasis`), fed by TMA like the tensor-core kernel."""
    if not _on_cuda(eta_af):
        return rom_expand_plain(op, eta_af)
    _build.refuse_grad("rom_expand_f32", eta_af)
    B, m = eta_af.shape
    phi_map = _split(op, 1).phi_maps[0]
    x = _padded_empty(B, op.n_rows, eta_af)
    if B:
        a = tma_rows(eta_af)
        _launch("rom_expand_f32", eta_af, B, m, op.n_rows, a.data_ptr(), _pitch(a),
                ctypes.addressof(phi_map), x.data_ptr(), _pitch(x))
        rom_expand_f32.launches += 1
    return x


def rom_project_f32(op: ROMOperators, g):
    """:func:`rom_project` in full float32 (``nl_precision="highest"``):
    ``(S, B, m)`` partial products of a float32 FMA GEMM on the unsplit
    ``W^T`` over ``S`` slices (:func:`project_splits_f32`)."""
    if not _on_cuda(g):
        return rom_project_plain(op, g)
    _build.refuse_grad("rom_project_f32", g)
    B, N = g.shape
    m = op.w.shape[1]
    wt_map = _split(op, 1).wt_maps[0]
    splits = project_splits_f32(B, m, N, g.device)
    partials = torch.empty((splits, B, m), dtype=g.dtype, device=g.device)
    if B:
        a = tma_rows(g)
        _launch("rom_project_f32", g, B, m, N, splits, a.data_ptr(), _pitch(a),
                ctypes.addressof(wt_map), partials.data_ptr())
        rom_project_f32.launches += 1
    return partials


def rom_update(op: ROMOperators, partials, eta, etad, etadd, a1, last: bool):
    """``g_m`` (the partials summed in slice order), the residual at ``a1``
    and the diagonal Newton update: returns ``a1 - sinv r``, or on the last
    iteration the new ``(eta, etad, etadd)``."""
    if not _on_cuda(partials):
        return rom_update_plain(op, partials, eta, etad, etadd, a1, last)
    _build.refuse_grad("rom_update", partials, eta, etad, etadd, a1)
    B, m = eta.shape
    outs = _state_out(op, eta, last)
    o = outs + [None] * (3 - len(outs))
    if B:
        _launch("rom_update", partials, B, m, partials.shape[0], _ptr(partials),
                _ptr(eta), _ptr(etad), _ptr(etadd), _ptr(a1), _ptr(op.lam),
                _ptr(op.u), _ptr(op.cd), _ptr(op.sinv), int(last),
                _ptr(o[0]), _ptr(o[1]), _ptr(o[2]), op.csc)
        rom_update.launches += 1
    return tuple(outs) if last else outs[0]


DENSE_MAX_MODES = 928  # the dense Newton kernel's r tile and ring fill 227 KB


def rom_newton_dense(op: ROMOperators, partials, eta, etad, etadd, a1, last: bool):
    """Dense modified-Newton update from the project's partials: ``g_m``
    summed in slice order and the residual ``r`` at ``a1`` (as
    :func:`rom_update` forms them), then ``a1 - r @ Sinv^T``; on the last
    iteration returns the new ``(eta, etad, etadd)``. One launch; ``r``
    stays in the kernel's shared memory."""
    if not _on_cuda(partials):
        return rom_newton_dense_plain(op, partials, eta, etad, etadd, a1, last)
    _build.refuse_grad("rom_newton_dense", partials, eta, etad, etadd, a1)
    B, m = eta.shape
    if m > DENSE_MAX_MODES:
        raise ValueError(f"the dense Newton kernel takes at most {DENSE_MAX_MODES} "
                         f"modes, got {m}")
    outs = _state_out(op, eta, last)
    o = outs + [None] * (3 - len(outs))
    if B:
        _launch("rom_newton_dense", partials, B, m, partials.shape[0], _ptr(partials),
                _ptr(eta), _ptr(etad), _ptr(etadd), _ptr(a1), _ptr(op.lam),
                _ptr(op.u), _ptr(op.cd), op.sinvT.data_ptr(), _pitch(op.sinvT),
                int(last), _ptr(o[0]), _ptr(o[1]), _ptr(o[2]), op.csc)
        rom_newton_dense.launches += 1
    return tuple(outs) if last else outs[0]


KERNELS = (rom_alpha_point, rom_expand, rom_correction_window,
           rom_correction_gathered, rom_project, rom_update, rom_newton_dense,
           rom_expand_f32, rom_project_f32)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    """Set every ROM kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Span loops
# ---------------------------------------------------------------------------


def _plain_correction(op, x):
    if op.gathered:
        return rom_correction_gathered_plain(op, x)
    return rom_correction_window_plain(op, x)


_KERNEL_PIECES = (rom_alpha_point, rom_expand, rom_correction, rom_project,
                  rom_update, rom_newton_dense)
_PLAIN_PIECES = (rom_alpha_point_plain, rom_expand_plain, _plain_correction,
                 rom_project_plain, rom_update_plain, rom_newton_dense_plain)


def _step(pieces, op, state, n_newton: int):
    """One modified-Newton generalized-α step of the fused recurrence."""
    alpha_point, expand, correction, project, update, newton_dense = pieces
    newton = update if op.sinv is not None else newton_dense
    eta, etad, etadd = state
    a1 = etadd
    for it in range(int(n_newton)):
        last = it == n_newton - 1
        g = correction(op, expand(op, alpha_point(op, eta, etad, etadd, a1)))
        a1 = newton(op, project(op, g), eta, etad, etadd, a1, last)
    return a1  # the new (eta, etad, etadd) after the last iteration


def _span(pieces, op, eta, etad, etadd, steps: int, n_newton: int):
    if n_newton < 1:
        raise ValueError(f"n_newton must be >= 1, got {n_newton}")
    s = (eta, etad, etadd)
    for _ in range(int(steps)):
        s = _step(pieces, op, s, n_newton)
    return s


def _frames(pieces, op, eta, etad, etadd, n_frames: int, substeps: int,
            n_newton: int):
    s = (eta, etad, etadd)
    qs, vs = [eta], [etad]
    for _ in range(int(n_frames)):
        s = _span(pieces, op, *s, substeps, n_newton)
        qs.append(s[0])
        vs.append(s[1])
    return torch.stack(qs), torch.stack(vs)


def rom_steps(op, eta, etad, etadd, steps: int, n_newton: int = 1):
    """``steps`` fused ROM steps through the kernel wrappers; returns the
    final ``(eta, etad, etadd)``, each ``(B, m)``."""
    return _span(_KERNEL_PIECES, op, eta, etad, etadd, steps, n_newton)


def rom_steps_plain(op, eta, etad, etadd, steps: int, n_newton: int = 1):
    """Plain twin of :func:`rom_steps`."""
    return _span(_PLAIN_PIECES, op, eta, etad, etadd, steps, n_newton)


def rom_frames(op, eta, etad, etadd, n_frames: int, substeps: int = 1,
               n_newton: int = 1):
    """Frame-collecting span: ``(etas, etads)`` of shape ``(F+1, B, m)``
    including the initial state."""
    return _frames(_KERNEL_PIECES, op, eta, etad, etadd, n_frames, substeps,
                   n_newton)


def rom_frames_plain(op, eta, etad, etadd, n_frames: int, substeps: int = 1,
                     n_newton: int = 1):
    """Plain twin of :func:`rom_frames`."""
    return _frames(_PLAIN_PIECES, op, eta, etad, etadd, n_frames, substeps,
                   n_newton)


# ---------------------------------------------------------------------------
# The engine-facing wrapper
# ---------------------------------------------------------------------------


class FusedROMRollout:
    """Fused ROM rollout of a :class:`ModalROMGenAlpha` (constant input, no
    external force), built by :meth:`ModalROMGenAlpha.make_pallas_rollout`.

    Host float64 operators are laid out once here; device uploads are
    memoized per device and dtype. ``tile`` and ``chunk`` are accepted for
    signature parity with the JAX package and unused: a span is a Python
    loop of kernel launches, and the state stays in the natural ``(B, m)``
    layout. The initial acceleration is the engine's plain
    ``initial_accel`` (torch ops, as the JAX package computes it outside
    its kernel).
    """

    def __init__(self, ms, tile: int = 256, chunk: int = 100):
        if ms.lam is None or ms.planar_correction is None:
            raise ValueError(
                "fused ROM rollout requires the split planar fast path "
                "(parity nonlinear/hybrid beam, no external forces)"
            )
        if ms.external_force is not None or ms.ext_modal is not None:
            raise ValueError(
                "fused ROM rollout does not support external forces; "
                "use ModalROMGenAlpha.rollout"
            )
        if ms.window_params is None and ms.sampled_params is None:
            raise ValueError(
                "engine has neither the contiguous-window nor the "
                "ECSW gathered-sample layout; use the plain rollout"
            )
        self.ms = ms
        self.gathered = ms.sampled_params is not None
        params = ms.sampled_params if self.gathered else ms.window_params
        f64 = lambda x: np.ascontiguousarray(np.asarray(x, np.float64))  # noqa: E731
        self._host = {
            "phiT": f64(np.asarray(ms.Phi_planar).T),
            "w": f64(ms.PhiW_planar),
            "lam": f64(ms.lam),
            "cd": None if ms.cdamp is None else f64(ms.cdamp),
            "sinv": None if ms.Sinv_diag is None else f64(ms.Sinv_diag),
            "sinvT": None if ms.Sinv_diag is not None else f64(np.asarray(ms.Sinv).T),
            "L": f64(params["length"]),
            "D": f64(params["EI"]),
            "A": f64(params["EA"]),
            "mask": f64(np.asarray(params["nonlinear_mask"], np.float64)),
        }
        self.m = self._host["lam"].shape[0]
        self._device_ops = {}
        self._splits = {}

    def operators(self, like: torch.Tensor, u_modal=None,
                  nl_precision=None) -> ROMOperators:
        """The device operators on ``like``'s device and dtype, with the
        constant modal force ``u_modal`` (None: zero) and the transforms'
        tier ``nl_precision`` (normalised, as :meth:`prepare` passes it).
        On the card the bases' K-major layouts and tensor maps are built on
        first use by a tier: the TF32 halves for a tensor-core tier, the
        unsplit bases for "highest" (:func:`split_basis`)."""
        key = (like.device, like.dtype)
        on_card = like.device.type == "cuda" and like.dtype == torch.float32
        base = self._device_ops.get(key)
        if base is None:
            up = {k: None if v is None else torch.tensor(
                v, dtype=like.dtype, device=like.device)
                for k, v in self._host.items()}
            if on_card and up["sinvT"] is not None:  # 16-byte rows for cp.async
                m = self.m
                sinvT = torch.zeros((m, _pad4(m)), dtype=like.dtype,
                                    device=like.device)[:, :m]
                up["sinvT"] = sinvT.copy_(up["sinvT"])
            if on_card:  # the correction kernels' factors, rounded once from float64
                h = self._host
                up["coef"] = torch.tensor(correction_table(h["L"], h["A"], h["mask"]),
                                          dtype=like.dtype, device=like.device)
            base = ROMOperators(
                **up, u=None, gathered=self.gathered,
                sc=step_scalars(float(self.ms.dt), float(self.ms.rho_inf)),
            )
            self._device_ops[key] = base
        split = None
        if on_card:
            tf32 = nl_precision != "highest"
            split = self._splits.get((key, tf32))
            if split is None:
                split = self._splits[key, tf32] = split_basis(base.phiT, base.w, tf32)
        if u_modal is None:
            u = torch.zeros(self.m, dtype=like.dtype, device=like.device)
        else:
            if isinstance(u_modal, torch.Tensor):
                u_modal = u_modal.detach().cpu().numpy()
            u = torch.as_tensor(np.asarray(u_modal, np.float64).reshape(self.m),
                                dtype=like.dtype, device=like.device)
        return dataclasses.replace(base, u=u, split=split, nl_precision=nl_precision)

    def prepare(self, eta, etad, u_modal, precision=None, nl_precision=None):
        """``(op, eta, etad, etadd, shape)``: the operators with the force
        and the transforms' tier (``nl_precision``, normalised), the state
        flattened to ``(B, m)`` and the initial acceleration, as a span
        starts from them (:func:`rom_steps` or its twin)."""
        precision, nl_precision = (p.lower() if isinstance(p, str) else p
                                   for p in (precision, nl_precision))
        for p in (precision, nl_precision):
            if p not in _PRECISIONS:
                raise ValueError(
                    f"precision must be one of {_PRECISIONS}, got {p!r}"
                )
        if callable(u_modal):
            raise ValueError("fused ROM rollout takes a constant input force")
        eta, etad = self.ms._tensor(eta), self.ms._tensor(etad)
        op = self.operators(eta, u_modal, nl_precision)
        shape = eta.shape
        eta = eta.reshape(-1, self.m).contiguous()
        etad = etad.reshape(-1, self.m).contiguous()
        etadd = self.ms.initial_accel(eta, etad, op.u).contiguous()
        return op, eta, etad, etadd, shape

    def __call__(self, eta, etad, u_modal, n_steps: int, n_newton: int = 1,
                 precision=None, nl_precision=None, unroll: int = 1):
        """Advance ``(eta, etad)`` by ``n_steps`` fused ROM gen-α steps;
        returns ``(eta, etad, etadd)``. ``u_modal``: constant modal force
        or None. ``unroll`` is accepted for signature parity and unused."""
        op, eta, etad, etadd, shape = self.prepare(eta, etad, u_modal,
                                                   precision, nl_precision)
        out = rom_steps(op, eta, etad, etadd, n_steps, n_newton)
        return tuple(x.reshape(shape) for x in out)

    def frames(self, eta, etad, u_modal, n_frames: int, substeps: int = 1,
               n_newton: int = 1, precision=None, nl_precision=None,
               unroll: int = 1):
        """Frame-collecting fused rollout (``rollout_frames`` contract):
        ``(ts (F+1,), etas (F+1, ..., m), etads (F+1, ..., m))`` including
        the initial state."""
        op, eta, etad, etadd, shape = self.prepare(eta, etad, u_modal,
                                                   precision, nl_precision)
        etas, etads = rom_frames(op, eta, etad, etadd, n_frames, substeps,
                                 n_newton)
        ts = (self.ms.dt * substeps) * torch.arange(
            int(n_frames) + 1, dtype=torch.float64, device=eta.device
        )
        frame_shape = (int(n_frames) + 1, *shape)
        return ts, etas.reshape(frame_shape), etads.reshape(frame_shape)

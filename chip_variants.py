#!/usr/bin/env python3
"""Build variants of the ROM kernels and time them on one card.

    python3 chip_variants.py                    # every float32 GEMM variant below
    python3 chip_variants.py base diag_noload   # some of them
    python3 chip_variants.py --correction       # every correction variant
    python3 chip_variants.py --correction corr_rows8 gath_rows4
    python3 chip_variants.py --drift            # the 3xTF32 span against float64
    python3 chip_variants.py --fused            # every fused small-beam variant
    python3 chip_variants.py --fused --tree DIR # another checkout's kernel and wrapper
    python3 chip_variants.py --modal            # every linear modal variant
    python3 chip_variants.py --modal --sass     # the modal kernels' FP32/FP64 mix
    python3 chip_variants.py --sass             # FFMA operands, correction mix (cuobjdump)
    python3 chip_variants.py --sass --source PATH/rom_rollout.cu   # another tree's

Each variant is ``continuum_robot_tpu_torch/ops/cuda/csrc/rom_rollout.cu``
with a few text replacements, compiled with the package's ``nvcc`` flags
into ``build/variants/``, one ``nvcc`` each, all started together. The
script then launches ``rom_expand_f32`` and ``rom_project_f32`` of each
variant through the package's wrappers (the wrappers' library swapped for
the variant's) at the ROM main path's shapes (B = 4096, m = 256, N = 3003,
seeded random operands) and prints, for each variant in turn and three
times over, the milliseconds a launch takes in 20 back-to-back launches
(CUDA events, best of 3) and whether its outputs equal ``base``'s bit for
bit; then ``torch.matmul`` of the same products, the SM clock and power
while the float32 expand runs, and each variant's ``-Xptxas -v`` line.

The ``diag_*`` variants compute wrong products on purpose: they take work
out of the kernel to show what bounds it (the shared-memory loads, the
waits on the TMA ring). A variant whose anchor text is gone from the
source is reported and skipped.

``--correction`` does the same for the two von Karman correction kernels
(``CORR_VARIANTS``: the rows a thread walks and loads at once, the
parent's dividing body on the new thread map, a body that only copies, FMA
contraction off) at the ROM main path's shapes (B = 4096; the window's
1001 nodes, an ECSW sample of 41 elements; seeded node states, the bench
beam's element parameters): each variant's device time per launch
(``torch.profiler``, 20 launches), its milliseconds in 20 back-to-back
launches (CUDA events, best of 3), its error against the float32 twin as
a fraction of the twin's scale, and whether its outputs equal
``corr_base``'s bit for bit; then torch's ``copy_`` of the same bytes
(the memory floor), and each variant's span drift against the twin on
``chip_smoke.py`` phase 7's small engines over eight input draws
(``span_drift``).

``--drift`` builds ``corr_base`` alone and prints its span drift
(``span_drift``) with, for each draw, the kernel span's and the float32
twin span's error against a float64 twin span from the same start and
their ratio: the bound of the 3xTF32 card test
``test_rom_kernels_match_plain_on_card`` holds that ratio.

``--fused`` does the same for the fused small-beam kernel
(``csrc/fused_rollout.cu`` with ``csrc/fused_geometry.h`` inlined,
``FUSED_VARIANTS``) at the fused path's shape (the water beam's operators,
20 steps a launch) at 4096 and 65536 envs, float32 and float64: each
variant's device time per launch (``torch.profiler``, 20 launches; and
``queued_ms``, CUDA events around 20 launches queued behind a spin of the
card, ``chip_smoke.queued_device_ms``), its milliseconds in 20 back-to-back
launches (CUDA events, best of 3), and at 4096 envs whether its output
equals the plain twin's bit for bit; where the tree has
``fused_gen_alpha_frames``, the same for the whole span (250 frames x 20
substeps, 4096 envs, float32) in one launch.

``--modal`` does the same for the linear modal kernels
(``csrc/modal_rollout.cu``, ``MODAL_VARIANTS``: the envs a step-kernel
thread carries, the step loop's unroll, the envs an affine thread carries,
the affine grid's waves, a block's shape; the frames kernel's substep
unroll and the SM load behind its choice of envs a thread, the frames
drive on a persistent grid, streaming frame stores; and diagnostic affine bodies that only load and store or
only compute) at the linear main path's shapes (4096 envs x 3000 modes of
a synthetic beam-like spectrum, float32): ``modal_steps`` over 2000 steps,
``affine_steps`` with 31 applications of a 64-step map, ``affine_drive``
(31 and a 16-step remainder), and the two frame drives at 10 frames x 20
substeps at 64 envs (``simulate``'s) and 4096: ``modal_frames`` with each
envs a thread (1, 2, 4), ``affine_frames`` with one map and (4096 envs)
with a schedule of three runs: each variant's device time per launch
(``torch.profiler``; and ``queued_ms``, launches queued behind a spin of
the card) and whether its outputs equal ``mbase``'s bit for bit;
``mbase``'s outputs against the plain twins (the steps over 50 steps, the
twin costing ten float64 torch operations a multiply-add); then the SM
clock and power while the step kernel runs. With ``--sass``: each modal kernel's count of FP32 and FP64
multiplies, adds and FMAs.

``--sass`` builds ``base`` alone, disassembles its two float32 kernels
with ``cuobjdump -sass`` and counts, over their FFMAs, those whose sources
all come from the register file (no operand held in the reuse cache from
the instruction before) and those that read two or more registers of one
parity (one bank, in a register file of two banks); and the instruction
mix of each kernel; for the two correction kernels their count of
instructions and of divisions (``MUFU.RCP``, ``FCHK`` and the ``CALL`` of
the division's slow path), FMAs, multiplies, adds, loads, stores,
shuffles and barriers. ``--source`` disassembles another copy of the
source (a parent's).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE = """    float4 a[2][8], b[2][8];
    load(stage, 0, a[0], b[0]);
#pragma unroll
    for (int c = 0; c < kSliceK / 4; ++c) {
      if (c + 1 < kSliceK / 4) load(stage, c + 1, a[(c + 1) & 1], b[(c + 1) & 1]);
      fma4(a[c & 1], b[c & 1]);
    }"""
SLICE_SINGLE = """    float4 a[8], b[8];
#pragma unroll
    for (int c = 0; c < kSliceK / 4; ++c) {
      load(stage, c, a, b);
      fma4(a, b);
    }"""
SLICE_ROLLED = SLICE_SINGLE.replace("#pragma unroll\n", "#pragma unroll 1\n")
SLICE_NOLOAD = """    float4 a[8], b[8];
    load(stage, 0, a, b);
#pragma unroll
    for (int c = 0; c < kSliceK / 4; ++c) fma4(a, b);"""
WAIT = """      mbar_wait(full0 + 8 * stage, phase);
      c.slice("""
WAIT_FIRST = """      if (u == blockIdx.x && k0 == z * s.k_chunk) mbar_wait(full0 + 8 * stage, phase);
      c.slice("""
STAGES = "  static constexpr int kStages = 6;"
FMA_X = """#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);"""

VARIANTS = {
    "base": [],
    # fragments loaded once per slice, not once per 4 k: no shared-memory traffic
    "diag_noload": [(SLICE, SLICE_NOLOAD)],
    # the consumers wait on the ring only for a block's first slice
    "diag_nofeed": [(WAIT, WAIT_FIRST)],
    "diag_nofeed_noload": [(WAIT, WAIT_FIRST), (SLICE, SLICE_NOLOAD)],
    "single_buffer": [(SLICE, SLICE_SINGLE)],
    "rolled": [(SLICE, SLICE_ROLLED)],
    "stages4": [(STAGES, STAGES.replace("6", "4"))],
    "stages7": [(STAGES, STAGES.replace("6", "7"))],
    "j_outer_x": [(FMA_X, FMA_X.replace("int i = 0; i < 8; ++i)", "int @ = 0; @ < 8; ++@)")
                   .replace("int j = 0; j < 8; ++j)", "int i = 0; i < 8; ++i)")
                   .replace("int @ = 0; @ < 8; ++@)", "int j = 0; j < 8; ++j)"))],
    "regs240": [("constexpr int kProducerRegs = 40, kConsumerRegs = 232;",
                 "constexpr int kProducerRegs = 24, kConsumerRegs = 240;")],
}


CORR_BODY_START = "  const float dw = w1 - w2;\n  const float du = u1 - u2;\n"
CORR_BODY_END = "  g[5] = g6;\n}\n"
# The first port's correction body, dividing by L and by the constants; the
# variant reads L, A and mask from the first three rows of its table.
DIVIDING_BODY = """  const float L = c[0], A = c[1], mask = c[2];
  const float dw = w1 - w2;
  const float du = u1 - u2;
  const float s = t1 + t2;
  const float t1t2 = t1 * t2;
  const float tsq = t1 * t1 + t2 * t2;
  const float dw2 = dw * dw;
  const float dw3 = dw2 * dw;
  const float invL = 1.0f / L;
  const float invL2 = invL * invL;
  const float invL3 = invL2 * invL;
  const float g1 = A * (-tsq / 15.0f + t1t2 / 30.0f + s * u2 * (invL / 20.0f) +
                        s * dw * (invL / 10.0f) - 0.6f * u2 * dw * invL2 -
                        0.6f * dw2 * invL2);
  const float g2 = A * (tsq / 15.0f - t1t2 / 30.0f - s * dw * (invL / 10.0f) +
                        0.6f * dw2 * invL2);
  const float t3sum = t1 * t1 * t1 + t2 * t2 * t2;
  const float g3 = A * (t3sum / 280.0f - 3.0f * t1t2 * s / 280.0f +
                        (9.0f / 70.0f) * tsq * dw * invL + du * s * (invL / 10.0f) -
                        (27.0f / 70.0f) * s * dw2 * invL2 - 1.2f * du * dw * invL2 +
                        (36.0f / 35.0f) * dw3 * invL3);
  const float g4 = A * (L * (t1 * t1 * t1) / 35.0f - 3.0f * L * t1 * t1 * t2 / 280.0f +
                        L * t1 * t2 * t2 / 140.0f - L * (t2 * t2 * t2) / 280.0f +
                        (3.0f / 280.0f) * dw * (t1 * t1 - 2.0f * t1t2 - t2 * t2) -
                        (2.0f / 15.0f) * t1 * du + t2 * du / 30.0f +
                        (9.0f / 70.0f) * t1 * dw2 * invL + du * dw * (invL / 10.0f) -
                        (9.0f / 70.0f) * dw3 * invL2);
  const float g6 = A * (-L * (t1 * t1 * t1) / 280.0f + L * t1 * t1 * t2 / 140.0f -
                        3.0f * L * t1 * t2 * t2 / 280.0f + L * (t2 * t2 * t2) / 35.0f +
                        (3.0f / 280.0f) * dw * (-t1 * t1 - 2.0f * t1t2 + t2 * t2) +
                        t1 * du / 30.0f - (2.0f / 15.0f) * t2 * du +
                        (9.0f / 70.0f) * t2 * dw2 * invL + du * dw * (invL / 10.0f) -
                        (9.0f / 70.0f) * dw3 * invL2);
  g[0] = mask * g1;
  g[1] = mask * g3;
  g[2] = mask * g4;
  g[3] = mask * g2;
  g[4] = mask * -g3;
  g[5] = mask * g6;
}
"""
COPY_BODY = """  g[0] = u1;
  g[1] = w1;
  g[2] = t1;
  g[3] = u2;
  g[4] = w2;
  g[5] = t2;
}
"""


def body(new):
    """A variant that swaps the body of the correction device function."""
    def swap(src):
        a, b = src.find(CORR_BODY_START), src.find(CORR_BODY_END)
        if a < 0 or b < a:
            return None
        return src[:a] + new + src[b + len(CORR_BODY_END):]
    return swap


ROWS = "constexpr int kCorrRows = 16;"
BATCH = "constexpr int kCorrBatch = 4;"
GATH = "constexpr int kGathRows = 1;"
CORR_VARIANTS = {
    "corr_base": [],
    "corr_rows4": [(ROWS, ROWS.replace("16", "4"))],
    "corr_rows8": [(ROWS, ROWS.replace("16", "8"))],
    "corr_rows32": [(ROWS, ROWS.replace("16", "32"))],
    "corr_batch1": [(BATCH, BATCH.replace("4", "1"))],
    "corr_batch2": [(BATCH, BATCH.replace("4", "2"))],
    "corr_batch8": [(BATCH, BATCH.replace("4", "8"))],
    "corr_rows4_batch2": [(ROWS, ROWS.replace("16", "4")), (BATCH, BATCH.replace("4", "2"))],
    # the parent's dividing body on the new thread maps
    "corr_divide": body(DIVIDING_BODY),
    # node states copied to the slots: the loads, shuffles and stores alone
    "diag_corr_copy": body(COPY_BODY),
    "gath_rows2": [(GATH, GATH.replace("1", "2"))],
    "gath_rows4": [(GATH, GATH.replace("1", "4"))],
    "gath_rows8": [(GATH, GATH.replace("1", "8"))],
    # the same with nvcc's FMA contraction off (the whole source)
    "corr_base_nofma": [],
    "corr_divide_nofma": body(DIVIDING_BODY),
}
VARIANT_FLAGS = {"corr_base_nofma": ("-fmad=false",), "corr_divide_nofma": ("-fmad=false",)}

ENVS = "constexpr int kEnvs = sizeof(T) == 4 ? 2 : 3;"
PAIRS = "constexpr int kPairs = 128;"
# The thread map's constants (csrc/fused_geometry.h, inlined into the source):
# (float, double) environments a thread, or (row, env group) pairs a block
# ("fbase": the source's own, 2 and 3 at 128 pairs).
FUSED_VARIANTS = {
    "fbase": [],
    **{f"e{f}": [(ENVS, ENVS.replace("2 : 3", f"{f} : {d}"))]
       for f, d in ((1, 1), (3, 2), (4, 2), (5, 4), (8, 4))},
    **{f"p{n}": [(PAIRS, PAIRS.replace("128", str(n)))] for n in (64, 96, 144, 192, 256)},
}

# The linear modal kernels' thread-map constants and their values in the source.
MODAL_KNOBS = {"kStepEnvs": 4, "kStepUnroll": 8, "kFramesUnroll": 10, "kAffineEnvs": 1,
               "kAffineWaves": 4, "kFrameBlocksPerSm": 2, "kModesX": 32, "kGroupsY": 8}
APPS_LOOP = "    for (int k = 0; k < apps; ++k) map.apply(q, v, a);"


def knobs(**values):
    """Replacements setting thread-map constants."""
    return [(f"constexpr int {k} = {MODAL_KNOBS[k]};", f"constexpr int {k} = {v};")
            for k, v in values.items()]


AFFINE_LOADS = [(f"{x}[j] = b < B ? {y}[i] : T(0);", f"{x}[j] = T(b);")
                for x, y in (("nq", "q0"), ("nv", "v0"), ("na", "a0"))]
AFFINE_STORE = ("    if (rtmat != nullptr) AffineMap<T>(rtmat, rbvec, mode).apply(q, v, a);\n"
                "#pragma unroll\n    for (int j = 0; j < E; ++j) {\n"
                "      const int64_t b = g * E + j;\n      if (b < B) {")
FRAMES_E4 = "    case 4: return launch_frames<T, DAMPED, 4>(B, m, args...);"
FRAMES_GRID = "  const dim3 grid = group_grid(EnvGroups<E>::groups(B), m, kMaxGridY);\n  modal_frames"
AFFINE_FRAMES_GRID = "  const dim3 grid = group_grid(B, m, kMaxGridY);\n  affine_frames_kernel"
# The two frames kernels' per-frame stores (modal_frames, the frames drive)
FRAME_STORES = ["          qs[i] = q[j];\n          vs[i] = v[j];",
                "      qs[f * n + i] = q[0];\n      vs[f * n + i] = v[0];"]
FRAME_STORES_CS = ["          __stcs(qs + i, q[j]);\n          __stcs(vs + i, v[j]);",
                   "      __stcs(qs + f * n + i, q[0]);\n      __stcs(vs + f * n + i, v[0]);"]
FRAME_IFS = ["        if (b < B) {\n          const int64_t i = f * n + b * m + mode;",
             "      map.apply(q, v, a);\n      qs[f * n + i]"]
FRAME_IFS_LAST = [FRAME_IFS[0].replace("b < B", "b < B && f == n_frames"),
                  FRAME_IFS[1].replace("      qs[f", "      if (f < n_frames) continue;\n      qs[f")]
# "mbase": the source's own; "w1000": one env group a thread, so no group's
# loads overlap another's arithmetic. The diag_* variants compute wrong
# results on purpose: "diag_noapps" only loads and stores (the affine
# kernels' memory time alone), "diag_nomem" only computes (no state loads,
# a store only where q is 0.125, which it never is here).
MODAL_VARIANTS = {
    "mbase": [],
    "s1": knobs(kStepEnvs=1, kStepUnroll=4),
    "s2": knobs(kStepEnvs=2),
    "s8": knobs(kStepEnvs=8),
    **{f"unroll{k}": knobs(kStepUnroll=k) for k in (4, 16)},
    **{f"a{k}": knobs(kAffineEnvs=k) for k in (2, 4)},
    **{f"w{k}": knobs(kAffineWaves=k) for k in (1, 2, 8, 1000)},
    "g4": knobs(kGroupsY=4),
    "x64": knobs(kModesX=64, kGroupsY=4),
    "diag_noapps": [(APPS_LOOP, APPS_LOOP.replace("k < apps", "k < 0"))],
    **{f"diag_nomem{suffix}": AFFINE_LOADS + [(AFFINE_STORE, AFFINE_STORE.replace(
        "if (b < B) {", "if (b < B && q[j] == T(0.125)) {"))] + knobs(**kw)
       for suffix, kw in (("", {}), ("_a2", {"kAffineEnvs": 2}),
                          ("_a4", {"kAffineEnvs": 4}))},
    "a2_w2": knobs(kAffineEnvs=2, kAffineWaves=2),
    "a4_w2": knobs(kAffineEnvs=4, kAffineWaves=2),
    # the frames kernels: the substep loop's unroll; the batch's choice of
    # envs a thread with a block an SM (mf_bps1); the frames drive on a
    # persistent grid of 1, 2, 4 waves; streaming (evict-first) frame stores
    **{f"fu{k}": knobs(kFramesUnroll=k) for k in (4, 5, 20)},
    "mf_bps1": knobs(kFrameBlocksPerSm=1),
    **{f"afw{k}": [(AFFINE_FRAMES_GRID, AFFINE_FRAMES_GRID.replace(
        "kMaxGridY", f"wave_rows(affine_frames_kernel<T>, (m + kModesX - 1) / kModesX, {k})"))]
       for k in (1, 2, 4)},
    # modal_frames: 8 envs a thread where 4 is asked for; a grid of the
    # blocks one wave holds, each thread walking several env groups
    "mf_e4_is_8": [(FRAMES_E4, FRAMES_E4.replace("4>(B", "8>(B"))],
    "mf_persistent": [(FRAMES_GRID, FRAMES_GRID.replace(
        "kMaxGridY", "wave_rows(modal_frames_kernel<T, DAMPED, E>, (m + kModesX - 1) / kModesX, 1)"))],
    "stcs": list(zip(FRAME_STORES, FRAME_STORES_CS)),
    # the frames kernels store only the last frame: their arithmetic and
    # first stores alone (wrong frames on purpose)
    "diag_lastframe": list(zip(FRAME_IFS, FRAME_IFS_LAST)),
}

def inline_headers(src: str, source) -> str:
    """The source with each ``#include "x.h"`` of a header beside it
    replaced by the header's text, so a variant can change the header's
    constants and builds from one file."""
    here = os.path.dirname(os.path.abspath(source))

    def text(m):
        path = os.path.join(here, m.group(1))
        return open(path).read() if os.path.exists(path) else m.group(0)

    return re.sub(r'^#include "([^"]+)"$', text, src, flags=re.M)


def variant_text(spec, src):
    """The source with a variant's replacements, or None if an anchor is
    not found once."""
    if callable(spec):
        return spec(src)
    for old, new in spec:
        if src.count(old) != 1:
            return None
        src = src.replace(old, new)
    return src


def kernel_tag(line: str) -> str:
    """``"<kernel><template arguments>: "`` from a ptxas "Compiling entry
    function '_Z...'" line, as the mangled name spells them (``IfLb1ELi4E``:
    float, true, 4), or nothing for a name it does not recognise."""
    m = re.search(r"(?<=\d)([a-z]+(?:_[a-z0-9]+)*_kernel)(I[A-Za-z0-9]*?E)E*v", line)
    return f"{m.group(1)}{m.group(2)}: " if m else ""


def build(names, src, flags, nvcc, out_dir, variants=None):
    """``{name: (library path, ptxas line)}`` of the variants that apply."""
    variants = VARIANTS if variants is None else variants
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = variant_text(variants[name], src)
        if text is None:
            print(f"{name}: anchor not found once in the source, skipped", flush=True)
        else:
            path = os.path.join(out_dir, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            cmd = [nvcc, *flags, *VARIANT_FLAGS.get(name, ()), "-o", path[:-3] + ".so", path]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-2000:]}", flush=True)
            continue
        lines = log.splitlines()
        info = [kernel_tag(ln) + lines[i + 2].strip() + " | "
                + lines[i + 3].split(":")[-1].strip()
                for i, ln in enumerate(lines) if "Compiling" in ln
                and any(k in ln for k in ("f32_kernel", "correction", "fused", "modal",
                                          "affine"))]
        built[name] = (os.path.join(out_dir, f"{name}.so"), "; ".join(info))
    return built


CORR_OPS = ("MUFU.RCP", "FCHK", "CALL", "FFMA", "FMUL", "FADD", "LDG", "STG", "SHFL", "LDS",
            "STS", "BAR")
FUSED_OPS = ("FMUL", "FADD", "FFMA", "DMUL", "DADD", "DFMA", "LDS", "STS", "LDG", "STG", "BAR",
             "BRA")


def sass_stats(so_path: str) -> None:
    """``--sass``: see the module's docstring."""
    import collections
    import re

    text = subprocess.run(["cuobjdump", "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n")[0]
        corr = re.search(r"(correction_\w+_kernel)", name)
        fused = re.search(r"fused_rows_kernelI([fd])Li18ELi(\d+)", name)
        modal = re.search(r"(modal_steps_kernel|modal_frames_kernel|affine_kernel)I([fd])Lb(\d)",
                          name)
        if "f32_kernel" not in name and not corr and not fused and not modal:
            continue
        ops, ffma = collections.Counter(), collections.Counter()
        held = set()  # (slot, register) the previous instruction kept in the reuse cache
        for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", func):
            ins = re.sub(r"^@!?U?P\w+\s+", "", ins.strip())
            op = ins.split()[0]
            ops[op.split(".")[0]] += 1
            ops[".".join(op.split(".")[:2])] += op.startswith("MUFU")
            if not op.startswith("FFMA"):
                held = set()
                continue
            srcs = [p.strip() for p in ins[len(op):].split(",")][1:]
            reads = [int(p.split(".")[0][1:]) for slot, p in enumerate(srcs)
                     if re.match(r"R\d", p) and (slot, p.split(".")[0]) not in held]
            held = {(slot, p.split(".")[0]) for slot, p in enumerate(srcs) if ".reuse" in p}
            ffma["all"] += 1
            ffma["no operand reused"] += len(reads) == 3
            parity = collections.Counter(r % 2 for r in reads)
            ffma["two reads in one bank"] += bool(parity) and max(parity.values()) > 1
        total = sum(v for k, v in ops.items() if "." not in k)
        if modal:
            flag = "damped" if "affine" not in modal.group(1) else "drive"
            print(f"sass {modal.group(1)}<{'float' if modal.group(2) == 'f' else 'double'}, "
                  f"{flag}={modal.group(3)}>: instructions {total}; "
                  + ", ".join(f"{k} {ops[k]}" for k in FUSED_OPS), flush=True)
            continue
        if fused:
            print(f"sass fused_rows_kernel<{'float' if fused.group(1) == 'f' else 'double'}, "
                  f"n = 18, E = {fused.group(2)}>: instructions {total}; "
                  + ", ".join(f"{k} {ops[k]}" for k in FUSED_OPS), flush=True)
            continue
        if corr:
            print(f"sass {corr.group(1)}: instructions {total}; "
                  + ", ".join(f"{k} {ops[k]}" for k in CORR_OPS), flush=True)
            continue
        kernel = re.search(r"(rom_\w+_f32_kernel)", name).group(1)
        print(f"sass {kernel}: FFMA {dict(ffma)}; instructions {total}, "
              f"most common {ops.most_common(8)}", flush=True)


def device_ms(fn, dev, n: int = 20) -> float:
    """Device milliseconds per call of ``fn`` (one kernel a call) under
    ``torch.profiler``: the kernels' time over the launches the trace
    holds, which may miss some (taken again, up to three times, when it
    holds none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize(dev)
        total, launches = 0.0, 0
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                dev_us = getattr(ev, "self_device_time_total", None)
                total += ev.self_cuda_time_total if dev_us is None else dev_us
                launches = max(launches, ev.count)
        if launches:
            return total / 1e3 / launches
    raise RuntimeError("the profiler recorded no device time")


def events_ms(fn, dev, n: int = 20) -> float:
    """Milliseconds per call of ``fn`` in ``n`` back-to-back calls (CUDA
    events, best of 3)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(3):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def dividing_table(op):
    """The table the ``corr_divide`` variants read: L, A and mask in its
    first rows."""
    import torch

    table = torch.zeros_like(op.coef)
    table[0], table[1], table[2] = op.L, op.A, op.mask
    return table


def time_corrections(libs, rk, dev, card) -> None:
    """``--correction``: see the module's docstring."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    B, n_sub, s = 4096, 1001, 41
    L, A = 0.25 / 6, 75e9 * np.pi * 0.005**2  # the bench beam's elements

    def op_of(E, gathered, table=None):
        e = np.ones(E)
        table = rk.correction_table(L * e, A * e, e) if table is None else table
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        return rk.ROMOperators(phiT=None, w=None, lam=None, u=None, cd=None, sinv=None,
                               sinvT=None, L=t(L * e), D=t(e), A=t(A * e), mask=t(e),
                               gathered=gathered, sc=(0.0,) * 9, coef=t(table))

    def dividing(op):
        return dataclasses.replace(op, coef=dividing_table(op))

    def states(E, blocks):
        x = np.concatenate([rng.normal(scale=sc, size=(B, E))
                            for sc in (1e-4, 1e-3, 1e-2) * (blocks // 3)], axis=1)
        return rk.tma_rows(torch.tensor(x, dtype=torch.float32, device=dev))

    cases = {"window": (rk.rom_correction_window, op_of(n_sub - 1, False), states(n_sub, 3),
                        rk.rom_correction_window_plain),
             "gathered": (rk.rom_correction_gathered, op_of(s, True), states(s, 6),
                          rk.rom_correction_gathered_plain)}
    ref = {}
    for name, lib in list(libs.items()) * 3:
        rk._lib = lib
        row = {}
        for case, (kern, op, x, plain) in cases.items():
            o = dividing(op) if name.startswith("corr_divide") else op
            out = kern(o, x)
            twin = plain(op, x)
            ref.setdefault(case, out.clone())
            row[case] = dict(device_ms=device_ms(lambda: kern(o, x), dev),
                             events_ms=events_ms(lambda: kern(o, x), dev),
                             vs_twin=float((out - twin).abs().max() / twin.abs().max()),
                             same_as_base=bool(torch.equal(out, ref[case])))
        print(f"[{card}] {name}: " + json.dumps(row), flush=True)
    for case, (_, _, x, _) in cases.items():  # the memory floor of a library copy
        out = rk._padded_empty(*x.shape, x)
        print(f"[{card}] torch copy_ ({case}): device_ms "
              f"{device_ms(lambda: out.copy_(x), dev):.5f}", flush=True)
    span_drift(libs, rk, dev, card)


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its set-up helpers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def time_fused(libs, dev, card) -> None:
    """``--fused``: see the module's docstring."""
    import numpy as np
    import torch

    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import fused_rollout as kf

    cs = smoke()
    F = cs.FUSED
    beam = cs.reference_beam(crt)
    mats, c_drag, u, x_main, h = cs.fused_main_case(kf, beam)
    kw = dict(rho_inf=F["rho_inf"], n_newton=F["n_newton"])
    cases = {}
    for envs in (F["envs"], F["big_envs"]):
        for dtype in (torch.float32, torch.float64):
            t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731, B023
            cases[f"{envs}_{str(dtype)[6:]}"] = (
                tuple(t(A) for A in mats), t(c_drag), t(u),
                t(np.tile(x_main, (envs // F["envs"], 1))), F["substeps"], h)
    twins = {k: kf.fused_gen_alpha_steps_plain(*a, **kw) for k, a in cases.items()
             if k.startswith(f"{F['envs']}_")}
    frames = int(round(F["t_final"] / F["dt"]))
    for name, lib in list(libs.items()) * 3:
        _build._libs["fused_rollout"] = lib  # the wrapper reads its thread map from it too
        row = {}
        for key, args in cases.items():
            run = lambda: kf.fused_gen_alpha_steps(*args, **kw)  # noqa: E731, B023
            out = run()
            row[key] = dict(device_ms=device_ms(run, dev), events_ms=events_ms(run, dev),
                            queued_ms=cs.queued_device_ms(run, dev, n=20))
            if key in twins:
                row[key]["equal_twin"] = bool(torch.equal(out, twins[key]))
        if hasattr(kf, "fused_gen_alpha_frames"):
            mt, ct, ut, xt, sub, _ = cases[f"{F['envs']}_float32"]
            run = lambda: kf.fused_gen_alpha_frames(mt, ct, ut, xt, frames, sub, h, **kw)  # noqa: E731
            row[f"frames_{F['envs']}_float32"] = dict(device_ms=device_ms(run, dev, n=3),
                                                      events_ms=events_ms(run, dev, n=3),
                                                      queued_ms=cs.queued_device_ms(run, dev, n=3))
        print(f"[{card}] {name}: " + json.dumps(row), flush=True)


def time_modal(libs, dev, card) -> None:
    """``--modal``: see the module's docstring."""
    import numpy as np
    import torch

    from continuum_robot_tpu_torch.models import simulate as sim
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as kr

    cs = smoke()
    rng = np.random.default_rng(0)
    B, m, steps, K = cs.N_ENVS, cs.N_MODES_FULL, cs.N_STEPS, cs.K_POWER
    ms = cs.synthetic_engine(m, rng, damped=False)

    def normal(scale, *shape):
        return torch.tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32,
                            device=dev)

    eta, etad, u = normal(1e-6, B, m), normal(1e-6, B, m), normal(1e-3, m)
    lam, winv, _ = ms._stepper_consts(eta)
    a0 = kr.initial_accel(lam, u, None, eta, etad)
    u64 = u.double().cpu().numpy()
    P, b = ms._power_map_device(K, u64, eta)
    Pr, br = ms._power_map_device(steps % K, u64, eta)
    apps = steps // K
    # The frame drives at simulate's shape (SIM's envs) and at full width,
    # 10 frames x 20 substeps: modal_frames with each envs a thread, the
    # frames drive with the engine's memoized arguments (one map; and a
    # schedule of three runs, its break inside frame 4).
    F, sub = cs.SIM["frames"], cs.SIM["substeps"]

    coeffs = ms._frames_consts(u64, eta)[3]
    power_args = ms._frames_power_args(u64, F, sub, eta)
    pwc = sim.PiecewiseConstant(((4 * sub + 9.5) * cs.DT,), np.stack([u64, -0.5 * u64]))
    pwc_args = ms._frames_power_args(pwc, F, sub, eta)
    frames, plains = {}, {}  # {case: (run, twin's key)}, {twin's key: twin}
    for envs in (cs.SIM["envs"], B):
        e, ed = eta[:envs], etad[:envs]
        for E in cs.FRAME_ENVS:
            frames[f"modal_frames_{envs}_e{E}"] = (
                lambda e=e, ed=ed, E=E: kr.modal_frames(
                    lam, winv, u, e, ed, F, sub, cs.DT, cs.RHO_INF, coeffs=coeffs, envs=E),
                f"modal_frames_{envs}")
        plains[f"modal_frames_{envs}"] = lambda e=e, ed=ed: kr.modal_frames_plain(
            lam, winv, u, e, ed, F, sub, cs.DT, cs.RHO_INF)
        frames[f"affine_frames_{envs}"] = (
            lambda e=e, ed=ed: kr.affine_frames(*power_args[:5], e, ed, power_args[5]),
            f"affine_frames_{envs}")
        plains[f"affine_frames_{envs}"] = lambda e=e, ed=ed: kr.affine_frames_plain(
            *power_args[:5], e, ed, power_args[5])
    frames[f"affine_frames_{B}_schedule"] = (
        lambda: kr.affine_frames(*pwc_args[:5], eta, etad, pwc_args[5]),
        f"affine_frames_{B}_schedule")
    plains[f"affine_frames_{B}_schedule"] = lambda: kr.affine_frames_plain(
        *pwc_args[:5], eta, etad, pwc_args[5])
    cases = {
        "modal_steps": lambda: kr.modal_steps(lam, winv, u, eta, etad, a0, steps, cs.DT,
                                              cs.RHO_INF),
        "affine_steps": lambda: kr.affine_steps(P, b, eta, etad, a0, apps),
        "affine_drive": lambda: kr.affine_drive(lam, u, None, P, b, eta, etad, apps, Pr, br),
        # the step kernel over the frames' 200 steps: their arithmetic, no frames
        "modal_steps_200": lambda: kr.modal_steps(lam, winv, u, eta, etad, a0, F * sub, cs.DT,
                                                  cs.RHO_INF),
        **{k: run for k, (run, _) in frames.items()},
    }
    _build._libs["modal_rollout"] = libs["mbase"]
    base = {k: run() for k, run in cases.items()}
    short = kr.modal_steps(lam, winv, u, eta, etad, a0, 50, cs.DT, cs.RHO_INF)
    twins = {
        "modal_steps (50 steps)": (short, kr.modal_steps_plain(lam, winv, u, eta, etad, a0, 50,
                                                               cs.DT, cs.RHO_INF)),
        "affine_steps": (base["affine_steps"], kr.affine_steps_plain(P, b, eta, etad, a0, apps)),
        "affine_drive": (base["affine_drive"], kr.affine_drive_plain(lam, u, None, P, b, eta,
                                                                     etad, apps, Pr, br)),
    }
    for key, fn in plains.items():
        ref = fn()
        twins.update({k: (base[k], ref) for k, (_, of) in frames.items() if of == key})
        del ref
    print(f"[{card}] mbase equals the plain twin bit for bit: " + json.dumps(
        {k: all(torch.equal(x, y) for x, y in zip(*v)) for k, v in twins.items()}), flush=True)
    del twins
    for name, lib in list(libs.items()) * 2:
        _build._libs["modal_rollout"] = lib
        row = {}
        for key, run in cases.items():
            out = run()
            n = 5 if key == "modal_steps" else 20
            row[key] = dict(device_ms=device_ms(run, dev, n=n),
                            queued_ms=cs.queued_device_ms(run, dev, n=n),
                            same_as_base=all(torch.equal(x, y) for x, y in zip(out, base[key])))
        print(f"[{card}] {name}: " + json.dumps(row), flush=True)

    _build._libs["modal_rollout"] = libs["mbase"]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < 3.0:
        for _ in range(20):
            cases["modal_steps"]()
        torch.cuda.synchronize(dev)
    smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    print(f"[{card}] SM clock, power during modal_steps: {samples[-5:]}", flush=True)


def span_drift(libs, rk, dev, card, seeds=8, f64=False) -> None:
    """Each variant's ROM spans against the plain twin's on
    ``chip_smoke.py`` phase 7's small engines (8-element nonlinear and
    hybrid beams; 5 envs at amplitude 3e-2, 50 steps, 2 Newton iterations;
    seed 0 is phase 7's draw): the largest ``max|kernel - plain|`` over
    each output's scale, by case, for each of ``seeds`` draws; and the
    largest ratio, over the outputs, of the kernel span's error against a
    float64 twin span from the same start to the float32 twin span's (each
    draw's errors too, with ``f64``)."""
    import numpy as np
    import torch

    import continuum_robot_tpu_torch as crt

    cs = smoke()
    small = cs.ROM_SMALL
    engines = cs.small_rom_engines(crt, dev)
    starts = []
    for seed in range(seeds):
        rng = np.random.default_rng(6 + seed)  # phase 7's generator at seed 0
        for case, (model, ms) in engines.items():
            eta = torch.tensor(rng.normal(scale=small["amp"], size=(small["B"], ms.n_modes)),
                               dtype=torch.float32, device=dev)
            u = np.zeros(model.n_pos_states)
            u[-2] = 5.0
            fused = ms.make_pallas_rollout()
            u_m = ms.project_force_host(u)
            op, e, ed, a0, _ = fused.prepare(eta, torch.zeros_like(eta), u_m)
            ref = rk.rom_steps_plain(op, e, ed, a0, small["steps"], small["n_newton"])
            exact = rk.rom_steps_plain(fused.operators(e.double(), u_m), e.double(),
                                       ed.double(), a0.double(), small["steps"],
                                       small["n_newton"])
            starts.append((case, op, (e, ed, a0), ref, exact))
    base, launch = libs["corr_base"], rk._launch

    def corr_only(lib):  # the variant's correction kernels, the base's others
        def call(name, *args):
            rk._lib = lib if "correction" in name else base
            return launch(name, *args)
        return call

    def vs_exact(out, exact):  # each output's largest error, over its float64 scale
        return [float((o.double() - x).abs().max() / x.abs().max())
                for o, x in zip(out, exact)]

    for name, lib in libs.items():
        rk._launch = corr_only(lib)
        drift, ratio = {}, {}
        for case, op, st, ref, exact in starts:
            if name.startswith("corr_divide"):
                op = dataclasses.replace(op, coef=dividing_table(op))
            out = rk.rom_steps(op, *st, small["steps"], small["n_newton"])
            drift.setdefault(case, []).append(float(f"{cs.scaled_err(out, ref):.3e}"))
            k_err, t_err = vs_exact(out, exact), vs_exact(ref, exact)
            ratio.setdefault(case, []).append(float(f"{max(k / t for k, t in zip(k_err, t_err)):.3g}"))
            if f64:
                print(f"[{card}] {name} {case} draw {len(drift[case]) - 1} vs float64 "
                      f"(eta, etad, etadd): kernel {['%.3e' % v for v in k_err]}, float32 "
                      f"twin {['%.3e' % v for v in t_err]}", flush=True)
        print(f"[{card}] {name} span drift by draw (phase 7's limit {cs.ROM_SMALL_MAX}): "
              + json.dumps(drift), flush=True)
        print(f"[{card}] {name} largest (kernel vs float64) / (twin vs float64) over "
              f"eta, etad, etadd, by draw: " + json.dumps(ratio), flush=True)
    rk._launch = launch


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    sys.path.insert(0, HERE)
    if "--tree" in args:  # another checkout's package, its wrappers and sources
        i = args.index("--tree")
        sys.path.insert(0, os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

    sass, corr, drift, fused, modal = (flag in args for flag in
                                       ("--sass", "--correction", "--drift", "--fused",
                                        "--modal"))
    lib_name = "fused_rollout" if fused else "modal_rollout" if modal else "rom_rollout"
    source = _build.SOURCES[lib_name]
    if "--source" in args:
        i = args.index("--source")
        source = args[i + 1]
        del args[i:i + 2]
    args = [a for a in args if not a.startswith("--")]
    corr = corr or drift
    variants = (FUSED_VARIANTS if fused else MODAL_VARIANTS if modal else
                CORR_VARIANTS if corr else VARIANTS)
    first = ("fbase" if fused else "mbase" if modal else
             "corr_base" if corr and not sass else "base")
    names = [first] if sass or drift else args or list(variants)
    if first not in names:
        names = [first, *names]
    with open(source) as f:
        src = inline_headers(f.read(), source)
    built = build(names, src, _build.NVCC_FLAGS, _build._nvcc(),
                  os.path.join(HERE, "build", "variants"), variants)
    if sass:
        print(f"ptxas {first}: {built[first][1]}", flush=True)
        sass_stats(built[first][0])
        return 0
    libs = {}
    for name, (path, info) in built.items():
        print(f"ptxas {name}: {info}", flush=True)
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in _build._SIGNATURES[lib_name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    if fused:
        time_fused(libs, dev, card)
        return 0
    if modal:
        time_modal(libs, dev, card)
        return 0
    if drift:
        span_drift(libs, rk, dev, card, f64=True)
        return 0
    if corr:
        time_corrections(libs, rk, dev, card)
        return 0
    rng = np.random.default_rng(0)
    B, m, N = 4096, 256, 3003

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    phiT, w = normal(m, N), normal(N, m)
    z = torch.zeros(1, device=dev)
    rk._lib = libs["base"]
    op = rk.ROMOperators(phiT=phiT, w=w, lam=z, u=z, cd=None, sinv=z, sinvT=None, L=z, D=z,
                         A=z, mask=z, gathered=False, sc=(0.0,) * 9,
                         split=rk.split_basis(phiT, w, tf32=False), nl_precision="highest")
    af, g = normal(B, m), rk.tma_rows(normal(B, N))

    def launch_ms(fn, n=20):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(3):
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / n)
        return best

    ref = None
    for name, lib in list(libs.items()) * 3:
        rk._lib = lib
        x, p = rk.rom_expand_f32(op, af), rk.rom_project_f32(op, g)
        if ref is None:
            ref = (x.clone(), p.clone())
        same = bool(torch.equal(x, ref[0]) and torch.equal(p, ref[1]))
        print(f"[{card}] {name}: " + json.dumps(dict(
            expand_ms=launch_ms(lambda: rk.rom_expand_f32(op, af)),
            project_ms=launch_ms(lambda: rk.rom_project_f32(op, g)), same_as_base=same)),
            flush=True)
    print(f"[{card}] torch.matmul: " + json.dumps(dict(
        expand_ms=launch_ms(lambda: af @ phiT), project_ms=launch_ms(lambda: g @ w))), flush=True)

    rk._lib = libs["base"]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < 3.0:
        for _ in range(200):
            rk.rom_expand_f32(op, af)
        torch.cuda.synchronize(dev)
    smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    print(f"[{card}] SM clock, power during the float32 expand: {samples[-5:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build variants of the float32 ROM GEMM kernels and time them on one card.

    python3 chip_variants.py                    # every variant below
    python3 chip_variants.py base diag_noload   # some of them
    python3 chip_variants.py --sass             # base's FFMA operands (cuobjdump)

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

``--sass`` builds ``base`` alone, disassembles its two float32 kernels
with ``cuobjdump -sass`` and counts, over their FFMAs, those whose sources
all come from the register file (no operand held in the reuse cache from
the instruction before) and those that read two or more registers of one
parity (one bank, in a register file of two banks); and the instruction
mix of each kernel.
"""

from __future__ import annotations

import ctypes
import json
import os
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


def build(names, src, flags, nvcc, out_dir):
    """``{name: (library path, ptxas line)}`` of the variants that apply."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                print(f"{name}: anchor not found once in the source, skipped", flush=True)
                break
            text = text.replace(old, new)
        else:
            path = os.path.join(out_dir, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            cmd = [nvcc, *flags, "-o", path[:-3] + ".so", path]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-2000:]}", flush=True)
            continue
        lines = log.splitlines()
        info = [lines[i + 2].strip() + " | " + lines[i + 3].split(":")[-1].strip()
                for i, ln in enumerate(lines) if "Compiling" in ln and "f32_kernel" in ln]
        built[name] = (os.path.join(out_dir, f"{name}.so"), "; ".join(info))
    return built


def sass_stats(so_path: str) -> None:
    """``--sass``: see the module's docstring."""
    import collections
    import re

    text = subprocess.run(["cuobjdump", "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n")[0]
        if "f32_kernel" not in name:
            continue
        ops, ffma = collections.Counter(), collections.Counter()
        held = set()  # (slot, register) the previous instruction kept in the reuse cache
        for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", func):
            ins = re.sub(r"^@!?U?P\w+\s+", "", ins.strip())
            op = ins.split()[0]
            ops[op.split(".")[0]] += 1
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
        kernel = re.search(r"(rom_\w+_f32_kernel)", name).group(1)
        print(f"sass {kernel}: FFMA {dict(ffma)}; instructions {sum(ops.values())}, "
              f"most common {ops.most_common(8)}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

    sass = "--sass" in sys.argv[1:]
    names = ["base"] if sass else sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    with open(_build.SOURCES["rom_rollout"]) as f:
        src = f.read()
    built = build(names, src, _build.NVCC_FLAGS, _build._nvcc(),
                  os.path.join(HERE, "build", "variants"))
    if sass:
        sass_stats(built["base"][0])
        return 0
    libs = {}
    for name, (path, info) in built.items():
        print(f"ptxas {name}: {info}", flush=True)
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in _build._SIGNATURES["rom_rollout"].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    dev = torch.device("cuda", 0)
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
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

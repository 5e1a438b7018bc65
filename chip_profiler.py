#!/usr/bin/env python3
"""Check that back-to-back ``torch.profiler`` sessions on the card record
the kernels they launch.

    python3 chip_profiler.py [--rounds 5]

Builds the ``fma_chain`` probe (``utils/roofline.py``), then, in a fresh
process for each setting of the environment (Kineto's defaults,
``TEARDOWN_CUPTI=0``, ``DISABLE_CUPTI_LAZY_REINIT=1``, and the defaults and
``TEARDOWN_CUPTI=0`` after an NCCL group of one rank was opened and
destroyed), takes ``rounds`` x 3 back-to-back sessions around one
``fma_chain`` launch (a kernel of the port's ctypes libraries), one torch
op, and both, then three ``utils.trace()`` sessions around one
``fma_chain`` launch. Each session's code says what its trace holds: ``F``
the probe kernel, ``T`` the torch op's kernel, ``-`` neither. The last line
counts the sessions whose trace lacks a kernel they launched. Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SETTINGS = (("default", {}), ("teardown0", {"TEARDOWN_CUPTI": "0"}),
            ("nolazy", {"DISABLE_CUPTI_LAZY_REINIT": "1"}),
            ("nccl", {}), ("nccl_teardown0", {"TEARDOWN_CUPTI": "0"}))


def sessions(nccl: bool, rounds: int) -> list:
    """``[(what was launched, what the trace holds)]`` of one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from continuum_robot_tpu_torch.utils import roofline as rl
    from continuum_robot_tpu_torch.utils import trace

    dev = torch.device("cuda", 0)
    x = torch.rand(1 << 20, device=dev)

    def ct():
        rl.fma_chain(x, 16, 1e-7, out=x)

    def tt():
        x.mul_(1.0)

    def both():
        tt()
        ct()

    ct()
    tt()
    torch.cuda.synchronize()

    def held(fn) -> str:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        keys = [ev.key for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA")]
        return (("F" if any("fma" in k for k in keys) else "-")
                + ("T" if any("mul" in k.lower() or "elementwise" in k.lower() for k in keys)
                   else "-"))

    out = []
    if nccl:
        import torch.distributed as dist

        out.append(("ct", held(ct)))
        dist.init_process_group("nccl", init_method="tcp://localhost:29511", world_size=1,
                                rank=0)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    for _ in range(rounds):
        for name, fn in (("ct", ct), ("tt", tt), ("both", both)):
            out.append((name, held(fn)))
    with tempfile.TemporaryDirectory() as d:
        for _ in range(3):
            with trace(d, device=dev) as path:
                ct()
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            out.append(("trace_ct", "F" if any(
                e.get("cat") == "kernel" and "fma" in e.get("name", "") for e in events)
                else "-"))
    return out


def missing(held: list) -> int:
    """Sessions whose trace lacks a kernel they launched."""
    want = {"ct": "F-", "tt": "-T", "both": "FT", "trace_ct": "F"}
    return sum(1 for what, got in held if got != want[what])


def main() -> int:
    args = sys.argv[1:]
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 5
    if "--child" in args:
        held = sessions(args[args.index("--child") + 1] == "nccl", rounds)
        print("RESULT " + json.dumps(held), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_profiler: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from continuum_robot_tpu_torch.ops.cuda import _build

    _build.build("roofline")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    total = bad = 0
    for name, env in SETTINGS:
        kind = "nccl" if name.startswith("nccl") else "plain"
        t0 = time.time()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", kind,
                              "--rounds", str(rounds)],
                             env=dict(os.environ, **env), cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
        if run.returncode != 0 or not lines:
            print(f"{name}: rc {run.returncode}\n{run.stderr[-3000:]}", flush=True)
            return 1
        held = json.loads(lines[-1][len("RESULT "):])
        total += len(held)
        bad += missing(held)
        print(f"{name} ({time.time() - t0:.1f} s): {missing(held)} of {len(held)} sessions "
              f"lack a kernel: {' '.join(f'{w}:{g}' for w, g in held)}", flush=True)
    print(json.dumps({"sessions": total, "lacking_a_kernel": bad}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py                     # the full check
    python3 chip_smoke.py --profile           # ROM main path under torch.profiler
    python3 chip_smoke.py --profile highest   # its "highest" span under torch.profiler
    python3 chip_smoke.py --profile implicit  # implicit main path under torch.profiler
    python3 chip_smoke.py --profile fused     # fused small-beam span under torch.profiler
    python3 chip_smoke.py --control           # phases 25-28 alone (no kernel is built)
    python3 chip_smoke.py --rom-tier          # phases 29-32 alone (the ROM main path rebuilt)
    python3 chip_smoke.py --parallel          # phases 33-38 alone (the parallel layer)
    python3 chip_smoke.py --cards 4           # phases 33-38, then 39-44 and 49 on four cards
    python3 chip_smoke.py --sweep             # phases 45-48 alone (the gradient path)
    python3 chip_smoke.py --adjoint           # phase 45 alone (the adjoint kernel)
    python3 chip_smoke.py --examples          # phases 50-53 alone
    python3 chip_smoke.py --cards 4 --examples  # phase 54 alone, on four cards

Phases, one line each (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile the CUDA sources of this checkout, one nvcc each, at once;
3. linear kernels vs plain: every modal kernel (``modal_steps``,
   ``modal_frames``, ``affine_steps``, ``affine_drive`` and
   ``affine_frames``) against its plain PyTorch version on the card,
   float32 and float64, undamped and damped, at a small ragged size (17
   steps) and at the main path's width (4096 x 3000) over
   ``MAIN_CHECK_STEPS`` steps (the frame drives at ``simulate``'s cadence,
   10 frames x 20 substeps; ``modal_frames`` with each envs a thread it
   has, ``affine_frames`` with one map and with a two-run schedule; the
   affine entries over the main path's 31 applications); they must agree
   bit for bit (in float32 the twins round each multiply-add once, as the
   kernels' FMAs do);
4. linear main path: the 1000-element linear Nitinol cantilever (the JAX
   package's bench.py beam), host float64 eigh, 4096 envs in float32,
   ``rollout_power(K=64)`` over 2000 steps at dt=1e-4 and rho_inf=0.8 (one
   ``affine_drive`` launch), checked against the step kernel over the same
   span (``vs_stepper_rel`` <= 1e-4) and for finite physical states; the
   float32 FMA stepper's error against a float64 run of the span at most
   1.5 times the unfused float32 engine's (``ms.rollout``); then
   ``rollout_power`` with a ``PiecewiseConstant`` force (the tip force
   released after ``PWC_BREAK`` s: ``affine_steps`` launches only), bit for
   bit equal to its plain drive;
5. ``simulate(method="modal")`` with engines "pallas", "power" and "xla"
   (64 envs, 10 frames x 20 substeps): "power" in float32 held to "xla",
   the plain path (<= 1e-4), with the constant force and with the force
   released inside a frame (a ``PiecewiseConstant`` schedule,
   ``SIM_BREAK``); "pallas" held to "xla"
   in float64, where the two share their arithmetic (<= 1e-6), and in
   float32, where the kernels round each multiply-add once, its error
   against float64 "xla" (by norm) at most 1.5 times float32 "xla"'s own;
   "pallas" must be exactly one ``modal_frames`` launch and "power" exactly
   one ``affine_frames`` launch (both forces), nothing else;
6. linear timings: CUDA events, best of 3 after a warm-up; each modal
   kernel's lone launch, its device time (CUDA events around launches
   queued behind a spin of the card), its host dispatch and its plain twin
   (one call); the two frame drives also at full width (4096 envs), with
   their bound there;
7. ROM kernels vs plain, small: the fused ROM span against its plain twin
   on 8-element nonlinear and hybrid beams (12 modes, 5 envs, amplitude
   3e-2 so the correction is leading order, 50 steps, 2 Newton
   iterations): diagonal and dense (coupled) Newton, damped, gathered
   ECSW layout; max |kernel - plain| <= 5e-6 x the state scale;
8. ROM main path: the 1000-element von Karman beam of the JAX package's
   nonlinear ROM benchmark (bench.py, BENCH_TYPE=nonlinear
   BENCH_ENGINE=modal_rom_pallas): ``make_modal_rom`` with 256 modes
   (Arnoldi branch), ``make_pallas_rollout()``, 4096 envs in float32,
   2000 steps at dt=1e-4, rho_inf=0.5, one Newton iteration; the endpoint
   ``(eta, etad)`` against the plain twin over the same span (relative
   error <= 1e-4) and finite physical states; host set-up seconds; then
   the same span with ``nl_precision="highest"`` (the float32 expand and
   project) against the same twin (<= 1e-4), its time (first call) beside
   its all-float32 bound;
9. ECSW at full width: trained as bench.py trains it (tip force 3.0, 30
   frames x 20 substeps on 1 env, 2 Newton iterations, snapshots [::3],
   tau=1e-3), then the gathered kernels over 4096 envs x 2000 steps
   against the plain twin (relative error <= 1e-4);
10. dense Newton at full width: the main-path engine with its dense Sinv,
    200 steps against the plain twin (<= 1e-4) and the diagonal path, and
    the span's time (best of 3, CUDA events) and env-steps/s;
11. ``simulate(method="modal_rom")``, engine "pallas" (float32 kernels)
    against "xla" (float64 plain stepper) on the 8-element beam, 10 frames
    of 5 steps (max error <= 1e-5 x the state scale);
12. ROM timings: CUDA events, best of 3 after a warm-up; each ROM kernel
    alone at the main path's shapes against its plain twin and the one
    torch call that computes its product; ``rom_expand`` and
    ``rom_project`` (3xTF32 on the tensor cores) with their bound at the
    TF32 peak and, for reference, at the float32 CUDA-core peak;
    ``rom_expand_f32`` and ``rom_project_f32`` (the "highest" tier) within
    5e-7 of their twin's scale; ``rom_correction_window`` and
    ``rom_correction_gathered`` against a float64 evaluation of the planes
    within 1.5x the float32 twin's own error; each kernel's device time per
    launch (``torch.profiler``, ten launches) and the host's dispatch time
    of five wrappers (no synchronisation, 200 calls);
13. block-tridiagonal kernel vs plain: ``ops/cuda/btd_solve`` against
    ``ops/banded.btd_solve`` on the card, float32 and float64, at ragged
    sizes (B in 1, 31, 33, 4096 across the 32-env blocks; N in 1, 2, one
    chunk -1 and +1; rows of a padded and an unpadded pitch) and at the
    main path's size (the bench beam's generalized-alpha system, 1001
    nodes, 4096 envs); bit for bit;
14. implicit main path, linear: the JAX package's full-order benchmark row
    (bench.py, the implicit generalized-alpha env-steps/s line) with
    ``linear_solver="pallas"``: ``make_newmark_operator`` on the
    1000-element linear beam, 4096 envs in float32, ``generalized_alpha_step``
    x 2000 at dt=1e-4, rho_inf=0.8, one Newton iteration; env-steps/s
    (best of 3, CUDA events); checks: (a) the same span in float64 against
    the float64 modal stepper on the same beam (<= 1e-6 relative, q and v
    each against its own norm), (b) float32 against float64 (<= 1e-2),
    (c) finite states;
15. implicit main path, nonlinear: the same beam with the consistent von
    Karman element, rho_inf=0.5, two modified-Newton iterations, 2000
    steps, 4096 envs: float32 against float64 (<= 1e-2), and 50 float64
    steps against ``linear_solver="dense_inv"`` (<= 1e-8);
16. ``simulate(method="generalized_alpha"|"newmark")`` on the 8-element
    consistent von Karman beam (0.25 m elements), 64 envs, 10 frames x 20
    substeps, tip force 0.1: "pallas" bit for bit equal to
    "btd"; "cr" and "dense_inv" within 1e-9 x the state scale (float64);
17. implicit timings: the kernel per launch (a lone launch and its device
    time) against its plain version, its bound and the dense-inverse
    product (the one torch call computing the same solve); 50 steps of the
    linear main path with "pallas" and with "dense_inv" (the measurement
    behind ``CARD_LINEAR_SOLVER``);
18. fused small-beam kernel vs plain: ``ops/cuda/fused_rollout``'s
    ``fused_gen_alpha_steps`` against its plain twin on the card, float32
    and float64, on random well-conditioned operators with drag and a
    nonzero force (n=13 with 5 envs; n=36 with 37 envs, rows past 32
    lanes) and at the main path's shape (the water beam's operators, 4096
    envs, 20 steps); bit for bit;
19. fused small-beam path: the JAX package's sweep of
    examples/batched_rollouts.py on the reference's 6-segment linear
    Nitinol cantilever in water, 4096 envs with tip displacements ~ N(0,
    1e-3), generalized-alpha over t=0.25 s at dt=1e-3 with 20 substeps
    (5000 implicit steps), rho_inf=0.8, two Newton iterations,
    ``fused_rollout`` in float32 (the timed span, best of 3): checks (a)
    the same rollout in float64 against float64 ``simulate(method=
    "generalized_alpha")`` with the registered drag (<= 1e-9 x the state
    scale, q and v each against its own), (b) float32 against float64 (<=
    1e-3, q and v each against its own norm), (c) finite states;
20. entry points: ``simulate(method="generalized_alpha"|"newmark")`` on
    the same beam with drag and gravity, 64 envs, 10 frames x 20 substeps,
    "pallas" bit for bit equal to "btd"; ``parallel.batched_rollout`` bit
    for bit equal to ``simulate``; ``sweep_statistics`` finite; then the
    fused timings: the kernel per launch at 4096 and 65536 envs against
    its plain twin and its bound, and the float64 oracle span's time;
21. reference parity: ``simulate(method="dopri5")`` (float64, rtol 1e-10,
    atol 1e-12) on the six golden configurations of
    tests/test_parity_golden.py over their first ``PARITY["prefix"]`` s
    against ``tests/goldens/trajectories.npz`` (< 2e-6 x the state
    scale), trials, host reads and wall time each; then
    nonlinear_fluid_gravity continued span by span toward 1 s (an exact
    restart from ``(x, dt_next)``) while ``PARITY["full_budget_s"]`` lasts,
    against the golden over the frames reached;
22. batched RK4: ``parallel.batched_rollout(method="rk4")`` on the
    6-segment hybrid flagship with drag and gravity (``entry.py``), 4096
    envs with tip displacements ~ N(0, 1e-3), h = 1e-5 s halved until RK4
    is stable on the beam's spectrum, float32 timed (best of 3,
    env-steps/s) and float64; three float64 envs bit for bit equal to
    ``simulate(method="rk4")`` alone, float32 against float64 (<= 1e-3),
    RK4's order against Dopri5 over the first frame (h, h/2, h/4); one
    ``entry()`` step; the same three envs on a von Karman beam of
    ``POLY_MAX_ELEMENTS`` elements with drag and gravity (the widest whose
    RHS is batch-invariant), bit for bit alone;
23. per-env Dopri5: ``integrate_adaptive(per_env=True)`` on
    nonlinear_fluid_gravity, 4096 envs, tip impulses 0.05-0.2 N: the
    lanes of the smallest, median and largest impulse equal their solo
    runs (<= 1e-10, counts equal), the median (0.1 N) against the golden;
24. adaptive implicit on the stiff60 mesh (60 linear elements of 0.025 m)
    over ``STIFF["horizon"]``: ``generalized_alpha_adaptive`` with
    ``"dense_inv"`` and ``"pallas"`` and ``sdirk3``, at 1 and 4096 envs
    (impulses scaled 0.5-1.5, one shared controller), every run equal to
    the port on the CPU on the same inputs (<= 1e-10, counts equal),
    ``"pallas"`` equal to ``"dense_inv"`` on the card at each width, each
    ``btd_solve`` launch of the ``"pallas"`` runs bit for bit its plain
    version on its own inputs, tip errors against the exact flow printed;
    ``chunk=`` bit for bit the one-call run; the expm propagator over 1 s
    against the stiff60 golden (printed); the ms a trial of
    ``generalized_alpha_adaptive`` at full width (1000 elements, 4096
    envs, float32; 20 trials after a one-trial warm-up, the initial
    acceleration outside the timing) with ``"btd"`` and ``"cr"``;
25-28. the control layer and the utilities (``--control``);
29. ``modal_rom_adaptive``: ``rollout_adaptive`` on the ROM main path's
    engine and inputs (4096 envs, float32, 20 frames of 1 ms, rtol 1e-5):
    trials, ms a trial and the device's busy share; 4 envs in float64 held
    to the port on the CPU on the same inputs (equal counts, <= 1e-10);
    ``simulate(method="modal_rom_adaptive", chunk=1)`` bit for bit the
    one-call run; the nonlinear_fluid_gravity golden at rtol 1e-8 (the JAX
    test's 1e-10 would take about 3800 trials for one 1 ms frame, 1e-8
    about 813) span by span for ``ROM_ADAPTIVE["golden_budget_s"]``,
    within the JAX bound 3e-4 over the frames reached;
30. forced ROM: the ROM main path's beam in water with gravity through
    ``simulate(method="modal_rom", engine="xla")`` at 4096 envs (float64)
    and the same drive in float32 (env-steps/s; against float64 by norm
    <= 1e-3); the reduced closures against ``PhiW^T compute_forces`` in
    float64 (<= 1e-12); the split path against the general one (<= 1e-9);
31. ECSW guard and files: ``rollout_frames_guarded`` on phase 9's trained
    engine at 4096 envs (guarded against unguarded ms; no env flagged at
    0.5-1 x the training force, every env at 10-15 x); ``save_basis`` /
    ``save_ecsw`` / ``load_basis`` / ``load_ecsw``: bit-equal operators
    and the loaded gathered span bit for bit the trained one's, held to
    its twin; ``carry_dtype=torch.bfloat16`` drift (< 0.05) and ms;
32. augmentation: the consistent 1000-element beam with
    ``modal_derivatives=3`` (host set-up, modes, 4096-env float32 against
    float64 <= 1e-4); a 32-segment parity beam with ``modal_derivatives=3``
    through ``simulate(engine="pallas")`` at 4096 envs against "xla" in
    float64 within phase 7's 5e-6 x scale.
33-38. the parallel layer at world size 1 (``--parallel``): the process
    group, the SPIKE gen-alpha row (34), ``simulate_sharded``'s adaptive,
    SDIRK3 and RK4 paths (35), its modal (36) and ROM engines (37),
    ``batched_rollout(mesh=)`` and ``dryrun_multichip(1)``, one NCCL rank on
    the card (38);
39-44. ``--cards 4`` only, after phases 33-38 (their results are the
    oracle): a world of four ranks, one a card over NCCL. 39 the runtime
    (``ppermute`` both ways, ``psum``, ``all_gather`` on sp = 4 and on both
    axes of dp x sp = 2 x 2, exact); 40 the SPIKE row at sp = 4 and 41 at
    2 x 2 (thomas against phase 34's thomas span, cr and dense against
    thomas, <= 1e-3; float64 against the plain single-device span, <= 1e-9;
    1 + steps x n_newton ``btd_solve`` launches on every rank; ms a step
    beside phase 34's, each rank's busy share and NCCL time a step); 42
    ``batched_rollout(mesh=)`` at dp = 4 over the same batch, each card's
    block bit for bit the one-card rollout's rows, env-steps/s of both; 43
    phases 35-37 at sp = 4 against their world-size-1 results (equal
    adaptive counts, one ``modal_frames`` / ``affine_frames`` launch a
    rank); 44 ``dryrun_multichip(4)`` (2 x 2). A failure on any rank fails
    the run with that rank's traceback.
45-48. the differentiable-parameter path (``--sweep`` runs them alone;
    ``--adjoint`` phase 45 alone):
    45 ``btd_solve_adjoint`` (the reverse-mode sweeps of the block-tridiagonal
    solve) against ``banded.btd_adjoint_sweeps``, bit for bit, float32 and
    float64: the 1001-node main path system at 1, 33 and 4096 rhs, and the
    kernel's chunk edges (N = C - 1, C, C + 1 and one node past the
    resident chunks, from ``btd_solve.adjoint_geometry``) at 1 and 33, each
    with b and g unpadded, both in padded rows, and g one row shared by the
    batch (pitch 0); the whole adjoint against ``banded.btd_solve_adjoint``
    at 4096; ``btd_solve``'s autograd Function (backward and forward-mode
    tangent) against autograd and forward AD of the plain sweep, float64 at
    13 nodes (<= 1e-12); the kernel's device times (float32, float64) beside
    its byte bound, the whole backward's (the kernel and the factor sums)
    and the library's (``g @ T^-1``, b_bar only); 46 the SPIKE gen-alpha row's
    beam at sp = 1 with traced ``arrays=``: ``beam.arrays`` as tensors
    against the baked span (float64 16 envs, float32 4096 envs, the JAX
    test's 1e-14 x max(scale, 1)), reverse-mode gradients in the elastic
    modulus and the density scales against central differences (float64,
    2 frames x 4 substeps, rtol 2e-5), both kernels launched in each
    gradient path, and float32 forward and backward at 4096 envs (ms, peak
    memory; the batch halved past 70 GB); 47
    ``parametric_modal_rom_rollout`` on the ROM main path's engine (frozen
    256-mode bases): the float64 gradient against central differences
    (rtol 1e-6), remat equal to plain (rtol 1e-10), float32 forward and
    backward with remat at the largest of 4096, 1024, 256 configurations
    that fits (ms, peak memory); 48 the small dense paths:
    ``parametric_rollout`` and ``parametric_genalpha_rollout`` gradients
    against central differences on examples/system_identification.py's
    beam (its impulse's 2 ms) and tests/test_sweep.py's, remat equality, the
    traced operator under adaptive gen-alpha against
    ``make_newmark_operator(linear_solver="btd")`` and its forward-mode
    tangent against central differences. The kernel record gains
    ``btd_solve_adjoint`` (its launches from phase 46's paths).
49. ``--cards 4`` only: phase 46's float64 gradients at sp = 4 over NCCL
    against the world-size-1 gradients (<= 1e-9 relative), every rank.
50-53. the roofline probes, the profiling helpers and the examples
    (``--examples`` runs them alone): 50 the ``fma_chain`` probe kernel
    against its plain twin, bit for bit (a ragged size, out of place and in
    place, and the probe's size, where every thread takes several
    grid-stride passes), then
    ``utils.roofline.measure_ceilings()`` with each ceiling's ratio to its
    data-sheet constant (``CEILING_PEAKS``, at most ``CEILING_MAX``), and
    the probe's time at its size beside its bound; 51 ``StepMeter``,
    ``trace`` (a kernel of the trace must be a port kernel) and
    ``compile_time_breakdown`` on the linear main path; 52 the web demo
    server on the card (port 0, a thread): three ``GET /simulate`` and a
    ``GET /``, each request's latency, the payload against the port's CPU
    run (<= 1e-9 relative) and the ``btd_solve`` launches of the first
    request; 53 every other example's ``run()`` on the card at
    ``EXAMPLES[name]["full"]`` (a cut of the JAX script's spans, printed
    on its line; defaults where nothing is printed): wall seconds, its figures, its
    launches by kernel (an implicit path must launch ``btd_solve``), then
    at the tests' size on the card and on the CPU (<= 1e-9 relative). The
    kernel record gains ``fma_chain`` and the examples' paths in each
    kernel's ``launches_by_path``.
54. ``--cards 4`` only: ``multichip_beam`` at dp x sp = 2 x 2 over NCCL
    against the same example at world size 1 (<= 1e-9, equal SDIRK3
    counts, ECSW sample and audit flags); every rank's generalized-alpha
    tier must launch ``btd_solve`` (SPIKE's local "thomas" solves).

Phases 25-32 launch no kernel but the ROM kernels of phase 31's loaded
ECSW span and phase 32's augmented simulate; every other path of theirs
must read 0 launches of every kernel.

Launch counts are set to 0 just before each path and read just after it:
the linear main path (``rollout_power``), ``rollout_pallas``,
``rollout_power`` with a schedule and the ``simulate`` engines with a
constant and a released force (phases 4-5); the ROM main path (window layout, phase
8) and its "highest" span (8), the ECSW gathered span (9), the
dense-Newton span (10) and
``simulate(method="modal_rom", engine="pallas")`` (11); the implicit
linear and nonlinear main paths (14, 15; the block-tridiagonal kernel once
for the initial acceleration and once per Newton iteration: 2001 and 4001)
and the ``simulate`` runs with ``linear_solver="pallas"`` (16); the fused
small-beam path in float32 and float64 (19, one launch per frame: 250),
its float64 oracle (19, the block-tridiagonal kernel 1 + 5000 x 2 times),
the ``simulate`` and ``batched_rollout`` runs of phase 20 and the adaptive
generalized-alpha runs with ``"pallas"`` (24: one launch a run, the
initial acceleration); the loaded ECSW span (31) and the augmented
``simulate(engine="pallas")`` (32). Every
kernel must have been launched by its own path, and each ROM path must
launch exactly its kernels, once per Newton iteration of every step. The
second-to-last lines are the kernels' JSON record (``launches`` from the
kernel's own path, ``launches_by_path`` from every path; ``design`` for
the tensor-core kernels) and the card line; the last line is the JSON
result naming the device.

``--profile`` builds the ROM main path only (``--profile implicit``: the
linear implicit main path, and a lone ``btd_solve`` launch) and runs
``PROFILE_STEPS`` steps of it under ``torch.profiler``: device time by
kernel, and the device's busy share of the same steps timed without the
profiler. ``--profile highest`` does the same for the ROM main path's
"highest" span, ``--profile dense`` for the dense-Newton span,
``--profile fused`` for the whole float32 span of the fused small-beam
path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

import torch

N_ELEMENTS, N_ENVS, N_STEPS, K_POWER = 1000, 4096, 2000, 64
N_MODES_FULL = 3 * N_ELEMENTS  # the bench beam's free DOFs = its modes
DEVICE = "cuda"
DT, RHO_INF = 1e-4, 0.8
SMALL = dict(B=5, m=37, steps=17)
# Phase 3 at the main path's width: the float32 twins round each multiply-add
# once through about ten float64 torch operations, so the step kernels are
# held to them over this many steps (the affine entries over the main path's
# applications).
MAIN_CHECK_STEPS = 200
FMA_VS_UNFUSED_MAX = 1.5  # the FMA stepper's error against float64, / the unfused engine's
SIM = dict(envs=64, frames=10, substeps=20)
FRAME_ENVS = (1, 2, 4)  # modal_frames' instances: envs a thread (0: the batch's choice)
PWC_BREAK = 0.05  # s: the tip force released in phase 4 (step 500 of 2000)
SIM_BREAK = 0.005  # s: the tip force released in phase 5 (step 50, inside frame 3)
VS_STEPPER_MAX = 1e-4
# The nonlinear ROM benchmark configuration (JAX package bench.py:38-98,
# 455-529, 1017-1062), nothing cut.
ROM = dict(modes=256, rho_inf=0.5, n_newton=1, dense_steps=200)
ROM_SMALL = dict(n_el=8, m=12, B=5, steps=50, amp=3e-2, n_newton=2)
ROM_SIM = dict(envs=3, frames=10, substeps=5)
ROM_SPAN_MAX = 1e-4  # f32 kernel vs f32 twin, endpoint relative error, 2000 steps
ROM_SMALL_MAX = 5e-6  # the JAX package's own fused-kernel bound (x state scale)
ROM_PIECE_MAX = 1e-4  # one launch vs its twin, each output x its max|twin|:
# f32 sums of <= 3003 terms
ROM_F32_PIECE_MAX = 5e-7  # the float32 ("highest") expand and project, the same way
PROFILE_STEPS = 50
# The JAX package's full-order implicit benchmark rows (bench.py:1089-1140):
# generalized-alpha, linear (rho_inf 0.8, one Newton iteration) and
# consistent von Karman (rho_inf 0.5, two modified-Newton iterations).
IMPLICIT = dict(rho_lin=0.8, newton_lin=1, rho_nl=0.5, newton_nl=2, dense_steps=50)
IMP_SMALL = dict(n_nodes=13, B=5)
IMP_SIM = dict(n_el=8, envs=64, frames=10, substeps=20, amp=1e-5)
IMP_VS_MODAL_MAX = 1e-6  # float64 full-order vs float64 modal, same recurrence
IMP_F32_MAX = 1e-2  # float32 span vs float64 span
IMP_DENSE_MAX = 1e-8  # float64, prefactored sweeps vs dense inverses
IMP_SIM_MAX = 1e-9  # simulate cr / dense_inv vs btd, x state scale, float64
# The fused small-beam sweep (the JAX package's examples/batched_rollouts.py:34-62)
# on the reference's 6-segment linear Nitinol cantilever in water
# (examples/example_utilities.py:27-83), nothing cut.
FUSED = dict(envs=4096, t_final=0.25, dt=1e-3, substeps=20, rho_inf=0.8, n_newton=2,
             tip_scale=1e-3, big_envs=65536)
FUSED_SMALL = ((13, 5), (36, 37))  # (n, envs): random operators, ragged sizes
FUSED_CHECK_FRAMES = 3  # frames of the whole-rollout entry in phase 18
FUSED_SIM = dict(envs=64, frames=10, substeps=20)
FUSED_VS_SIM_MAX = 1e-9  # float64 fused vs float64 simulate, x state scale
FUSED_F32_MAX = 1e-3  # float32 fused vs float64 fused, each of q, v by norm
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3,
# dense TF32 on the tensor cores.
PEAK_F32_FLOPS, PEAK_BYTES, PEAK_TF32_FLOPS = 67e12, 3.35e12, 495e12
# FP32 instructions a second (132 SMs x 128 lanes x 1.98 GHz), half the flop
# peak: the floor of a kernel that rounds every multiply and add on its own
# (_rn, no contraction into an FMA) to stay bit-equal to its twin, where each
# operation is one instruction. Printed beside the bound as `rn_bound_ms` for
# the kernels that still do so (the fused small-beam entries); the bound
# itself prices a multiply-add pair as one FMA, which is what the float32
# modal kernels issue (their twins round as an FMA does).
PEAK_F32_INSTR = 132 * 128 * 1.98e9

SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/modal_rollout.cu"
REPLACES = {
    "modal_steps": "continuum_robot_tpu/ops/pallas/modal_rollout.py:201",
    "modal_frames": "continuum_robot_tpu/ops/pallas/modal_rollout.py:392",
    "affine_steps": "continuum_robot_tpu/ops/pallas/modal_rollout.py:280",
    "affine_drive": "continuum_robot_tpu/ops/pallas/modal_rollout.py:280",
    "affine_frames": "continuum_robot_tpu/ops/pallas/modal_rollout.py:280",
}
ROM_SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/rom_rollout.cu"
ROM_REPLACES = "continuum_robot_tpu/ops/pallas/rom_rollout.py:65"
ROM_TC_DESIGN = "wgmma 3xTF32"  # rom_expand and rom_project: tensor cores, hi/lo split
# rom_expand_f32 and rom_project_f32: the same persistent TMA ring, FFMA consumers
ROM_F32_DESIGN = "persistent TMA ring, FFMA float32 8x8"
# The path whose run gives each kernel's ``launches``.
LINEAR_PATH = {"modal_steps": "rollout_pallas", "modal_frames": "simulate:pallas",
               "affine_steps": "rollout_power:schedule", "affine_drive": "rollout_power",
               "affine_frames": "simulate:power"}
ROM_WINDOW = ("rom_alpha_point", "rom_expand", "rom_correction_window",
              "rom_project", "rom_update")
ROM_GATHERED = ("rom_alpha_point", "rom_expand", "rom_correction_gathered",
                "rom_project", "rom_update")
ROM_DENSE = ("rom_alpha_point", "rom_expand", "rom_correction_window",
             "rom_project", "rom_newton_dense")
ROM_HIGHEST = ("rom_alpha_point", "rom_expand_f32", "rom_correction_window",
               "rom_project_f32", "rom_update")
ROM_PATH = {**{k: "window" for k in ROM_WINDOW},
            "rom_correction_gathered": "ecsw", "rom_newton_dense": "dense_newton",
            "rom_expand_f32": "highest", "rom_project_f32": "highest"}
# The correction kernels: the polynomial's per-element factors from a host
# float64 table, multiplies and FMAs only.
ROM_DESIGN = {"rom_expand": ROM_TC_DESIGN, "rom_project": ROM_TC_DESIGN,
              "rom_expand_f32": ROM_F32_DESIGN, "rom_project_f32": ROM_F32_DESIGN,
              "rom_correction_window": "factor table; a warp owns 32 nodes (writes 31) "
                                       "over 16 env rows, shuffles for adjacency",
              "rom_correction_gathered": "factor table; a block owns min(s, 256) "
                                         "elements of 256 // min(s, 256) env rows"}
# A correction kernel against a float64 evaluation of the same planes, as a
# multiple of the float32 twin's own error against it.
ROM_CORR_F64_RATIO = 1.5
BTD_SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/btd_solve.cu"
BTD_CHUNK = {torch.float32: 64, torch.float64: 32}  # nodes a ring slot holds
BTD_REPLACES = "continuum_robot_tpu/ops/pallas/btd_solve.py:97"
FUSED_SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/fused_rollout.cu"
FUSED_REPLACES = "continuum_robot_tpu/ops/pallas/fused_rollout.py:97"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them; on a
    machine of several cards, "N x <line>" when they are alike, else the
    lines joined by " | "."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    lines = out.stdout.strip().splitlines()
    if len(set(lines)) == 1 and len(lines) > 1:
        return f"{len(lines)} x {lines[0]}"
    return " | ".join(lines)


def bench_beam_dataframe(n: int, kind: str = "linear"):
    """The JAX package's bench.py beam: 0.25/6 m Nitinol elements, fixed base."""
    import pandas as pd

    L_el, E, r, rho = 0.25 / 6, 75e9, 0.005, 6450.0
    return pd.DataFrame({
        "length": [L_el] * n,
        "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n,
        "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n,
        "type": [kind] * n,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
    })


def synthetic_engine(m: int, rng, damped: bool):
    """A modal engine with a beam-like spectrum (1 .. 1e12) and no basis:
    the coefficients the kernels see, without an eigensolve."""
    from continuum_robot_tpu_torch import convert

    lam = np.sort(10.0 ** rng.uniform(0.0, 12.0, m))
    cdamp = 0.5 + 1e-6 * lam if damped else None
    return convert.modal_engine_from_numpy(
        np.zeros((1, m)), np.zeros((m, 1)), lam, RHO_INF, DT, cdamp,
        device=DEVICE,
    )


class OpCount:
    """A number stand-in that counts the arithmetic done on it: the
    operation counts of the bounds come from the plain versions' formulas."""

    n = 0

    def _op(self, *_):
        OpCount.n += 1
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = __neg__ = _op


def count_ops(fn, n_args: int) -> int:
    OpCount.n = 0
    fn(*[OpCount() for _ in range(n_args)])
    return OpCount.n


def bound(ops: float, nbytes: float, tc_ops: float = 0.0):
    """``(bound_ms, bound_by)``: the larger of the operation and byte times
    at the card's float32 and memory peaks; ``tc_ops`` more operations run
    at the tensor cores' TF32 peak."""
    t_ops = ops / PEAK_F32_FLOPS + tc_ops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rn_bound_ms(ops: float) -> float:
    """Milliseconds for ``ops`` operations issued one FP32 instruction each
    (``PEAK_F32_INSTR``): the floor of a kernel that never fuses a multiply
    and an add, beside its ``bound``."""
    return ops / PEAK_F32_INSTR * 1e3


def errors(out, ref) -> list:
    """``[(max|out_i - ref_i|, max|ref_i|)]`` for each output of a call."""
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    return [(float((x - y).abs().max()), float(y.abs().max()))
            for x, y in zip(out, ref)]


def max_abs(out, ref) -> float:
    return max(e for e, _ in errors(out, ref))


def scaled_err(out, ref) -> float:
    """The largest ``max|out_i - ref_i| / max|ref_i|``: each output is held
    to its own scale, so a large acceleration cannot hide an error in a
    small displacement."""
    return max(e / s if s else (0.0 if e == 0 else float("inf"))
               for e, s in errors(out, ref))


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def rel_parts(out, ref) -> list:
    """``[||x - ref_x|| / ||ref_x||]`` for the first two components (eta and
    etad, or q and v) of the endpoint state."""
    return [float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))
            for x, y in zip(out[:2], ref[:2])]


def rel_state(out, ref) -> float:
    """The larger of ``||eta - ref|| / ||ref||`` and the same for ``etad``,
    over the endpoint state."""
    return max(rel_parts(out, ref))


def counted(kmod, fn):
    """``(fn(), {kernel: launches})``: the counts of module ``kmod``'s
    kernels set to 0 just before the path ``fn`` and read just after it."""
    kmod.reset_launch_counts()
    out = fn()
    return out, {k.__name__: k.launches for k in kmod.KERNELS}


def expect_launches(counts: dict, kernels, n: int, path: str) -> None:
    """Require ``n`` launches of each of ``kernels`` and none of the rest."""
    want = {k: (n if k in kernels else 0) for k in counts}
    require(counts == want, f"{path}: launches {counts}, expected {want}")


@contextlib.contextmanager
def replaced(module, name, value):
    """While open, ``module.<name>`` is ``value``."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


class Recording:
    """Module ``kmod`` with its function ``name`` recorded: each call's
    arguments and result go to ``calls`` (the function, and its launch
    count, stay the module's own). Stand it in for ``kmod`` where a caller
    holds the module."""

    def __init__(self, kmod, name: str):
        self._kmod, self._name, self.calls = kmod, name, []

    def __getattr__(self, attr):
        real = getattr(self._kmod, attr)
        if attr != self._name:
            return real

        def call(*args):
            out = real(*args)
            self.calls.append((args, out))
            return out

        return call


@contextlib.contextmanager
def clocked(module, *names):
    """While open, record the host seconds of every call of each
    ``module.<name>``; yields ``{name: [seconds, ...]}``."""
    real = {n: getattr(module, n) for n in names}
    secs = {n: [] for n in names}

    def wrap(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            secs[name].append(time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield secs
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def phase_kernels(kr, dev):
    """Kernel vs plain on the card; returns {kernel: max |kernel - plain|}."""
    from continuum_robot_tpu_torch.utils import force_completion

    err = {name: 0.0 for name in REPLACES}
    frames_s = 0.0  # wall time of the frame drives' checks, twins included
    rng = np.random.default_rng(1)
    sizes = [SMALL, dict(B=N_ENVS, m=N_MODES_FULL, steps=MAIN_CHECK_STEPS)]
    for dtype in (torch.float32, torch.float64):
        for size in sizes:
            B, m, steps = size["B"], size["m"], size["steps"]
            eta = torch.tensor(rng.normal(scale=1e-6, size=(B, m)), dtype=dtype, device=dev)
            etad = torch.tensor(rng.normal(scale=1e-6, size=(B, m)), dtype=dtype, device=dev)
            u = rng.normal(scale=1e-3, size=m)
            main = B == N_ENVS
            for damped in (False, True):
                ms = synthetic_engine(m, rng, damped)
                args = (ms.lam, ms.winv64(), u, eta, etad)
                kw = dict(h=DT, rho_inf=RHO_INF, cdamp=ms.cdamp)
                e = max_abs(kr.modal_steps(*args, steps=steps, **kw),
                            kr.modal_steps_plain(*args, steps=steps, **kw))
                err["modal_steps"] = max(err["modal_steps"], e)
                frames = (dict(n_frames=SIM["frames"], substeps=SIM["substeps"]) if main
                          else dict(n_frames=4, substeps=max(1, steps // 4)))
                t0 = time.time()
                plain = kr.modal_frames_plain(*args, **frames, **kw)
                # every instance, whatever the batch picks; at full width in
                # float64 only the batch's choice (float32's runs cover the maps)
                checked = (0,) if main and dtype == torch.float64 else FRAME_ENVS
                for envs in checked:
                    e = max_abs(kr.modal_frames(*args, **frames, **kw, envs=envs), plain)
                    err["modal_frames"] = max(err["modal_frames"], e)
                del plain
                frames_s += time.time() - t0
                P, b = ms._power_map(K_POWER, u)
                a0 = kr.initial_accel(ms.lam, u, ms.cdamp, eta, etad)
                apps = N_STEPS // K_POWER if main else steps
                e = max_abs(kr.affine_steps(P, b, eta, etad, a0, apps=apps),
                            kr.affine_steps_plain(P, b, eta, etad, a0, apps=apps))
                err["affine_steps"] = max(err["affine_steps"], e)
                lam, _, cd = ms._stepper_consts(eta)
                Pr, br = ms._power_map(N_STEPS % K_POWER if main else 5, u)
                u_t = torch.as_tensor(u, dtype=dtype, device=dev)
                drive = (lam, u_t, cd, P, b, eta, etad, apps, Pr, br)
                e = max_abs(kr.affine_drive(*drive), kr.affine_drive_plain(*drive))
                err["affine_drive"] = max(err["affine_drive"], e)
                # the frames drive: one map a frame, and two runs of two maps
                n_fr = frames["n_frames"]
                t0 = time.time()
                for maps, counts in ((([P], [b]), (n_fr,)),
                                     (([P, Pr], [b, br]), (n_fr - n_fr // 2, n_fr // 2))):
                    fr = (lam, u_t, cd, np.stack(maps[0]), np.stack(maps[1]), eta, etad, counts)
                    e = max_abs(kr.affine_frames(*fr), kr.affine_frames_plain(*fr))
                    err["affine_frames"] = max(err["affine_frames"], e)
                frames_s += time.time() - t0
            force_completion((eta,))
            print(f"phase 3 kernel vs plain: {str(dtype)[6:]} B={B} m={m} steps={steps} "
                  f"(affine: {apps} applications; frames {frames['n_frames']} x "
                  f"{frames['substeps']}, modal_frames with {checked} envs a thread), "
                  f"undamped and damped: max|kernel-plain| "
                  + " ".join(f"{k}={v:.3e}" for k, v in err.items())
                  + f"; frame drives' checks so far {frames_s:.1f} s", flush=True)
    for name, e in err.items():
        require(e == 0.0, f"{name}: kernel and plain version differ by {e:.3e}")
    return err


def linear_bounds(kr, n_modes):
    """``{kernel: (bound_ms, bound_by)}`` of phase 6's calls (float32); the
    frame drives also at full width (``<kernel>:full``)."""
    sc = kr.step_scalars(DT, RHO_INF, torch.float32)
    step_ops = count_ops(
        lambda q, v, a, p4, p1, p2, p3: kr.gen_alpha_step(
            q, v, a, p4, (p1, p2, p3, None, None), sc), 7)
    affine_ops = count_ops(
        lambda q, v, a, t, b: [t * q + t * v + t * a + b for _ in range(3)], 5)
    accel_ops = count_ops(lambda q, lam, u: -lam * q + u, 3)
    n = N_ENVS * n_modes
    apps = N_STEPS // K_POWER
    F, sub = SIM["frames"], SIM["substeps"]
    ops = {"modal_steps": step_ops * n * N_STEPS,
           "affine_steps": affine_ops * n * apps,
           "affine_drive": (accel_ops + affine_ops * (apps + 1)) * n}
    nbytes = {"modal_steps": 4 * (6 * n + 4 * n_modes),
              "affine_steps": 4 * (6 * n + 12 * n_modes),
              "affine_drive": 4 * (5 * n + 26 * n_modes)}
    # The frame drives read (q, v) and their per-mode rows (p1..p4, lam, u;
    # lam, u and one map) and write every frame's (q, v).
    for tag, envs in (("", SIM["envs"]), (":full", N_ENVS)):
        ne = envs * n_modes
        ops["modal_frames" + tag] = (accel_ops + step_ops * F * sub) * ne
        ops["affine_frames" + tag] = (accel_ops + affine_ops * F) * ne
        nbytes["modal_frames" + tag] = 4 * (2 * ne + 6 * n_modes + 2 * (F + 1) * ne)
        nbytes["affine_frames" + tag] = 4 * (2 * ne + 14 * n_modes + 2 * (F + 1) * ne)
    return {k: bound(ops[k], nbytes[k]) for k in ops}


def linear_paths(crt, kr, dev, card):
    """Phases 4-6; returns the linear kernels' records, the beam and its
    modal engine."""
    from continuum_robot_tpu_torch.models.simulate import make_modal_genalpha
    from continuum_robot_tpu_torch.utils import cuda_event_times, force_completion

    t0 = time.time()
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS))
    build_model_s = time.time() - t0
    t0 = time.time()
    ms = make_modal_genalpha(model, DT, rho_inf=RHO_INF, device=dev,
                             dtype=torch.float32)
    eigh_s = time.time() - t0
    n_red = model.n_pos_states
    require(n_red == N_MODES_FULL, f"expected {N_MODES_FULL} modes, got {n_red}")
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(N_ENVS, n_red)),
                     dtype=torch.float32, device=dev)
    v = torch.zeros_like(q)
    u = np.zeros(n_red, np.float32)
    u[-2] = 0.1
    eta, etad = ms.to_modal(q, v)
    u_m = np.asarray(ms.project_force_host(u), np.float32)

    paths = {}
    (e2, ed2, _), paths["rollout_power"] = counted(
        kr, lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER))
    (er, edr, _), paths["rollout_pallas"] = counted(
        kr, lambda: ms.rollout_pallas(eta, etad, u_m, N_STEPS))
    vs_stepper_rel = rel_state((e2, ed2), (er, edr))
    q2, v2 = ms.from_modal(e2, ed2)
    force_completion((q2, v2))
    finite = bool(torch.isfinite(q2).all() and torch.isfinite(v2).all())
    # The float32 FMA stepper and the unfused float32 engine (the plain
    # torch stepper) against a float64 run of the same span.
    ref64 = ms.rollout_pallas(eta.double(), etad.double(), u_m, N_STEPS)
    fma_err = rel_state((er, edr), ref64)
    unfused_err = rel_state(ms.rollout(eta, etad, u_m, N_STEPS), ref64)
    print(f"phase 4 main path: {N_ELEMENTS} elements, {n_red} modes, "
          f"{N_ENVS} envs, {N_STEPS} steps, K={K_POWER}: "
          f"vs_stepper_rel={vs_stepper_rel:.3e} finite={finite} "
          f"q shape {tuple(q2.shape)}; against float64: FMA stepper {fma_err:.3e}, "
          f"unfused float32 engine {unfused_err:.3e} (ratio {fma_err / unfused_err:.3f}); "
          f"model build {build_model_s:.2f} s, eigh {eigh_s:.2f} s (host)", flush=True)
    require(finite and q2.shape == (N_ENVS, n_red), "non-finite or misshapen states")
    require(vs_stepper_rel <= VS_STEPPER_MAX,
            f"vs_stepper_rel {vs_stepper_rel:.3e} > {VS_STEPPER_MAX}")
    require(fma_err <= FMA_VS_UNFUSED_MAX * unfused_err,
            f"FMA stepper vs float64 {fma_err:.3e} > {FMA_VS_UNFUSED_MAX} x the unfused "
            f"engine's {unfused_err:.3e}")
    require(paths["rollout_power"] == {k: int(k == "affine_drive") for k in LINEAR_PATH},
            f"rollout_power: launches {paths['rollout_power']}, expected one affine_drive")
    # The released force: the composed drive of each constant-force span,
    # applied by affine_steps (a launch for a span's applications, one for
    # its remainder), equal to the same drive on the plain twin.
    pwc = crt.PiecewiseConstant((PWC_BREAK,), np.stack([u_m, np.zeros_like(u_m)]))
    sched, paths["rollout_power:schedule"] = counted(
        kr, lambda: ms.rollout_power(eta, etad, pwc, N_STEPS, K=K_POWER))
    sched_plain = ms.rollout_power(eta, etad, pwc, N_STEPS, K=K_POWER, use_pallas=False)
    sched_ok = all(torch.equal(x, y) for x, y in zip(sched, sched_plain))
    print(f"phase 4 released force: rollout_power with a PiecewiseConstant force (break "
          f"{PWC_BREAK} s): equal to its plain drive {sched_ok}, finite "
          f"{bool(torch.isfinite(sched[0]).all())}, launches "
          f"{paths['rollout_power:schedule']}", flush=True)
    require(sched_ok and bool(torch.isfinite(sched[0]).all()),
            "rollout_power with a PiecewiseConstant force: kernel and plain drive differ")
    require(paths["rollout_power:schedule"]["affine_steps"] > 0
            and not any(v for k, v in paths["rollout_power:schedule"].items()
                        if k != "affine_steps"),
            f"rollout_power:schedule: launches {paths['rollout_power:schedule']}, expected "
            "affine_steps only")

    # -- phase 5: simulate(method="modal") ----------------------------------
    x0 = np.zeros((SIM["envs"], 2 * n_red))
    x0[:, :n_red] = rng.normal(scale=1e-6, size=(SIM["envs"], n_red))
    frame_dt = DT * SIM["substeps"]

    u_release = crt.PiecewiseConstant((SIM_BREAK,),
                                      np.stack([u, np.zeros_like(u)]).astype(np.float64))

    def sim(engine, dtype, force=u.astype(np.float64)):
        return crt.simulate(
            model, x0, SIM["frames"] * frame_dt, frame_dt, method="modal",
            u=force, substeps=SIM["substeps"], rho_inf=RHO_INF,
            engine=engine, device=dev, dtype=dtype)

    ys = {}
    for engine, force in (("pallas", ""), ("power", ""), ("xla", ""), ("power", ":schedule"),
                          ("xla", ":schedule")):
        key = f"{engine}{force}"
        res, paths[f"simulate:{key}"] = counted(
            kr, lambda: sim(engine, torch.float32, *([u_release] if force else [])))
        ys[key] = force_completion(res.ys)
        require(tuple(res.ys.shape) == (SIM["frames"] + 1, SIM["envs"], 2 * n_red)
                and bool(torch.isfinite(res.ys).all()),
                f"simulate engine={engine}{force}: bad output")
    for path, kernel in (("simulate:pallas", "modal_frames"), ("simulate:power", "affine_frames"),
                         ("simulate:power:schedule", "affine_frames")):
        require(paths[path] == {k: int(k == kernel) for k in LINEAR_PATH},
                f"{path}: launches {paths[path]}, expected one {kernel}, nothing else")
    # "pallas" and "xla" share their arithmetic in float64 (the kernels round
    # each operation there); in float32 the kernels' FMAs round once where
    # the plain engine rounds twice, so there each is held to float64.
    ys64 = {engine: sim(engine, torch.float64).ys for engine in ("pallas", "xla")}
    rel_pallas = rel(ys64["pallas"], ys64["xla"])
    rel_power = max(rel(ys["power"], ys["xla"]),
                    rel(ys["power:schedule"], ys["xla:schedule"]))
    f32_err = {k: float(torch.linalg.vector_norm(ys[k].double() - ys64["xla"])
                        / torch.linalg.vector_norm(ys64["xla"])) for k in ("pallas", "xla")}
    print(f"phase 5 simulate: {SIM}: max rel vs xla: pallas {rel_pallas:.3e} (float64), "
          f"power {rel_power:.3e} (constant and released force); float32 against float64 xla (norm): pallas "
          f"{f32_err['pallas']:.3e}, "
          f"xla {f32_err['xla']:.3e} (pallas vs xla in float32: "
          f"{rel(ys['pallas'], ys['xla']):.3e})", flush=True)
    require(rel_pallas <= 1e-6, f"simulate pallas vs xla {rel_pallas:.3e}")
    require(rel_power <= 1e-4, f"simulate power vs xla {rel_power:.3e}")
    require(f32_err["pallas"] <= FMA_VS_UNFUSED_MAX * f32_err["xla"],
            f"simulate pallas float32 vs float64 {f32_err['pallas']:.3e} > "
            f"{FMA_VS_UNFUSED_MAX} x xla's {f32_err['xla']:.3e}")

    print(f"linear paths' launches: {paths}", flush=True)
    for name, path in LINEAR_PATH.items():
        require(paths[path][name] > 0, f"{path} did not launch {name}: {paths[path]}")
    for path in ("simulate:xla", "simulate:xla:schedule"):
        require(not any(paths[path].values()),
                f"the plain engine launched a kernel: {paths[path]}")

    # -- phase 6: timings -----------------------------------------------------
    def best(fn, *args):
        return min(cuda_event_times(fn, *args, repeats=3, warmup=1, device=dev))

    env_steps = N_STEPS * N_ENVS
    power_k = best(lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER))
    power_p = best(lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER,
                                            use_pallas=False))
    power_host_us = dispatch_us(lambda: ms.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER),
                                dev)
    step_k = best(lambda: ms.rollout_pallas(eta, etad, u_m, N_STEPS))
    step_p = best(lambda: ms.rollout(eta, etad, u_m, N_STEPS))
    t0 = time.time()
    u64 = u_m.astype(np.float64)
    ms._power_map(K_POWER, u64)
    ms._power_map(N_STEPS % K_POWER, u64)
    compose_s = time.time() - t0

    lam, winv, _ = ms._stepper_consts(eta)
    u_t = torch.as_tensor(u_m, device=dev)  # on the card: no copy in the timed calls
    a0 = kr.initial_accel(lam, u_t, None, eta, etad)
    PK, bK = ms._power_map_device(K_POWER, u64, eta)
    Pr, br = ms._power_map_device(N_STEPS % K_POWER, u64, eta)
    apps = N_STEPS // K_POWER
    F, sub = SIM["frames"], SIM["substeps"]
    frames = dict(n_frames=F, substeps=sub, h=DT, rho_inf=RHO_INF)
    calls = {
        "modal_steps": (
            lambda: kr.modal_steps(lam, winv, u_t, eta, etad, a0, N_STEPS, DT, RHO_INF),
            lambda: kr.modal_steps_plain(lam, winv, u_t, eta, etad, a0, N_STEPS, DT, RHO_INF)),
        "affine_steps": (
            lambda: kr.affine_steps(PK, bK, eta, etad, a0, apps),
            lambda: kr.affine_steps_plain(PK, bK, eta, etad, a0, apps)),
        "affine_drive": (
            lambda: kr.affine_drive(lam, u_t, None, PK, bK, eta, etad, apps, Pr, br),
            lambda: kr.affine_drive_plain(lam, u_t, None, PK, bK, eta, etad, apps, Pr, br)),
    }
    # The frame drives as the engine calls them (its memoized coefficient
    # rows and maps), at simulate's shape and at full width; and the engine
    # entries themselves.
    t0 = time.time()
    coeffs = ms._frames_consts(u64, eta)[3]
    fargs = ms._frames_power_args(u64, F, sub, eta)
    entries = {}
    for tag, envs in (("", SIM["envs"]), (":full", N_ENVS)):
        e, ed = eta[:envs], etad[:envs]
        calls["modal_frames" + tag] = (
            lambda e=e, ed=ed: kr.modal_frames(lam, winv, u64, e, ed, **frames, coeffs=coeffs),
            lambda e=e, ed=ed: kr.modal_frames_plain(lam, winv, u_t, e, ed, **frames))
        calls["affine_frames" + tag] = (
            lambda e=e, ed=ed: kr.affine_frames(*fargs[:5], e, ed, fargs[5]),
            lambda e=e, ed=ed: kr.affine_frames_plain(*fargs[:5], e, ed, fargs[5]))
        for name in ("rollout_frames_pallas", "rollout_frames_power"):
            entries[name + tag] = best(
                lambda e=e, ed=ed, name=name: getattr(ms, name)(e, ed, u_m, F, substeps=sub))
    frames_s = time.time() - t0  # wall time of the frame drives' timings
    # The float32 twins run about ten float64 torch operations a multiply-add:
    # timed once, not best of 3 (the modal_steps twin takes seconds).
    times = {}
    for k, (kern, plain) in calls.items():
        t0 = time.time()
        times[k] = (best(kern), min(cuda_event_times(plain, repeats=1, warmup=0, device=dev)),
                    queued_device_ms(kern, dev),
                    dispatch_us(kern, dev) if "frames" in k else None)
        frames_s += time.time() - t0 if "frames" in k else 0.0
    bounds = linear_bounds(kr, n_red)
    from continuum_robot_tpu_torch.ops.cuda import _build

    lib = _build.library("modal_rollout")
    with torch.cuda.device(dev):  # the frames launcher's choice of envs a thread
        frame_envs = {B: lib.modal_frames_envs(B, n_red) for B in (SIM["envs"], N_ENVS)}
    print(f"phase 6 timings [{card}]: rollout_power K={K_POWER} "
          f"{env_steps / power_k * 1e3:.4e} env-steps/s ({power_k:.3f} ms) vs plain "
          f"{env_steps / power_p * 1e3:.4e} ({power_p:.3f} ms), host dispatch "
          f"{power_host_us:.1f} us a call; rollout_pallas "
          f"{env_steps / step_k * 1e3:.4e} env-steps/s ({step_k:.3f} ms) vs plain "
          f"{env_steps / step_p * 1e3:.4e} ({step_p:.3f} ms); host eigh "
          f"{eigh_s:.2f} s, map composition {compose_s:.4f} s", flush=True)
    print(f"phase 6 kernels [{card}]: " + "; ".join(
        f"{k} {t[0]:.4f} ms a lone launch, device {t[2]:.4f} ms (queued CUDA events)"
        + ("" if t[3] is None else f", host dispatch {t[3]:.1f} us")
        + f" vs plain {t[1]:.3f} ms (bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
        for k, t in times.items()), flush=True)
    print(f"phase 6 frames [{card}]: {F} frames x {sub} substeps, the engine's calls "
          f"(best of 3): " + "; ".join(f"{k} {v:.4f} ms" for k, v in entries.items())
          + f" (':full': {N_ENVS} envs, else {SIM['envs']}; modal_frames carries "
          f"{frame_envs[N_ENVS]} envs a thread at {N_ENVS}, "
          f"{frame_envs[SIM['envs']]} at {SIM['envs']}); timing the frame "
          f"drives, twins included, took {frames_s:.1f} s", flush=True)

    def full_width(name):
        t = times[name + ":full"]
        return {"envs": N_ENVS, "ms": t[0], "plain_ms": t[1], "device_ms": t[2],
                "device_ms_by": "queued_cuda_events",
                "dispatch_us": t[3], "bound_ms": bounds[name + ":full"][0],
                "bound_by": bounds[name + ":full"][1],
                "entry_ms": entries[{"modal_frames": "rollout_frames_pallas",
                                     "affine_frames": "rollout_frames_power"}[name] + ":full"]}

    return {
        name: dict(launches=paths[LINEAR_PATH[name]][name],
                   launches_by_path={p: c[name] for p, c in paths.items()},
                   ms=times[name][0], plain_ms=times[name][1], device_ms=times[name][2],
                   device_ms_by="queued_cuda_events",
                   bound=bounds[name], library_ms=None,
                   **({"dispatch_us": times[name][3], "full_width": full_width(name)}
                      if "frames" in name else {}))
        for name in REPLACES
    }, model, ms


# ---------------------------------------------------------------------------
# The ROM path
# ---------------------------------------------------------------------------


def small_rom_engines(crt, dev):
    """{case: engine} on the 8-element nonlinear and hybrid beams: diagonal,
    dense coupled Newton (via convert), damped, gathered ECSW."""
    from continuum_robot_tpu_torch import convert
    from continuum_robot_tpu_torch.models.simulate import make_modal_rom

    out = {}
    rng = np.random.default_rng(5)
    for kind in ("nonlinear", "mixed"):
        n_el = ROM_SMALL["n_el"]
        types_ = ["nonlinear"] * n_el if kind == "nonlinear" else (
            ["linear"] * (n_el // 2) + ["nonlinear"] * (n_el - n_el // 2))
        df = bench_beam_dataframe(n_el)
        df["type"] = types_
        df["length"] = 0.25
        model = crt.DynamicEulerBernoulliBeam(df)
        ms = make_modal_rom(model, DT, rho_inf=ROM["rho_inf"], n_modes=ROM_SMALL["m"],
                            device=dev, dtype=torch.float32)
        out[f"{kind}/diag"] = (model, ms)
        out[f"{kind}/damped"] = (model, make_modal_rom(
            model, DT, rho_inf=ROM["rho_inf"], n_modes=ROM_SMALL["m"],
            rayleigh=(0.5, 1e-6), device=dev, dtype=torch.float32))
        m = ms.n_modes
        coupled = ms.Sinv + 1e-3 * np.abs(np.diag(ms.Sinv)).mean() * rng.normal(size=(m, m)) / m
        out[f"{kind}/dense"] = (model, convert.modal_rom_engine_from_numpy(
            ms.Phi, ms.PhiW, ms.PhiTM, coupled, ms.lam, ms.rho_inf, ms.dt, model,
            device=dev, dtype=torch.float32))
        u = np.zeros(model.n_pos_states)
        u[-2] = 3.0
        z = torch.zeros((1, m), dtype=torch.float32, device=dev)
        _, etas, _ = ms.rollout_frames(z, z, ms.project_force_host(u), 10,
                                       substeps=5, n_newton=2)
        out[f"{kind}/gathered"] = (model, ms.hyper_reduce(etas[::2, 0, :], tau=1e-3))
    return out


def phase_rom_small(engines, rk, dev):
    from continuum_robot_tpu_torch.utils import force_completion

    worst = 0.0
    rng = np.random.default_rng(6)
    for case, (model, ms) in engines.items():
        m = ms.n_modes
        eta = torch.tensor(rng.normal(scale=ROM_SMALL["amp"], size=(ROM_SMALL["B"], m)),
                           dtype=torch.float32, device=dev)
        u = np.zeros(model.n_pos_states)
        u[-2] = 5.0
        fused = ms.make_pallas_rollout()
        op, e, ed, a0, _ = fused.prepare(eta, torch.zeros_like(eta),
                                         ms.project_force_host(u))
        out = rk.rom_steps(op, e, ed, a0, ROM_SMALL["steps"], ROM_SMALL["n_newton"])
        ref = rk.rom_steps_plain(op, e, ed, a0, ROM_SMALL["steps"], ROM_SMALL["n_newton"])
        force_completion(out)
        err = scaled_err(out, ref)
        worst = max(worst, err)
        print(f"phase 7 ROM kernel vs plain, small: {case} B={ROM_SMALL['B']} m={m} "
              f"{ROM_SMALL['steps']} steps: max|kernel-plain|/scale {err:.3e} "
              f"(each of eta, etad, etadd against its own scale)", flush=True)
        require(err <= ROM_SMALL_MAX, f"ROM kernel vs plain ({case}): {err:.3e}")
    return worst


def timed_once(fn, dev):
    """``(result, ms)`` of one call, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.device(dev):
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    return out, start.elapsed_time(end)


def rom_main_path(crt, dev):
    """The ROM main path's model, engine and inputs (phase 8's set-up):
    ``(model, ms, eta, etad, u_m, setup seconds)``."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod

    t0 = time.time()
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "nonlinear"))
    setup = {"model": time.time() - t0}
    with clocked(sim_mod, "reduce_matrix_dense", "_lowest_modes_sparse") as secs:
        t0 = time.perf_counter()
        ms = sim_mod.make_modal_rom(model, DT, rho_inf=ROM["rho_inf"],
                                    n_modes=ROM["modes"], device=dev,
                                    dtype=torch.float32)
        total = time.perf_counter() - t0
    require(len(secs["_lowest_modes_sparse"]) == 2,
            "the full-width build did not take the Arnoldi branch")
    setup["k0"] = sum(secs["reduce_matrix_dense"])
    setup["arpack_right"], setup["arpack_left"] = secs["_lowest_modes_sparse"]
    setup["compose"] = total - setup["k0"] - setup["arpack_right"] - setup["arpack_left"]
    n_red = model.n_pos_states
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(N_ENVS, n_red)),
                     dtype=torch.float32, device=dev)
    u = np.zeros(n_red, np.float32)
    u[-2] = 0.1
    eta, etad = ms.to_modal(q, torch.zeros_like(q))
    return model, ms, eta, etad, ms.project_force_host(u).astype(np.float32), setup


# Late in a full run, torch.profiler traces on the card come back without
# the kernels' records now and then (the runtime calls that launched them
# are there): two in a row before a full one at phase 51 in two runs.
PROFILER_TRIES = 6
TRACE_PAD_S = 0.02  # host pause around phase 51's traced path, seconds
EMPTY_TRACES = []  # where a trace held no device event; printed at the end of the run


def device_ms(fn, dev, n: int = 10) -> tuple:
    """``(ms, method)``: device milliseconds per call of ``fn``, its CUDA
    kernels' time under ``torch.profiler`` over ``n`` calls after a warm-up,
    divided by the calls the trace holds (the most launches of one kernel);
    ``method`` is ``"profiler"``. A trace with no device time is taken
    again, up to ``PROFILER_TRIES`` times; after that the calls are timed by
    CUDA events (``queued_device_ms``), ``method`` is ``"queued_cuda_events"``
    and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for _ in range(PROFILER_TRIES):
        EMPTY_TRACES.append("device_ms")  # taken back below if the trace holds device time
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
        if total > 0:
            EMPTY_TRACES.pop()
            # Per call as the trace recorded them (a one-kernel call: per launch).
            return total / 1e3 / launches, "profiler"
    print(f"device_ms: {PROFILER_TRIES} profiler traces held no device time; "
          "timed by queued CUDA events instead", flush=True)
    return queued_device_ms(fn, dev, n), "queued_cuda_events"


def queued_device_ms(fn, dev, n: int = 10, repeats: int = 3) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events, with no host
    time in them: ``n`` calls queued behind a spin of the card
    (``torch.cuda._sleep``) between two events, so the card runs them back
    to back (the gap between two launches, about a microsecond, counts in);
    the best of ``repeats``. Fails unless the host has queued the last call
    before the card reaches the first event. Unlike ``device_ms`` it needs no
    profiler trace."""
    fn()
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles, times = 20_000_000, []  # about 10 ms of the card's clock
    for _ in range(4 * repeats):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()  # the card is still spinning
        end.synchronize()
        if queued:
            times.append(start.elapsed_time(end) / n)
            if len(times) == repeats:
                return min(times)
        else:
            cycles *= 2
    require(False, "queued_device_ms: the card reached the calls before the host queued them")


def dispatch_us(fn, dev, n: int = 200) -> float:
    """Host microseconds per call of ``fn`` without synchronising: the
    wrapper's dispatch, as a span of many launches pays it."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    return (t1 - t0) / n * 1e6


def profile_rom(crt, dev, card, nl_precision=None) -> None:
    """``--profile`` (``--profile highest``: ``nl_precision="highest"``):
    device time by kernel over ``PROFILE_STEPS`` steps of the ROM main path,
    and the busy share of the unprofiled steps."""
    _, ms, eta, etad, u_m, _ = rom_main_path(crt, dev)
    fused = ms.make_pallas_rollout()
    what = "the ROM main path" + (f" at nl_precision={nl_precision!r}" if nl_precision else "")
    profile_span(lambda: fused(eta, etad, u_m, PROFILE_STEPS, n_newton=ROM["n_newton"],
                               nl_precision=nl_precision), dev, card, what)


def profile_dense(crt, dev, card) -> None:
    """``--profile dense``: the same for the dense-Newton span."""
    _, ms, eta, etad, u_m, _ = rom_main_path(crt, dev)
    fused_d = dataclasses.replace(ms, Sinv_diag=None).make_pallas_rollout()
    profile_span(lambda: fused_d(eta, etad, u_m, PROFILE_STEPS, n_newton=ROM["n_newton"]),
                 dev, card, "the dense-Newton span")


def kernel_rows(fn, dev) -> list:
    """``[(device ms, launches, kernel)]`` of one ``fn()`` under
    ``torch.profiler``, the largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    rows = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            rows.append((dev_us / 1e3, ev.count,
                         ev.key.replace("(anonymous namespace)::", "")))
    rows.sort(reverse=True)
    require(rows, "the profiler recorded no device time")
    return rows


def busy_share(fn, dev) -> tuple:
    """``(device busy ms, wall ms, share)``: the kernels' device time of one
    profiled ``fn()`` over the best of three unprofiled runs' wall time."""
    fn()
    _, wall_ms = min((timed_once(fn, dev) for _ in range(3)), key=lambda r: r[1])
    busy = sum(r[0] for r in kernel_rows(fn, dev))
    return busy, wall_ms, busy / wall_ms


def profile_span(span, dev, card, what: str, steps: int = PROFILE_STEPS) -> None:
    """Run ``span`` (``steps`` steps of ``what``) under ``torch.profiler``:
    device time by kernel, and the device's busy share of the best of three
    unprofiled runs."""
    span()
    _, wall_ms = min((timed_once(span, dev) for _ in range(3)), key=lambda r: r[1])
    rows = kernel_rows(span, dev)
    busy = sum(r[0] for r in rows)
    print(f"profile [{card}]: {steps} steps of {what}, "
          f"unprofiled {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.3f} of it)", flush=True)
    for dev_ms, count, key in rows:
        print(f"profile: {dev_ms / steps:.4f} ms/step, {count} launches, "
              f"{dev_ms / count:.4f} ms/launch: {key[:150]}", flush=True)


def rom_span_bounds(rk, op, B: int, steps: int) -> dict:
    """Bounds of a ROM window span of ``steps`` steps over ``B`` envs (one
    Newton iteration a step): ``"tf32"`` with its two products at the TF32
    peak (three passes) and the rest at the float32 peak, ``"f32"`` all in
    float32 (the "highest" tier); and the counts behind them."""
    from continuum_robot_tpu_torch.models import elements

    m, N = op.w.shape[1], op.n_rows
    E = N // 3 - 1
    corr_ops = count_ops(lambda *a: elements.nonlinear_correction_planes(*a), 9) + 6
    counter_op = types.SimpleNamespace(sc=op.sc)
    epi_ops = count_ops(lambda e, ed, edd, a1, gm, lam, uu, si: rk._finish(
        counter_op, a1 - si * rk._residual(
            types.SimpleNamespace(lam=lam, u=uu, cd=None, sc=counter_op.sc),
            gm, e, ed, edd, a1), e, ed, edd, True), 8)
    af_ops = count_ops(lambda e, ed, edd, a1: rk.rom_alpha_point_plain(
        counter_op, e, ed, edd, a1), 4)
    splits = rk.project_splits(B, m, N, op.w.device)
    splits_f32 = rk.project_splits_f32(B, m, N, op.w.device)
    gemm_ops = steps * 4 * B * m * N

    def other_ops(s):  # all but the products, with s partials summed
        return steps * (B * E * corr_ops + 3 * B * (N // 3)
                        + B * m * (af_ops + s - 1 + epi_ops))

    span_bytes = 4 * (4 * m * N + 6 * B * m + 3 * m + 4 * E)
    return dict(tf32=bound(other_ops(splits), span_bytes, tc_ops=3 * gemm_ops),
                f32=bound(other_ops(splits_f32) + gemm_ops, span_bytes), corr_ops=corr_ops,
                epi_ops=epi_ops, af_ops=af_ops, splits=splits, counter_op=counter_op)


def train_main_ecsw(ms, n_red: int, dev):
    """Phase 9's ECSW training on the ROM main path's engine: a 3 N tip load,
    30 frames x 20 substeps on 1 env, 2 Newton iterations, snapshots
    [::3], tau 1e-3. Returns the reduced engine, the NNLS info and the
    seconds of the training rollout and of the NNLS."""
    u_tr = np.zeros(n_red)
    u_tr[-2] = 3.0
    z = torch.zeros((1, ms.n_modes), dtype=torch.float32, device=dev)
    t0 = time.time()
    _, etas_tr, _ = ms.rollout_frames(z, z, ms.project_force_host(u_tr), 30,
                                      substeps=20, n_newton=2)
    train_s = time.time() - t0
    t0 = time.time()
    ms_g, info = ms.hyper_reduce(etas_tr[::3, 0, :], tau=1e-3, return_info=True)
    return ms_g, info, train_s, time.time() - t0


def rom_paths(crt, rk, dev, card, small_model):
    """Phases 8-12; returns the ROM kernels' records and the main path's
    engines and inputs (phases 29-32 reuse them)."""
    from continuum_robot_tpu_torch.utils import cuda_event_times, force_completion

    # -- phase 8: the ROM main path at full width -------------------------------
    model, ms, eta, etad, u_m, setup = rom_main_path(crt, dev)
    n_red = model.n_pos_states
    rng = np.random.default_rng(0)
    fused = ms.make_pallas_rollout()

    n_it = N_STEPS * ROM["n_newton"]
    (out, span_first_ms), paths = counted(rk, lambda: timed_once(
        lambda: fused(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"]), dev))
    paths = {"window": paths}
    expect_launches(paths["window"], ROM_WINDOW, n_it, "ROM main path")
    op, e0, ed0, a0, _ = fused.prepare(eta, etad, u_m)
    ref, plain_span_ms = timed_once(
        lambda: rk.rom_steps_plain(op, e0, ed0, a0, N_STEPS, ROM["n_newton"]), dev)
    span_rel = rel_state(out, ref)
    q2, v2 = ms.from_modal(out[0], out[1])
    force_completion((q2, v2))
    finite = bool(torch.isfinite(q2).all() and torch.isfinite(v2).all())
    window = ms.Phi_planar.shape[0]
    print(f"phase 8 ROM main path: {N_ELEMENTS} nonlinear elements, {ms.n_modes} "
          f"modes, window {window // 3} nodes ({window} rows), {N_ENVS} envs, "
          f"{N_STEPS} steps, n_newton={ROM['n_newton']}, diagonal Newton "
          f"{ms.Sinv_diag is not None}: vs_plain_rel={span_rel:.3e} finite={finite} "
          f"q shape {tuple(q2.shape)}; launches {paths['window']}; host set-up: "
          f"model build {setup['model']:.2f} s, K0 {setup['k0']:.2f} s, ARPACK right "
          f"{setup['arpack_right']:.2f} s, left {setup['arpack_left']:.2f} s, "
          f"composition {setup['compose']:.2f} s", flush=True)
    require(finite and q2.shape == (N_ENVS, n_red), "ROM: non-finite or misshapen states")
    require(span_rel <= ROM_SPAN_MAX, f"ROM kernel vs plain span {span_rel:.3e}")
    # The "highest" tier: the float32 transforms. The twin is the same for
    # every tier (float32 torch.matmul), so ``ref`` holds it too.
    (out_h, h_first_ms), paths["highest"] = counted(rk, lambda: timed_once(
        lambda: fused(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"],
                      nl_precision="highest"), dev))
    expect_launches(paths["highest"], ROM_HIGHEST, n_it, "ROM highest span")
    h_rel, h_vs_tc = rel_state(out_h, ref), rel_state(out_h, out)
    spans = rom_span_bounds(rk, op, N_ENVS, N_STEPS)
    print(f"phase 8 ROM highest span [{card}]: {N_ENVS} envs, {N_STEPS} steps: "
          f"vs_plain_rel={h_rel:.3e}, vs the 3xTF32 span {h_vs_tc:.3e}; {h_first_ms:.3f} ms "
          f"(first call) against its all-float32 bound {spans['f32'][0]:.3f} ms "
          f"({spans['f32'][1]}); launches {paths['highest']}", flush=True)
    require(all(bool(torch.isfinite(x).all()) for x in out_h), "ROM highest: non-finite")
    require(h_rel <= ROM_SPAN_MAX, f"ROM highest kernel vs plain span {h_rel:.3e}")

    # -- phase 9: ECSW at full width ----------------------------------------------
    ms_g, info, train_s, nnls_s = train_main_ecsw(ms, n_red, dev)
    fused_g = ms_g.make_pallas_rollout()
    out_g, paths["ecsw"] = counted(
        rk, lambda: fused_g(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"]))
    expect_launches(paths["ecsw"], ROM_GATHERED, n_it, "ECSW gathered span")
    op_g, eg, edg, ag, _ = fused_g.prepare(eta, etad, u_m)
    ref_g, plain_g_ms = timed_once(
        lambda: rk.rom_steps_plain(op_g, eg, edg, ag, N_STEPS, ROM["n_newton"]), dev)
    g_rel = rel_state(out_g, ref_g)
    vs_window = rel_state(out_g, out)
    print(f"phase 9 ECSW: n_sampled={info['n_sampled']} of {N_ELEMENTS}, train "
          f"residual {info['train_residual']:.3e} (training rollout {train_s:.2f} s, "
          f"NNLS {nnls_s:.2f} s); gathered kernels {N_ENVS} envs x {N_STEPS} steps: "
          f"vs_plain_rel={g_rel:.3e}, vs window engine {vs_window:.3e}", flush=True)
    require(all(bool(torch.isfinite(x).all()) for x in out_g), "ECSW: non-finite states")
    require(g_rel <= ROM_SPAN_MAX, f"gathered kernel vs plain span {g_rel:.3e}")

    # -- phase 10: dense Newton at full width -------------------------------------
    ms_d = dataclasses.replace(ms, Sinv_diag=None)
    fused_d = ms_d.make_pallas_rollout()
    out_d, paths["dense_newton"] = counted(
        rk, lambda: fused_d(eta, etad, u_m, ROM["dense_steps"], n_newton=ROM["n_newton"]))
    expect_launches(paths["dense_newton"], ROM_DENSE,
                    ROM["dense_steps"] * ROM["n_newton"], "dense-Newton span")
    op_d, ed_, edd_, ad_, _ = fused_d.prepare(eta, etad, u_m)
    ref_d = rk.rom_steps_plain(op_d, ed_, edd_, ad_, ROM["dense_steps"], ROM["n_newton"])
    diag_d = fused(eta, etad, u_m, ROM["dense_steps"], n_newton=ROM["n_newton"])
    d_rel, d_vs_diag = rel_state(out_d, ref_d), rel_state(out_d, diag_d)
    dense_ms = min(cuda_event_times(
        lambda: fused_d(eta, etad, u_m, ROM["dense_steps"], n_newton=ROM["n_newton"]),
        repeats=3, warmup=1, device=dev))
    print(f"phase 10 dense Newton [{card}]: {ROM['dense_steps']} steps: vs_plain_rel="
          f"{d_rel:.3e}, vs diagonal Newton {d_vs_diag:.3e}; span {dense_ms:.3f} ms = "
          f"{ROM['dense_steps'] * N_ENVS / dense_ms * 1e3:.4e} env-steps/s (best of 3)",
          flush=True)
    require(d_rel <= ROM_SPAN_MAX and d_vs_diag <= ROM_SPAN_MAX,
            f"dense Newton: vs plain {d_rel:.3e}, vs diagonal {d_vs_diag:.3e}")

    # -- phase 11: simulate(method="modal_rom") -----------------------------------
    n_s = small_model.n_pos_states
    x0 = np.zeros((ROM_SIM["envs"], 2 * n_s))
    x0[:, :n_s] = rng.normal(scale=1e-4, size=(ROM_SIM["envs"], n_s))
    u_s = np.zeros(n_s)
    u_s[-2] = 0.1
    frame_dt = DT * ROM_SIM["substeps"]
    ys = {}
    for engine in ("pallas", "xla"):
        res, paths[f"simulate:{engine}"] = counted(rk, lambda: crt.simulate(
            small_model, x0, ROM_SIM["frames"] * frame_dt, frame_dt,
            method="modal_rom", u=u_s, substeps=ROM_SIM["substeps"],
            rho_inf=ROM["rho_inf"], n_modes=ROM_SMALL["m"], n_newton=1,
            engine=engine, device=dev))
        ys[engine] = force_completion(res.ys)
        require(tuple(res.ys.shape) == (ROM_SIM["frames"] + 1, ROM_SIM["envs"], 2 * n_s)
                and bool(torch.isfinite(res.ys).all()),
                f"simulate modal_rom engine={engine}: bad output")
    sim_rel = rel(ys["pallas"].double(), ys["xla"])
    print(f"phase 11 simulate modal_rom: {ROM_SIM}: pallas (f32) vs xla (f64) "
          f"max rel {sim_rel:.3e}", flush=True)
    require(sim_rel <= 1e-5, f"simulate modal_rom pallas vs xla {sim_rel:.3e}")

    expect_launches(paths["simulate:pallas"], ROM_WINDOW,
                    ROM_SIM["frames"] * ROM_SIM["substeps"], "simulate modal_rom pallas")
    expect_launches(paths["simulate:xla"], (), 0, "simulate modal_rom xla")
    print(f"ROM paths' launches: {paths}", flush=True)

    # -- phase 12: timings ------------------------------------------------------
    def best(fn):
        return min(cuda_event_times(fn, repeats=3, warmup=1, device=dev))

    env_steps = N_STEPS * N_ENVS
    span_ms = best(lambda: fused(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"]))
    span_h_ms = best(lambda: fused(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"],
                                   nl_precision="highest"))
    span_g_ms = best(lambda: fused_g(eta, etad, u_m, N_STEPS, n_newton=ROM["n_newton"]))
    af0 = rk.rom_alpha_point_plain(op, e0, ed0, a0, a0)
    g0 = rk.rom_correction_window_plain(op, rk.rom_expand_plain(op, af0))

    def library_span():  # the two products of every step, results dropped
        for _ in range(N_STEPS):
            torch.matmul(af0, op.phiT)
            torch.matmul(g0, op.w)

    lib_span_ms = best(library_span)
    B, m, N = N_ENVS, ms.n_modes, op.n_rows
    E = N // 3 - 1
    s = op_g.n_rows // 6
    # The two products run three TF32 passes on the tensor cores, the rest
    # in float32 on the CUDA cores; span_f32 is the bound of all in float32.
    span_bound, span_f32 = spans["tf32"], spans["f32"]  # the latter the "highest" span's
    corr_ops, epi_ops, af_ops = spans["corr_ops"], spans["epi_ops"], spans["af_ops"]
    splits, counter_op = spans["splits"], spans["counter_op"]
    print(f"phase 12 ROM timings [{card}]: window span {span_ms:.3f} ms = "
          f"{env_steps / span_ms * 1e3:.4e} env-steps/s (first call {span_first_ms:.3f} ms) "
          f"vs plain twin {plain_span_ms:.3f} ms (one run) and torch.matmul of the "
          f"two products x {N_STEPS} {lib_span_ms:.3f} ms; bound {span_bound[0]:.3f} ms "
          f"({span_bound[1]}; all float32: {span_f32[0]:.3f} ms), kernel at "
          f"{span_bound[0] / span_ms:.3f} of it; \"highest\" span {span_h_ms:.3f} ms = "
          f"{env_steps / span_h_ms * 1e3:.4e} env-steps/s, at {span_f32[0] / span_h_ms:.3f} "
          f"of its all-float32 bound {span_f32[0]:.3f} ms; gathered "
          f"(s={s}) span {span_g_ms:.3f} ms = {env_steps / span_g_ms * 1e3:.4e} "
          f"env-steps/s vs plain twin {plain_g_ms:.3f} ms (one run)", flush=True)

    # Each kernel alone at the main path's shapes, on a mid-span state.
    st = out
    a1 = st[2]
    op_dense = fused_d.operators(st[0], u_m)
    op_h = fused.operators(st[0], u_m, "highest")
    eta_af = rk.rom_alpha_point_plain(op, *st, a1)
    x = rk.rom_expand_plain(op, eta_af)
    g = rk.tma_rows(rk.rom_correction_window_plain(op, x))  # rows padded as on the path
    xg = rk.rom_expand_plain(op_g, eta_af)
    partials = rk.rom_project(op, g)
    r = rk._partials_residual(op_dense, partials, *st, a1)  # for the library call
    dense_ops = (count_ops(lambda e, ed, edd, a1_, gm, lam, uu: rk._residual(
        types.SimpleNamespace(lam=lam, u=uu, cd=None, sc=counter_op.sc),
        gm, e, ed, edd, a1_), 7)
        + count_ops(lambda e, ed, edd, a1_, dr: rk._finish(
            counter_op, a1_ - dr, e, ed, edd, True), 5) + splits - 1)
    state_bytes = 4 * B * m
    splits_f32 = rk.project_splits_f32(B, m, N, dev)
    pieces = {
        "rom_alpha_point": (
            lambda: rk.rom_alpha_point(op, *st, a1),
            lambda: rk.rom_alpha_point_plain(op, *st, a1), None,
            bound(B * m * af_ops, 4 * state_bytes)),  # a1 is etadd here
        "rom_expand": (
            lambda: rk.rom_expand(op, eta_af), lambda: rk.rom_expand_plain(op, eta_af),
            lambda: torch.matmul(eta_af, op.phiT),
            bound(0, state_bytes + 4 * (2 * m * N + B * N), tc_ops=3 * 2 * B * m * N)),
        "rom_correction_window": (  # bytes: x, g, L, A, mask and the factor table
            lambda: rk.rom_correction_window(op, x),
            lambda: rk.rom_correction_window_plain(op, x), None,
            bound(B * E * corr_ops + 3 * B * (N // 3),
                  4 * (2 * B * N + (3 + rk.CORRECTION_FACTORS) * E))),
        "rom_correction_gathered": (
            lambda: rk.rom_correction_gathered(op_g, xg),
            lambda: rk.rom_correction_gathered_plain(op_g, xg), None,
            bound(B * s * corr_ops, 4 * (2 * B * 6 * s + (3 + rk.CORRECTION_FACTORS) * s))),
        "rom_project": (  # compared as the sum of its partial products
            lambda: rk.rom_project(op, g), lambda: rk.rom_project_plain(op, g),
            lambda: torch.matmul(g, op.w),
            bound(0, 4 * (B * N + 2 * N * m) + splits * state_bytes,
                  tc_ops=3 * 2 * B * N * m)),
        "rom_update": (
            lambda: rk.rom_update(op, partials, *st, a1, True),
            lambda: rk.rom_update_plain(op, partials, *st, a1, True), None,
            bound(B * m * (splits - 1 + epi_ops),
                  (splits + 6) * state_bytes + 4 * 3 * m)),
        "rom_newton_dense": (  # the partials' sum, the residual, the product, the update
            lambda: rk.rom_newton_dense(op_dense, partials, *st, a1, True),
            lambda: rk.rom_newton_dense_plain(op_dense, partials, *st, a1, True),
            lambda: r @ op_dense.sinvT,
            bound(2 * B * m * m + B * m * dense_ops,
                  4 * (m * m + 3 * m) + (splits + 4 + 3) * state_bytes)),
        "rom_expand_f32": (
            lambda: rk.rom_expand_f32(op_h, eta_af), lambda: rk.rom_expand_plain(op_h, eta_af),
            lambda: torch.matmul(eta_af, op_h.phiT),
            bound(2 * B * m * N, state_bytes + 4 * (m * N + B * N))),
        "rom_project_f32": (  # compared as the sum of its partial products
            lambda: rk.rom_project_f32(op_h, g), lambda: rk.rom_project_plain(op_h, g),
            lambda: torch.matmul(g, op_h.w),
            bound(2 * B * N * m, 4 * (B * N + N * m) + splits_f32 * state_bytes)),
    }
    # The float32 CUDA-core bounds of the two products, for reference.
    f32_bounds = {"rom_expand": bound(2 * B * m * N, state_bytes + 4 * (m * N + B * N)),
                  "rom_project": bound(2 * B * N * m,
                                       4 * (B * N + N * m) + splits * state_bytes)}
    records = {}
    for name, (kern, plain, lib, bnd) in pieces.items():
        k_out, p_out = kern(), plain()
        if name in ("rom_project", "rom_project_f32"):
            k_out, p_out = k_out.sum(0), p_out.sum(0)
        err, ratio = max_abs(k_out, p_out), scaled_err(k_out, p_out)
        limit = ROM_F32_PIECE_MAX if name.endswith("_f32") else ROM_PIECE_MAX
        require(ratio <= limit,
                f"{name}: kernel vs plain {errors(k_out, p_out)} (max|k-p|, scale)")
        k_dev_ms, k_dev_by = device_ms(kern, dev)
        records[name] = dict(
            launches=paths[ROM_PATH[name]][name],
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=err, scaled_err=ratio, ms=best(kern), device_ms=k_dev_ms,
            device_ms_by=k_dev_by,
            plain_ms=best(plain), bound=bnd,
            library_ms=None if lib is None else best(lib))
        if name in ROM_DESIGN:
            records[name]["design"] = ROM_DESIGN[name]
        if name in f32_bounds:
            records[name]["bound_f32"] = f32_bounds[name]
    # The correction kernels against a float64 evaluation of the planes,
    # beside the float32 twin's own error (each as a fraction of the twin's
    # scale).
    f64_ops = {"rom_correction_window": (fused.operators(x.double(), u_m), x),
               "rom_correction_gathered": (fused_g.operators(xg.double(), u_m), xg)}
    for name, (op64, xin) in f64_ops.items():
        ref64 = (rk.rom_correction_window_plain if name.endswith("window")
                 else rk.rom_correction_gathered_plain)(op64, xin.double())
        k_out, p_out = pieces[name][0](), pieces[name][1]()
        scale = float(p_out.abs().max())
        k64 = float((k_out.double() - ref64).abs().max()) / scale
        p64 = float((p_out.double() - ref64).abs().max()) / scale
        records[name].update(vs_f64=k64, twin_vs_f64=p64)
        print(f"phase 12 {name} vs float64 [{card}]: kernel {k64:.3e}, float32 twin "
              f"{p64:.3e} (x the twin's scale; limit {ROM_CORR_F64_RATIO} x the twin's)",
              flush=True)
        require(k64 <= ROM_CORR_F64_RATIO * p64,
                f"{name}: vs float64 {k64:.3e}, over {ROM_CORR_F64_RATIO} x the twin's {p64:.3e}")
    host = {name: dispatch_us(pieces[name][0], dev)
            for name in ("rom_alpha_point", "rom_correction_window",
                         "rom_correction_gathered", "rom_update", "rom_newton_dense")}
    print(f"phase 12 ROM dispatch [{card}]: host us per wrapper call (200 calls, no "
          f"synchronisation): " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()),
          flush=True)
    print(f"phase 12 ROM kernels [{card}]: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f}) vs plain {v['plain_ms']:.4f} ms, "
        f"library "
        f"{'none' if v['library_ms'] is None else '%.4f ms' % v['library_ms']}, "
        f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}"
        + (f"; float32 CUDA cores {v['bound_f32'][0]:.4f} ms" if "bound_f32" in v else "")
        + f"), max|k-p| {v['max_abs_err']:.3e}, /scale {v['scaled_err']:.3e}"
        for k, v in records.items()), flush=True)
    return records, dict(model=model, ms=ms, ms_g=ms_g, eta=eta, etad=etad, u_m=u_m)


# ---------------------------------------------------------------------------
# The full-order implicit path
# ---------------------------------------------------------------------------


def gen_alpha_system(rho_inf: float, h: float = DT):
    """``(a, c)`` of the generalized-alpha effective Jacobian ``a M + c K``."""
    am = (2.0 * rho_inf - 1.0) / (rho_inf + 1.0)
    af = rho_inf / (rho_inf + 1.0)
    beta = 0.25 * (1.0 - am + af) ** 2
    return 1.0 - am, (1.0 - af) * beta * h * h


def implicit_op(crt, model, rho_inf: float, solver: str, dev):
    return crt.make_newmark_operator(model, dt=None, linear_solver=solver,
                                     extra_systems=[gen_alpha_system(rho_inf)],
                                     device=dev)


def implicit_start(op, n_red: int, dtype, dev):
    """The bench's start: q ~ N(0, 1e-6) (seed 0), v = 0, tip force 0.1,
    consistent acceleration; ``(q, v, a, u)``."""
    q = torch.tensor(np.random.default_rng(0).normal(scale=1e-6, size=(N_ENVS, n_red)),
                     dtype=dtype, device=dev)
    u = torch.zeros(n_red, dtype=dtype, device=dev)
    u[-2] = 0.1
    return q, torch.zeros_like(q), op.solve(q, 0.0)(u - op.internal_force(q)), u


def implicit_span(crt, op, state, steps: int, rho_inf: float, n_newton: int):
    """``steps`` generalized-alpha steps from ``(q, v, a, u)``; ``(q, v, a)``."""
    q, v, a, u = state
    for _ in range(steps):
        q, v, a = crt.generalized_alpha_step(op, 0.0, q, v, a, DT, u,
                                             rho_inf=rho_inf, n_newton=n_newton)
    return q, v, a


def implicit_path(crt, kb, op, n_red, dtype, dev, rho_inf, n_newton):
    """One counted run of an implicit main path from the bench's start:
    ``((q, v, a), ms, launches)``. The launches count the initial
    acceleration's solve too; the time is the steps' alone."""
    kb.reset_launch_counts()
    start = implicit_start(op, n_red, dtype, dev)
    out, span_ms = timed_once(
        lambda: implicit_span(crt, op, start, N_STEPS, rho_inf, n_newton), dev)
    return out, span_ms, kb.btd_solve.launches


def finite(*xs) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in xs)


def btd_host_factors(model, a: float, c: float):
    """The prefactored block-Thomas factors of ``a M + c K0`` (host float64)."""
    from continuum_robot_tpu_torch.models import assembly
    from continuum_robot_tpu_torch.ops import banded

    arrays, bc = model.beam_model.arrays, model.beam_model.bc_info
    md, moff = assembly.mass_block_tridiagonal(arrays)
    kd, kl, ku = assembly.tangent_block_tridiagonal(arrays, np.zeros(bc.n_dofs_full))
    bands = banded.btd_apply_bc(a * md + c * kd, a * np.swapaxes(moff, -1, -2) + c * kl,
                                a * moff + c * ku, bc.free_mask.reshape(-1, 3))
    return banded.btd_factor(*bands)


def random_btd_factors(n: int, rng):
    """Block-Thomas factors of a random diagonally dominant system of ``n``
    nodes (host float64)."""
    from continuum_robot_tpu_torch.ops import banded

    d = rng.normal(size=(n, 3, 3))
    return banded.btd_factor(d + np.swapaxes(d, -1, -2) + 10 * np.eye(3),
                             0.3 * rng.normal(size=(n - 1, 3, 3)),
                             0.3 * rng.normal(size=(n - 1, 3, 3)))


def dense_system_inverse(model, a: float, c: float, dev) -> torch.Tensor:
    """The dense float32 inverse of ``a M + c K0`` on the free DOFs: the
    library yardstick of the block-tridiagonal kernels (one ``torch.matmul``
    of the rows' free part with it)."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod

    J = (a * np.asarray(model.beam_model.M.toarray())
         + c * sim_mod.reduce_matrix_dense(model.beam_model.arrays,
                                           model.beam_model.bc_info.free_dofs))
    return torch.tensor(np.linalg.inv(J), dtype=torch.float32, device=dev)


def padded_rows(x: torch.Tensor, kb) -> torch.Tensor:
    """``(B, N, 3)`` ``x`` in rows padded to the kernel's pitch (NaN in the
    pad), as the implicit operator hands them to it."""
    b, n, _ = x.shape
    buf = torch.full((b, kb.padded_width(3 * n)), float("nan"), dtype=x.dtype,
                     device=x.device)
    return buf[:, :3 * n].copy_(x.reshape(b, -1)).reshape(b, n, 3)


def phase_btd_kernel(kb, model, dev):
    """Phase 13: the kernel against its plain version, bit for bit, at
    ragged sizes and the main path's."""
    from continuum_robot_tpu_torch.ops import banded

    rng = np.random.default_rng(11)
    full = btd_host_factors(model, *gen_alpha_system(IMPLICIT["rho_lin"]))
    n_full = full[0].shape[0]
    err = 0.0
    for dtype in (torch.float32, torch.float64):
        chunk = BTD_CHUNK[dtype]
        cases = [(random_btd_factors(n, rng), n, b)
                 for n in (1, 2, chunk - 1, chunk + 1) for b in (1, 31, 33, N_ENVS)]
        cases += [(full, n_full, b) for b in (1, 31, 33, N_ENVS)]
        worst = {}
        for fac, n, b in cases:
            f = kb.pack_factors(tuple(torch.tensor(x, dtype=dtype, device=dev) for x in fac))
            rhs = torch.tensor(rng.normal(size=(b, n, 3)), dtype=dtype, device=dev)
            ref = banded.btd_solve(f, rhs)
            for pitch, r in (("unpadded", rhs), ("padded", padded_rows(rhs, kb))):
                kb.reset_launch_counts()
                out = kb.btd_solve(f, r)
                require(kb.btd_solve.launches == 1, "btd_solve did not launch its kernel")
                require(finite(out), f"btd_solve: non-finite solution (N={n}, B={b}, {pitch})")
                e = float((out - ref).abs().max())
                worst[(n, b, pitch)] = e
                err = max(err, e)
        print(f"phase 13 btd_solve vs plain: {str(dtype)[6:]}, chunk {chunk} nodes, "
              f"N in {sorted({k[0] for k in worst})} x B in {sorted({k[1] for k in worst})} "
              f"x padded/unpadded rows: max|kernel-plain| {max(worst.values()):.3e} "
              f"(main path N={n_full} B={N_ENVS}: "
              f"{worst[(n_full, N_ENVS, 'padded')]:.3e})", flush=True)
    require(err == 0.0, f"btd_solve: kernel and plain version differ by {err:.3e}")
    return err


def implicit_paths(crt, kb, dev, card, lin_model, lin_ms):
    """Phases 13-17; returns the block-tridiagonal kernel's record."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod
    from continuum_robot_tpu_torch.ops import banded
    from continuum_robot_tpu_torch.utils import cuda_event_times, force_completion

    err = phase_btd_kernel(kb, lin_model, dev)
    n_red = lin_model.n_pos_states
    paths = {}

    # -- phase 14: the linear implicit main path ---------------------------------
    rho, nn = IMPLICIT["rho_lin"], IMPLICIT["newton_lin"]
    t0 = time.time()
    op = implicit_op(crt, lin_model, rho, "pallas", dev)
    op_s = time.time() - t0
    implicit_span(crt, op, implicit_start(op, n_red, torch.float32, dev), 5, rho, nn)
    runs = [implicit_path(crt, kb, op, n_red, torch.float32, dev, rho, nn)
            for _ in range(3)]
    (q32, v32, _), _, paths["implicit:linear"] = runs[0]
    require(all(r[2] == N_STEPS * nn + 1 for r in runs),
            f"linear implicit path: {[r[2] for r in runs]} btd_solve launches, "
            f"expected {N_STEPS * nn + 1}")
    span_ms = min(r[1] for r in runs)
    (q64, v64, _), span64_ms, _ = implicit_path(crt, kb, op, n_red, torch.float64,
                                                 dev, rho, nn)
    q0 = implicit_start(op, n_red, torch.float64, dev)[0]
    u64 = np.zeros(n_red)
    u64[-2] = 0.1
    eta, etad = lin_ms.to_modal(q0, torch.zeros_like(q0))
    e1, ed1, _ = lin_ms.rollout_pallas(eta, etad, lin_ms.project_force_host(u64), N_STEPS)
    qm, vm = lin_ms.from_modal(e1, ed1)
    vs_modal = rel_parts((q64, v64), (qm, vm))
    f32_rel = rel_parts((q32.double(), v32.double()), (q64, v64))
    ok = finite(q32, v32, q64, v64)
    env_steps = N_ENVS * N_STEPS
    print(f"phase 14 implicit linear: {N_ELEMENTS} elements, {n_red} DOFs, {N_ENVS} envs, "
          f"{N_STEPS} steps, rho_inf={rho}, n_newton={nn}, pallas: float32 span "
          f"{span_ms:.3f} ms = {env_steps / span_ms * 1e3:.4e} env-steps/s (best of 3: "
          f"{', '.join('%.3f' % r[1] for r in runs)} ms); float64 span {span64_ms:.3f} ms; "
          f"(a) float64 vs modal q {vs_modal[0]:.3e} v {vs_modal[1]:.3e}, (b) float32 vs "
          f"float64 q {f32_rel[0]:.3e} v {f32_rel[1]:.3e}, "
          f"(c) finite {ok}; btd_solve launches {paths['implicit:linear']}; operator "
          f"build {op_s:.2f} s (host)", flush=True)
    require(ok and q32.shape == (N_ENVS, n_red), "implicit linear: non-finite states")
    require(max(vs_modal) <= IMP_VS_MODAL_MAX, f"implicit vs modal {vs_modal}")
    require(max(f32_rel) <= IMP_F32_MAX, f"implicit float32 vs float64 {f32_rel}")

    # -- phase 15: the consistent von Karman implicit main path ------------------
    rho_n, nn_n = IMPLICIT["rho_nl"], IMPLICIT["newton_nl"]
    nl_model = crt.DynamicEulerBernoulliBeam(
        bench_beam_dataframe(N_ELEMENTS, "nonlinear"), use_consistent_nonlinear=True)
    t0 = time.time()
    op_nl = implicit_op(crt, nl_model, rho_n, "pallas", dev)
    op_nl_s = time.time() - t0
    (qn32, vn32, _), nl_ms, paths["implicit:nonlinear"] = implicit_path(
        crt, kb, op_nl, n_red, torch.float32, dev, rho_n, nn_n)
    require(paths["implicit:nonlinear"] == N_STEPS * nn_n + 1,
            f"nonlinear implicit path: {paths['implicit:nonlinear']} btd_solve "
            f"launches, expected {N_STEPS * nn_n + 1}")
    (qn64, vn64, _), nl64_ms, _ = implicit_path(crt, kb, op_nl, n_red, torch.float64,
                                                 dev, rho_n, nn_n)
    nl_f32_rel = rel_parts((qn32.double(), vn32.double()), (qn64, vn64))
    t0 = time.time()
    op_nl_dense = implicit_op(crt, nl_model, rho_n, "dense_inv", dev)
    dense_build_s = time.time() - t0
    steps_d = IMPLICIT["dense_steps"]
    start = implicit_start(op_nl, n_red, torch.float64, dev)
    qs, vs, _ = implicit_span(crt, op_nl, start, steps_d, rho_n, nn_n)
    start_d = implicit_start(op_nl_dense, n_red, torch.float64, dev)
    qd, vd, _ = implicit_span(crt, op_nl_dense, start_d, steps_d, rho_n, nn_n)
    vs_dense = rel_state((qs, vs), (qd, vd))
    ok = finite(qn32, vn32, qn64, vn64)
    print(f"phase 15 implicit consistent von Karman: {N_ENVS} envs, {N_STEPS} steps, "
          f"rho_inf={rho_n}, n_newton={nn_n} (modified Newton), pallas: float32 span "
          f"{nl_ms:.3f} ms = {env_steps / nl_ms * 1e3:.4e} env-steps/s (one run); float64 "
          f"span {nl64_ms:.3f} ms; float32 vs float64 q {nl_f32_rel[0]:.3e} v "
          f"{nl_f32_rel[1]:.3e}; {steps_d} float64 "
          f"steps vs dense_inv {vs_dense:.3e}; finite {ok}; btd_solve launches "
          f"{paths['implicit:nonlinear']}; operator build {op_nl_s:.2f} s, dense_inv "
          f"build {dense_build_s:.2f} s (host)", flush=True)
    require(ok, "implicit nonlinear: non-finite states")
    require(max(nl_f32_rel) <= IMP_F32_MAX, f"nonlinear float32 vs float64 {nl_f32_rel}")
    require(vs_dense <= IMP_DENSE_MAX, f"nonlinear pallas vs dense_inv {vs_dense:.3e}")

    # -- phase 16: simulate(method="generalized_alpha"|"newmark") -----------------
    df = bench_beam_dataframe(IMP_SIM["n_el"], "nonlinear")
    df["length"] = 0.25
    small_model = crt.DynamicEulerBernoulliBeam(df, use_consistent_nonlinear=True)
    n_s = small_model.n_pos_states
    rng = np.random.default_rng(12)
    x0 = np.zeros((IMP_SIM["envs"], 2 * n_s))
    x0[:, :n_s] = rng.normal(scale=IMP_SIM["amp"], size=(IMP_SIM["envs"], n_s))
    u_s = np.zeros(n_s)
    u_s[-2] = 0.1
    frame_dt = DT * IMP_SIM["substeps"]
    sim_err = {}
    for method in ("generalized_alpha", "newmark"):
        ys = {}
        for solver in ("pallas", "btd", "cr", "dense_inv"):
            kb.reset_launch_counts()
            res = crt.simulate(small_model, x0, IMP_SIM["frames"] * frame_dt, frame_dt,
                               method=method, u=u_s, substeps=IMP_SIM["substeps"],
                               linear_solver=solver, device=dev)
            paths[f"simulate:{method}:{solver}"] = kb.btd_solve.launches
            ys[solver] = force_completion(res.ys)
            require(tuple(res.ys.shape) == (IMP_SIM["frames"] + 1, IMP_SIM["envs"], 2 * n_s)
                    and finite(res.ys), f"simulate {method} {solver}: output of shape "
                    f"{tuple(res.ys.shape)}, finite {finite(res.ys)}")
        scale = float(ys["btd"].abs().max())
        sim_err[method] = {s: float((ys[s] - ys["btd"]).abs().max()) / scale
                           for s in ("pallas", "cr", "dense_inv")}
        n_it = IMP_SIM["frames"] * IMP_SIM["substeps"] * 2 + 1  # n_newton=2
        require(paths[f"simulate:{method}:pallas"] == n_it and not any(
            paths[f"simulate:{method}:{s}"] for s in ("btd", "cr", "dense_inv")),
            f"simulate {method}: launches {paths}")
        require(sim_err[method]["pallas"] == 0.0,
                f"simulate {method}: pallas vs btd {sim_err[method]['pallas']:.3e}")
        require(max(sim_err[method].values()) <= IMP_SIM_MAX,
                f"simulate {method}: {sim_err[method]}")
    print(f"phase 16 simulate implicit: {IMP_SIM}: max|x - btd|/scale {sim_err}", flush=True)
    print(f"implicit paths' launches: {paths}", flush=True)

    # -- phase 17: timings --------------------------------------------------------
    def best(fn):
        return min(cuda_event_times(fn, repeats=3, warmup=1, device=dev))

    a, c = gen_alpha_system(rho)
    fac = tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                for x in btd_host_factors(lin_model, a, c))
    n_nodes = fac[0].shape[0]
    rhs = torch.tensor(rng.normal(size=(N_ENVS, n_nodes, 3)), dtype=torch.float32,
                       device=dev)
    rhs[:, 0, :] = 0.0  # the fixed node's rows, as the operator pads them
    rhs = padded_rows(rhs, kb)  # and in rows of the kernel's pitch, as it hands them
    fac = kb.pack_factors(fac)  # packed once, as the operator uploads them
    inv = dense_system_inverse(lin_model, a, c, dev)
    r_red = rhs.reshape(N_ENVS, -1)[:, 3:].contiguous()
    x_lib = r_red @ inv.mT
    x_ker = kb.btd_solve(fac, rhs).reshape(N_ENVS, -1)[:, 3:]
    lib_rel = rel(x_ker, x_lib)
    k_ms = best(lambda: kb.btd_solve(fac, rhs))
    k_dev_ms, k_dev_by = device_ms(lambda: kb.btd_solve(fac, rhs), dev)
    p_ms = best(lambda: banded.btd_solve(fac, rhs))
    lib_ms = best(lambda: r_red @ inv.mT)
    btd_ops = N_ENVS * ((n_nodes - 1) * (18 + 33) + 15)
    btd_bytes = 4 * (2 * N_ENVS * 3 * n_nodes + 9 * (3 * n_nodes - 2))
    bnd = bound(btd_ops, btd_bytes)
    steps_t = IMPLICIT["dense_steps"]
    op_dense = implicit_op(crt, lin_model, rho, "dense_inv", dev)
    step_ms = {}
    for name, o in (("pallas", op), ("dense_inv", op_dense)):
        st = implicit_start(o, n_red, torch.float32, dev)
        step_ms[name] = best(lambda: implicit_span(crt, o, st, steps_t, rho, nn)) / steps_t
    print(f"phase 17 implicit timings [{card}]: btd_solve {k_ms:.4f} ms a lone launch, "
          f"device {k_dev_ms:.4f} ms, vs plain "
          f"{p_ms:.3f} ms, dense-inverse torch.matmul {lib_ms:.4f} ms (kernel vs it "
          f"{lib_rel:.3e} relative), bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at "
          f"{bnd[0] / k_ms:.3f} of it; linear main path per step: pallas "
          f"{step_ms['pallas']:.4f} ms, dense_inv {step_ms['dense_inv']:.4f} ms "
          f"({steps_t} steps, best of 3); CARD_LINEAR_SOLVER="
          f"{sim_mod.CARD_LINEAR_SOLVER}", flush=True)
    return dict(launches=paths["implicit:linear"],
                launches_by_path=paths, max_abs_err=err, ms=k_ms, device_ms=k_dev_ms,
                device_ms_by=k_dev_by,
                plain_ms=p_ms,
                bound=bnd, library_ms=lib_ms, source=BTD_SOURCE, replaces=BTD_REPLACES)


def profile_implicit(crt, kb, dev, card) -> None:
    """``--profile implicit``: device time by kernel over ``PROFILE_STEPS``
    steps of the linear implicit main path, and the busy share; then one
    ``btd_solve`` at the path's shapes, a lone launch and its device time."""
    from continuum_robot_tpu_torch.utils import cuda_event_times

    rho, nn = IMPLICIT["rho_lin"], IMPLICIT["newton_lin"]
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS))
    op = implicit_op(crt, model, rho, "pallas", dev)
    start = implicit_start(op, model.n_pos_states, torch.float32, dev)
    profile_span(lambda: implicit_span(crt, op, start, PROFILE_STEPS, rho, nn), dev,
                 card, "the linear implicit main path")
    a, c = gen_alpha_system(rho)
    fac = kb.pack_factors(tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                                for x in btd_host_factors(model, a, c)))
    n = fac[0].shape[0]
    rhs = padded_rows(torch.tensor(np.random.default_rng(0).normal(size=(N_ENVS, n, 3)),
                                   dtype=torch.float32, device=dev), kb)
    lone = min(cuda_event_times(lambda: kb.btd_solve(fac, rhs), repeats=5, warmup=1,
                                device=dev))
    print(f"profile [{card}]: btd_solve {N_ENVS} x {n} nodes float32: a lone launch "
          f"{lone:.4f} ms, device {device_ms(lambda: kb.btd_solve(fac, rhs), dev)[0]:.4f} ms",
          flush=True)


# ---------------------------------------------------------------------------
# The fused small-beam path
# ---------------------------------------------------------------------------


def reference_beam(crt, gravity: bool = False):
    """The reference's 6-segment linear Nitinol cantilever (0.25 m segments,
    r = 5 mm, C_d = 0.82, wetted area 2 pi r L), fixed base, in water."""
    import pandas as pd

    L, E, r, rho, n = 0.25, 75e9, 0.005, 6450.0, 6
    df = pd.DataFrame({
        "length": [L] * n, "elastic_modulus": [E] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n, "density": [rho] * n,
        "cross_area": [np.pi * r**2] * n, "type": ["linear"] * n,
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [2 * np.pi * r * L] * n, "drag_coef": [0.82] * n,
    })
    return crt.DynamicEulerBernoulliBeam(df, crt.ForceParams(
        enable_fluid_effects=True, fluid_density=1000.0, enable_gravity_effects=gravity))


def fused_start(n: int, envs: int, seed: int = 0) -> np.ndarray:
    """The sweep's starts: x0 zero but the tip displacement ~ N(0, 1e-3)."""
    x0 = np.zeros((envs, 2 * n))
    x0[:, n - 2] = np.random.default_rng(seed).normal(scale=FUSED["tip_scale"], size=envs)
    return x0


def fused_ops_per_env_step(n: int, n_newton: int) -> int:
    """Operations of one environment-step, counted from the kernel's code:
    per row the predictor 6 and corrector 4; per Newton iteration 16 for
    q1, v1, the alpha point and the drag, 3 (2n - 1) for the three matrix
    products, 3 for the residual and 1 for the update."""
    return n * (10 + n_newton * (6 * n + 17))


def fused_main_case(kf, beam):
    """The fused kernel's operands at the main path's shape, host float64:
    ``((M, K, Jinv), drag, u, x, h)`` with the sweep's 4096 starts and
    their consistent accelerations (v0 = 0, u = 0)."""
    h = FUSED["dt"] / FUSED["substeps"]
    M, K, Jinv, Minv = kf.fused_host_operators(beam, h, FUSED["rho_inf"])
    n = M.shape[0]
    x0 = fused_start(n, FUSED["envs"])
    a0 = -(x0[:, :n] @ K.T) @ Minv.T
    return ((M, K, Jinv), kf.drag_coefficient_vector(beam), np.zeros(n),
            np.concatenate([x0, a0], axis=-1), h)


def phase_fused_kernel(kf, beam, dev):
    """Phase 18: both entries of the kernel against their plain twins, bit
    for bit, at sizes that reach both instances; returns ``({entry: max
    |kernel - plain|}, main-shape operands)``."""
    rng = np.random.default_rng(18)
    cases = []
    for n, B in FUSED_SMALL:
        A = rng.normal(size=(3, n, n)) / np.sqrt(n)
        M = A[0] @ A[0].T + np.eye(n)
        K = 1e3 * (A[1] @ A[1].T)
        cases.append(((M, K, np.linalg.inv(M + 1e-3 * K)), rng.uniform(0.0, 3.0, n),
                      rng.normal(size=n), rng.normal(size=(B, 3 * n)), 1e-3))
    main = fused_main_case(kf, beam)
    cases.append(main)
    err = {"fused_gen_alpha_steps": 0.0, "fused_gen_alpha_frames": 0.0}
    kw = dict(rho_inf=FUSED["rho_inf"], n_newton=FUSED["n_newton"])
    sub, frames = FUSED["substeps"], FUSED_CHECK_FRAMES
    for dtype in (torch.float32, torch.float64):
        for mats, cd, u, x, hh in cases:
            t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731, B023
            ops = (tuple(t(A) for A in mats), t(cd), t(u), t(x))
            kf.reset_launch_counts()
            out = kf.fused_gen_alpha_steps(*ops, sub, hh, **kw)
            ys = kf.fused_gen_alpha_frames(*ops, frames, sub, hh, **kw)
            require([k.launches for k in kf.KERNELS] == [1, 1],
                    "fused_gen_alpha_steps or _frames did not launch its kernel")
            require(finite(out, ys), "fused kernel: non-finite states")
            e = {"fused_gen_alpha_steps": max_abs(out, kf.fused_gen_alpha_steps_plain(
                     *ops, sub, hh, **kw)),
                 "fused_gen_alpha_frames": max_abs(ys, kf.fused_gen_alpha_frames_plain(
                     *ops, frames, sub, hh, **kw))}
            for k in err:
                err[k] = max(err[k], e[k])
            n, B = x.shape[1] // 3, x.shape[0]
            geo = kf.launch_geometry(n, dtype, B)
            print(f"phase 18 fused kernel vs plain: {str(dtype)[6:]} B={B} n={n}, "
                  f"{geo['instance']} instance: steps ({sub} steps) max|kernel-plain| "
                  f"{e['fused_gen_alpha_steps']:.3e}, frames ({frames} x {sub}) "
                  f"{e['fused_gen_alpha_frames']:.3e}", flush=True)
    require(max(err.values()) == 0.0, f"fused kernel and plain version differ: {err}")
    return err, main


def fused_paths(crt, kf, kb, dev, card):
    """Phases 18-20; returns the fused kernels' records."""
    from continuum_robot_tpu_torch.parallel import batched_rollout, sweep_statistics
    from continuum_robot_tpu_torch.utils import cuda_event_times, force_completion

    beam = reference_beam(crt)
    n = beam.n_pos_states
    err, (mats, c_drag, _, x_main, h) = phase_fused_kernel(kf, beam, dev)

    # -- phase 19: the fused small-beam path ----------------------------------------
    T, dt, sub = FUSED["t_final"], FUSED["dt"], FUSED["substeps"]
    frames = int(round(T / dt))
    kw = dict(substeps=sub, rho_inf=FUSED["rho_inf"], n_newton=FUSED["n_newton"])
    x0 = fused_start(n, FUSED["envs"])
    x0_32 = torch.tensor(x0, dtype=torch.float32, device=dev)
    x0_64 = torch.tensor(x0, dtype=torch.float64, device=dev)

    def span32():
        return kf.fused_rollout(beam, x0_32, T, dt, **kw)

    def expect_one(launches, what):
        require(launches == {"fused_gen_alpha_steps": 0, "fused_gen_alpha_frames": 1},
                f"{what}: launches {launches}, expected one fused_gen_alpha_frames")

    span32()  # warm-up: the kernel's first launch loads its library
    paths, runs = {}, []
    for _ in range(3):
        ((_, ys32), span_ms), launches = counted(kf, lambda: timed_once(span32, dev))
        runs.append(span_ms)
        paths.setdefault("fused:float32", launches)
        expect_one(launches, "fused path")
    (_, ys64), paths["fused:float64"] = counted(
        kf, lambda: kf.fused_rollout(beam, x0_64, T, dt, **kw))
    expect_one(paths["fused:float64"], "fused float64 path")

    # The TPU kernel's per-call entry, a launch a frame, as the JAX package's
    # scan drives it, from the main-shape start: bit-equal to the one launch.
    t32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ops32 = (tuple(t32(A) for A in mats), t32(c_drag), torch.zeros(n, device=dev),
             t32(x_main))
    kw_k = dict(rho_inf=FUSED["rho_inf"], n_newton=FUSED["n_newton"])

    def per_frame():
        x, ys = ops32[-1], [ops32[-1][:, : 2 * n]]
        for _ in range(frames):
            x = kf.fused_gen_alpha_steps(*ops32[:-1], x, sub, h, **kw_k)
            ys.append(x[:, : 2 * n])
        return torch.stack(ys)

    def one_launch():
        return kf.fused_gen_alpha_frames(*ops32, frames, sub, h, **kw_k)

    (ys_steps, steps_ms), paths["fused:steps_per_frame"] = counted(
        kf, lambda: timed_once(per_frame, dev))
    require(paths["fused:steps_per_frame"] == {"fused_gen_alpha_steps": frames,
                                               "fused_gen_alpha_frames": 0},
            f"per-frame drive: launches {paths['fused:steps_per_frame']}")
    ys_frames = one_launch()
    t0 = time.perf_counter()
    ys_twin = force_completion(kf.fused_gen_alpha_frames_plain(*ops32, frames, sub, h, **kw_k))
    frames_plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(ys_frames, ys_steps) and torch.equal(ys_frames, ys_twin),
            "fused_gen_alpha_frames differs from the per-frame launches or from its twin")

    kb.reset_launch_counts()
    kf.reset_launch_counts()
    oracle, oracle_ms = timed_once(lambda: crt.simulate(
        beam, x0_64, T, dt, method="generalized_alpha", device=dev, **kw), dev)
    paths["oracle:btd_solve"] = kb.btd_solve.launches
    fused_launches = sum(k.launches for k in kf.KERNELS)
    require(kb.btd_solve.launches == 1 + frames * sub * FUSED["n_newton"]
            and fused_launches == 0,
            f"oracle: {kb.btd_solve.launches} btd_solve and {fused_launches} fused "
            f"launches, expected {1 + frames * sub * FUSED['n_newton']} and 0")
    def qv(ys):  # every frame's (q, v)
        return ys[..., :n], ys[..., n:]

    vs_sim = [e / scale for e, scale in errors(qv(ys64), qv(oracle.ys))]
    f32_rel = rel_parts(qv(ys32.double()), qv(ys64))
    ok = finite(ys32, ys64, oracle.ys)
    env_steps = FUSED["envs"] * frames * sub
    span_ms = min(runs)
    frames_ms = min(cuda_event_times(one_launch, repeats=3, warmup=1, device=dev))
    frames_dev = queued_device_ms(one_launch, dev, n=3)
    print(f"phase 19 fused path: {n} DOFs, {FUSED['envs']} envs, {frames} frames x {sub} "
          f"substeps = {frames * sub} steps, n_newton={FUSED['n_newton']}: float32 span "
          f"{span_ms:.3f} ms = {env_steps / span_ms * 1e3:.4e} env-steps/s (best of 3: "
          f"{', '.join('%.3f' % t for t in runs)} ms), fused_gen_alpha_frames device "
          f"{frames_dev:.3f} ms (queued CUDA events), {frames_dev / span_ms:.3f} of the span; "
          f"(a) float64 vs "
          f"float64 simulate q {vs_sim[0]:.3e} v {vs_sim[1]:.3e} (x scale; oracle "
          f"{oracle_ms:.3f} ms = {env_steps / oracle_ms * 1e3:.4e} env-steps/s), (b) "
          f"float32 vs float64 q {f32_rel[0]:.3e} v {f32_rel[1]:.3e} (by norm), (c) finite "
          f"{ok}; ys {tuple(ys32.shape)}; one launch == {frames} per-frame launches == "
          f"twin, bit for bit (per-frame drive {steps_ms:.3f} ms, twin "
          f"{frames_plain_ms:.1f} ms); launches {paths}", flush=True)
    require(ok and tuple(ys32.shape) == (frames + 1, FUSED["envs"], 2 * n),
            "fused path: non-finite or misshapen states")
    require(max(vs_sim) <= FUSED_VS_SIM_MAX, f"fused vs simulate {vs_sim}")
    require(max(f32_rel) <= FUSED_F32_MAX, f"fused float32 vs float64 {f32_rel}")

    # -- phase 20: the entry points with drag and gravity ----------------------------
    beam_g = reference_beam(crt, gravity=True)
    xs = fused_start(n, FUSED_SIM["envs"], seed=20)
    sim_T = FUSED_SIM["frames"] * dt
    sim_kw = dict(substeps=FUSED_SIM["substeps"], n_newton=FUSED["n_newton"])
    n_it = 1 + FUSED_SIM["frames"] * FUSED_SIM["substeps"] * FUSED["n_newton"]
    ys = {}
    for method in ("generalized_alpha", "newmark"):
        for solver in ("pallas", "btd"):
            kb.reset_launch_counts()
            res = crt.simulate(beam_g, xs, sim_T, dt, method=method, linear_solver=solver,
                               device=dev, **sim_kw)
            paths[f"simulate:{method}:{solver}"] = kb.btd_solve.launches
            ys[method, solver] = force_completion(res.ys)
            require(tuple(res.ys.shape) == (FUSED_SIM["frames"] + 1, FUSED_SIM["envs"], 2 * n)
                    and finite(res.ys), f"simulate {method} {solver}: bad output")
            require(kb.btd_solve.launches == (n_it if solver == "pallas" else 0),
                    f"simulate {method} {solver}: {kb.btd_solve.launches} launches")
        require(torch.equal(ys[method, "pallas"], ys[method, "btd"]),
                f"simulate {method}: pallas and btd differ by "
                f"{float((ys[method, 'pallas'] - ys[method, 'btd']).abs().max()):.3e}")
    kb.reset_launch_counts()
    res_b = batched_rollout(beam_g, xs, sim_T, dt, method="generalized_alpha", device=dev,
                            **sim_kw)
    paths["batched_rollout:generalized_alpha"] = kb.btd_solve.launches
    require(kb.btd_solve.launches == n_it, f"batched_rollout: {kb.btd_solve.launches} launches")
    require(torch.equal(res_b.ys, ys["generalized_alpha", "pallas"]),
            "batched_rollout differs from simulate")
    stats = {k: float(v) for k, v in sweep_statistics(res_b.ys).items()}
    require(all(np.isfinite(v) for v in stats.values()), f"sweep statistics {stats}")
    print(f"phase 20 entry points, drag and gravity: {FUSED_SIM}: pallas == btd "
          f"(generalized_alpha, newmark), batched_rollout == simulate; sweep statistics "
          f"{stats}", flush=True)
    print(f"fused paths' launches: {paths}", flush=True)

    # -- timings ----------------------------------------------------------------------
    def per_launch(args, reps=10):  # back-to-back launches, so dispatch overlaps
        def run():
            for _ in range(reps):
                kf.fused_gen_alpha_steps(*args, **kw_k)
        return min(cuda_event_times(run, repeats=3, warmup=1, device=dev)) / reps

    ops_step = fused_ops_per_env_step(n, FUSED["n_newton"])
    times, bounds, dev_ms = {}, {}, {}
    for label, envs, dtype in (("main", FUSED["envs"], torch.float32),
                               ("main_f64", FUSED["envs"], torch.float64),
                               ("big", FUSED["big_envs"], torch.float32)):
        x = torch.tensor(np.tile(x_main, (envs // FUSED["envs"], 1)), dtype=dtype, device=dev)
        args = (tuple(torch.tensor(A, dtype=dtype, device=dev) for A in mats),
                torch.tensor(c_drag, dtype=dtype, device=dev),
                torch.zeros(n, dtype=dtype, device=dev), x, sub, h)
        times[label] = per_launch(args)
        dev_ms[label] = queued_device_ms(lambda: kf.fused_gen_alpha_steps(*args, **kw_k), dev)
        if dtype == torch.float32:  # the bound is at float32 peaks
            ops = envs * sub * ops_step
            bounds[label] = (*bound(ops, 4 * (2 * envs * 3 * n + 3 * n * n + 2 * n)),
                             rn_bound_ms(ops))
        if label == "main":
            plain_ms = min(cuda_event_times(
                lambda: kf.fused_gen_alpha_steps_plain(*args, **kw_k), repeats=3, warmup=1,
                device=dev))
    env_main = FUSED["envs"]
    frames_ops = env_main * frames * sub * ops_step
    frames_bound = (*bound(frames_ops, 4 * (env_main * 3 * n + (frames + 1) * env_main * 2 * n
                                            + 3 * n * n + 2 * n)),
                    rn_bound_ms(frames_ops))

    def vs_bound(label):
        return (f"bound {bounds[label][0]:.4f} ms, {bounds[label][1]}, device at "
                f"{bounds[label][0] / dev_ms[label]:.3f} of it; unfused _rn floor "
                f"{bounds[label][2]:.4f} ms, device at {bounds[label][2] / dev_ms[label]:.3f}")

    print(f"phase 20 fused timings [{card}]: fused_gen_alpha_steps per launch ({sub} steps; "
          f"10 back-to-back launches by CUDA events, device time by queued CUDA events in "
          f"brackets): float32 {env_main} envs {times['main']:.4f} ms [{dev_ms['main']:.4f} "
          f"ms] ({vs_bound('main')}), float64 {times['main_f64']:.4f} ms "
          f"[{dev_ms['main_f64']:.4f} ms], float32 {FUSED['big_envs']} envs "
          f"{times['big']:.4f} ms [{dev_ms['big']:.4f} ms] ({vs_bound('big')}); plain twin "
          f"{plain_ms:.3f} ms; fused_gen_alpha_frames ({frames} x {sub} steps) a lone launch "
          f"{frames_ms:.3f} ms [{frames_dev:.3f} ms] (bound {frames_bound[0]:.3f} ms, "
          f"{frames_bound[1]}; unfused _rn floor {frames_bound[2]:.3f} ms), the span "
          f"{span_ms:.3f} ms; {frames} per-frame launches {steps_ms:.3f} ms; float64 oracle "
          f"span {oracle_ms:.3f} ms", flush=True)
    geo = {dt_: kf.launch_geometry(n, dt_, env_main) for dt_ in (torch.float32, torch.float64)}
    design = (f"a thread owns one DOF row of {geo[torch.float32]['envs']} envs (float; "
              f"{geo[torch.float64]['envs']} in double), its rows of M, K, Jinv in registers, "
              f"the j loop unrolled; env-minor broadcast vectors in shared memory; a warp an "
              f"env where the rows do not fit in registers")

    def common(name):
        return dict(library_ms=None, source=FUSED_SOURCE, replaces=FUSED_REPLACES,
                    launches_by_path={p: c[name] for p, c in paths.items()
                                      if isinstance(c, dict)})

    return {
        "fused_gen_alpha_steps": dict(
            common("fused_gen_alpha_steps"), launches=paths["fused:steps_per_frame"]["fused_gen_alpha_steps"],
            max_abs_err=err["fused_gen_alpha_steps"], ms=times["main"], plain_ms=plain_ms,
            device_ms=dev_ms["main"], device_ms_by="queued_cuda_events",
            bound=bounds["main"][:2],
            rn_bound_ms=bounds["main"][2], design=design),
        "fused_gen_alpha_frames": dict(
            common("fused_gen_alpha_frames"), launches=paths["fused:float32"]["fused_gen_alpha_frames"],
            max_abs_err=err["fused_gen_alpha_frames"], ms=frames_ms,
            plain_ms=frames_plain_ms, device_ms=frames_dev, device_ms_by="queued_cuda_events",
            bound=frames_bound[:2],
            rn_bound_ms=frames_bound[2],
            design=design + "; every frame in one launch (the JAX scan, "
                            "ops/pallas/fused_rollout.py:238)"),
    }


def profile_fused(crt, dev, card) -> None:
    """``--profile fused``: device time by kernel over the float32 span of
    the fused small-beam path, and the busy share."""
    from continuum_robot_tpu_torch.ops.cuda import fused_rollout as kf

    beam = reference_beam(crt)
    x0 = torch.tensor(fused_start(beam.n_pos_states, FUSED["envs"]), dtype=torch.float32,
                      device=dev)
    kw = dict(substeps=FUSED["substeps"], rho_inf=FUSED["rho_inf"],
              n_newton=FUSED["n_newton"])
    steps = int(round(FUSED["t_final"] / FUSED["dt"])) * FUSED["substeps"]
    profile_span(lambda: kf.fused_rollout(beam, x0, FUSED["t_final"], FUSED["dt"], **kw),
                 dev, card, "the fused small-beam path", steps=steps)


# ---------------------------------------------------------------------------
# The reference-parity and adaptive paths (phases 21-24)
# ---------------------------------------------------------------------------

GOLDEN_DIR = "tests/goldens"
# tests/test_parity_golden.py's six configurations (tests/helpers.py's
# Nitinol beam: 0.25 m elements, fixed base).
GOLDEN_CONFIGS = {
    "linear": (["linear"] * 6, {}),
    "nonlinear": (["nonlinear"] * 6, {}),
    "mixed": (["linear"] * 3 + ["nonlinear"] * 3, {}),
    "linear_fluid": (["linear"] * 6, {"enable_fluid_effects": True,
                                      "fluid_density": 1000.0}),
    "linear_gravity": (["linear"] * 6, {"enable_gravity_effects": True}),
    "nonlinear_fluid_gravity": (["nonlinear"] * 6, {
        "enable_fluid_effects": True, "fluid_density": 1000.0,
        "enable_gravity_effects": True}),
}
GOLDEN_MAX = 2e-6  # the JAX package's golden bound, x the state scale
# Phase 21: Dopri5 at the golden test's tolerances over the first 5 ms of
# every configuration (0.05 s in the plan: ~36000 trials at 5-9 ms, PERF.md);
# then nonlinear_fluid_gravity on toward 1 s, in spans of `span` frames,
# while `full_budget_s` of wall time lasts (10 s: phases 21-24 have 150 s,
# and phase 24's references on the CPU at 4096 envs take ~20 s of them).
PARITY = dict(prefix=0.005, rtol=1e-10, atol=1e-12, span=2, full_budget_s=10.0,
              full="nonlinear_fluid_gravity", jax_cpu_trials=91_695)
# Phase 22: batched RK4 on the flagship (continuum_robot_tpu_torch.entry),
# h = 1e-5 s halved until RK4 is stable on the beam's zero-state spectrum
# (|h lambda| < 2.78 on the imaginary axis): 5e-6 s. 10 frames of 0.1 ms
# (the 1 ms frames of the plan take 2000 steps a sweep: PERF.md). RK4 at
# its stability limit does not resolve the top modes the tip start excites,
# so its accuracy is read as its order of convergence against Dopri5.
# Then the same envs on the widest beam whose RHS is batch-invariant, over
# `wide_sub` steps of h, each bit for bit its solo run.
RK4_SWEEP = dict(envs=4096, frames=10, frame_dt=1e-4, h=1e-5, tip_scale=1e-3,
                 rk4_limit=2.78, min_order=3.5, f32_max=1e-3, check_envs=(0, 2047, 4095),
                 wide_sub=4)
# Phase 23: per-environment Dopri5 on nonlinear_fluid_gravity, tip impulses
# geometrically spread over 0.05-0.2 N, the median lane exactly the golden's;
# 3 ms (0.02 s in the plan: the three solo runs alone would take ~60 s).
PER_ENV = dict(envs=4096, frames=3, amp=(0.05, 0.2), median=2048, solo_max=1e-10)
# Phase 24: the stiff60 mesh (tests/test_stiff_validation.py) at the JAX
# test's tolerances, cut to `horizon` seconds in frames of `frame` (the
# 78678 generalized-alpha trials of the JAX test's 0.05 s at 75-90 ms each
# do not fit: PERF.md). Each run, at 1 env and at 4096, is held to the port
# on the CPU on the same inputs (the CPU tests hold that to the JAX
# package), and "pallas" to "dense_inv" on the card: equal counts, states
# within `vs_cpu_max`; every run's tip error against the exact flow (the port's
# expm propagator at the frame spacing, the golden's own construction,
# scaled per env: the beam is linear) is printed, not bounded (the JAX
# test's 5e-5 is a 0.05 s bound). Then 20 trials of the 1000-element bench
# beam at full width.
STIFF = dict(n_el=60, length=0.025, horizon=1e-5, frame=5e-6, rtol=1e-8, atol=1e-11,
             rho_inf=0.95, n_newton=2, envs=4096, scale=(0.5, 1.5), chunk=1,
             vs_cpu_max=1e-10)
TRIAL_BENCH = dict(trials=20, envs=4096, rho_inf=0.8, n_newton=1)


def golden_beam(crt, types, fp=None, length: float = 0.25):
    """tests/helpers.py's CSV beam as a DataFrame: Nitinol, r = 5 mm,
    C_d 0.82 on a wetted area of 2 pi r 0.25 m, fixed base."""
    import pandas as pd

    n, r = len(types), 0.005
    df = pd.DataFrame({
        "length": [length] * n, "elastic_modulus": [75e9] * n,
        "moment_inertia": [np.pi * r**4 / 4] * n, "density": [6450.0] * n,
        "cross_area": [np.pi * r**2] * n, "type": list(types),
        "boundary_condition": ["FIXED"] + ["NONE"] * (n - 1),
        "wetted_area": [2 * np.pi * r * 0.25] * n, "drag_coef": [0.82] * n,
    })
    return crt.DynamicEulerBernoulliBeam(df, crt.ForceParams(**(fp or {})))


def tip_impulse(n: int, amplitude, t_end: float, dtype, dev):
    """``u(t)``: ``amplitude`` (a float, or a tensor of one per env) on the
    tip's transverse DOF while ``t < t_end``; ``t`` a tensor of the
    controller's shape."""
    base = torch.zeros(n, dtype=dtype, device=dev)
    tip = base.clone()
    tip[-2] = 1.0
    on = torch.as_tensor(amplitude, dtype=dtype, device=dev)[..., None] * tip

    def u(t):
        return torch.where((t < t_end)[..., None], on, base)

    return u


def golden_err(ys, y_ref) -> float:
    """max |ys - golden| / max |golden| over the frames given."""
    ys = ys.detach().cpu().numpy()
    return float(np.abs(ys.T - y_ref).max() / np.abs(y_ref).max())


def wall(fn):
    """``(fn(), seconds)``, the card's queue drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parity(crt, dev, meta, data) -> float:
    """Phase 21; returns its wall seconds."""
    from continuum_robot_tpu_torch.ops import integrators

    t_phase = time.perf_counter()
    dt = meta["dt"]
    nf = int(round(PARITY["prefix"] / dt))
    kw = dict(rtol=PARITY["rtol"], atol=PARITY["atol"])
    for name, (types, fp) in GOLDEN_CONFIGS.items():
        model = golden_beam(crt, types, fp)
        n = model.n_pos_states
        u = tip_impulse(n, meta["impulse_amplitude"], meta["impulse_t_end"],
                        torch.float64, dev)
        res, secs = wall(lambda: crt.simulate(model, np.zeros(2 * n), nf * dt, dt,
                                              method="dopri5", u=u, device=dev, **kw))
        y_ref = data[f"{name}_y"][:, : nf + 1]
        err = golden_err(res.ys, y_ref)
        st = res.stats
        print(f"phase 21 parity {name}: dopri5 float64 over {PARITY['prefix']} s "
              f"({nf} frames), {int(st.n_steps)} trials ({int(st.n_accepted)} accepted, "
              f"{int(st.n_rejected)} rejected; {st.trials_run} run), {st.host_reads} host "
              f"reads, {secs:.2f} s = {secs / st.trials_run * 1e3:.3f} ms a trial run; vs "
              f"golden {err:.3e}",
              flush=True)
        require(res.ys.shape == (nf + 1, 2 * n) and err < GOLDEN_MAX,
                f"parity {name}: golden error {err:.3e}")
        require(int(st.n_incomplete) == 0, f"parity {name}: truncated intervals")
        if name == PARITY["full"]:
            full = (model, u, res)

    # The full horizon, continued span by span from the prefix run: the
    # driver's (x, dt_next) restart replays the one-call run exactly.
    model, u, res = full
    rhs = model.build_rhs()
    t_eval = np.arange(int(round(meta["t_final"] / dt)) + 1) * dt
    xs, x, st = [res.ys], res.ys[-1], res.stats
    trials, dt_next, i, t0 = int(st.n_steps), st.dt_next, nf, time.perf_counter()
    runs = 0
    while i < len(t_eval) - 1 and time.perf_counter() - t0 < PARITY["full_budget_s"]:
        j = min(i + PARITY["span"], len(t_eval) - 1)
        ys, st = integrators.integrate_adaptive(rhs, x, t_eval[i : j + 1], u=u,
                                                dt0=dt_next, **kw)
        xs.append(ys[1:])
        x, dt_next, i = ys[-1], st.dt_next, j
        trials += int(st.n_steps)
        runs += st.trials_run
        require(int(st.n_incomplete) == 0, "parity full horizon: truncated intervals")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ys = torch.cat(xs)
    err = golden_err(ys, data[f"{PARITY['full']}_y"][:, : i + 1])
    cut = "" if i == len(t_eval) - 1 else (
        f" (cut at the {PARITY['full_budget_s']} s budget: {t_eval[i]:.3f} of "
        f"{meta['t_final']} s)")
    print(f"phase 21 parity {PARITY['full']} to t={t_eval[i]:.3f} s{cut}: {trials} trials "
          f"(JAX package, CPU, 1 s: {PARITY['jax_cpu_trials']}), {secs:.2f} s past the "
          f"prefix = {secs / max(runs, 1) * 1e3:.3f} ms a trial run ({runs} run); "
          f"vs golden {err:.3e}", flush=True)
    require(err < GOLDEN_MAX, f"parity full horizon: golden error {err:.3e}")
    return time.perf_counter() - t_phase


def phase_rk4_sweep(crt, dev, card) -> float:
    """Phase 22; returns its wall seconds."""
    import scipy.linalg

    from continuum_robot_tpu_torch.entry import entry, flagship_model
    from continuum_robot_tpu_torch.models import dynamic_beam_model as dbm
    from continuum_robot_tpu_torch.models.simulate import reduce_matrix_dense
    from continuum_robot_tpu_torch.parallel import batched_rollout
    from continuum_robot_tpu_torch.utils import cuda_event_times

    t_phase = time.perf_counter()
    model = flagship_model()
    bm = model.beam_model
    n = model.n_pos_states
    K0 = reduce_matrix_dense(bm.arrays, bm.bc_info.free_dofs)
    omega = float(np.sqrt(np.abs(scipy.linalg.eigvals(K0, bm.M.toarray())).max()))
    h, k = RK4_SWEEP["h"], 0
    while h * omega >= RK4_SWEEP["rk4_limit"]:
        h, k = h / 2.0, k + 1
    F, fdt, envs = RK4_SWEEP["frames"], RK4_SWEEP["frame_dt"], RK4_SWEEP["envs"]
    sub = int(round(fdt / h))
    x0 = np.zeros((envs, 2 * n))
    x0[:, n - 2] = np.random.default_rng(19).normal(scale=RK4_SWEEP["tip_scale"], size=envs)
    x32 = torch.tensor(x0, dtype=torch.float32, device=dev)
    x64 = torch.tensor(x0, dtype=torch.float64, device=dev)

    def sweep(x, substeps=sub, frames=F):
        return batched_rollout(model, x, frames * fdt, fdt, method="rk4",
                               substeps=substeps).ys

    runs = cuda_event_times(sweep, x32, repeats=3, warmup=1, device=dev)
    ys32 = sweep(x32)
    ys64, secs64 = wall(lambda: sweep(x64))
    rate = envs * F * sub / min(runs) * 1e3
    same = []
    for i in RK4_SWEEP["check_envs"]:
        solo = crt.simulate(model, x0[i], F * fdt, fdt, method="rk4", substeps=sub,
                            device=dev).ys
        same.append(bool(torch.equal(solo, ys64[:, i])))
    f32 = rel(ys32.double(), ys64)
    ok = finite(ys32, ys64)
    # The widest beam whose RHS is batch-invariant (the cubic force and row
    # sums up to POLY_MAX_ELEMENTS): the same envs bit for bit alone.
    n_el = dbm.POLY_MAX_ELEMENTS
    wide = golden_beam(crt, ["nonlinear"] * n_el, GOLDEN_CONFIGS["nonlinear_fluid_gravity"][1])
    nw = wide.n_pos_states
    xw = np.zeros((envs, 2 * nw))
    xw[:, nw - 2] = x0[:, n - 2]
    kw_w = dict(method="rk4", substeps=RK4_SWEEP["wide_sub"], device=dev)
    span_w = RK4_SWEEP["wide_sub"] * h
    wide_ys = batched_rollout(wide, xw, span_w, span_w, **kw_w).ys
    wide_same = [bool(torch.equal(crt.simulate(wide, xw[i], span_w, span_w, **kw_w).ys,
                                  wide_ys[:, i])) for i in RK4_SWEEP["check_envs"]]
    # Accuracy: the first frame of env 0 against Dopri5 at rtol 1e-10, with
    # h, h/2 and h/4 (the order RK4 shows there; q and v each on its norm).
    i0 = RK4_SWEEP["check_envs"][0]
    ref, secs_d = wall(lambda: crt.simulate(model, x0[i0], fdt, fdt, method="dopri5",
                                            rtol=1e-10, atol=1e-12, device=dev))
    errs = []
    for m in (1, 2, 4):
        y = crt.simulate(model, x0[i0], fdt, fdt, method="rk4", substeps=sub * m,
                         device=dev).ys
        errs.append(max(rel(y[..., :n], ref.ys[..., :n]), rel(y[..., n:], ref.ys[..., n:])))
    order = float(np.log2(errs[1] / errs[2]))
    step, (xe, ue) = entry(device=dev)
    x1 = step(xe, ue)
    entry_ok = finite(x1) and x1.shape == xe.shape
    print(f"phase 22 batched RK4 [{card}]: flagship (6 hybrid segments, drag, gravity), "
          f"{envs} envs, omega_max {omega:.4e} rad/s, h = 1e-5/2^{k} = {h:.4e} s "
          f"(h omega {h * omega:.3f}; 1e-5 gives {1e-5 * omega:.3f} >= "
          f"{RK4_SWEEP['rk4_limit']}), {F} frames x {sub} substeps: float32 span "
          f"{min(runs):.3f} ms = {rate:.4e} env-steps/s (best of 3: "
          f"{', '.join('%.3f' % r for r in runs)} ms), float64 {secs64:.3f} s; envs "
          f"{list(RK4_SWEEP['check_envs'])} == simulate: {same}; float32 vs float64 "
          f"{f32:.3e}; finite {ok}; frame 1 of env {i0} vs dopri5 (rtol 1e-10, "
          f"{int(ref.stats.n_steps)} trials, {secs_d:.2f} s) at h, h/2, h/4: "
          f"{', '.join('%.3e' % e for e in errs)} (order {order:.2f}); entry() finite "
          f"{entry_ok}; {n_el}-element von Karman beam (drag, gravity), {envs} envs x "
          f"{RK4_SWEEP['wide_sub']} steps of h, envs == simulate: {wide_same}", flush=True)
    require(all(same), f"batched RK4 != simulate per env: {same}")
    require(all(wide_same) and finite(wide_ys),
            f"batched RK4 on {n_el} elements != simulate per env: {wide_same}")
    require(ok and entry_ok, "batched RK4: non-finite states")
    require(errs[0] > errs[1] > errs[2] and order >= RK4_SWEEP["min_order"],
            f"RK4 vs dopri5 at h, h/2, h/4: {errs} (order {order:.2f})")
    require(f32 <= RK4_SWEEP["f32_max"], f"RK4 float32 vs float64 {f32:.3e}")
    return time.perf_counter() - t_phase


def phase_per_env(crt, dev, meta, data) -> float:
    """Phase 23; returns its wall seconds."""
    from continuum_robot_tpu_torch.ops import integrators

    t_phase = time.perf_counter()
    types, fp = GOLDEN_CONFIGS["nonlinear_fluid_gravity"]
    model = golden_beam(crt, types, fp)
    n = model.n_pos_states
    rhs = model.build_rhs()
    dt, envs, med = meta["dt"], PER_ENV["envs"], PER_ENV["median"]
    amps = np.geomspace(*PER_ENV["amp"], envs)
    amps[med] = meta["impulse_amplitude"]
    t_eval = np.arange(PER_ENV["frames"] + 1) * dt
    kw = dict(rtol=PARITY["rtol"], atol=PARITY["atol"], dt0=dt / 10.0)
    t_end = meta["impulse_t_end"]
    x0 = torch.zeros(envs, 2 * n, dtype=torch.float64, device=dev)
    u = tip_impulse(n, torch.tensor(amps, device=dev), t_end, torch.float64, dev)
    (xs, st), secs = wall(lambda: integrators.integrate_adaptive(
        rhs, x0, t_eval, u=u, per_env=True, **kw))
    acc = st.n_accepted.cpu().numpy()
    steps = st.n_steps.cpu().numpy()
    solo = {}
    for i in (0, med, envs - 1):
        ui = tip_impulse(n, float(amps[i]), t_end, torch.float64, dev)
        xi, si = integrators.integrate_adaptive(rhs, x0[i], t_eval, u=ui, **kw)
        solo[i] = (rel(xs[:, i], xi), int(si.n_accepted) == acc[i]
                   and int(si.n_rejected) == int(st.n_rejected[i]))
    err = golden_err(xs[:, med], data["nonlinear_fluid_gravity_y"][:, : len(t_eval)])
    print(f"phase 23 per-env dopri5: nonlinear_fluid_gravity, {envs} envs, tip impulse "
          f"{PER_ENV['amp'][0]}-{PER_ENV['amp'][1]} N, {t_eval[-1]} s, float64: {secs:.2f} s "
          f"= {acc.sum() / secs:.4e} accepted env-steps/s; trials a lane {steps.min()}-"
          f"{steps.max()} (slowest lane {steps.max()}), {st.host_reads} host reads; lanes "
          f"vs solo (rel, counts equal) {solo}; median lane (amplitude "
          f"{amps[med]}) vs golden {err:.3e}", flush=True)
    require(all(e <= PER_ENV["solo_max"] and c for e, c in solo.values()),
            f"per-env lanes vs solo runs {solo}")
    require(int(st.n_incomplete.sum()) == 0 and finite(xs), "per-env: truncated or non-finite")
    require(err < GOLDEN_MAX, f"per-env median lane vs golden {err:.3e}")
    return time.perf_counter() - t_phase


def phase_stiff(crt, kb, dev, card, meta, data) -> tuple:
    """Phase 24; returns (wall seconds, {path: btd_solve launches})."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod
    from continuum_robot_tpu_torch.models.simulate import make_newmark_operator
    from continuum_robot_tpu_torch.ops import banded, integrators
    from continuum_robot_tpu_torch.ops.exponential import make_expm_propagator

    t_phase = time.perf_counter()
    model = golden_beam(crt, ["linear"] * STIFF["n_el"], length=STIFF["length"])
    n = model.n_pos_states
    amp, t_end = meta["impulse_amplitude"], meta["impulse_t_end"]

    # The propagator over the golden's full 1 s: its reading is printed (the
    # JAX package's reads 2.834e-7 against the test's 1e-9 bound).
    nf = int(round(meta["t_final"] / meta["dt"]))
    u_frames = np.zeros((nf, n))
    u_frames[: int(round(t_end / meta["dt"])), -2] = amp
    prop = make_expm_propagator(model, meta["dt"], dtype=torch.float64, device=dev)
    ys_e, secs_e = wall(lambda: prop(np.zeros(2 * n), u_frames))
    expm_err = golden_err(ys_e, data["stiff60_y"])

    # The oracle of the cut horizon: the exact flow at the frame spacing.
    fr = int(round(STIFF["horizon"] / STIFF["frame"]))
    t_final, frame = fr * STIFF["frame"], STIFF["frame"]
    u_cut = np.zeros((fr, n))
    u_cut[np.arange(fr) * frame < t_end, -2] = amp
    exact = make_expm_propagator(model, frame, dtype=torch.float64, device=dev)(
        np.zeros(2 * n), u_cut)
    tip_ref = exact[:, n - 2]
    kw = dict(rtol=STIFF["rtol"], atol=STIFF["atol"], n_newton=STIFF["n_newton"])
    scales = torch.linspace(*STIFF["scale"], STIFF["envs"], dtype=torch.float64,
                            device=dev)
    cpu = torch.device("cpu")
    paths, lines, runs, vs_cpu, launch_err = {}, [], {}, {}, {}
    for method, solver in (("generalized_alpha_adaptive", "dense_inv"),
                           ("generalized_alpha_adaptive", "pallas"),
                           ("sdirk3", "dense_inv")):
        extra = {"rho_inf": STIFF["rho_inf"]} if method != "sdirk3" else {}
        for envs in (1, STIFF["envs"]):
            x0 = np.zeros((envs, 2 * n)) if envs > 1 else np.zeros(2 * n)
            sc = scales if envs > 1 else torch.ones((), dtype=torch.float64, device=dev)
            u = tip_impulse(n, amp * sc, t_end, torch.float64, dev)
            rec = Recording(kb, "btd_solve")
            kb.reset_launch_counts()
            with replaced(sim_mod, "btd_kernel", rec):
                res, secs = wall(lambda: crt.simulate(
                    model, x0, t_final, frame, method=method, u=u, linear_solver=solver,
                    device=dev, **kw, **extra))
            if solver == "pallas":
                paths[f"adaptive:{method}:pallas:{envs}"] = kb.btd_solve.launches
                # Each launch of the run against the plain version on its own
                # inputs: bit for bit, as in phase 13.
                launch_err[envs] = max(float((out - banded.btd_solve(f, r.contiguous()))
                                             .abs().max()) for (f, r), out in rec.calls)
            tips = res.ys[..., n - 2]
            ref = tip_ref[:, None] * scales if envs > 1 else tip_ref
            err = float((tips - ref).abs().max() / ref.abs().max())
            st = res.stats
            runs[(method, solver, envs)] = res
            lines.append(f"{method}/{solver}/{envs} env: {int(st.n_steps)} trials "
                         f"({st.trials_run} run), {secs:.2f} s a call (set-up included), tip "
                         f"vs exact {err:.3e}")
            require(finite(res.ys) and int(st.n_incomplete) == 0,
                    f"{method}/{solver}/{envs}: non-finite or truncated")
            # The port on the CPU (held to the JAX package there) on the same
            # inputs, the whole batch under its one controller: the same steps
            # and states to roundoff.
            u_c = tip_impulse(n, amp * sc.cpu(), t_end, torch.float64, cpu)
            ref_c = crt.simulate(model, x0, t_final, frame, method=method, u=u_c,
                                 linear_solver=solver, device=cpu, **kw, **extra)
            vs_cpu[(method, solver, envs)] = (
                rel(res.ys.cpu(), ref_c.ys),
                int(st.n_accepted) == int(ref_c.stats.n_accepted)
                and int(st.n_rejected) == int(ref_c.stats.n_rejected))
    # The two solvers of generalized-alpha on the card, at each width.
    vs_dense = {}
    for envs in (1, STIFF["envs"]):
        a = runs[("generalized_alpha_adaptive", "pallas", envs)]
        b = runs[("generalized_alpha_adaptive", "dense_inv", envs)]
        vs_dense[envs] = (rel(a.ys, b.ys), all(int(x) == int(y) for x, y in zip(
            a.stats[:3], b.stats[:3])))
    require(all(e <= STIFF["vs_cpu_max"] and c for e, c in vs_cpu.values()),
            f"adaptive implicit card vs CPU: {vs_cpu}")
    require(all(e <= STIFF["vs_cpu_max"] and c for e, c in vs_dense.values()),
            f"adaptive generalized-alpha pallas vs dense_inv: {vs_dense}")
    require(all(v == 1 for v in paths.values()),
            f"adaptive generalized-alpha (pallas): btd_solve launches {paths}, expected one "
            f"a run (the initial acceleration)")
    require(all(e == 0.0 for e in launch_err.values()),
            f"adaptive generalized-alpha: btd_solve launch vs plain {launch_err}")

    # chunk= on the card: bit for bit the one-call run, stats aggregated.
    x0 = np.zeros(2 * n)
    u = tip_impulse(n, amp, t_end, torch.float64, dev)
    chunked = crt.simulate(model, x0, t_final, frame, method="generalized_alpha_adaptive",
                           u=u, linear_solver="dense_inv", chunk=STIFF["chunk"],
                           rho_inf=STIFF["rho_inf"], device=dev, **kw)
    mono = runs[("generalized_alpha_adaptive", "dense_inv", 1)]
    same = bool(torch.equal(chunked.ys, mono.ys)) and all(
        bool(torch.equal(a, b)) for a, b in zip(chunked.stats[:5], mono.stats[:5]))

    # ms a trial at full width: the bench beam, its trial-dt factorization.
    bench = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS))
    nb = bench.n_pos_states
    q0 = torch.zeros(TRIAL_BENCH["envs"], nb, dtype=torch.float32, device=dev)
    q0[:, -2] = 1e-3
    trial_ms = {}
    for solver in ("btd", "cr"):
        op = make_newmark_operator(bench, dt=None, linear_solver=solver, device=dev,
                                   dtype=torch.float32)
        v0 = torch.zeros_like(q0)
        a0 = integrators.initial_accel(op, q0, v0)  # set-up, outside the timing

        def trials(cap):
            return integrators.integrate_generalized_alpha_adaptive(
                op, q0, v0, [0.0, 1.0], rho_inf=TRIAL_BENCH["rho_inf"],
                n_newton=TRIAL_BENCH["n_newton"], dt0=DT, a0=a0,
                max_steps_per_interval=cap)

        trials(1)  # warm-up: one trial
        (qs, _, st), secs = wall(lambda: trials(TRIAL_BENCH["trials"]))
        require(st.trials_run == int(st.n_steps) == TRIAL_BENCH["trials"] and finite(qs),
                f"trial bench {solver}: {int(st.n_steps)} trials, {st.trials_run} run")
        trial_ms[solver] = secs / st.trials_run * 1e3
    print(f"phase 24 adaptive implicit [{card}]: stiff60 over {t_final} s in {fr} frames "
          f"(rtol {STIFF['rtol']}, atol {STIFF['atol']}): " + "; ".join(lines)
          + f"; card vs CPU port (rel, counts equal) {vs_cpu}; pallas vs dense_inv on the "
          f"card (rel, counts equal) {vs_dense}; btd_solve launches vs plain "
          f"(max|kernel-plain| by envs) {launch_err}"
          f"; chunk={STIFF['chunk']} == one call: {same}; expm propagator over "
          f"{meta['t_final']} s vs golden {expm_err:.3e} ({secs_e:.2f} s); btd_solve "
          f"launches {paths}; generalized_alpha_adaptive trial at full width "
          f"({N_ELEMENTS} elements, {TRIAL_BENCH['envs']} envs, float32): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in trial_ms.items()), flush=True)
    require(same, "chunked adaptive run differs from the one-call run")
    return time.perf_counter() - t_phase, paths


def adaptive_paths(crt, kb, dev, card) -> dict:
    """Phases 21-24; returns the block-tridiagonal kernel's launches by path."""
    with open(f"{GOLDEN_DIR}/trajectories_meta.json") as f:
        meta = json.load(f)
    data = np.load(f"{GOLDEN_DIR}/trajectories.npz")
    secs = {"21": phase_parity(crt, dev, meta, data)}
    secs["22"] = phase_rk4_sweep(crt, dev, card)
    secs["23"] = phase_per_env(crt, dev, meta, data)
    secs["24"], paths = phase_stiff(crt, kb, dev, card, meta, data)
    print(f"phases 21-24 wall: {', '.join(f'{k}: {v:.1f} s' for k, v in secs.items())}; "
          f"together {sum(secs.values()):.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# The control layer and the utilities (phases 25-28)
# ---------------------------------------------------------------------------

# Phase 25: the LQR workload of examples/lqr_control.py and of the goldens
# (tests/goldens/lqr.npz, lqr_closed_loop.npz: 6 linear segments with
# gravity, a 10 N tip impulse for 10 ms, u = K (0 - x) with the golden's
# gain) at the golden test's tolerances. A Dopri5 trial is host issue (a few
# ms), so each closed loop runs span by span for `budget_s` of wall time
# (the golden's 1 s takes ~180 trials a frame) and is held to the golden over
# the frames reached; then per-env Dopri5 over `envs` envs for
# `per_env_frames` frames, the impulse scaled 0.5-1.5.
LQR = dict(rtol=1e-10, atol=1e-12, amp=10.0, t_end=0.01, dt=1e-3, first=2, span=2,
           budget_s=5.0, envs=4096, scale=(0.5, 1.5), per_env_frames=1, solo_max=1e-10,
           gain_max=1e-4, care_max=1e-8)
# Phase 26: examples/lqg_control.py's design (tip axial and transverse
# actuators, R = 1e-8; tip displacement and velocity sensors, V = 1e-2,
# W = 1e-8) on the 6-segment linear cantilever; the exact closed-loop
# propagator over 2000 frames of 1 ms at 4096 envs, the tip ~ N(0, 1e-3),
# the observer cold.
LQG = dict(dt=1e-3, frames=2000, envs=4096, tip_scale=1e-3, check_envs=(0, 2047, 4095),
           cpu_max=1e-12, f32_max=1e-3, sep_max=1e-6)
# Phase 27: tests/test_control.py's EKF (2e-5 s steps of two RK4 substeps;
# tip displacement and velocity measured without noise; V = W = 1e-12, P0 =
# 1e-6 I, started cold) on the 6-segment von Karman cantilever, 4096
# filters each with its own truth (the tip ~ N(0, 5e-4)). The JAX test's
# criterion, < 1% of |x| from step T/3 = 50 of 150 on, is for its
# 2-segment beam at a 5e-4 tip. On 6 segments the filter settles later,
# the later the larger the tip (the von Karman terms grow with it; both
# packages run the same filter). So the filters run `steps` steps and are
# held to 1% from step `after`; the readings from steps 50 and 100 and the
# share of lanes under 1% from step 50 are printed. Lanes are held to
# their solo runs, and lane 0 to the port on the CPU, over the first
# `solo_steps`.
EKF = dict(dt=2e-5, substeps=2, steps=250, envs=4096, tip_scale=5e-4, after=150,
           track_max=1e-2, check_envs=(0, 2047, 4095), solo_steps=100, solo_max=1e-10)
# Phase 28: the utilities on the card: the flagship's RK4 step (entry.py) at
# 4096 envs, tips ~ N(0, 1 um) (velocities ~0.1 m/s, inside the guard's
# default bound of 1e3), one env driven to NaN by its force from step
# `nan_step` on.
UTILS = dict(envs=4096, steps=10, nan_env=7, nan_step=3, tip_scale=1e-6)


@contextlib.contextmanager
def cpu_threads(n: int):
    """While open, torch uses ``n`` CPU threads (the CPU references are
    small: more threads only add their start-up)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def reset_counts(kmods) -> None:
    for kmod in kmods:
        kmod.reset_launch_counts()


def require_no_launches(kmods, path: str) -> None:
    """The control and utility paths launch no kernel: every count read
    just after the path is 0."""
    counts = {k.__name__: k.launches for kmod in kmods for k in kmod.KERNELS}
    require(not any(counts.values()), f"{path}: kernel launches {counts}")


def host_secs(fn):
    """``(fn(), seconds)`` on the host's clock (no card work)."""
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def phase_lqr(crt, dev, card, kmods) -> tuple:
    """Phase 25; returns (wall seconds, (model, controlled SimulationResult))."""
    from continuum_robot_tpu_torch.models.dynamics import sum_forces
    from continuum_robot_tpu_torch.ops import care, integrators

    t_phase = time.perf_counter()
    reset_counts(kmods)
    g = np.load(f"{GOLDEN_DIR}/lqr.npz")
    gcl = np.load(f"{GOLDEN_DIR}/lqr_closed_loop.npz")
    # The design on the host: float64 sign function and Kleinman polish.
    lqr = crt.LinearQuadraticRegulator(g["K_beam"], g["M_beam"], g["Q"], g["R"])
    K, secs_design = host_secs(lqr.compute_gain_matrix)
    gain_err = float(np.abs(K - g["K_gain"]).max() / np.abs(g["K_gain"]).max())
    # The tensor solver on the card in float64 (first call, then a warm one).
    A, B = lqr.get_A(), lqr.get_B()
    # (NumPy inputs: the card and float64 by default.)
    _, secs_cold = wall(lambda: care.solve_care(A, B, g["Q"], g["R"]))
    sol, secs_care = wall(lambda: care.solve_care(A, B, g["Q"], g["R"]))
    P = sol.P.cpu().numpy()
    P_host = care.solve_care_numpy(A, B, g["Q"], g["R"]).P
    scale = float(np.abs(g["P"]).max())
    care_host = float(np.abs(P - P_host).max()) / scale
    care_gold = float(np.abs(P - g["P"]).max()) / scale
    require(sol.P.is_cuda and sol.P.dtype == torch.float64, "solve_care left the card")
    require(gain_err <= LQR["gain_max"], f"LQR gain vs golden K_gain {gain_err:.3e}")
    require(care_host <= LQR["care_max"] and care_gold <= LQR["care_max"],
            f"solve_care on the card: vs host {care_host:.3e}, vs golden {care_gold:.3e}")

    # The closed loops, span by span while the budget lasts.
    beam = golden_beam(crt, ["linear"] * 6, {"enable_gravity_effects": True})
    n = beam.n_pos_states
    ctrl = crt.FullStateLinear(gcl["K_gain"])
    gravity = beam.force_registry.create_aggregated_function()
    loops = {"uncontrolled": None,
             "controlled": sum_forces([gravity, lambda x, t: ctrl.feedback(x, 0.0)])}
    dt, kw = LQR["dt"], dict(rtol=LQR["rtol"], atol=LQR["atol"])
    u = tip_impulse(n, LQR["amp"], LQR["t_end"], torch.float64, dev)
    t_eval = np.arange(gcl["controlled_t"].shape[0]) * dt
    lines, out = [], None
    for tag, ff in loops.items():
        t0 = time.perf_counter()
        res = crt.simulate(beam, np.zeros(2 * n), LQR["first"] * dt, dt, method="dopri5",
                           u=u, forces_func=ff, **kw)
        rhs = beam.build_rhs(ff)
        xs, x, st, i = [res.ys], res.ys[-1], res.stats, LQR["first"]
        trials, runs, dt_next = int(st.n_steps), st.trials_run, st.dt_next
        require(int(st.n_incomplete) == 0, f"LQR {tag}: truncated intervals")
        while i < len(t_eval) - 1 and time.perf_counter() - t0 < LQR["budget_s"]:
            j = min(i + LQR["span"], len(t_eval) - 1)
            ys, st = integrators.integrate_adaptive(rhs, x, t_eval[i : j + 1], u=u,
                                                    dt0=dt_next, **kw)
            xs.append(ys[1:])
            x, dt_next, i = ys[-1], st.dt_next, j
            trials += int(st.n_steps)
            runs += st.trials_run
            require(int(st.n_incomplete) == 0, f"LQR {tag}: truncated intervals")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ys = torch.cat(xs)
        err = golden_err(ys, gcl[f"{tag}_y"][:, : i + 1])
        lines.append(f"{tag} to t={t_eval[i]:.3f} s of {t_eval[-1]:.0f} s (cut at the "
                     f"{LQR['budget_s']} s budget): {trials} trials ({runs} run), "
                     f"{secs / runs * 1e3:.3f} ms a trial run; vs golden {err:.3e}")
        require(err < GOLDEN_MAX and finite(ys) and ys.is_cuda,
                f"LQR {tag}: golden error {err:.3e}")
        if tag == "controlled":
            out = (beam, crt.SimulationResult(ts=torch.as_tensor(t_eval[: i + 1]), ys=ys))

    # Per-env Dopri5 of the controlled loop: impulses scaled 0.5-1.5.
    envs = LQR["envs"]
    amps = LQR["amp"] * np.linspace(*LQR["scale"], envs)
    rhs = beam.build_rhs(loops["controlled"])
    te = np.arange(LQR["per_env_frames"] + 1) * dt
    kwp = dict(dt0=dt / 10.0, **kw)
    x0 = torch.zeros(envs, 2 * n, dtype=torch.float64, device=dev)
    u_env = tip_impulse(n, torch.tensor(amps, device=dev), LQR["t_end"], torch.float64, dev)
    (xs, st), secs_pe = wall(lambda: integrators.integrate_adaptive(
        rhs, x0, te, u=u_env, per_env=True, **kwp))
    steps = st.n_steps.cpu().numpy()
    solo = {}
    for i in (0, envs // 2, envs - 1):
        ui = tip_impulse(n, float(amps[i]), LQR["t_end"], torch.float64, dev)
        xi, si = integrators.integrate_adaptive(rhs, x0[i], te, u=ui, **kwp)
        solo[i] = (rel(xs[:, i], xi), int(si.n_accepted) == int(st.n_accepted[i])
                   and int(si.n_rejected) == int(st.n_rejected[i]))
    t_b = torch.zeros((), dtype=torch.float64, device=dev)
    busy = {b: busy_share(lambda: integrators.dopri5_step(rhs, t_b, xb, 1e-5, ub), dev)
            for b, xb, ub in ((1, xs[-1, 0], u), (envs, xs[-1], u_env))}
    require_no_launches(kmods, "phase 25")
    print(f"phase 25 LQR [{card}]: design (host float64) {secs_design * 1e3:.1f} ms, gain vs "
          f"golden K_gain {gain_err:.3e}; solve_care on the card (float64, 72 x 72 "
          f"Hamiltonian) {int(sol.iterations)} iterations, {secs_care * 1e3:.3f} ms "
          f"({secs_cold * 1e3:.3f} ms the first call), P vs host {care_host:.3e}, vs golden "
          f"{care_gold:.3e} (of max|P|); closed loops, dopri5 rtol {LQR['rtol']} atol "
          f"{LQR['atol']}: " + "; ".join(lines) + f"; per-env dopri5 of the controlled loop, "
          f"{envs} envs, impulse x {LQR['scale'][0]}-{LQR['scale'][1]}, {te[-1]} s: "
          f"{secs_pe:.2f} s, trials a lane {steps.min()}-{steps.max()} ({st.trials_run} run, "
          f"{secs_pe / st.trials_run * 1e3:.3f} ms a trial run); lanes vs solo (rel, counts "
          f"equal) {solo}; device busy in a Dopri5 step of the controlled loop (profiler, "
          f"ms of the step's wall ms): " + ", ".join(
              f"{b} envs {v[0]:.3f} of {v[1]:.3f} ({v[2]:.3f})" for b, v in busy.items())
          + "; kernel launches 0", flush=True)
    require(all(e <= LQR["solo_max"] and c for e, c in solo.values()),
            f"LQR per-env lanes vs solo runs {solo}")
    require(int(st.n_incomplete.sum()) == 0 and finite(xs), "LQR per-env: truncated")
    return time.perf_counter() - t_phase, out


def phase_lqg(crt, dev, card, kmods) -> tuple:
    """Phase 26; returns (wall seconds, (model, plant SimulationResult))."""
    from continuum_robot_tpu_torch.control import (
        LinearQuadraticEstimator, LinearQuadraticGaussian, output_matrix)
    from continuum_robot_tpu_torch.utils import cuda_event_times

    t_phase = time.perf_counter()
    reset_counts(kmods)
    beam = golden_beam(crt, ["linear"] * 6)
    Kb, Mb = beam.beam_model.get_stiffness_matrix(), beam.beam_model.get_mass_matrix()
    nf = Kb.shape[0]

    def design():
        act = [nf - 3, nf - 2]
        Q = np.diag([100.0] * nf + [10.0] * nf)
        lqr = crt.LinearQuadraticRegulator(Kb, Mb, Q, 1e-8 * np.eye(len(act)), input_dofs=act)
        meas = [nf - 3, nf - 2, 2 * nf - 3, 2 * nf - 2]
        lqe = LinearQuadraticEstimator(Kb, Mb, output_matrix(2 * nf, meas),
                                       1e-2 * np.eye(2 * nf), 1e-8 * np.eye(len(meas)))
        return LinearQuadraticGaussian(lqr, lqe)

    lqg, secs_design = host_secs(design)
    ev_aug = np.sort_complex(np.linalg.eigvals(lqg.augmented_matrix()))
    ev_sep = np.sort_complex(np.concatenate([np.linalg.eigvals(lqg.A - lqg.B @ lqg.K),
                                             np.linalg.eigvals(lqg.A - lqg.L @ lqg.C)]))
    sep = float(np.max(np.abs(ev_aug - ev_sep)) / np.max(np.abs(ev_sep)))
    re_max = float(np.max(np.real(ev_aug)))

    F, envs, dt = LQG["frames"], LQG["envs"], LQG["dt"]
    z0 = np.zeros((envs, 4 * nf))
    z0[:, nf - 2] = np.random.default_rng(26).normal(scale=LQG["tip_scale"], size=envs)
    r0 = np.zeros(2 * nf)
    prop64 = lqg.make_closed_loop_propagator(dt, dtype=torch.float64)  # the card
    zs64, secs64 = wall(lambda: prop64(z0, r0, n_frames=F))
    prop32 = lqg.make_closed_loop_propagator(dt, dtype=torch.float32)
    z32 = torch.tensor(z0, dtype=torch.float32, device=dev)
    r32 = torch.zeros(2 * nf, dtype=torch.float32, device=dev)
    runs = cuda_event_times(lambda: prop32(z32, r32, n_frames=F), repeats=3, warmup=1,
                            device=dev)
    zs32 = prop32(z32, r32, n_frames=F)
    f32 = rel(zs32.double(), zs64)
    idx = list(LQG["check_envs"])
    prop_cpu = lqg.make_closed_loop_propagator(dt, dtype=torch.float64, device="cpu")
    with cpu_threads(1):
        zc = prop_cpu(z0[idx], r0, n_frames=F)
    vs_cpu = rel(zs64[:, idx].cpu(), zc)
    x, e = zs64[..., : 2 * nf], zs64[..., : 2 * nf] - zs64[..., 2 * nf:]
    lock = float((torch.linalg.vector_norm(e[-1], dim=-1)
                  / torch.linalg.vector_norm(e[0], dim=-1)).max())
    tip = float((x[-1, :, nf - 2].abs() / x[0, :, nf - 2].abs()).max())
    best = min(runs)
    busy = busy_share(lambda: prop32(z32, r32, n_frames=200), dev)
    require_no_launches(kmods, "phase 26")
    print(f"phase 26 LQG [{card}]: examples/lqg_control.py design (2 actuators, 4 sensors; "
          f"host {secs_design * 1e3:.1f} ms), separation |eig(aug) - eig(A-BK) U "
          f"eig(A-LC)| {sep:.3e} of the spectrum's scale, max Re {re_max:.3f}; propagator "
          f"dt {dt}, {F} frames x {envs} envs (4n = {4 * nf}), observer cold: float32 best "
          f"of 3 {best:.3f} ms ({', '.join('%.3f' % r for r in runs)}) = "
          f"{F / best * 1e3:.4e} frames/s = {F * envs / best * 1e3:.4e} env-frames/s; "
          f"float64 {secs64 * 1e3:.3f} ms (one call); envs {idx} vs the CPU port (float64) "
          f"{vs_cpu:.3e}; float32 vs float64 {f32:.3e}; estimate error at the end / start "
          f"<= {lock:.3e}, tip |x_end / x_0| <= {tip:.3e}; device busy over 200 float32 frames "
          f"(profiler) {busy[0]:.3f} ms of {busy[1]:.3f} ({busy[2]:.3f}); kernel launches 0",
          flush=True)
    require(sep <= LQG["sep_max"] and re_max < 0, f"LQG separation {sep:.3e}, Re {re_max}")
    require(vs_cpu <= LQG["cpu_max"], f"LQG propagator card vs CPU {vs_cpu:.3e}")
    require(f32 <= LQG["f32_max"] and finite(zs32, zs64), f"LQG float32 vs float64 {f32:.3e}")
    require(lock < 1e-2 and tip < 0.5, f"LQG: observer {lock:.3e}, tip {tip:.3e}")
    require(zs64.is_cuda and zs32.is_cuda, "LQG propagator left the card")
    ts = torch.arange(F + 1, dtype=torch.float64) * dt
    return time.perf_counter() - t_phase, (beam, crt.SimulationResult(ts=ts, ys=x))


def phase_ekf(crt, dev, card, kmods) -> tuple:
    """Phase 27; returns (wall seconds, the batch's final EKFState)."""
    from continuum_robot_tpu_torch.control import (
        EKFState, make_discrete_step, make_ekf, output_matrix, run_ekf)

    t_phase = time.perf_counter()
    reset_counts(kmods)
    model = golden_beam(crt, ["nonlinear"] * 6)
    nf = model.n_pos_states
    step = make_discrete_step(model, EKF["dt"], substeps=EKF["substeps"])
    envs, T = EKF["envs"], EKF["steps"]
    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.zeros(envs, 2 * nf, **f64)
    x[:, nf - 2] = torch.tensor(np.random.default_rng(27).normal(
        scale=EKF["tip_scale"], size=envs), **f64)
    truth = []
    for _ in range(T):
        x = step(x)
        truth.append(x)
    truth = torch.stack(truth)
    C = output_matrix(2 * nf, [nf - 2, 2 * nf - 2])
    ys = truth @ torch.tensor(C.T, **f64)
    ekf = make_ekf(step, C, 1e-12 * np.eye(2 * nf), 1e-12 * np.eye(2))
    xh0 = torch.zeros(2 * nf, **f64)
    P0 = 1e-6 * torch.eye(2 * nf, **f64)
    run_ekf(ekf, xh0, P0, ys[:2, 0])  # warm-up: first use of the transforms
    ((xf, Pf), est), secs_b = wall(lambda: run_ekf(
        ekf, xh0.expand(envs, -1).clone(), P0.expand(envs, -1, -1).clone(), ys))
    err = (torch.linalg.vector_norm(est - truth, dim=-1)
           / torch.linalg.vector_norm(truth, dim=-1))
    worst = float(err[EKF["after"]:].max())
    reads = {k: float(err[k:].max()) for k in (50, 100)}
    share = float((err[50:].max(0).values < EKF["track_max"]).double().mean())
    Ts = EKF["solo_steps"]
    solo, secs_1 = {}, []
    for i in EKF["check_envs"]:
        (_, ei), s = wall(lambda: run_ekf(ekf, xh0, P0, ys[:Ts, i]))
        secs_1.append(s)
        solo[i] = rel(est[:Ts, i], ei)
    with cpu_threads(1):
        _, ec = run_ekf(ekf, np.zeros(2 * nf), 1e-6 * np.eye(2 * nf), ys[:Ts, 0].cpu(),
                        device="cpu")
    vs_cpu = rel(est[:Ts, 0].cpu(), ec)
    busy = {b: busy_share(lambda: ekf(state, y), dev) for b, state, y in (
        (1, EKFState(xf[0], Pf[0]), ys[-1, 0]), (envs, EKFState(xf, Pf), ys[-1]))}
    require_no_launches(kmods, "phase 27")
    print(f"phase 27 EKF [{card}]: 6-segment von Karman beam ({2 * nf} states), "
          f"make_discrete_step(dt={EKF['dt']}, substeps={EKF['substeps']}), {envs} filters "
          f"in float64, each its own truth, cold start, {T} steps: {secs_b:.2f} s = "
          f"{secs_b / T * 1e3:.3f} ms a filter step at {envs} filters, "
          f"{min(secs_1) / Ts * 1e3:.3f} ms at 1 (best of {len(secs_1)} solo runs of {Ts} "
          f"steps); worst |x_hat - x| / |x| from step {EKF['after']} {worst:.3e} (from step "
          f"50: {reads[50]:.3e}, {share:.4f} of the lanes under {EKF['track_max']}; from 100: "
          f"{reads[100]:.3e}); over the first {Ts} steps lanes vs solo (rel) {solo}, lane 0 "
          f"vs the CPU port {vs_cpu:.3e}; device busy in a filter step (profiler, ms of the "
          f"step's wall ms): " + ", ".join(f"{b} filters {v[0]:.3f} of {v[1]:.3f} "
                                           f"({v[2]:.3f})" for b, v in busy.items())
          + "; kernel launches 0",
          flush=True)
    require(worst < EKF["track_max"] and finite(est, Pf) and est.is_cuda,
            f"EKF tracking {worst:.3e}")
    require(all(e <= EKF["solo_max"] for e in solo.values()), f"EKF lanes vs solo {solo}")
    require(vs_cpu <= EKF["solo_max"], f"EKF lane 0 vs CPU {vs_cpu:.3e}")
    return time.perf_counter() - t_phase, (xf, Pf)


def phase_utils(crt, dev, card, kmods, lqr_out, lqg_out, ekf_state) -> float:
    """Phase 28; returns its wall seconds."""
    import tempfile

    from continuum_robot_tpu_torch.entry import entry
    from continuum_robot_tpu_torch.utils import (
        init_health, load_checkpoint, save_checkpoint, step_with_guard,
        verify_batch_consistency)
    from continuum_robot_tpu_torch.utils.metrics import run_metrics

    t_phase = time.perf_counter()
    reset_counts(kmods)
    metrics = {name: run_metrics(*o) for name, o in (("25", lqr_out), ("26", lqg_out))}
    ok_metrics = all(m["finite"] and all(np.isfinite(v) for v in m.values())
                     for m in metrics.values())

    step, (_, ue) = entry(device=dev)
    n, envs, k_bad = ue.shape[-1], UTILS["envs"], UTILS["nan_env"]
    x0 = torch.zeros(envs, 2 * n, dtype=ue.dtype, device=dev)
    x0[:, n - 2] = torch.tensor(np.random.default_rng(28).normal(
        scale=UTILS["tip_scale"], size=envs), dtype=ue.dtype, device=dev)
    batch_dev = verify_batch_consistency(lambda z: step(z, ue), x0, n_check=3)

    u_ok = ue.expand(envs, n).clone()
    u_bad = u_ok.clone()
    u_bad[k_bad] = float("nan")
    xg, xu, health = x0, x0, init_health(x0, (envs,))
    for k in range(UTILS["steps"]):
        u_k = u_bad if k >= UTILS["nan_step"] else u_ok
        xu = step(xu, u_k)
        xg, health = step_with_guard(lambda z: step(z, u_k))(xg, health)
        if k == UTILS["nan_step"] - 1:
            x_last = xg[k_bad].clone()
    rest = torch.arange(envs, device=dev) != k_bad
    guard_ok = (torch.equal(xg[rest], xu[rest]) and torch.equal(xg[k_bad], x_last)
                and health.diverged.nonzero().flatten().tolist() == [k_bad]
                and not finite(xu[k_bad]) and finite(xg))

    gen = torch.Generator(device=dev).manual_seed(28)
    torch.rand(3, generator=gen, device=dev)
    state = {"x_hat": ekf_state[0], "P": ekf_state[1], "plant": lqg_out[1].ys[-1]}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(f"{d}/state.npz", state, t=0.003, rng_key=gen, meta={"envs": envs})
        back, t, gen_back, meta = load_checkpoint(f"{d}/state.npz", treedef_like=state)
    ckpt_ok = (t == 0.003 and int(meta["envs"]) == envs and list(back) == list(state)
               and all(back[k].is_cuda and torch.equal(back[k], state[k]) for k in state)
               and torch.equal(torch.rand(4, generator=gen_back, device=dev),
                               torch.rand(4, generator=gen, device=dev)))
    require_no_launches(kmods, "phase 28")
    print(f"phase 28 utils [{card}]: run_metrics finite {ok_metrics} (phase 25 controlled "
          f"loop: energy {metrics['25']['energy_initial']:.4e} -> "
          f"{metrics['25']['energy_final']:.4e} J, tip max {metrics['25']['tip_abs_max']:.4e} "
          f"m; phase 26 plants: energy max {metrics['26']['energy_max']:.4e} J, drift "
          f"{metrics['26']['energy_drift_rel']:.4e}); verify_batch_consistency of the "
          f"flagship's RK4 step at {envs} envs (float32): {batch_dev:.3e}; step_with_guard, "
          f"env {k_bad} driven to NaN from step {UTILS['nan_step']} of {UTILS['steps']}: "
          f"frozen, the other {envs - 1} bit for bit the unguarded run: {guard_ok}; "
          f"checkpoint of a card state (EKF x_hat, P; LQG plants; a CUDA generator) "
          f"saved, loaded, bit for bit: {ckpt_ok}; kernel launches 0", flush=True)
    require(ok_metrics, f"run_metrics not finite: {metrics}")
    require(guard_ok, "step_with_guard: frozen env or the others differ")
    require(ckpt_ok, "checkpoint round trip differs")
    return time.perf_counter() - t_phase


def control_paths(crt, dev, card, kmods) -> None:
    """Phases 25-28."""
    secs = {}
    secs["25"], lqr_out = phase_lqr(crt, dev, card, kmods)
    secs["26"], lqg_out = phase_lqg(crt, dev, card, kmods)
    secs["27"], ekf_state = phase_ekf(crt, dev, card, kmods)
    secs["28"] = phase_utils(crt, dev, card, kmods, lqr_out, lqg_out, ekf_state)
    print(f"phases 25-28 wall: {', '.join(f'{k}: {v:.1f} s' for k, v in secs.items())}; "
          f"together {sum(secs.values()):.1f} s", flush=True)


# ---------------------------------------------------------------------------
# The rest of the ROM tier (phases 29-32)
# ---------------------------------------------------------------------------

# Phase 29: modal_rom_adaptive on the ROM main path (its engine, starts and
# tip load) over `frames` frames of `frame_dt` at rtol near the float32
# floor (50 eps = 6e-6); `check_envs` envs in float64 against the port on
# the CPU on the same inputs; simulate(chunk=) on the 8-element beam; the
# nonlinear_fluid_gravity golden (three Newton iterations, as the JAX test)
# frame by frame while `golden_budget_s` lasts, held to the JAX test's bound
# over the frames reached. At the JAX test's rtol 1e-10 one 1 ms frame takes
# ~3800 trials (~19 s of host dispatch on the CPU), so rtol is 1e-8 (~770
# trials a frame).
ROM_ADAPTIVE = dict(frames=20, frame_dt=1e-3, rtol=1e-5, atol=1e-8, n_newton=2, cap=2000,
                    check_envs=4, vs_cpu_max=1e-10, chunk_envs=64, chunk_frames=3,
                    chunk_frame_dt=5e-4, chunk_rtol=1e-4,
                    golden_rtol=1e-8, golden_atol=1e-12, golden_newton=3,
                    golden_budget_s=8.0, golden_max=3e-4)
# Phase 30: the ROM main path's beam in water with gravity (fluid density
# 1000, the reference's C_d 0.82 on 2 pi r L) through simulate(method=
# "modal_rom", engine="xla"), 4096 envs, `frames` x `substeps` steps, the
# main path's rho_inf and Newton count; float32 against float64 by norm.
ROM_FORCED = dict(frames=5, substeps=20, f32_max=1e-3, closure_envs=8, closure_max=1e-12,
                  path_envs=64, path_steps=20, path_max=1e-9)
# Phase 31: the trained ECSW engine of phase 9. Tip forces spread over
# `inside` x the training force (3 N) stay in the trained envelope; `outside`
# x it (10 x the training amplitude and up) must be flagged in every env.
ROM_GUARD = dict(frames=10, substeps=20, inside=(0.5, 1.0), outside=(10.0, 15.0),
                 ecsw_steps=200, carry_steps=200, carry_unroll=8, carry_max=0.05)
# Phase 32: the implicit phase's consistent 1000-element beam augmented with
# three modes' derivatives (the JAX package's 256 + loads), `steps` steps at
# 4096 envs; then a 32-segment parity beam (tests/helpers.py's), 24 modes +
# derivatives, through simulate(engine="pallas") at 4096 envs against "xla"
# in float64 within phase 7's bound, from fused_start's tip displacements.
ROM_AUGMENT = dict(cons_steps=50, cons_newton=2, cons_f32_max=1e-4, segments=32, modes=24,
                   md=3, envs=4096, frames=10, substeps=5, n_newton=1)


def forced_beam(crt, n: int):
    """The bench beam with the reference's drag columns (C_d 0.82 on 2 pi r L),
    in water (density 1000) with gravity."""
    df = bench_beam_dataframe(n, "nonlinear")
    df["wetted_area"] = 2 * np.pi * 0.005 * df["length"]
    df["drag_coef"] = 0.82
    fp = crt.ForceParams(enable_fluid_effects=True, fluid_density=1000.0,
                         enable_gravity_effects=True)
    return crt.DynamicEulerBernoulliBeam(df, fp)


def rom_tier_main(crt, dev):
    """The ROM main path's model, engine and inputs and phase 9's trained
    ECSW engine, for ``--rom-tier`` (the full run reuses phases 8-9's)."""
    model, ms, eta, etad, u_m, _ = rom_main_path(crt, dev)
    ms_g = train_main_ecsw(ms, model.n_pos_states, dev)[0]
    return dict(model=model, ms=ms, ms_g=ms_g, eta=eta, etad=etad, u_m=u_m)


def phase_rom_adaptive(crt, dev, card, main, kmods) -> float:
    """Phase 29; returns its wall seconds."""
    from continuum_robot_tpu_torch.models.simulate import make_modal_rom

    t_phase = time.perf_counter()
    cfg = ROM_ADAPTIVE
    ms, eta, etad, u_m = main["ms"], main["eta"], main["etad"], main["u_m"]
    t_eval = np.arange(cfg["frames"] + 1) * cfg["frame_dt"]
    kw = dict(rtol=cfg["rtol"], atol=cfg["atol"], n_newton=cfg["n_newton"],
              max_steps_per_interval=cfg["cap"])

    def run():
        return ms.rollout_adaptive(eta, etad, u_m, t_eval, **kw)

    reset_counts(kmods)
    (etas, etads, st), first_s = wall(run)
    require_no_launches(kmods, "modal_rom_adaptive")
    (_, _, st2), wall_s = wall(run)
    busy = sum(r[0] for r in kernel_rows(run, dev))
    q, v = ms.from_modal(etas[-1], etads[-1])
    require(etas.shape == (cfg["frames"] + 1, N_ENVS, ms.n_modes)
            and bool(torch.isfinite(q).all() and torch.isfinite(v).all()),
            "modal_rom_adaptive: bad output")
    require(int(st.n_incomplete) == 0 and int(st2.n_accepted) == int(st.n_accepted),
            f"modal_rom_adaptive: {st}")
    print(f"phase 29 modal_rom_adaptive [{card}]: {N_ENVS} envs x {ms.n_modes} modes, "
          f"float32, {cfg['frames']} frames of {cfg['frame_dt']} s, rtol {cfg['rtol']}: "
          f"{int(st.n_accepted)} accepted, {int(st.n_rejected)} rejected, {st.trials_run} "
          f"trials run, {st.host_reads} host reads; {wall_s * 1e3:.3f} ms = "
          f"{wall_s * 1e3 / st.trials_run:.3f} ms a trial (first call {first_s * 1e3:.3f} ms); "
          f"device busy {busy:.3f} ms, share {busy / (wall_s * 1e3):.3f}", flush=True)

    # float64 on a few envs, against the port on the CPU on the same inputs.
    k = cfg["check_envs"]
    e64, ed64 = eta[:k].double(), etad[:k].double()
    card64 = ms.rollout_adaptive(e64, ed64, u_m, t_eval, **kw)
    with cpu_threads(8):
        cpu64 = ms.rollout_adaptive(e64.cpu(), ed64.cpu(), u_m, t_eval, **kw)
    counts = [tuple(int(getattr(s, f)) for f in ("n_accepted", "n_rejected"))
              for s in (card64[2], cpu64[2])]
    vs_cpu = max(rel(a.cpu(), b) for a, b in zip(card64[:2], cpu64[:2]))
    print(f"phase 29 modal_rom_adaptive float64, {k} envs: card vs CPU {vs_cpu:.3e}, "
          f"(accepted, rejected) card {counts[0]} CPU {counts[1]}", flush=True)
    require(counts[0] == counts[1] and vs_cpu <= cfg["vs_cpu_max"],
            f"modal_rom_adaptive float64 card vs CPU: {vs_cpu:.3e}, {counts}")

    # simulate(chunk=) bit for bit the one-call run, on tests/helpers.py's
    # 8-segment von Karman beam.
    small = golden_beam(crt, ["nonlinear"] * ROM_SMALL["n_el"])
    n_s = small.n_pos_states
    rng = np.random.default_rng(29)
    x0 = np.zeros((cfg["chunk_envs"], 2 * n_s), np.float32)
    x0[:, :n_s] = rng.normal(scale=1e-4, size=(cfg["chunk_envs"], n_s))
    u_s = np.zeros(n_s)
    u_s[-2] = 0.1
    skw = dict(method="modal_rom_adaptive", u=u_s, rtol=cfg["chunk_rtol"],
               atol=cfg["chunk_rtol"] * 1e-3, n_newton=cfg["n_newton"],
               rho_inf=ROM["rho_inf"], device=dev)
    t_f = cfg["chunk_frames"] * cfg["chunk_frame_dt"]
    reset_counts(kmods)
    one = crt.simulate(small, x0, t_f, cfg["chunk_frame_dt"], **skw)
    chunked = crt.simulate(small, x0, t_f, cfg["chunk_frame_dt"], chunk=1, **skw)
    require_no_launches(kmods, "simulate modal_rom_adaptive")
    same = bool(torch.equal(one.ys, chunked.ys))
    print(f"phase 29 simulate modal_rom_adaptive: {cfg['chunk_envs']} envs, chunk=1 bit for "
          f"bit the one-call run: {same} ({int(one.stats.n_accepted)} accepted)", flush=True)
    require(same and int(chunked.stats.n_accepted) == int(one.stats.n_accepted),
            "modal_rom_adaptive: chunk= differs from the one-call run")

    # The nonlinear_fluid_gravity golden, span by span within the budget.
    with open(f"{GOLDEN_DIR}/trajectories_meta.json") as f:
        meta = json.load(f)
    y_gold = np.load(f"{GOLDEN_DIR}/trajectories.npz")["nonlinear_fluid_gravity_y"]
    types, fp = GOLDEN_CONFIGS["nonlinear_fluid_gravity"]
    beam = golden_beam(crt, types, fp)
    n = beam.n_pos_states
    dt = meta["dt"]
    gms = make_modal_rom(beam, dt, device=dev)
    u = tip_impulse(n, meta["impulse_amplitude"], meta["impulse_t_end"], torch.float64, dev)
    u_g = lambda t: gms.project_force(u(t))  # noqa: E731
    t_gold = np.arange(int(round(meta["t_final"] / dt)) + 1) * dt
    zero = torch.zeros(gms.n_modes, dtype=torch.float64, device=dev)
    state, dt_next, i, trials = (zero, zero, None), None, 0, 0
    frames, frames_d = [zero[None]], [zero[None]]
    gkw = dict(rtol=cfg["golden_rtol"], atol=cfg["golden_atol"], n_newton=cfg["golden_newton"])
    reset_counts(kmods)
    t0 = time.perf_counter()
    while i < len(t_gold) - 1 and time.perf_counter() - t0 < cfg["golden_budget_s"]:
        es, eds, stg, state = gms.rollout_adaptive(
            state[0], state[1], u_g, t_gold[i:i + 2], dt0=dt_next, etadd0=state[2],
            return_final=True, **gkw)
        frames.append(es[1:])
        frames_d.append(eds[1:])
        dt_next, i, trials = stg.dt_next, i + 1, trials + stg.trials_run
        require(int(stg.n_incomplete) == 0, "modal_rom_adaptive golden: truncated")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require_no_launches(kmods, "modal_rom_adaptive golden")
    qs, vs = gms.from_modal(torch.cat(frames), torch.cat(frames_d))
    err = golden_err(torch.cat([qs, vs], dim=-1), y_gold[:, : i + 1])
    print(f"phase 29 modal_rom_adaptive golden nonlinear_fluid_gravity [{card}]: float64, "
          f"rtol {cfg['golden_rtol']}, reached t={t_gold[i]:.3f} of {meta['t_final']} s in "
          f"{secs:.2f} s ({i} frames, {trials} trials, {secs / max(trials, 1) * 1e3:.3f} ms "
          f"a trial); vs golden {err:.3e} (the JAX bound {cfg['golden_max']})",
          flush=True)
    require(i >= 1 and err < cfg["golden_max"], f"modal_rom_adaptive golden: {err:.3e}")
    return time.perf_counter() - t_phase


def phase_rom_forced(crt, dev, card, kmods) -> float:
    """Phase 30; returns its wall seconds."""
    from continuum_robot_tpu_torch.models.simulate import make_modal_rom

    t_phase = time.perf_counter()
    cfg = ROM_FORCED
    model = forced_beam(crt, N_ELEMENTS)
    n = model.n_pos_states
    rng = np.random.default_rng(30)
    x0 = np.zeros((N_ENVS, 2 * n))
    x0[:, :n] = rng.normal(scale=1e-6, size=(N_ENVS, n))
    u = np.zeros(n)
    u[-2] = 0.1
    dt_f = DT * cfg["substeps"]
    t_f = cfg["frames"] * dt_f
    kw = dict(method="modal_rom", u=u, substeps=cfg["substeps"], n_newton=ROM["n_newton"],
              rho_inf=ROM["rho_inf"], n_modes=ROM["modes"], engine="xla", device=dev)
    reset_counts(kmods)
    res64, sim_s = wall(lambda: crt.simulate(model, x0, t_f, dt_f, **kw))
    require_no_launches(kmods, "simulate modal_rom with forces")
    # The same drive in float32, its set-up apart from its timing.
    ms, setup_s = host_secs(lambda: make_modal_rom(
        model, DT, rho_inf=ROM["rho_inf"], n_modes=ROM["modes"], device=dev,
        dtype=torch.float32))
    require(ms.ext_modal is not None and ms.external_force is None,
            "forced ROM: registry forces not on the split path")
    x32 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    eta, etad = ms.to_modal(x32[:, :n], x32[:, n:])
    u_m = ms.project_force_host(u)

    def drive():
        return ms.rollout_frames(eta, etad, u_m, cfg["frames"], substeps=cfg["substeps"],
                                 n_newton=ROM["n_newton"])

    reset_counts(kmods)
    drive()
    require_no_launches(kmods, "forced ROM rollout")
    (_, etas, etads), span_s = wall(drive)
    qs, vs = ms.from_modal(etas, etads)
    ys32 = torch.cat([qs, vs], dim=-1)
    ys64 = res64.ys
    require(tuple(ys64.shape) == (cfg["frames"] + 1, N_ENVS, 2 * n)
            and bool(torch.isfinite(ys32).all()), "forced ROM: bad output")
    f32_vs_f64 = max(rel_parts((ys32[-1, :, :n], ys32[-1, :, n:]),
                               (ys64[-1, :, :n], ys64[-1, :, n:])))
    steps = cfg["frames"] * cfg["substeps"]
    print(f"phase 30 forced ROM [{card}]: {N_ELEMENTS} von Karman elements in water with "
          f"gravity, {ms.n_modes} modes, {N_ENVS} envs, {steps} steps: float32 span "
          f"{span_s * 1e3:.3f} ms = {steps * N_ENVS / span_s:.4e} env-steps/s (set-up "
          f"{setup_s:.2f} s apart); simulate float64 {sim_s:.2f} s with its set-up; float32 "
          f"vs float64 {f32_vs_f64:.3e} (by norm, q and v)", flush=True)
    require(f32_vs_f64 <= cfg["f32_max"], f"forced ROM float32 vs float64 {f32_vs_f64:.3e}")

    # The closure on the card, float64, against the projected force.
    k = cfg["closure_envs"]
    x = torch.as_tensor(rng.normal(scale=1e-3, size=(k, 2 * n)), device=dev)
    e, ed = ms.to_modal(x[:, :n], x[:, n:])
    q, v = ms.from_modal(e, ed)
    agg = model.force_registry.create_aggregated_function()
    want = ms.project_force(agg(torch.cat([q, v], dim=-1), 0.0))
    closure = rel(ms.ext_modal(e, ed, 0.0), want)
    # The split path against the general path on the same basis, float64.
    general = dataclasses.replace(ms, ext_modal=None, external_force=agg)
    k = cfg["path_envs"]
    e64, ed64 = eta[:k].double(), etad[:k].double()
    split_out = ms.rollout(e64, ed64, u_m, cfg["path_steps"], n_newton=ROM["n_newton"])
    gen_out = general.rollout(e64, ed64, u_m, cfg["path_steps"], n_newton=ROM["n_newton"])
    paths = rel_state(split_out, gen_out)
    print(f"phase 30 forced ROM checks: ext_modal vs PhiW^T compute_forces (float64, {cfg['closure_envs']} "
          f"envs) {closure:.3e}; split vs general path ({k} envs, {cfg['path_steps']} steps, "
          f"float64) {paths:.3e}", flush=True)
    require(closure <= cfg["closure_max"] and paths <= cfg["path_max"],
            f"forced ROM: closure {closure:.3e}, paths {paths:.3e}")
    return time.perf_counter() - t_phase


def phase_rom_guard(crt, rk, dev, card, main, kmods) -> tuple:
    """Phase 31; returns (wall seconds, {ROM kernel: launches} of the loaded
    ECSW span)."""
    import tempfile

    from continuum_robot_tpu_torch.models.simulate import make_modal_rom

    t_phase = time.perf_counter()
    cfg = ROM_GUARD
    model, ms, ms_g = main["model"], main["ms"], main["ms_g"]
    eta, etad, u_m = main["eta"], main["etad"], main["u_m"]
    n = model.n_pos_states
    z = torch.zeros((N_ENVS, ms.n_modes), dtype=torch.float32, device=dev)

    def tip_forces(scale):
        U = torch.zeros((N_ENVS, n), dtype=torch.float32, device=dev)
        U[:, -2] = 3.0 * torch.linspace(*scale, N_ENVS, device=dev)
        return ms_g.project_force(U)

    kw = dict(substeps=cfg["substeps"], n_newton=1)
    reset_counts(kmods)
    inside = tip_forces(cfg["inside"])
    g_in = ms_g.rollout_frames_guarded(z, z, inside, cfg["frames"], **kw)
    g_out = ms_g.rollout_frames_guarded(z, z, tip_forces(cfg["outside"]), cfg["frames"], **kw)
    require_no_launches(kmods, "ECSW guard")
    _, guarded_s = wall(lambda: ms_g.rollout_frames_guarded(z, z, inside, cfg["frames"], **kw))
    ms_g.rollout_frames(z, z, inside, cfg["frames"], **kw)
    _, plain_s = wall(lambda: ms_g.rollout_frames(z, z, inside, cfg["frames"], **kw))
    gi, go = g_in[3], g_out[3]
    n_in, n_out = int(gi["flagged"].sum()), int(go["flagged"].sum())
    print(f"phase 31 ECSW guard [{card}]: {N_ENVS} envs, {cfg['frames']} frames x "
          f"{cfg['substeps']}: guarded {guarded_s * 1e3:.3f} ms vs unguarded "
          f"{plain_s * 1e3:.3f} ms ({guarded_s / plain_s:.3f}x); tip force "
          f"{cfg['inside']} x the training 3 N: max residual "
          f"{float(gi['max_residual'].max()):.3e}, {n_in} flagged; {cfg['outside']} x: min "
          f"residual {float(go['max_residual'].min()):.3e}, {n_out} of {N_ENVS} flagged "
          f"(guard_tol {gi['guard_tol']:.3g})", flush=True)
    require(n_in == 0 and n_out == N_ENVS,
            f"ECSW guard: {n_in} flagged inside, {n_out} of {N_ENVS} outside")

    # Files: the deployment path rebuilds the engines from disk.
    with tempfile.TemporaryDirectory() as tmp:
        bpath = ms.save_basis(f"{tmp}/basis.npz")
        spath = ms_g.save_ecsw(f"{tmp}/ecsw.npz")
        ms2, rebuild_s = host_secs(lambda: make_modal_rom(
            model, DT, rho_inf=ROM["rho_inf"], basis=crt.load_basis(bpath), device=dev,
            dtype=torch.float32))
        red2 = ms2.apply_ecsw(*crt.load_ecsw(spath))
    names = ("Phi", "PhiW", "PhiTM", "Sinv", "Sinv_diag", "lam", "Phi_planar", "PhiW_planar")
    same_ops = all(np.array_equal(getattr(ms2, k_), getattr(ms, k_)) for k_ in names)
    same_ops = same_ops and all(np.array_equal(red2.sampled_params[k_], ms_g.sampled_params[k_])
                                for k_ in ("sel", "xi")) and np.array_equal(
        red2.PhiW_planar, ms_g.PhiW_planar)
    require(same_ops, "load_basis/load_ecsw: operators differ from the trained engine's")
    steps = cfg["ecsw_steps"]
    n_it = steps * ROM["n_newton"]
    trained = ms_g.make_pallas_rollout()(eta, etad, u_m, steps, n_newton=ROM["n_newton"])
    fused2 = red2.make_pallas_rollout()
    out, counts = counted(rk, lambda: fused2(eta, etad, u_m, steps, n_newton=ROM["n_newton"]))
    expect_launches(counts, ROM_GATHERED, n_it, "loaded ECSW span")
    op, e0, ed0, a0, _ = fused2.prepare(eta, etad, u_m)
    ref = rk.rom_steps_plain(op, e0, ed0, a0, steps, ROM["n_newton"])
    bit = all(bool(torch.equal(a, b)) for a, b in zip(out, trained))
    vs_plain = rel_state(out, ref)
    print(f"phase 31 ECSW files: basis and sample written and loaded, engine rebuilt in "
          f"{rebuild_s:.2f} s with bit-equal operators; loaded gathered span {N_ENVS} envs x "
          f"{steps} steps bit for bit the trained engine's: {bit}; vs_plain_rel "
          f"{vs_plain:.3e}; launches {counts}", flush=True)
    require(bit and vs_plain <= ROM_SPAN_MAX,
            f"loaded ECSW span: bit-equal {bit}, vs plain {vs_plain:.3e}")

    # carry_dtype: the main engine's plain stepper with a bfloat16 carry.
    csteps = cfg["carry_steps"]
    reset_counts(kmods)
    base = ms.rollout(eta, etad, u_m, csteps, n_newton=ROM["n_newton"])
    bf = ms.rollout(eta, etad, u_m, csteps, n_newton=ROM["n_newton"],
                    unroll=cfg["carry_unroll"], carry_dtype=torch.bfloat16)
    require_no_launches(kmods, "carry_dtype rollout")
    _, base_s = wall(lambda: ms.rollout(eta, etad, u_m, csteps, n_newton=ROM["n_newton"]))
    _, bf_s = wall(lambda: ms.rollout(eta, etad, u_m, csteps, n_newton=ROM["n_newton"],
                                      unroll=cfg["carry_unroll"], carry_dtype=torch.bfloat16))
    drift = rel_state(bf, base)
    print(f"phase 31 carry_dtype=bfloat16 [{card}]: {N_ENVS} envs x {csteps} steps, unroll "
          f"{cfg['carry_unroll']}: drift {drift:.3e} (by norm, eta and etad); "
          f"{bf_s * 1e3:.3f} ms vs {base_s * 1e3:.3f} ms with the float32 carry", flush=True)
    require(bool(torch.isfinite(bf[0]).all()) and drift < cfg["carry_max"],
            f"carry_dtype drift {drift:.3e}")
    return time.perf_counter() - t_phase, counts


def phase_rom_augment(crt, rk, dev, card, kmods) -> tuple:
    """Phase 32; returns (wall seconds, {ROM kernel: launches} of the
    augmented simulate)."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod

    t_phase = time.perf_counter()
    cfg = ROM_AUGMENT
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "nonlinear"),
                                          use_consistent_nonlinear=True)
    with clocked(sim_mod, "_augment_static") as secs:
        ms, setup_s = host_secs(lambda: sim_mod.make_modal_rom(
            model, DT, rho_inf=ROM["rho_inf"], n_modes=ROM["modes"], modal_derivatives=cfg["md"],
            device=dev, dtype=torch.float32))
    require(ms.n_modes > ROM["modes"] and ms.lam is None and ms.Sinv_diag is not None,
            f"consistent ROM: {ms.n_modes} modes, lam {ms.lam is None}, "
            f"Sinv_diag {ms.Sinv_diag is not None}")
    n = model.n_pos_states
    rng = np.random.default_rng(32)
    q = torch.tensor(rng.normal(scale=1e-6, size=(N_ENVS, n)), dtype=torch.float32, device=dev)
    u = np.zeros(n)
    u[-2] = 0.1
    eta, etad = ms.to_modal(q, torch.zeros_like(q))
    u_m = ms.project_force_host(u)
    steps = cfg["cons_steps"]
    reset_counts(kmods)
    out32 = ms.rollout(eta, etad, u_m, steps, n_newton=cfg["cons_newton"])
    out64 = ms.rollout(eta.double(), etad.double(), u_m, steps, n_newton=cfg["cons_newton"])
    require_no_launches(kmods, "consistent ROM")
    _, span_s = wall(lambda: ms.rollout(eta, etad, u_m, steps, n_newton=cfg["cons_newton"]))
    f32_vs_f64 = rel_state(out32, out64)
    print(f"phase 32 consistent ROM [{card}]: {N_ELEMENTS} consistent von Karman elements, "
          f"{ROM['modes']} modes + derivatives of {cfg['md']} -> {ms.n_modes} modes (general "
          f"path, diagonal Newton); host set-up {setup_s:.2f} s (augmentation "
          f"{sum(secs['_augment_static']):.2f} s); {N_ENVS} envs x {steps} steps float32 "
          f"{span_s * 1e3:.3f} ms = {steps * N_ENVS / span_s:.4e} env-steps/s; float32 vs "
          f"float64 {f32_vs_f64:.3e}", flush=True)
    require(all(bool(torch.isfinite(x).all()) for x in out32)
            and f32_vs_f64 <= cfg["cons_f32_max"], f"consistent ROM f32 vs f64 {f32_vs_f64:.3e}")

    # The augmented parity basis through the fused ROM kernels.
    beam = golden_beam(crt, ["nonlinear"] * cfg["segments"])
    n_a = beam.n_pos_states
    x0 = fused_start(n_a, cfg["envs"], seed=32)
    u_a = np.zeros(n_a)
    u_a[-2] = 0.1
    dt_f = DT * cfg["substeps"]
    kw = dict(method="modal_rom", u=u_a, substeps=cfg["substeps"], n_newton=cfg["n_newton"],
              rho_inf=ROM["rho_inf"], n_modes=cfg["modes"], modal_derivatives=cfg["md"],
              device=dev)
    ms_a = sim_mod.make_modal_rom(beam, DT, rho_inf=ROM["rho_inf"], n_modes=cfg["modes"],
                                  modal_derivatives=cfg["md"], device=dev)
    res, counts = counted(rk, lambda: crt.simulate(beam, x0, cfg["frames"] * dt_f, dt_f,
                                                   engine="pallas", **kw))
    ref = crt.simulate(beam, x0, cfg["frames"] * dt_f, dt_f, engine="xla", **kw)
    kernels = ROM_WINDOW if ms_a.Sinv_diag is not None else ROM_DENSE
    expect_launches(counts, kernels, cfg["frames"] * cfg["substeps"] * cfg["n_newton"],
                    "simulate modal_rom pallas, augmented basis")
    err = scaled_err(res.ys.double(), ref.ys)
    print(f"phase 32 augmented parity basis: {cfg['segments']} segments, {cfg['modes']} modes "
          f"-> {ms_a.n_modes}, diagonal Newton {ms_a.Sinv_diag is not None}; simulate pallas "
          f"(float32) vs xla (float64), {cfg['envs']} envs, {cfg['frames']} x "
          f"{cfg['substeps']}: max err / scale {err:.3e} (limit {ROM_SMALL_MAX}); launches "
          f"{counts}", flush=True)
    require(ms_a.n_modes > cfg["modes"] and err <= ROM_SMALL_MAX,
            f"augmented parity basis: {ms_a.n_modes} modes, pallas vs xla {err:.3e}")
    return time.perf_counter() - t_phase, counts


def rom_tier_paths(crt, rk, dev, card, kmods, main=None) -> dict:
    """Phases 29-32; returns the ROM kernels' launches by path."""
    t0 = time.perf_counter()
    if main is None:
        main = rom_tier_main(crt, dev)
        print(f"ROM tier set-up (the ROM main path and its ECSW engine): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    secs = {"29": phase_rom_adaptive(crt, dev, card, main, kmods)}
    secs["30"] = phase_rom_forced(crt, dev, card, kmods)
    secs["31"], loaded = phase_rom_guard(crt, rk, dev, card, main, kmods)
    secs["32"], augmented = phase_rom_augment(crt, rk, dev, card, kmods)
    print(f"phases 29-32 wall: {', '.join(f'{k}: {v:.1f} s' for k, v in secs.items())}; "
          f"together {sum(secs.values()):.1f} s", flush=True)
    return {"ecsw:loaded": loaded, "simulate:pallas:augmented": augmented}


# Phases 33-38: the parallel layer at world size 1 (one card). The SPIKE row
# is the JAX package's bench.py sharded_genalpha row (bench.py:652-760): the
# 1000-element linear beam, 4096 envs, float32, node layout, dt 1e-4,
# rho_inf 0.8, one Newton iteration; the span is cut from 2000 steps to
# SPIKE["steps"] (3 frames) and held to the single-device implicit gen-alpha
# over the same span. With --cards 4, phases 39-44 run the same paths on four
# cards (one rank a card, NCCL) and hold them to these world-size-1 results.
SPIKE = dict(envs=4096, frames=3, substeps=100, rho_inf=0.8, n_newton=1, time_steps=50,
             f64_envs=16, f64_steps=40)
# float32 spans of the same recurrence in another order of operations, q and
# v each by norm: the SPIKE thomas span against the single-device span (at
# world size 1) or the world-size-1 thomas span (on four cards), and the
# plain cr and dense local solvers against thomas. On the H100 they read
# 9.6e-5 / 2.7e-4 (thomas vs single device) and 6.0e-5 / 2.9e-4 (cr),
# 5.7e-5 / 3.1e-4 (dense) over 300 steps.
SPIKE_F32_MAX = 1e-3
# float64: the SPIKE spans (thomas through the btd_solve kernel, cr and
# dense plain) against the plain single-device implicit gen-alpha
# (linear_solver="cr"), x state scale.
SPIKE_F64_MAX = 1e-9
PAR_SMALL = dict(n_el=14, t_final=4e-4, dt=1e-4, rtol=1e-6, atol=1e-9)
PAR_ADAPTIVE_MAX = 1e-9  # adaptive methods, equal counts, x state scale (float64)
PAR_RK4_MAX = 1e-6  # RK4 through the CG mass solve (cg_tol 1e-8), the JAX test's bound
PAR_MODAL = dict(envs=64, frames=10, substeps=20)
PAR_MODAL_MAX = 1e-5  # float32, the sharded transforms' sums in another order
PAR_ROM_MAX = 1e-10  # float64 sharded ROM vs simulate, x state scale
PAR_BATCH = dict(envs=64, frames=10, substeps=20)
N_CARDS = 4  # --cards: sp = 4, dp x sp = 2 x 2 and dp = 4 need four
CARDS_TIMEOUT = 420.0  # s: the four ranks of phases 39-43 together


def lead() -> bool:
    """Whether this process prints a phase's line: rank 0 of an open
    world, or a process with none."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def say(line: str) -> None:
    if lead():
        print(line, flush=True)


def host_syncs(fn):
    """``(fn(), n)``: ``n`` the host synchronisations ``fn`` makes (reads
    of device values and blocking copies), counted by torch's CUDA
    sync-debug warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def memo_modal_engines():
    """While open, ``make_modal_genalpha`` (in ``simulate`` and in
    ``parallel/spatial_modal``) returns one engine per argument set: the
    1000-element eigensolve runs once for phase 36's six rollouts."""
    from continuum_robot_tpu_torch.models import simulate as sim_mod
    from continuum_robot_tpu_torch.parallel import spatial_modal as sm_mod

    real, memo = sim_mod.make_modal_genalpha, {}

    def cached(model, dt, **kw):
        key = (id(model), float(dt), tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in memo:
            memo[key] = real(model, dt, **kw)
        return memo[key]

    with replaced(sim_mod, "make_modal_genalpha", cached), \
            replaced(sm_mod, "make_modal_genalpha", cached):
        yield


def spike_inputs(model, beam, envs: int, dtype, dev):
    """bench.py's sharded row inputs: tip displacements ~ N(0, 1e-6) on every
    free DOF, tip force 0.1; reduced, node-layout and force tensors."""
    from continuum_robot_tpu_torch.parallel import facade, reduced_to_node_layout

    n = model.n_pos_states
    rng = np.random.default_rng(0)
    x_red = np.zeros((envs, 2 * n))
    x_red[:, :n] = rng.normal(scale=1e-6, size=(envs, n))
    u_red = np.zeros(n)
    u_red[-2] = 0.1
    x = torch.tensor(x_red, dtype=dtype, device=dev)
    if beam is None:
        return x, u_red
    xn = reduced_to_node_layout(model, x, beam.n_nodes)
    return x, u_red, xn, facade._node_force(model, u_red, beam.n_nodes, xn)


def mesh_shape(mesh) -> str:
    return " x ".join(f"{k}={v}" for k, v in zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def phase_spike(crt, kb, dev, card, mesh, label: str = "phase 34", ref_end=None) -> dict:
    """The SPIKE gen-alpha row: phase 34 at world size 1, phases 40 (sp = 4)
    and 41 (dp x sp = 2 x 2) on four cards. ``ref_end`` is the
    world-size-1 thomas span's reduced endpoint (None: this is that run,
    held to the single-device implicit gen-alpha). Returns this rank's
    readings: the thomas span's btd_solve launches, ms a step by local
    solver, the thomas span's busy share (NCCL kernels apart), its NCCL
    device ms a step and host synchronisations a step, its top device rows
    and its endpoint."""
    from continuum_robot_tpu_torch import parallel as tpar
    from continuum_robot_tpu_torch.parallel import facade, spatial_implicit as si

    t_phase = time.perf_counter()
    oracle_run = ref_end is None
    cfg = SPIKE
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
    beam = tpar.make_spatial_beam(model.beam_model.arrays,
                                  model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    h, sub, frames = DT, cfg["substeps"], cfg["frames"]
    steps = frames * sub
    kw = dict(rho_inf=cfg["rho_inf"], n_newton=cfg["n_newton"])
    rolls = {s: tpar.build_spatial_genalpha(beam, h, local_solver=s, **kw)
             for s in si.LOCAL_SOLVERS}
    x, u_red, xn, u_node = spike_inputs(model, beam, cfg["envs"], torch.float32, dev)
    prep_s = {}
    for s, roll in rolls.items():  # the SPIKE preparations (memoized per dtype)
        _, prep_s[s] = wall(lambda roll=roll: roll(xn, 1, u=u_node, substeps=1))
    (ts, xs), counts = counted(kb, lambda: rolls["thomas"](xn, frames, u=u_node,
                                                          substeps=sub))
    want = 1 + steps * cfg["n_newton"]
    ys = facade._node_frames_to_reduced(model, xs)
    end = ys[-1]
    against = "the world-size-1 thomas span"
    if oracle_run:
        against = "the single-device implicit gen-alpha (linear_solver='pallas')"
        ref_end = crt.simulate(model, x, steps * h, sub * h, method="generalized_alpha",
                               u=u_red, substeps=sub, linear_solver="pallas", device=dev,
                               dtype=torch.float32, **kw).ys[-1]
    n = model.n_pos_states
    parts = rel_parts((end[:, :n], end[:, n:]), (ref_end[:, :n], ref_end[:, n:]))
    others = {}
    for s in ("cr", "dense"):
        ys_s = facade._node_frames_to_reduced(
            model, rolls[s](xn, frames, u=u_node, substeps=sub)[1])
        others[s] = rel_parts((ys_s[-1, :, :n], ys_s[-1, :, n:]), (end[:, :n], end[:, n:]))
    del ys, xs
    finite = bool(torch.isfinite(end).all())
    say(f"{label} SPIKE gen-alpha [{card}]: {N_ELEMENTS} linear elements ({beam.n_nodes} "
        f"nodes, {mesh_shape(mesh)}), {cfg['envs']} envs float32, {steps} steps dt={h} "
        f"rho_inf={cfg['rho_inf']} n_newton={cfg['n_newton']}; preparations (host + card) "
        f"{', '.join(f'{k} {v:.2f} s' for k, v in prep_s.items())}; thomas vs {against}, "
        f"q and v by norm: {parts[0]:.3e}, {parts[1]:.3e} (limit {SPIKE_F32_MAX}); cr and "
        f"dense vs thomas: {others}; btd_solve launches {counts['btd_solve']} (expected "
        f"{want} a rank); finite {finite}")
    require(finite and max(parts) <= SPIKE_F32_MAX,
            f"{label} SPIKE f32 span vs {against}: {parts}")
    require(all(max(v) <= SPIKE_F32_MAX for v in others.values()),
            f"{label} SPIKE local solvers disagree: {others}")
    expect_launches(counts, ("btd_solve",), want, f"{label} SPIKE thomas span")

    # float64 at a small batch: each local solver's span against the plain
    # single-device implicit gen-alpha (block cyclic reduction, no kernel).
    cfg64 = cfg["f64_envs"], cfg["f64_steps"]
    x64, _, xn64, u64 = spike_inputs(model, beam, cfg64[0], torch.float64, dev)
    ref64 = crt.simulate(model, x64, cfg64[1] * h, cfg64[1] * h, method="generalized_alpha",
                         u=u_red, substeps=cfg64[1], linear_solver="cr", device=dev,
                         **kw).ys
    err64 = {}
    for s, roll in rolls.items():
        ys64 = facade._node_frames_to_reduced(model, roll(xn64, 1, u=u64,
                                                          substeps=cfg64[1])[1])
        err64[s] = scaled_err((ys64[..., :n], ys64[..., n:]), (ref64[..., :n], ref64[..., n:]))
    say(f"{label} SPIKE float64 [{card}]: {cfg64[0]} envs x {cfg64[1]} steps vs the "
        f"plain single-device span (linear_solver='cr'): max err / scale "
        f"{', '.join(f'{k} {v:.3e}' for k, v in err64.items())} (limit {SPIKE_F64_MAX})")
    require(max(err64.values()) <= SPIKE_F64_MAX,
            f"{label} SPIKE float64 vs single device {err64}")

    # ms a step of each local solver (CUDA events, best of 3 after a
    # warm-up); one profiled thomas span: device rows, NCCL's share apart.
    T = cfg["time_steps"]
    step_ms = {}
    for s, roll in rolls.items():
        fn = (lambda roll=roll: roll(xn, 1, u=u_node, substeps=T))
        fn()
        step_ms[s] = min(timed_once(fn, dev)[1] for _ in range(3)) / T
    fn = lambda: rolls["thomas"](xn, 1, u=u_node, substeps=T)  # noqa: E731
    rows = kernel_rows(fn, dev)
    nccl = sum(r[0] for r in rows if "nccl" in r[2].lower())
    busy = sum(r[0] for r in rows) - nccl
    wall_ms = step_ms["thomas"] * T
    _, syncs = host_syncs(fn)
    issue = dispatch_us(fn, dev, n=1) / 1e3 / T  # the host's issue of a step, no wait
    say(f"{label} SPIKE thomas span by kernel (rank 0) [{card}]: " + "; ".join(
        f"{k[:60]} {ms:.3f} ms x{c}" for ms, c, k in rows[:8]))
    best = min(step_ms, key=step_ms.get)
    say(f"{label} SPIKE timings (rank 0) [{card}]: ms a step ({cfg['envs']} envs, {T} steps, "
        f"float32): {', '.join(f'{k} {v:.4f}' for k, v in step_ms.items())}; fastest "
        f"{best}; default local_solver {si.resolve_local_solver(None)}; thomas span busy "
        f"(NCCL apart) {busy:.3f} of {wall_ms:.3f} ms ({busy / wall_ms:.3f}), NCCL kernels "
        f"{nccl / T:.4f} ms a step (waits included, under the profiler), host issue "
        f"{issue:.4f} ms a step, host syncs {syncs / T:.2f} a step; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if oracle_run:
        require(best == si.resolve_local_solver(None),
                f"the default local solver is not the fastest on the card: {step_ms}")
    return dict(launches=counts["btd_solve"], step_ms=step_ms, busy=busy / wall_ms,
                nccl_ms_step=nccl / T, syncs_step=syncs / T, issue_ms_step=issue,
                rows=[(round(ms / T, 5), c, k[:80]) for ms, c, k in rows[:6]], end=end)


def phase_parallel_small(crt, kb, dev, card, mesh, label: str = "phase 35",
                         ref=None) -> tuple:
    """simulate_sharded's adaptive gen-alpha, SDIRK3 and RK4 (CG) on the card,
    float64: phase 35 against simulate(), phase 43 against phase 35's
    results ``ref``. Returns (btd_solve launches by path, {method: result
    and counts, host syncs})."""
    from continuum_robot_tpu_torch import parallel as tpar

    cfg = PAR_SMALL
    model = golden_beam(crt, mixed_types(cfg["n_el"]))
    n = model.n_pos_states
    x0 = np.zeros(2 * n)
    x0[n - 2] = 2e-4
    u = np.zeros(n)
    u[n - 2] = 0.05
    launches, out = {}, {}
    for method, kw in (("generalized_alpha_adaptive", dict(rho_inf=0.9)), ("sdirk3", {}),
                       ("rk4", dict(substeps=2))):
        adaptive = method != "rk4"
        if adaptive:
            kw = dict(kw, rtol=cfg["rtol"], atol=cfg["atol"])
        args = (model, x0, cfg["t_final"], cfg["dt"])
        t0 = time.perf_counter()
        (res, syncs), counts = counted(kb, lambda: host_syncs(
            lambda: tpar.simulate_sharded(*args[:4], mesh, method=method, u=u, **kw)))
        secs = time.perf_counter() - t0
        got = dict(ys=res.ys, syncs=syncs)
        if adaptive:
            got.update(acc=int(res.stats.n_accepted), rej=int(res.stats.n_rejected))
        if ref is None:
            sim = crt.simulate(*args, method=method, u=u, device=dev, **kw)
            want = dict(ys=sim.ys)
            if adaptive:
                want.update(acc=int(sim.stats.n_accepted), rej=int(sim.stats.n_rejected))
            against = "simulate"
        else:
            want, against = ref[method], "world size 1"
        err = scaled_err((res.ys,), (want["ys"],))
        line = (f"{label} simulate_sharded {method} ({mesh_shape(mesh)}) [{card}]: vs "
                f"{against} max err / scale {err:.3e}")
        if adaptive:
            line += (f"; accepted {got['acc']}/{want['acc']}, rejected "
                     f"{got['rej']}/{want['rej']}")
            require((got["acc"], got["rej"]) == (want["acc"], want["rej"]),
                    f"{label} {method}: counts differ from {against}")
            launches[f"simulate_sharded:{method}"] = counts["btd_solve"]
            steps = got["acc"] + got["rej"]
        else:
            line += f"; CG cap hits {int(res.stats['cg_incomplete'])}"
            steps = int(round(cfg["t_final"] / cfg["dt"])) * kw["substeps"]
        say(line + f"; btd_solve launches {counts['btd_solve']}; host syncs {syncs} over "
            f"{steps} {'trials' if adaptive else 'RK4 steps'} (set-up included); {secs:.2f} s")
        require(err <= (PAR_ADAPTIVE_MAX if adaptive else PAR_RK4_MAX),
                f"{label} simulate_sharded {method} vs {against} {err:.3e}")
        require(not adaptive or counts["btd_solve"] > 0,
                f"{method}: the SPIKE thomas solves launched no btd_solve kernel")
        out[method] = got
    return launches, out


def phase_parallel_modal(crt, kr, dev, card, mesh, label: str = "phase 36",
                         ref=None) -> tuple:
    """The sharded modal engines on the 1000-element beam: phase 36 against
    simulate(method="modal"), phase 43 against phase 36's results ``ref``;
    returns ({kernel: launches} of the kernel engines, {engine: frames})."""
    from continuum_robot_tpu_torch import parallel as tpar

    cfg = PAR_MODAL
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
    n = model.n_pos_states
    rng = np.random.default_rng(36)
    x0 = torch.zeros((cfg["envs"], 2 * n), dtype=torch.float32, device=dev)
    x0[:, :n] = torch.tensor(rng.normal(scale=1e-6, size=(cfg["envs"], n)), device=dev)
    u = np.zeros(n)
    u[-2] = 0.1
    dt_f = DT * cfg["substeps"]
    kw = dict(method="modal", u=u, substeps=cfg["substeps"], rho_inf=RHO_INF)
    launches, out = {}, {}
    with memo_modal_engines():
        for engine, kernel in (("xla", None), ("pallas", "modal_frames"),
                               ("power", "affine_frames")):
            (res, secs), counts = counted(kr, lambda: wall(lambda: tpar.simulate_sharded(
                model, x0, cfg["frames"] * dt_f, dt_f, mesh, engine=engine, **kw)))
            if ref is None:
                want = crt.simulate(model, x0, cfg["frames"] * dt_f, dt_f, engine=engine,
                                    device=dev, **kw).ys.movedim(1, 0)
                against = "simulate"
            else:
                want, against = ref[engine], "world size 1"
            err = scaled_err((res.ys,), (want,))
            say(f"{label} simulate_sharded modal engine={engine} ({mesh_shape(mesh)}) "
                f"[{card}]: {N_ELEMENTS} elements, {cfg['envs']} envs float32, "
                f"{cfg['frames']} frames x {cfg['substeps']}: vs {against} max err / scale "
                f"{err:.3e} (limit {PAR_MODAL_MAX}); launches {counts}; {secs:.2f} s (the "
                f"first: the host eigensolve)")
            require(err <= PAR_MODAL_MAX and bool(torch.isfinite(res.ys).all()),
                    f"{label} sharded modal {engine} vs {against} {err:.3e}")
            if kernel is None:
                require(not any(counts.values()), f"sharded modal xla: launches {counts}")
            else:
                expect_launches(counts, (kernel,), 1, f"{label} simulate_sharded modal {engine}")
                launches[kernel] = counts[kernel]
            out[engine] = res.ys
    return launches, out


def phase_parallel_rom(crt, dev, card, mesh, label: str = "phase 37", ref=None) -> dict:
    """The sharded ROM, fixed-step, adaptive, forced and guarded, on the card
    (float64): phase 37 against simulate() and the single-device engine,
    phase 43 against phase 37's results ``ref``; returns {key: result}."""
    from continuum_robot_tpu_torch import parallel as tpar

    cfg = PAR_SMALL
    fp = dict(enable_gravity_effects=True, gravity_vector=[0.0, -9.81, 0.0],
              enable_fluid_effects=True, fluid_density=1000.0)
    types = mixed_types(cfg["n_el"])
    out = {}
    for name, model in (("plain", golden_beam(crt, types)),
                        ("forced", golden_beam(crt, types, fp))):
        n = model.n_pos_states
        x0 = np.zeros((3, 2 * n))
        x0[:, n - 2] = [1e-4, 2e-4, -1e-4]
        u = np.zeros(n)
        u[n - 2] = 0.05
        for method, kw in (("modal_rom", dict(substeps=4, n_newton=2)),
                           ("modal_rom_adaptive", dict(rtol=cfg["rtol"], atol=1e-12))):
            xs = x0 if method == "modal_rom" else x0[0]
            res, secs = wall(lambda: tpar.simulate_sharded(model, xs, cfg["t_final"], cfg["dt"],
                                                           mesh, method=method, u=u, **kw))
            got = dict(ys=res.ys)
            if res.stats is not None:
                got.update(acc=int(res.stats.n_accepted), rej=int(res.stats.n_rejected))
            if ref is None:
                sim = crt.simulate(model, xs, cfg["t_final"], cfg["dt"], method=method, u=u,
                                   device=dev, **kw)
                want = dict(ys=sim.ys.movedim(1, 0) if sim.ys.dim() == 3 else sim.ys)
                if sim.stats is not None:
                    want.update(acc=int(sim.stats.n_accepted), rej=int(sim.stats.n_rejected))
                against = "simulate"
            else:
                want, against = ref[f"{name}:{method}"], "world size 1"
            err = scaled_err((res.ys,), (want["ys"],))
            line = (f"{label} sharded ROM {name} {method} ({mesh_shape(mesh)}) [{card}]: vs "
                    f"{against} max err / scale {err:.3e} (limit {PAR_ROM_MAX}); {secs:.2f} s")
            if "acc" in got:
                line += f"; accepted {got['acc']}/{want['acc']}"
                require((got["acc"], got["rej"]) == (want["acc"], want["rej"]),
                        f"{label} sharded {method}: counts differ from {against}")
            say(line)
            require(err <= PAR_ROM_MAX, f"{label} sharded ROM {name} {method} {err:.3e}")
            out[f"{name}:{method}"] = got

    # ECSW guard: the sharded audit against the single-device one.
    model = golden_beam(crt, ["nonlinear"] * 22)
    eng = tpar.build_spatial_modal_rom(model, mesh, DT, rho_inf=0.5, n_modes=16)
    n = model.n_pos_states
    u = np.zeros(n)
    u[-2] = 3.0
    u_m = eng.ms.project_force_host(u)
    z = torch.zeros((1, 16), dtype=torch.float64, device=dev)
    snaps = eng.ms.rollout_frames(z, z, u_m, 20, substeps=10, n_newton=2)[1][::2, 0]
    red = eng.hyper_reduce(snaps.cpu().numpy(), tau=1e-3)
    e0, z1 = snaps[-1], torch.zeros(16, dtype=torch.float64, device=dev)
    g = red.rollout_frames_guarded(e0, z1, u_m, 4, substeps=5)
    g1 = red.ms.rollout_frames_guarded(e0, z1, u_m, 4, substeps=5)
    err = scaled_err((g[1],), (g1[1],))
    res_err = abs(float(g[3]["max_residual"]) - float(g1[3]["max_residual"])) / float(
        g1[3]["max_residual"])
    say(f"{label} sharded ECSW guard ({mesh_shape(mesh)}) [{card}]: "
        f"{red.ms.sampled_params['sel'].size} sampled of 22; guarded frames vs single "
        f"device {err:.3e}, max residual {float(g[3]['max_residual']):.3e} (rel diff "
        f"{res_err:.3e}), flagged {bool(g[3]['flagged'])}")
    require(err <= PAR_ROM_MAX and res_err <= 1e-8 and not bool(g[3]["flagged"]),
            f"{label} sharded ECSW guard: {err:.3e}, {res_err:.3e}")
    return out


def mixed_types(n: int) -> list:
    """Half linear, half von Karman elements (the tests' hybrid beam)."""
    return ["linear"] * (n // 2) + ["nonlinear"] * (n - n // 2)


def phase_parallel_batched(crt, kb, dev, card, mesh) -> dict:
    """Phase 38: batched_rollout(mesh=) against the one-device call, and
    dryrun_multichip(1) on the card; returns btd_solve launches of the mesh
    rollout."""
    from continuum_robot_tpu_torch import parallel as tpar

    cfg = PAR_BATCH
    model = golden_beam(crt, ["linear"] * 6)
    n = model.n_pos_states
    x0 = torch.zeros((cfg["envs"], 2 * n), dtype=torch.float64, device=dev)
    x0[:, n - 2] = torch.linspace(1e-4, 2e-3, cfg["envs"], dtype=torch.float64)
    dt_f = 1e-4 * cfg["substeps"]
    kw = dict(method="generalized_alpha", substeps=cfg["substeps"], linear_solver="pallas")
    res, counts = counted(kb, lambda: tpar.batched_rollout(
        model, x0, cfg["frames"] * dt_f, dt_f, mesh=mesh, **kw))
    ref = tpar.batched_rollout(model, x0, cfg["frames"] * dt_f, dt_f, **kw)
    full = res.ys.full_tensor()
    st, st1 = tpar.sweep_statistics(res.ys), tpar.sweep_statistics(ref.ys)
    same = bool(torch.equal(full, ref.ys)) and all(
        float(st[k]) == float(st1[k]) for k in st)
    print(f"phase 38 batched_rollout(mesh=) [{card}]: {cfg['envs']} envs, placements "
          f"{res.ys.placements}, bit for bit the one-device rollout and its statistics: "
          f"{same}; btd_solve launches {counts['btd_solve']}", flush=True)
    require(same, "batched_rollout(mesh=) differs from the one-device rollout")
    t0 = time.perf_counter()
    summary = tpar.dryrun_multichip(1, timeout=240.0)
    print(f"phase 38 dryrun_multichip(1) (one NCCL rank on the card, launched) [{card}]: "
          f"{summary}; {time.perf_counter() - t0:.1f} s", flush=True)
    return {"batched_rollout:mesh": counts["btd_solve"]}


def parallel_paths(crt, kb, kr, dev, card) -> tuple:
    """Phases 33-38; returns (btd_solve launches by path, modal kernels'
    launches, SPIKE ms a step by local solver, the world-size-1 results
    that phases 40-43 are held to, on the host)."""
    import torch.distributed as dist

    from continuum_robot_tpu_torch import parallel as tpar

    t0 = time.perf_counter()
    backend = tpar.init_process_group(dev)
    try:
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version()) if dev.type == "cuda" else "-"
        mesh = tpar.make_mesh({"dp": 1, "sp": 1}, device=dev)
        print(f"phase 33 process group: backend {backend}, NCCL {nccl}, world "
              f"{dist.get_world_size()}, FileStore, mesh {tuple(mesh.mesh_dim_names)} "
              f"{tuple(mesh.mesh.shape)}", flush=True)
        require(backend == ("nccl" if dev.type == "cuda" else "gloo"), f"backend {backend}")
        spike = phase_spike(crt, kb, dev, card, mesh)
        btd = {"spike:thomas": spike["launches"]}
        small_btd, small = phase_parallel_small(crt, kb, dev, card, mesh)
        btd.update(small_btd)
        modal, modal_ys = phase_parallel_modal(crt, kr, dev, card, mesh)
        rom = phase_parallel_rom(crt, dev, card, mesh)
        btd.update(phase_parallel_batched(crt, kb, dev, card, mesh))
    finally:
        tpar.destroy_process_group()
    print(f"phases 33-38: {time.perf_counter() - t0:.1f} s", flush=True)
    oracle = dict(spike=spike["end"], small=small, modal=modal_ys, rom=rom)
    return btd, modal, spike["step_ms"], _host(oracle)


def _host(obj):
    """Tensors to the CPU, through dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# Phases 39-44 (--cards 4): the parallel layer on four cards
# ---------------------------------------------------------------------------


def gathered(reading) -> list:
    """Every rank's ``reading`` (a small picklable value), in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, reading)
    return out


def phase_runtime(dev, card) -> dict:
    """Phase 39: NCCL's version and the world; ``ppermute`` along
    ``right_perm`` and ``left_perm``, ``psum`` and ``all_gather`` on a 1-D
    ``sp`` mesh of every rank and on both axes of a ``dp x sp`` mesh, each
    equal to the same permutation or sum computed by hand (exact: integer
    values in float32 and float64); returns the meshes."""
    import torch.distributed as dist

    from continuum_robot_tpu_torch import parallel as tpar
    from continuum_robot_tpu_torch.parallel import collectives as col

    rank, world = dist.get_rank(), dist.get_world_size()

    def payload(r, dtype):
        return (1000.0 * r + torch.arange(12.0, dtype=torch.float64)).reshape(4, 3).to(dtype)

    meshes, checks = {}, []
    for sizes in ({"sp": world}, {"dp": 2, "sp": world // 2}, {"dp": world}):
        mesh = tpar.make_mesh(sizes, device=dev)
        meshes[tuple(sizes)] = mesh
        if tuple(sizes) == ("dp",):
            continue  # phase 42's mesh: its collectives are the sp mesh's
        for name in mesh.mesh_dim_names:
            ax = col.MeshAxis(mesh, name)
            S, k, R = ax.size, ax.index, ax.ranks
            for dtype in (torch.float32, torch.float64):
                x = payload(rank, dtype).to(dev)
                got = {"right_perm": col.ppermute(x, ax, col.right_perm(S)),
                       "left_perm": col.ppermute(x, ax, col.left_perm(S)),
                       "psum": col.psum(x, ax), "all_gather": col.all_gather(x, ax)}
                want = {"right_perm": payload(R[(k - 1) % S], dtype),
                        "left_perm": payload(R[(k + 1) % S], dtype),
                        "psum": sum(payload(r, dtype) for r in R),
                        "all_gather": torch.stack([payload(r, dtype) for r in R])}
                for key in got:
                    require(torch.equal(got[key].cpu(), want[key]),
                            f"phase 39 rank {rank}: {key} on {name} of {sizes} ({dtype})")
                    checks.append(f"{name}{S}:{key}")
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    counts = gathered(len(checks))
    # The SPIKE step's messages alone, the ranks in step: a 48 KB float32
    # halo (4096 envs x 1 node x 3) by ppermute, and the 6 interface values
    # a shard of 4096 envs by all_gather, on the sp axis of 4 (CUDA events,
    # 100 calls back to back after a warm-up).
    ax = col.MeshAxis(meshes[("sp",)], "sp")
    halo = torch.ones((SPIKE["envs"], 1, 3), dtype=torch.float32, device=dev)
    iface = torch.ones((SPIKE["envs"], 2, 3), dtype=torch.float32, device=dev)
    msg_ms = {}
    for key, fn in (("ppermute", lambda: col.ppermute(halo, ax, col.right_perm(ax.size))),
                    ("all_gather", lambda: col.all_gather(iface, ax))):
        fn()
        dist.barrier()
        msg_ms[key] = timed_once(lambda fn=fn: [fn() for _ in range(100)], dev)[1] / 100
    say(f"phase 39 runtime [{card}]: backend {dist.get_backend()}, NCCL {nccl}, world "
        f"{world}, meshes {[mesh_shape(m) for m in meshes.values()]}; ppermute (right_perm, "
        f"left_perm), psum and all_gather in position order on sp of {world} and on dp and sp "
        f"of 2 x {world // 2}, float32 and float64, each equal to the permutation computed "
        f"by hand: {counts} checks by rank, all exact; the step's messages alone (rank 0): "
        f"ppermute of a 48 KB halo {msg_ms['ppermute']:.4f} ms, all_gather of the interface "
        f"values {msg_ms['all_gather']:.4f} ms a call")
    return meshes


def phase_batched_cards(crt, kb, dev, card, mesh) -> dict:
    """Phase 42: ``batched_rollout(mesh=)`` at dp = 4 over the SPIKE row's
    batch (the 1000-element linear beam, 4096 envs float32, 300 steps of
    generalized-alpha, ``linear_solver="pallas"``): this rank's block
    against the one-card ``batched_rollout`` of the whole batch on this
    card, bit for bit; env-steps/s of each (the whole entry call, set-up
    included, best of 2 after a warm-up)."""
    from continuum_robot_tpu_torch import parallel as tpar
    from continuum_robot_tpu_torch.parallel.collectives import MeshAxis, env_chunk

    cfg = SPIKE
    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
    x, u_red = spike_inputs(model, None, cfg["envs"], torch.float32, dev)
    h, sub, frames = DT, cfg["substeps"], cfg["frames"]
    kw = dict(method="generalized_alpha", u=u_red, substeps=sub, linear_solver="pallas",
              rho_inf=cfg["rho_inf"], n_newton=cfg["n_newton"])
    args = (model, x, frames * sub * h, sub * h)
    one = lambda: tpar.batched_rollout(*args, **kw)  # noqa: E731
    four = lambda: tpar.batched_rollout(*args, mesh=mesh, **kw)  # noqa: E731
    ref, counts1 = counted(kb, one)
    res, counts = counted(kb, four)
    local = res.ys.to_local()
    ax = MeshAxis(mesh, "dp")
    lo = ax.index * env_chunk(cfg["envs"], ax)
    rows = ref.ys[:, lo:lo + local.shape[1]]
    same = bool(torch.equal(local, rows))
    err = 0.0 if same else rel(local, rows)
    ms_one = min(timed_once(one, dev)[1] for _ in range(2))
    ms_four = min(timed_once(four, dev)[1] for _ in range(2))
    # The rollout alone, its set-up built once: the whole batch on this
    # card, then this card's block.
    rollout = tpar.build_rollout_fn(*args[:1], *args[2:], device=dev, dtype=x.dtype, **kw)
    span = {}
    for key, xb in (("one", x), ("four", x[lo:lo + local.shape[1]])):
        rollout(xb)
        span[key] = min(timed_once(lambda xb=xb: rollout(xb), dev)[1] for _ in range(2))
    return dict(same=same, err=err, launches=counts["btd_solve"],
                launches_one=counts1["btd_solve"], ms_one=ms_one, ms_four=ms_four,
                span_one=span["one"], span_four=span["four"],
                local=tuple(local.shape), placements=str(res.ys.placements),
                env_steps=cfg["envs"] * frames * sub)


def cards_rank(oracle_path: str, sp1_ms: dict, t_launch: float) -> dict:
    """Phases 39-43 on one rank of a world of four, one a card over NCCL
    (launched by name from ``cards_paths``). ``oracle_path``: the
    world-size-1 results of phases 34-37 (``torch.save``); ``sp1_ms``:
    phase 34's ms a step by local solver; ``t_launch``: the launcher's
    ``time.time()`` at the start. Returns this rank's readings."""
    started = time.time() - t_launch  # the fork, imports and NCCL's set-up
    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as kr
    from continuum_robot_tpu_torch.parallel.collectives import world_device

    dev = world_device()
    card = card_line()
    oracle = torch.load(oracle_path, map_location=dev)
    out, secs = {"started_s": started}, {}
    t = time.perf_counter()
    meshes = phase_runtime(dev, card)
    secs["39"] = time.perf_counter() - t
    for ph, key in (("40", ("sp",)), ("41", ("dp", "sp"))):
        t = time.perf_counter()
        r = phase_spike(crt, kb, dev, card, meshes[key], f"phase {ph}", oracle["spike"])
        r.pop("end")
        every = gathered({k: r[k] for k in ("launches", "busy", "nccl_ms_step", "syncs_step",
                                            "issue_ms_step", "step_ms")})
        say(f"phase {ph} by rank [{card}]: btd_solve launches "
            f"{[e['launches'] for e in every]}, thomas busy share (NCCL apart) "
            f"{[round(e['busy'], 3) for e in every]}, NCCL kernels ms a step "
            f"{[round(e['nccl_ms_step'], 4) for e in every]}, host issue ms a step "
            f"{[round(e['issue_ms_step'], 4) for e in every]}, host syncs a step "
            f"{[e['syncs_step'] for e in every]}; ms a step sp=1 (phase 34, this run) "
            f"{ {k: round(v, 4) for k, v in sp1_ms.items()} } vs "
            f"{mesh_shape(meshes[key])} (rank 0) "
            f"{ {k: round(v, 4) for k, v in r['step_ms'].items()} }")
        out[ph], secs[ph] = r, time.perf_counter() - t
    t = time.perf_counter()
    r = phase_batched_cards(crt, kb, dev, card, meshes[("dp",)])
    every = gathered(r)
    slowest = max(e["ms_four"] for e in every)
    rate1 = r["env_steps"] / (r["ms_one"] / 1e3)
    rate4 = r["env_steps"] / (slowest / 1e3)
    span4 = max(e["span_four"] for e in every)
    steady1 = r["env_steps"] / (r["span_one"] / 1e3)
    steady4 = r["env_steps"] / (span4 / 1e3)
    say(f"phase 42 batched_rollout(mesh=) dp=4 [{card}]: {N_ELEMENTS} linear elements, "
        f"{SPIKE['envs']} envs float32 ({every[0]['local'][1]} a card), "
        f"{SPIKE['frames'] * SPIKE['substeps']} steps generalized_alpha "
        f"linear_solver='pallas', placements {r['placements']}; each block bit for bit the "
        f"one-card rollout's rows: {[e['same'] for e in every]} (max rel err "
        f"{max(e['err'] for e in every):.3e}); btd_solve launches by rank "
        f"{[e['launches'] for e in every]} (one card {r['launches_one']}); whole call "
        f"(set-up included) one card {r['ms_one']:.1f} ms (rank 0), four cards "
        f"{slowest:.1f} ms (slowest rank): {rate1:.4g} vs {rate4:.4g} env-steps/s "
        f"({rate4 / rate1:.3f}x); the rollout alone (set-up built once) {r['span_one']:.1f} "
        f"vs {span4:.1f} ms: {steady1:.4g} vs {steady4:.4g} env-steps/s "
        f"({steady4 / steady1:.3f}x)")
    require(all(e["same"] for e in every), f"phase 42: dp=4 differs from one card: "
            f"{[e['err'] for e in every]}")
    out["42"], secs["42"] = (dict(r, rate_one=rate1, rate_four=rate4, steady_one=steady1,
                                  steady_four=steady4), time.perf_counter() - t)
    t = time.perf_counter()
    sp4 = meshes[("sp",)]
    small_btd, _ = phase_parallel_small(crt, kb, dev, card, sp4, "phase 43", oracle["small"])
    modal, _ = phase_parallel_modal(crt, kr, dev, card, sp4, "phase 43", oracle["modal"])
    phase_parallel_rom(crt, dev, card, sp4, "phase 43", oracle["rom"])
    every = gathered((small_btd, modal))
    say(f"phase 43 launches by rank [{card}]: btd_solve {[e[0] for e in every]}, modal "
        f"kernels {[e[1] for e in every]}")
    out["43"], secs["43"] = dict(btd=small_btd, modal=modal), time.perf_counter() - t
    t = time.perf_counter()
    grads = spike_gradients(crt, dev, sp4)
    ref = oracle["spike_grads"]
    errs = {k: abs(grads[k]["g"] - float(ref[k]["g"])) / abs(float(ref[k]["g"]))
            for k in grads}
    every = gathered(errs)
    say(f"phase 49 SPIKE arrays= gradients at sp = 4 (NCCL) [{card}]: float64, "
        f"{N_ELEMENTS} linear elements, {SPIKE_GRAD['frames']} frames x "
        f"{SPIKE_GRAD['substeps']} substeps; d(1e3 q_tip)/d(scale) "
        f"{ {k: f'{v["g"]:.12e}' for k, v in grads.items()} } vs world size 1 "
        f"{ {k: f'{float(v["g"]):.12e}' for k, v in ref.items()} }: relative error by rank "
        f"{every} (limit {SPIKE_GRAD['cards_max']})")
    require(all(max(e.values()) <= SPIKE_GRAD["cards_max"] for e in every),
            f"phase 49 sp = 4 gradients differ from world size 1: {every}")
    out["49"], secs["49"] = errs, time.perf_counter() - t
    say(f"phases 39-43 wall by phase (rank 0): "
        f"{', '.join(f'{k}: {v:.1f} s' for k, v in secs.items())}")
    return out


def cards_paths(crt, kb, kr, dev, card, n_cards: int) -> dict:
    """``--cards 4``: phases 33-38 at world size 1 (the oracle), phases
    39-43 on ``n_cards`` ranks, one a card, and phase 44, the dry run on
    them; returns the launches by path."""
    import importlib
    import shutil
    import tempfile

    from continuum_robot_tpu_torch import parallel as tpar

    btd, modal, step_ms, oracle = parallel_paths(crt, kb, kr, dev, card)
    tpar.init_process_group(dev)
    try:  # phase 49's oracle: the float64 SPIKE gradients at world size 1
        oracle["spike_grads"] = spike_gradients(crt, dev, tpar.make_mesh({"sp": 1}, device=dev))
    finally:
        tpar.destroy_process_group()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_cards_")
    try:
        path = f"{tmp}/oracle.pt"
        torch.save(oracle, path)
        # The ranks import the rank body by name: this file as the module
        # chip_smoke (run as a script it is __main__, which they cannot).
        this = importlib.import_module("chip_smoke")
        t0 = time.perf_counter()
        world = tpar.launch(this.cards_rank, n_cards, path, step_ms, time.time(),
                            timeout=CARDS_TIMEOUT)
        print(f"phases 39-43: a world of {n_cards} NCCL ranks, one a card, started in "
              f"{max(r['started_s'] for r in world):.1f} s (the last rank in its body), "
              f"run in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    summary = tpar.dryrun_multichip(n_cards, timeout=240.0)
    print(f"phase 44 dryrun_multichip({n_cards}) on {n_cards} cards (NCCL) [{card}]: "
          f"{summary}; {time.perf_counter() - t0:.1f} s", flush=True)
    require((summary["dp"], summary["sp"]) == (2, 2), f"phase 44 mesh {summary}")
    return {"btd_solve": {**btd, **{f"{k}:cards": [r[k]["launches"] for r in world]
                                    for k in ("40", "41", "42")},
                          "43:cards": [r["43"]["btd"] for r in world]},
            "modal": {**modal, "43:cards": [r["43"]["modal"] for r in world]}}


# ---------------------------------------------------------------------------
# Phases 45-48: the differentiable-parameter path (--sweep runs them alone)
# ---------------------------------------------------------------------------

# Phase 45: the adjoint kernel at the implicit main path's system (1001
# nodes) and 4096 right-hand sides; the Function's derivatives at a small
# size, float64, against autograd and forward AD of the plain sweep.
ADJOINT = dict(small_nodes=13, small_envs=5, function_max=1e-12)
# The adjoint record's numbers that --sweep and --adjoint print.
ADJOINT_KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_f64", "whole_device_ms",
                "factor_sums_ms", "plain_ms", "library_ms", "bound")
# Phase 46: the SPIKE row's 1000-element beam at sp = 1, traced arrays=:
# the JAX test's span (2 frames x 4 substeps, dt 1e-4, rho_inf 0.8, one
# Newton iteration), its central-difference step and bound; the float32
# forward and backward at 4096 envs (halved past 70 GB of the card).
SPIKE_GRAD = dict(frames=2, substeps=4, h=1e-5, fd_rtol=2e-5, f64_envs=16, baked_max=1e-14,
                  f32_baked_max=1e-5, envs=4096, mem_limit_gb=70.0, cards_max=1e-9)
# Phase 47: the ROM main path's engine, frozen bases, 50 steps, 2 Newton
# iterations for the float64 gradient (the JAX test's rtol 1e-6 against
# central differences, remat equal to plain at rtol 1e-10); float32 forward
# and backward with remat at the largest of the batches that fits.
ROM_GRAD = dict(steps=50, n_newton=2, h=1e-5, fd_rtol=1e-6, remat_rtol=1e-10, tip=0.1,
                batches=(4096, 1024, 256), f32_steps=50)
# Phase 48: examples/system_identification.py's beam (4 linear segments,
# DT 2e-4, 20 substeps, a 0.1 N tip impulse for 2 ms) over the impulse's 2
# ms (the example's T is 0.02 s: 100 frames, whose RK4 gradient alone takes
# about 140 s of host issue on the card's machine) and tests/test_sweep.py's
# beams (6 and 5 linear segments; remat on the latter, 100 steps); the
# adaptive check over one 1 ms frame (the test's horizon is 5 ms: about
# 1900 trials).
DENSE_GRAD = dict(segments=4, t_final=0.002, dt=2e-4, substeps=20, impulse=0.1, t_imp=0.002,
                  h_rel=1e-5, rk4_rtol=2e-3, ga_rtol=1e-5, remat_rtol=1e-10,
                  adaptive_t=1e-3, adaptive_rtol=1e-6)


def _btd_adjoint_inputs(factors, envs, dtype, dev, rng):
    """The factors on the card, random right-hand sides and cotangents."""
    n = factors[0].shape[0]
    f = tuple(torch.tensor(np.asarray(x), dtype=dtype, device=dev) for x in factors)
    b = torch.tensor(rng.normal(size=(envs, n, 3)), dtype=dtype, device=dev)
    g = torch.tensor(rng.normal(size=(envs, n, 3)), dtype=dtype, device=dev)
    return f, b, g


def _adjoint_cases(kb, f, b, g):
    """The adjoint kernel against its plain sweeps on one system and batch:
    ``b`` and ``g`` unpadded (both copied into padded rows), both in padded
    rows (read in place), and one ``g`` row expanded over the batch (pitch
    0). Returns ``{layout: max|kernel - plain|}``."""
    from continuum_robot_tpu_torch.ops import banded

    packed = kb.pack_factors(f).packed()
    shared = g[0].expand(g.shape)
    ref, ref_shared = (banded.btd_adjoint_sweeps(f, b, x) for x in (g, shared))
    out = {}
    for layout, bb, gg, want in (
            ("unpadded", b, g, ref), ("padded", padded_rows(b, kb), padded_rows(g, kb), ref),
            ("shared g", padded_rows(b, kb), shared, ref_shared)):
        kb.reset_launch_counts()
        got = kb._launch_adjoint(packed, bb, gg)
        require(kb.btd_solve_adjoint.launches == 1, "btd_solve_adjoint did not launch")
        require(finite(*got), f"btd_solve_adjoint: non-finite ({layout}, {tuple(b.shape)})")
        out[layout] = max_abs(got, want)
    return out


def phase_btd_adjoint(kb, lin_model, dev, card) -> dict:
    """Phase 45: ``btd_solve_adjoint`` against its plain version, bit for
    bit, at the main path's system and at the chunk's ragged sizes, and the
    Function's derivatives; the kernel's timings beside its bound, the whole
    backward's and the library call's. Returns its record."""
    import torch.autograd.forward_ad as fwAD

    from continuum_robot_tpu_torch.ops import banded
    from continuum_robot_tpu_torch.utils import cuda_event_times

    t_phase = time.perf_counter()
    rng = np.random.default_rng(45)
    a, c = gen_alpha_system(IMPLICIT["rho_lin"])
    full = btd_host_factors(lin_model, a, c)
    n = full[0].shape[0]
    err, parts = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        # The chunk's ragged edges, and one node past the resident chunks
        # (chunk 0 loads its s back).
        chunk, slots = kb.adjoint_geometry(dtype)
        worst = 0.0
        for nr in (chunk - 1, chunk, chunk + 1, slots * chunk + 1):
            fac = random_btd_factors(nr, rng)
            for envs in (1, 33):
                cases = _adjoint_cases(kb, *_btd_adjoint_inputs(fac, envs, dtype, dev, rng))
                worst = max(worst, *cases.values())
        f, b, g = _btd_adjoint_inputs(full, N_ENVS, dtype, dev, rng)
        main = {}
        for envs in (1, 33, N_ENVS):
            main[envs] = max(_adjoint_cases(kb, f, b[:envs], g[:envs]).values())
        packed = kb.pack_factors(f)
        x = kb.btd_solve(packed, b)
        whole = kb.btd_solve_adjoint(packed, b, x, g)
        e_whole = max_abs(whole, banded.btd_solve_adjoint(f, b, x, g))
        require(finite(*whole), f"btd_solve_adjoint: non-finite ({dtype})")
        parts[name] = dict(main=main, whole=e_whole, edges=worst)
        err = max(err, worst, e_whole, *main.values())
    # The Function at a small float64 size: vjp and jvp against autograd and
    # forward AD of the plain sweep.
    small = random_btd_factors(ADJOINT["small_nodes"], rng)
    f, b, g = _btd_adjoint_inputs(small, ADJOINT["small_envs"], torch.float64, dev, rng)
    f = tuple(t.requires_grad_() for t in f)
    b.requires_grad_()
    kb.reset_launch_counts()
    got = torch.autograd.grad(kb.btd_solve(f, b), (*f, b), g)
    fn_launches = (kb.btd_solve.launches, kb.btd_solve_adjoint.launches)
    want = torch.autograd.grad(banded.btd_solve(f, b), (*f, b), g)
    vjp_err = max(scaled_err(x, y) for x, y in zip(got, want))
    tangents = [torch.randn_like(t) for t in (*f, b)]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t.detach(), d) for t, d in zip((*f, b), tangents)]
        jvp_ref = fwAD.unpack_dual(banded.btd_solve(tuple(duals[:3]), duals[3])).tangent
        jvp_out = fwAD.unpack_dual(kb.btd_solve(tuple(duals[:3]), duals[3])).tangent
    jvp_err = scaled_err(jvp_out, jvp_ref)
    say(f"phase 45 btd_solve_adjoint vs plain [{card}]: {n} nodes x B in (1, 33, {N_ENVS}) "
        f"and the ragged chunk edges (chunk, slots {kb.adjoint_geometry(torch.float32)} float32, "
        f"{kb.adjoint_geometry(torch.float64)} float64; N = C-1, C, C+1, slots x C + 1; B in "
        f"1, 33), g unpadded, padded and shared (pitch 0): max|kernel-plain| (sweeps y, s, "
        f"b_bar; whole adjoint with the factor sums at {N_ENVS}) {parts}; the Function on "
        f"{ADJOINT['small_envs']} x {ADJOINT['small_nodes']} float64: vjp vs autograd of the "
        f"plain sweep {vjp_err:.3e}, jvp vs forward AD {jvp_err:.3e} (limit "
        f"{ADJOINT['function_max']}), launches (btd_solve, adjoint) {fn_launches}")
    require(err == 0.0, f"btd_solve_adjoint: kernel and plain version differ: {parts}")
    require(max(vjp_err, jvp_err) <= ADJOINT["function_max"],
            f"btd_solve Function derivatives: vjp {vjp_err:.3e}, jvp {jvp_err:.3e}")
    require(fn_launches == (1, 1), f"btd_solve Function launches {fn_launches}")

    # Timings at the main path's size, b and g in padded rows as the implicit
    # operator and its solve hand them over (no copy in the wrapper).
    def best(fn):
        return min(cuda_event_times(fn, repeats=3, warmup=1, device=dev))

    times = {}
    for dtype in (torch.float32, torch.float64):
        f, b, g = _btd_adjoint_inputs(full, N_ENVS, dtype, dev, rng)
        b, g = padded_rows(b, kb), padded_rows(g, kb)
        packed = kb.pack_factors(f)
        fp = packed.packed()
        times[dtype] = dict(dev=queued_device_ms(lambda: kb._launch_adjoint(fp, b, g), dev))
        if dtype != torch.float32:
            continue
        times[dtype]["lone"] = best(lambda: kb._launch_adjoint(fp, b, g))
        x = kb.btd_solve(packed, b)
        y, s, bbar = kb._launch_adjoint(fp, b, g)
        times[dtype]["whole"] = queued_device_ms(
            lambda: kb.btd_solve_adjoint(packed, b, x, g), dev)
        times[dtype]["sums"] = queued_device_ms(
            lambda: banded.btd_adjoint_factors(f, x, g, y, s, bbar), dev)
        _, times[dtype]["plain"] = timed_once(lambda: banded.btd_adjoint_sweeps(f, b, g), dev)
        inv = dense_system_inverse(lin_model, a, c, dev)
        g_red = g.reshape(N_ENVS, -1)[:, 3:].contiguous()
        lib_rel = rel(bbar.reshape(N_ENVS, -1)[:, 3:], g_red @ inv)
        times[dtype]["library"] = best(lambda: g_red @ inv)
    t32, t64 = times[torch.float32], times[torch.float64]
    ops = N_ENVS * n * (18 + 33 + 18)
    nbytes = 4 * (5 * N_ENVS * 3 * n + 36 * n)
    bnd, bnd64 = bound(ops, nbytes), bound(ops, 2 * nbytes)
    say(f"phase 45 btd_solve_adjoint timings [{card}]: {N_ENVS} x {n}, b and g in padded "
        f"rows: float32 {t32['lone']:.4f} ms a lone launch, device {t32['dev']:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}: b and g read, y, s, b_bar written), kernel at "
        f"{bnd[0] / t32['dev']:.3f} of it; float64 device {t64['dev']:.4f} ms (bound "
        f"{bnd64[0]:.4f}); the whole backward (kernel and btd_adjoint_factors' batch sums) "
        f"device {t32['whole']:.4f} ms, the sums alone {t32['sums']:.4f} ms; plain sweeps "
        f"{t32['plain']:.1f} ms; library: g @ T^-1 (one torch.matmul, the dense inverse "
        f"of phase 17's library time; b_bar only) {t32['library']:.4f} ms (b_bar vs it "
        f"{lib_rel:.3e} relative); {time.perf_counter() - t_phase:.1f} s")
    return dict(max_abs_err=err, ms=t32["lone"], device_ms=t32["dev"],
                device_ms_by="queued_cuda_events", plain_ms=t32["plain"],
                bound=bnd, library_ms=t32["library"], device_ms_f64=t64["dev"],
                whole_device_ms=t32["whole"], factor_sums_ms=t32["sums"], source=BTD_SOURCE,
                replaces=BTD_REPLACES,
                note="the reverse-mode derivative of that kernel's solve (the JAX package "
                     "differentiates its jnp scans; no TPU kernel of its own); library_ms: "
                     "g @ T^-1 by torch.matmul, b_bar only")


def _tensor_arrays(beam, dev, **scales):
    """``beam.arrays`` as float64 tensors on ``dev``, fields scaled."""
    fields = {f.name: torch.as_tensor(np.asarray(getattr(beam.arrays, f.name)), device=dev)
              for f in dataclasses.fields(beam.arrays)}
    for name, s in scales.items():
        fields[name] = s * fields[name]
    return type(beam.arrays)(**fields)


def spike_grad_setup(crt, mesh):
    """The SPIKE row's beam on ``mesh`` and its traced-arrays rollout."""
    from continuum_robot_tpu_torch import parallel as tpar

    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
    beam = tpar.make_spatial_beam(model.beam_model.arrays,
                                  model.beam_model.bc_info.free_mask.reshape(-1, 3), mesh)
    roll = tpar.build_spatial_genalpha(beam, DT, rho_inf=SPIKE["rho_inf"],
                                       n_newton=SPIKE["n_newton"])
    return model, beam, roll


def spike_gradients(crt, dev, mesh, kb=None):
    """d(loss)/d(scale) of the elastic modulus and the density by autograd
    through the float64 SPIKE span (one environment at rest, the row's tip
    force), the loss ``1e3 sum(q_tip)`` at the last frame as the JAX test
    takes it; with ``kb`` also the central differences and the kernels'
    launches in the gradient path."""
    from continuum_robot_tpu_torch.parallel import facade

    model, beam, roll = spike_grad_setup(crt, mesh)
    cfg = SPIKE_GRAD
    tip = beam.n_nodes_real - 1
    u_red = np.zeros(model.n_pos_states)
    u_red[-2] = 0.1
    x0 = torch.zeros((2, beam.n_nodes, 3), dtype=torch.float64, device=dev)
    u = facade._node_force(model, u_red, beam.n_nodes, x0)

    def loss(**scales):
        _, xs = roll(x0, cfg["frames"], u=u, substeps=cfg["substeps"],
                     arrays=_tensor_arrays(beam, dev, **scales))
        return xs[-1, 0, tip].sum() * 1e3

    out = {}
    for field in ("elastic_modulus", "density"):
        s = torch.tensor(1.0, dtype=torch.float64, device=dev, requires_grad=True)
        if kb is not None:
            kb.reset_launch_counts()
        g, = torch.autograd.grad(loss(**{field: s}), s)
        rec = dict(g=float(g))
        if kb is not None:
            rec["launches"] = {k.__name__: k.launches for k in kb.KERNELS}
            h = cfg["h"]
            with torch.no_grad():
                rec["fd"] = float((loss(**{field: 1.0 + h}) - loss(**{field: 1.0 - h}))
                                  / (2 * h))
        out[field] = rec
    return out


def phase_spike_grad(crt, kb, dev, card) -> dict:
    """Phase 46; returns the launches of btd_solve and btd_solve_adjoint by
    path and the float64 gradients (the four-card oracle)."""
    from continuum_robot_tpu_torch import parallel as tpar

    t_phase = time.perf_counter()
    cfg = SPIKE_GRAD
    backend = tpar.init_process_group(dev)
    try:
        mesh = tpar.make_mesh({"sp": 1}, device=dev)
        model, beam, roll = spike_grad_setup(crt, mesh)
        frames, sub = cfg["frames"], cfg["substeps"]
        repro = {}
        for dtype, envs, limit in ((torch.float64, cfg["f64_envs"], cfg["baked_max"]),
                                   (torch.float32, cfg["envs"], cfg["f32_baked_max"])):
            _, _, xn, u_node = spike_inputs(model, beam, envs, dtype, dev)
            _, baked = roll(xn, frames, u=u_node, substeps=sub)
            _, traced = roll(xn, frames, u=u_node, substeps=sub,
                             arrays=_tensor_arrays(beam, dev))
            # The JAX test's form: max |traced - baked| <= limit x max(scale, 1).
            diff = float((traced - baked).abs().max())
            repro[str(dtype)[6:]] = (diff / max(float(baked.abs().max()), 1.0), limit,
                                     scaled_err(traced, baked))
            del baked, traced
        grads = spike_gradients(crt, dev, mesh, kb)
        paths = {}
        for field, r in grads.items():
            paths[f"spike:grad:{field}"] = r["launches"]
        fd_err = {k: abs(r["g"] - r["fd"]) / abs(r["fd"]) for k, r in grads.items()}
        say(f"phase 46 SPIKE arrays= [{card}]: {N_ELEMENTS} linear elements at sp = 1 "
            f"({backend}), {frames} frames x {sub} substeps; arrays=beam.arrays as tensors "
            f"vs the baked span, max err / max(scale, 1) (limit; max err / scale): "
            f"{ {k: (f'{v[0]:.3e}', v[1], f'{v[2]:.3e}') for k, v in repro.items()} }; "
            f"float64 d(1e3 "
            f"q_tip)/d(scale): "
            + ", ".join(f"{k} {r['g']:.10e} (central difference {r['fd']:.10e}, rel "
                        f"{fd_err[k]:.3e}, limit {cfg['fd_rtol']})" for k, r in grads.items())
            + f"; launches in each gradient path {paths}")
        for k, (e, limit, _) in repro.items():
            require(e <= limit, f"phase 46 traced vs baked ({k}): {e:.3e} > {limit}")
        require(max(fd_err.values()) <= cfg["fd_rtol"], f"phase 46 gradient vs FD {fd_err}")
        for p, c in paths.items():
            require(c["btd_solve"] > 0 and c["btd_solve_adjoint"] > 0,
                    f"phase 46 {p}: the thomas solves did not launch both kernels: {c}")

        # float32 forward and backward at full width, memory watched.
        envs, g32 = cfg["envs"], None
        while True:
            _, _, xn, u_node = spike_inputs(model, beam, envs, torch.float32, dev)
            tip = beam.n_nodes_real - 1

            def fwd_bwd():
                s = torch.ones(2, dtype=torch.float64, device=dev, requires_grad=True)
                arrs = _tensor_arrays(beam, dev, elastic_modulus=s[0], density=s[1])
                _, xs = roll(xn, frames, u=u_node, substeps=sub, arrays=arrs)
                return torch.autograd.grad(xs[-1, :, 0, tip].sum(), s)[0]

            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                kb.reset_launch_counts()
                g32, ms = timed_once(fwd_bwd, dev)
                counts = {k.__name__: k.launches for k in kb.KERNELS}
                peak = torch.cuda.max_memory_allocated(dev) / 1e9
            except torch.cuda.OutOfMemoryError:
                peak = float("inf")
            if peak <= cfg["mem_limit_gb"] or envs <= 256:
                break
            say(f"phase 46: {envs} envs took {peak:.1f} GB (limit {cfg['mem_limit_gb']} GB): "
                f"halving the batch")
            envs //= 2
        require(peak <= cfg["mem_limit_gb"] and g32 is not None and finite(g32),
                f"phase 46 float32 forward+backward at {envs} envs: {peak} GB, {g32}")
        paths["spike:grad:f32"] = counts
        say(f"phase 46 SPIKE float32 forward+backward [{card}]: {envs} envs, "
            f"{frames * sub} steps, d/d(E scale, density scale) of the summed tip "
            f"{g32.tolist()}; {ms:.2f} ms (one call, set-up in), peak memory {peak:.2f} GB; launches "
            f"{counts}; {time.perf_counter() - t_phase:.1f} s")
    finally:
        tpar.destroy_process_group()
    return dict(paths=paths, grads={k: r["g"] for k, r in grads.items()})


def phase_rom_grad(crt, dev, card, rom_main) -> None:
    """Phase 47: ``parametric_modal_rom_rollout`` on the ROM main path's
    engine (frozen bases)."""
    from continuum_robot_tpu_torch.parallel import sweep

    t_phase = time.perf_counter()
    cfg = ROM_GRAD
    model, ms = rom_main["model"], rom_main["ms"]
    bc, arrays = model.beam_model.bc_info, model.beam_model.arrays
    m = ms.Phi.shape[1]
    u = np.zeros(model.n_pos_states)
    u[-2] = cfg["tip"]
    u_m = ms.project_force_host(u)
    E0 = float(np.asarray(arrays.elastic_modulus)[0])

    def loss(scale, remat=False, dtype=torch.float64, n_newton=cfg["n_newton"],
             steps=cfg["steps"]):
        B = scale.shape[0] if scale.dim() else 1
        arrs = sweep.override_arrays(arrays, elastic_modulus=(scale * E0).reshape(B, 1))
        eta0 = torch.zeros(B, m, dtype=dtype, device=dev)
        eta, _ = sweep.parametric_modal_rom_rollout(ms, bc, arrs, eta0, eta0, u_modal=u_m,
                                                    n_steps=steps, n_newton=n_newton,
                                                    remat=remat)
        return (eta.double() ** 2).sum() * 1e6

    one = torch.tensor(1.0, dtype=torch.float64, device=dev)
    grads = {}
    for remat in (False, True):
        s = one.clone().requires_grad_()
        grads[remat] = float(torch.autograd.grad(loss(s, remat), s)[0])
    h = cfg["h"]
    with torch.no_grad():
        fd = float((loss(one + h) - loss(one - h)) / (2 * h))
    fd_err = abs(grads[False] - fd) / abs(fd)
    remat_err = abs(grads[True] - grads[False]) / abs(grads[False])
    say(f"phase 47 parametric_modal_rom_rollout [{card}]: {N_ELEMENTS} von Karman elements, "
        f"{m} frozen modes, float64, {cfg['steps']} steps x {cfg['n_newton']} Newton: "
        f"d(1e6 |eta|^2)/d(E scale) {grads[False]:.10e}, central difference {fd:.10e} (rel "
        f"{fd_err:.3e}, limit {cfg['fd_rtol']}); remat {grads[True]:.10e} (rel "
        f"{remat_err:.3e}, limit {cfg['remat_rtol']})")
    require(fd_err <= cfg["fd_rtol"], f"phase 47 gradient vs FD: {fd_err:.3e}")
    require(remat_err <= cfg["remat_rtol"], f"phase 47 remat vs plain: {remat_err:.3e}")

    rng = np.random.default_rng(47)
    tried = []
    for B in cfg["batches"]:
        scales = torch.tensor(1.0 + 0.01 * rng.normal(size=B), dtype=torch.float64,
                              device=dev)

        def fwd_bwd():
            s = scales.clone().requires_grad_()
            return torch.autograd.grad(loss(s, True, torch.float32, 1, cfg["f32_steps"]), s)[0]

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            g = fwd_bwd()
            ms_t = timed_once(fwd_bwd, dev)[1]
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
        except torch.cuda.OutOfMemoryError:
            tried.append(B)
            continue
        break
    else:
        require(False, f"phase 47: no batch of {cfg['batches']} fits")
    require(finite(g), "phase 47 float32 gradient not finite")
    say(f"phase 47 float32 forward+backward, remat [{card}]: {B} configurations (out of "
        f"memory at {tried}), {cfg['f32_steps']} steps, one Newton iteration: {ms_t:.1f} ms, "
        f"peak memory {peak:.2f} GB; {time.perf_counter() - t_phase:.1f} s")


def phase_dense_grad(crt, dev, card) -> None:
    """Phase 48: the small dense parametric paths."""
    import torch.autograd.forward_ad as fwAD

    from continuum_robot_tpu_torch.ops import integrators
    from continuum_robot_tpu_torch.parallel import sweep

    t_phase = time.perf_counter()
    cfg = DENSE_GRAD
    f64 = torch.float64
    lines, checks = [], []

    def grad_and_fd(run, E0, h):
        """``(g, fd)``: the gradient at ``E0`` of ``run(E (3,)) -> (3,)``
        (losses of three configurations E0 - h, E0, E0 + h in one batch)."""
        E = torch.tensor([E0 - h, E0, E0 + h], dtype=f64, device=dev, requires_grad=True)
        losses = run(E)
        g = float(torch.autograd.grad(losses[1], E)[0][1])
        return g, float(losses[2].detach() - losses[0].detach()) / (2 * h)

    # examples/system_identification.py: RK4 and implicit rollouts of the
    # tip trace under a 2 ms tip impulse.
    model = golden_beam(crt, ["linear"] * cfg["segments"])
    bc, arrays, n = model.beam_model.bc_info, model.beam_model.arrays, model.n_pos_states
    imp = torch.zeros(n, dtype=f64, device=dev)
    imp[-2] = cfg["impulse"]

    def u(t):
        return imp if t < cfg["t_imp"] else torch.zeros_like(imp)

    def tip_loss(kind):
        def run(E):
            arrs = sweep.override_arrays(arrays, elastic_modulus=E[:, None])
            x0 = torch.zeros(3, 2 * n, dtype=f64, device=dev)
            roll = sweep.parametric_rollout if kind == "rk4" else sweep.parametric_genalpha_rollout
            _, ys = roll(bc, arrs, x0, cfg["t_final"], cfg["dt"], u=u,
                         substeps=cfg["substeps"])
            return (ys[:, :, n - 2] ** 2).sum(0) * 1e6
        return run

    E0 = 75e9
    h = E0 * cfg["h_rel"]
    for kind, rtol in (("rk4", cfg["rk4_rtol"]), ("genalpha", cfg["ga_rtol"])):
        (g, fd), secs = wall(lambda: grad_and_fd(tip_loss(kind), E0, h))
        err = abs(g - fd) / abs(fd)
        lines.append(f"system_identification {kind}: dL/dE {g:.8e} vs FD {fd:.8e} (rel "
                     f"{err:.2e}, limit {rtol}; {secs:.1f} s)")
        checks.append((err <= rtol, f"{kind} gradient vs FD {err:.3e}"))

    # tests/test_sweep.py's beams: RK4 (6 segments, 2 ms, 20 substeps, the
    # tip displaced 1 mm) and gen-alpha (5 segments, 10 ms, 10 substeps).
    for kind, segs, t_final, dt, sub, rtol in (("rk4", 6, 0.002, 0.001, 20, cfg["rk4_rtol"]),
                                               ("genalpha", 5, 0.01, 1e-3, 10,
                                                cfg["ga_rtol"])):
        m6 = golden_beam(crt, ["linear"] * segs)
        nn = m6.n_pos_states

        def run(E, m6=m6, nn=nn, kind=kind, t_final=t_final, dt=dt, sub=sub, remat=False):
            arrs = sweep.override_arrays(m6.beam_model.arrays, elastic_modulus=E[:, None])
            x0 = torch.zeros(3, 2 * nn, dtype=f64, device=dev)
            x0[:, nn - 2] = 1e-3 if kind == "rk4" else 1e-4
            if kind == "rk4":
                _, ys = sweep.parametric_rollout(m6.beam_model.bc_info, arrs, x0, t_final, dt,
                                                 substeps=sub)
            else:
                uu = torch.zeros(nn, dtype=f64, device=dev)
                uu[-2] = 0.01
                _, ys = sweep.parametric_genalpha_rollout(m6.beam_model.bc_info, arrs, x0,
                                                          t_final, dt, u=uu, substeps=sub,
                                                          remat=remat)
            return (ys[-1, :, :nn] ** 2).sum(-1) * 1e6

        g, fd = grad_and_fd(run, E0, 1e3)
        err = abs(g - fd) / abs(fd)
        lines.append(f"test_sweep {kind} ({segs} segments): dL/dE {g:.8e} vs FD {fd:.8e} "
                     f"(rel {err:.2e}, limit {rtol})")
        checks.append((err <= rtol, f"test_sweep {kind} gradient vs FD {err:.3e}"))
        if kind == "genalpha":
            g_r, _ = grad_and_fd(lambda E: run(E, remat=True), E0, 1e3)
            err = abs(g_r - g) / abs(g)
            lines.append(f"remat vs plain {err:.2e}")
            checks.append((err <= cfg["remat_rtol"], f"test_sweep remat {err:.3e}"))

    # The traced operator under adaptive gen-alpha (test_sweep's 5-segment
    # beam, rho_inf 0.9, the tip force 0.01): the host-prefactored "btd"
    # operator's run, and forward mode against central differences.
    m5 = golden_beam(crt, ["linear"] * 5)
    n5 = m5.n_pos_states
    q0 = torch.zeros(n5, dtype=f64, device=dev)
    q0[-2] = 1e-4
    u5 = torch.zeros(n5, dtype=f64, device=dev)
    u5[-2] = 0.01
    t_eval = np.linspace(0.0, cfg["adaptive_t"], 2)
    kw = dict(u=u5, rho_inf=0.9, rtol=cfg["adaptive_rtol"], atol=1e-9)
    op_t = sweep.make_traced_genalpha_operator(m5.beam_model.bc_info, m5.beam_model.arrays,
                                               dt=1e-4, rho_inf=0.9, device=dev)
    op_h = crt.make_newmark_operator(m5, dt=None, linear_solver="btd", device=dev)
    (qs_t, _, st_t), secs = wall(lambda: integrators.integrate_generalized_alpha_adaptive(
        op_t, q0, torch.zeros_like(q0), t_eval, **kw))
    qs_h, _, st_h = integrators.integrate_generalized_alpha_adaptive(
        op_h, q0, torch.zeros_like(q0), t_eval, **kw)
    err = rel(qs_t, qs_h)
    same = int(st_t.n_accepted) == int(st_h.n_accepted)
    lines.append(f"adaptive traced vs host-prefactored btd: {err:.2e} (limit 1e-9), accepted "
                 f"{int(st_t.n_accepted)} vs {int(st_h.n_accepted)}, {int(st_t.trials_run)} "
                 f"trials in {secs:.1f} s")
    checks.append((err <= 1e-9 and same, f"adaptive traced vs btd {err:.3e}, {same}"))
    h5 = E0 * cfg["h_rel"]
    with fwAD.dual_level():
        E = fwAD.make_dual(torch.tensor([E0 - h5, E0, E0 + h5], dtype=f64, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], dtype=f64, device=dev))
        arr = sweep.override_arrays(m5.beam_model.arrays, elastic_modulus=E[:, None])
        op = sweep.make_traced_genalpha_operator(m5.beam_model.bc_info, arr, dt=1e-4,
                                                 rho_inf=0.9)
        (qs, _, _), secs = wall(lambda: integrators.integrate_generalized_alpha_adaptive(
            op, q0.expand(3, n5), torch.zeros(3, n5, dtype=f64, device=dev), t_eval,
            per_env=True, **kw))
        tip, tangent = fwAD.unpack_dual(qs[-1, :, -2])
    g = float(tangent[1])
    fd = float(tip[2] - tip[0]) / (2 * h5)
    err = abs(g - fd) / abs(fd)
    lines.append(f"forward mode through adaptive: d(tip)/dE {g:.8e} vs FD {fd:.8e} (rel "
                 f"{err:.2e}, limit 1e-6; {secs:.1f} s)")
    checks.append((err <= 1e-6, f"adaptive jvp vs FD {err:.3e}"))
    say(f"phase 48 dense parametric paths [{card}], float64: " + "; ".join(lines)
        + f"; {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in checks:
        require(ok, f"phase 48 {msg}")


def sweep_paths(crt, kb, dev, card, lin_model=None, rom_main=None) -> dict:
    """Phases 45-48; returns the btd_solve_adjoint record (launches by path
    included) and btd_solve's launches by path there."""
    t0 = time.perf_counter()
    if lin_model is None:
        lin_model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
    rec = phase_btd_adjoint(kb, lin_model, dev, card)
    spike = phase_spike_grad(crt, kb, dev, card)
    if rom_main is None:
        model, ms = rom_main_path(crt, dev)[:2]
        rom_main = dict(model=model, ms=ms)
    phase_rom_grad(crt, dev, card, rom_main)
    phase_dense_grad(crt, dev, card)
    paths = spike["paths"]
    rec.update(launches=paths["spike:grad:elastic_modulus"]["btd_solve_adjoint"],
               launches_by_path={p: c["btd_solve_adjoint"] for p, c in paths.items()})
    print(f"phases 45-48: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(record=rec, btd_paths={p: c["btd_solve"] for p, c in paths.items()},
                grads=spike["grads"])


# ---------------------------------------------------------------------------
# Phases 50-54: the roofline probes, the profiling helpers, the web demo and
# the examples (``--examples`` runs 50-53 alone; ``--cards 4`` adds 54)
# ---------------------------------------------------------------------------

ROOFLINE = dict(check_n=(1 << 16) + 3, chain=256, eps=1e-7, probe_mbytes=64)
ROOFLINE_SOURCE = "continuum_robot_tpu_torch/ops/cuda/csrc/roofline.cu"
ROOFLINE_REPLACES = ("none: the FMA-issue probe of utils/roofline.py's measure_vpu_ceiling "
                     "(continuum_robot_tpu/utils/roofline.py:132 is a fused XLA chain)")
CEILING_MAX = 1.05  # a measured ceiling over its data-sheet constant
# Each measured ceiling's data-sheet constant. ``fma_f32_flops`` counts an
# FMA as two FLOPs, as the data sheet's float32 rate does.
CEILING_PEAKS = {"f32_flops": PEAK_F32_FLOPS, "tf32_flops": PEAK_TF32_FLOPS,
                 "fma_f32_flops": 2 * PEAK_F32_INSTR, "hbm_bytes_per_sec": PEAK_BYTES}
PORT_KERNEL_NAMES = ("affine_kernel", "modal_steps_kernel", "modal_frames_kernel",
                     "affine_frames_kernel", "btd_", "rom_", "fused_gen_alpha", "fma_chain")
DEMO_MAX = 1e-9  # the served payload on the card vs the CPU run, x each key's scale
DEMO_REQUESTS = 3
EXAMPLES_MAX = 1e-9  # an example on the card vs the CPU at the tests' size, float64
# Each example's size: ``full`` in the full run and with ``--examples``
# (phases 50-53 within about 240 s together), and ``small``, the tests'
# size, run on the card and on the CPU and compared. ``full`` cuts every span
# that would not finish within about 30 s on the card: the examples issue
# small host ops (a Dopri5 trial about 4-5 ms), so lqr_control's 0.5 s takes
# ~6 min there, each comparison sweep's 1 s ~20 min, adaptive_stepping's
# spans ~13 min and system_identification's 150 iterations hours. Every size
# is printed on its phase line.
EXAMPLES = {
    "functional_composition_demo": dict(full={}, small={}),
    "lqr_control": dict(full=dict(t_final=0.005), small=dict(t_final=0.004)),
    "lqg_control": dict(full={}, small=dict(t_final=0.05)),
    "batched_rollouts": dict(full=dict(t_final=0.025), small=dict(n_envs=4, t_final=0.004)),
    "sampling_planner": dict(full=dict(n_mpc_rounds=2),
                             small=dict(n_candidates=5, horizon_segments=3, seg_time=0.004,
                                        n_mpc_rounds=2)),
    "beam_comparison_fluid": dict(full=dict(t_final=0.003), small=dict(t_final=0.002)),
    "beam_comparison_gravity": dict(full=dict(t_final=0.003), small=dict(t_final=0.002)),
    "nonlinear_large_deflection": dict(full=dict(t_final=0.02), small=dict(t_final=0.004)),
    "rom_hyper_reduction": dict(full=dict(n_steps=400), small=dict(n=10, n_steps=60, frames=6)),
    "adaptive_stepping": dict(full=dict(t_final=2e-4, dt_out=1e-4, nl_t_final=0.002),
                              small=dict(n_el=4, t_final=2e-4, dt_out=1e-4, nl_t_final=0.002)),
    "system_identification": dict(full=dict(iters=1, t_final=0.002),
                                  small=dict(iters=5, t_final=0.002, substeps=5)),
}
# Kernels that an example's path must launch (the others report their counts).
EXAMPLE_KERNELS = {"batched_rollouts": ("btd_solve",),
                   "nonlinear_large_deflection": ("btd_solve",)}
# Phase 54: multichip_beam at dp x sp = 2 x 2 on four cards against world
# size 1, the JAX script's beam (96 elements) over cut spans.
CARDS_EXAMPLE = dict(n_el=96, spans=dict(explicit_t=2e-6, explicit_substeps=20, ga_frames=2,
                                         sdirk_t=2e-4, rom_frames=4, guard_frames=2,
                                         sysid_frames=2, sysid_iters=2),
                     max=1e-9, timeout=600.0)


def kernel_counts(kmods) -> dict:
    """``{kernel: launches}`` of every kernel of ``kmods`` that launched."""
    return {k.__name__: k.launches for kmod in kmods for k in kmod.KERNELS if k.launches}


def phase_roofline(dev, card) -> dict:
    """Phase 50: ``fma_chain`` against its twin (bit for bit), the measured
    ceilings against the data sheet, the probe's record."""
    from continuum_robot_tpu_torch.utils import cuda_event_times
    from continuum_robot_tpu_torch.utils import roofline as rl

    chain, eps = ROOFLINE["chain"], ROOFLINE["eps"]
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.rand(ROOFLINE["check_n"], generator=gen).to(dev)
    ref = rl.fma_chain_plain(x, chain, eps)
    y = rl.fma_chain(x, chain, eps)
    z = x.clone()
    rl.fma_chain(z, chain, eps, out=z)
    err = max(max_abs(y, ref), max_abs(z, ref))
    require(torch.equal(y, ref) and torch.equal(z, ref),
            f"phase 50: fma_chain differs from its twin by {err:.3e}")

    rl.reset_launch_counts()
    t0 = time.perf_counter()
    ceilings = rl.measure_ceilings(device=dev)
    probe_s = time.perf_counter() - t0
    launches = rl.fma_chain.launches
    ratios = {k: ceilings[k] / CEILING_PEAKS[k] for k in ceilings}
    print(f"phase 50 roofline [{card}]: fma_chain == twin bit for bit "
          f"({ROOFLINE['check_n']} elements, chain {chain}); measured in {probe_s:.1f} s "
          f"({launches} fma_chain launches): " + "; ".join(
              f"{k} {ceilings[k]:.6e} = {ratios[k]:.4f} x {CEILING_PEAKS[k]:.4e}"
              for k in ceilings), flush=True)
    bad = {k: r for k, r in ratios.items() if r > CEILING_MAX}
    require(not bad, f"phase 50: ceilings above {CEILING_MAX} x the data sheet: {bad}")
    require(launches > 0, "phase 50: measure_ceilings launched no fma_chain")

    # At the probe's size (measure_vpu_ceiling's 64 MiB) the grid is capped
    # and every thread takes several grid-stride passes: compared there too,
    # out of place on the twin's input, before the in-place launches are timed.
    n = ROOFLINE["probe_mbytes"] * 1024 * 1024 // 4
    xp = torch.rand(n, generator=gen).to(dev)
    plain = {}
    plain_ms = cuda_event_times(
        lambda: plain.update(y=rl.fma_chain_plain(xp, chain, eps)), repeats=1, warmup=0)[0]
    yp = rl.fma_chain(xp, chain, eps)
    err = max(err, max_abs(yp, plain["y"]))
    require(torch.equal(yp, plain["y"]),
            f"phase 50: fma_chain differs from its twin at {n} elements by {err:.3e}")
    del yp, plain
    ms = min(cuda_event_times(lambda: rl.fma_chain(xp, chain, eps, out=xp), repeats=3))
    ops = 2.0 * chain * n  # an FMA two operations, the data sheet's unit
    rec = {"source": ROOFLINE_SOURCE, "replaces": ROOFLINE_REPLACES, "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound(ops, 8.0 * n),
           "library_ms": None, "launches_by_path": {"measure_ceilings": launches},
           "note": f"{n} float32 elements, chain {chain}; measured {ceilings['fma_f32_flops']:.4e}"
                   " FLOP/s"}
    print(f"phase 50 fma_chain at the probe's size ({n} elements x {chain} links): == twin "
          f"bit for bit; {ms:.4f} ms (bound {rec['bound'][0]:.4f} ms, {rec['bound'][1]}), "
          f"twin {plain_ms:.1f} ms", flush=True)
    return rec


def linear_main_engine(crt, dev):
    """The linear main path's engine and inputs (phase 4's), built anew."""
    from continuum_robot_tpu_torch.models.simulate import make_modal_genalpha

    model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS))
    return make_modal_genalpha(model, DT, rho_inf=RHO_INF, device=dev, dtype=torch.float32)


def phase_profiling(crt, kr, dev, card, ms=None) -> None:
    """Phase 51: ``StepMeter``, ``trace`` and ``compile_time_breakdown`` on
    the linear main path (``rollout_power``)."""
    import tempfile

    from continuum_robot_tpu_torch.utils import StepMeter, compile_time_breakdown, trace

    ms = linear_main_engine(crt, dev) if ms is None else ms
    n_red = ms.n_modes
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(scale=1e-6, size=(N_ENVS, n_red)), dtype=torch.float32,
                     device=dev)
    eta, etad = ms.to_modal(q, torch.zeros_like(q))
    u = np.zeros(n_red, np.float32)
    u[-2] = 0.1
    u_m = np.asarray(ms.project_force_host(u), np.float32)
    # A fresh memo: the first call composes the maps on the host again.
    fresh = dataclasses.replace(ms)

    def path(engine=ms):
        return engine.rollout_power(eta, etad, u_m, N_STEPS, K=K_POWER)

    breakdown = compile_time_breakdown(lambda: path(fresh))
    meter = StepMeter(n_steps=N_STEPS, n_envs=N_ENVS)
    meter.measure(path, repeats=3)
    report = meter.report()
    # The traced path sits in a named range between two pauses of the host,
    # so each try's line can say where the card's events fell against it
    # (a kernel outside Kineto's capture window is dropped from the trace).
    tries_seen = []
    with tempfile.TemporaryDirectory() as logdir:
        for tries in range(1, PROFILER_TRIES + 1):
            kr.reset_launch_counts()
            with trace(logdir, device=dev) as trace_path:
                time.sleep(TRACE_PAD_S)
                with torch.profiler.record_function("phase51_path"):
                    path()
                    torch.cuda.synchronize(dev)
                time.sleep(TRACE_PAD_S)
            traced = kr.affine_drive.launches
            with open(trace_path) as f:
                events = json.load(f).get("traceEvents", [])
            size_kb = os.path.getsize(trace_path) / 1024
            kernels = [e for e in events if e.get("cat") == "kernel"]
            names = {e.get("name", "") for e in kernels}
            cats = {}
            for e in events:
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            span = [e for e in events if e.get("name") == "phase51_path"
                    and e.get("cat") == "user_annotation"][:1]
            where = (f", first kernel at {kernels[0]['ts'] - span[0]['ts']:.1f} us of a "
                     f"{span[0].get('dur', 0):.1f} us range" if kernels and span else "")
            tries_seen.append(f"try {tries}: {size_kb:.0f} KB, events by category "
                              f"{dict(sorted(cats.items(), key=str))}{where}")
            if names:
                break
            EMPTY_TRACES.append("phase 51")
    port = sorted(n for n in names if any(k in n for k in PORT_KERNEL_NAMES))
    print(f"phase 51 profiling, linear main path [{card}]: StepMeter {report}; "
          f"compile_time_breakdown {breakdown}; trace {'; '.join(tries_seen)}; "
          f"{len(names)} kernel names, port kernels {port} ({traced} affine_drive launches "
          f"traced)", flush=True)
    require(report["run_s"] > 0 and report["env_steps_per_sec"] > 0, "phase 51: StepMeter")
    require(port, f"phase 51: the trace names no port kernel (kernels: {sorted(names)})")
    require(traced == 1, f"phase 51: the traced path launched {traced} affine_drive")


def phase_web_demo(kb, dev, card) -> dict:
    """Phase 52: the web demo server on the card against its CPU payload."""
    import threading
    import urllib.request

    from continuum_robot_tpu_torch.examples.web_demo import serve

    with cpu_threads(4):
        ref, cpu_s = host_secs(lambda: serve.run_simulation(device="cpu"))
    server = serve.make_server(0, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    latency, payloads = [], []
    try:
        kb.reset_launch_counts()
        for i in range(DEMO_REQUESTS):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{base}/simulate", timeout=600) as r:
                payloads.append(json.loads(r.read()))
            latency.append(time.perf_counter() - t0)
            if i == 0:
                first = kernel_counts((kb,))
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            page = r.read()
        page_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    errs = {k: max(float(np.abs(np.asarray(p[k]) - np.asarray(ref[k])).max()
                         / np.abs(np.asarray(ref[k])).max()) for p in payloads)
            for k in ref}
    frames = len(ref["times"])
    print(f"phase 52 web demo on the card [{card}]: {DEMO_REQUESTS} GET /simulate "
          f"({frames} frames) in {', '.join(f'{s * 1e3:.1f}' for s in latency)} ms, GET / "
          f"{page_s * 1e3:.1f} ms ({len(page)} bytes); first request's launches {first}; "
          f"payload vs the CPU run (rel.) {errs}; CPU run {cpu_s:.1f} s", flush=True)
    require(max(errs.values()) <= DEMO_MAX, f"phase 52: payload vs CPU {errs} > {DEMO_MAX}")
    require(first.get("btd_solve", 0) > 0, f"phase 52: the server launched {first}")
    require(b"/simulate" in page and not thread.is_alive(), "phase 52: page or shutdown")
    return {"web_demo": first}


def example_arrays(name: str, out: dict) -> dict:
    """The arrays of an example's result that its CPU and card runs must share."""
    pick = {
        "functional_composition_demo": lambda o: {k: o[k] for k in o},
        "lqr_control": lambda o: {k: o[k] for k in ("tip_open", "tip_closed", "gain")},
        "lqg_control": lambda o: {"zs": o["zs"]},
        "batched_rollouts": lambda o: {k: o[k] for k in ("tip", "tip_modal")},
        "sampling_planner": lambda o: {"final_state": o["final_state"]},
        "beam_comparison_fluid": lambda o: dict(o["tips"]),
        "beam_comparison_gravity": lambda o: dict(o["tips"]),
        "nonlinear_large_deflection": lambda o: {
            k: o[k] for k in ("tip_implicit", "tip_dopri5", "tip_rom")},
        "rom_hyper_reduction": lambda o: {k: o[k] for k in ("qs_full", "qs_hr")},
        "adaptive_stepping": lambda o: {k: v["tip"] for k, v in o.items()
                                        if isinstance(v, dict)},
        "system_identification": lambda o: {"history": np.asarray(o["history"]),
                                            "log_E_path": np.asarray(o["log_E_path"])},
    }[name]
    return {k: np.asarray(v, dtype=float) for k, v in pick(out).items()}


def figures(out: dict) -> dict:
    """An example's scalar figures (nested one level), for its phase line."""
    keep = {}
    for k, v in out.items():
        if isinstance(v, (bool, int, float)):
            keep[k] = v
        elif isinstance(v, dict):
            sub = {s: w for s, w in v.items() if isinstance(w, (bool, int, float))}
            if sub:
                keep[k] = sub
    return keep


def phase_examples(kmods, dev, card, sizes: dict) -> dict:
    """Phase 53: every example but the web demo and multichip_beam on the
    card at ``sizes``, its launches by kernel; then at the tests' size on
    the card and on the CPU, compared. Returns the launches by example."""
    import importlib

    by_path = {}
    for name, size in sizes.items():
        mod = importlib.import_module(f"continuum_robot_tpu_torch.examples.{name}")
        reset_counts(kmods)
        t0 = time.perf_counter()
        out = mod.run(device=dev, **size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts(kmods)
        by_path[name] = counts
        print(f"phase 53 {name} {size or 'defaults'} [{card}]: {wall:.2f} s; "
              f"launches {counts}; {json.dumps(figures(out), default=float)}", flush=True)
        missing = [k for k in EXAMPLE_KERNELS.get(name, ()) if not counts.get(k)]
        require(not missing, f"phase 53 {name}: no launch of {missing}")
        small = EXAMPLES[name]["small"]
        card_out = example_arrays(name, mod.run(device=dev, **small))
        with cpu_threads(4):
            cpu_out = example_arrays(name, mod.run(device="cpu", **small))
        errs = {k: float(np.abs(card_out[k] - cpu_out[k]).max()
                         / max(np.abs(cpu_out[k]).max(), 1e-300)) for k in cpu_out}
        print(f"phase 53 {name} at the tests' size {small}: card vs CPU (rel.) "
              f"{max(errs.values()):.3e}", flush=True)
        require(max(errs.values()) <= EXAMPLES_MAX,
                f"phase 53 {name}: card vs CPU {errs} > {EXAMPLES_MAX}")
    return by_path


def example_paths(crt, kmods, dev, card, sizes: dict, ms=None) -> tuple:
    """Phases 50-53 (51 on ``ms``, the linear main path's engine, or a new
    one); returns ``(fma_chain record, launches by example path)``."""
    t0 = time.time()
    rec = phase_roofline(dev, card)
    phase_profiling(crt, kmods[0], dev, card, ms)
    by_path = phase_web_demo(kmods[2], dev, card)
    by_path.update(phase_examples(kmods, dev, card, sizes))
    print(f"phases 50-53 done in {time.time() - t0:.1f} s", flush=True)
    return rec, by_path


def cards_example_rank(dp: int, sp: int, n_el: int, spans: dict) -> dict:
    """Phase 54 on one rank (launched by name): ``multichip_beam``'s tiers
    with every launch count set to 0 first; the result carries the
    generalized-alpha tier's ``btd_solve`` launches."""
    from continuum_robot_tpu_torch.examples import multichip_beam as mb
    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb

    kb.reset_launch_counts()
    return mb.rank_main(dp, sp, n_el, spans, False)


def phase_cards_example(card, n_cards: int) -> dict:
    """Phase 54: ``multichip_beam`` at dp x sp = 2 x 2 over NCCL, one rank a
    card, against the same example at world size 1 (one card)."""
    import importlib

    from continuum_robot_tpu_torch.examples import multichip_beam as mb
    from continuum_robot_tpu_torch.parallel import collectives

    # The ranks import the rank body by name (see cards_paths).
    this = importlib.import_module("chip_smoke")
    spans = {**mb.SPANS, **CARDS_EXAMPLE["spans"]}
    worlds, secs = {}, {}
    for n in (1, n_cards):
        t0 = time.perf_counter()
        worlds[n] = collectives.launch(this.cards_example_rank, n, 2 if n > 1 else 1,
                                       n // 2 if n > 1 else 1, CARDS_EXAMPLE["n_el"], spans,
                                       timeout=CARDS_EXAMPLE["timeout"])
        secs[n] = time.perf_counter() - t0
    one, four = worlds[1][0], worlds[n_cards][0]
    launches = {n: [r["genalpha_btd_launches"] for r in w] for n, w in worlds.items()}
    tips = ("explicit_tip", "genalpha_tip", "sdirk3_tip", "rom_training_tip_modal",
            "guard_max_residual", "outside_max_residual", "rom_tip", "sysid_scale")
    errs = {k: float(np.abs(np.asarray(four[k]) - np.asarray(one[k])).max()
                     / max(np.abs(np.asarray(one[k])).max(), 1e-300)) for k in tips}
    same = {k: bool(np.array_equal(four[k], one[k])) for k in (
        "sdirk3_accepted", "sdirk3_rejected", "ecsw_sampled", "guard_flagged",
        "outside_flagged")}
    walls = {k: round(four[k], 3) for k in four if k.endswith("_s")}
    print(f"phase 54 multichip_beam 2 x {n_cards // 2} over NCCL [{card}] "
          f"({CARDS_EXAMPLE['n_el']} elements, spans {CARDS_EXAMPLE['spans']}): "
          f"{secs[n_cards]:.1f} s (world size 1: {secs[1]:.1f} s); tiers' wall s {walls}; "
          f"generalized-alpha btd_solve launches by rank {launches[n_cards]} (world size 1: "
          f"{launches[1]}); vs world size 1 (rel.) {errs}; counts and flags equal {same}; "
          f"SDIRK3 {np.asarray(four['sdirk3_accepted']).tolist()} accepted", flush=True)
    require(max(errs.values()) <= CARDS_EXAMPLE["max"],
            f"phase 54: 2 x 2 vs world size 1 {errs} > {CARDS_EXAMPLE['max']}")
    require(all(same.values()), f"phase 54: counts or flags differ {same}")
    require(all(c > 0 for w in launches.values() for c in w),
            f"phase 54: a rank's generalized-alpha tier launched no btd_solve {launches}")
    return {"multichip_beam:genalpha:cards": launches[n_cards],
            "multichip_beam:genalpha": launches[1][0]}


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Imported here: a directory without the package fails at this point.
    import continuum_robot_tpu_torch as crt
    from continuum_robot_tpu_torch.ops.cuda import _build
    from continuum_robot_tpu_torch.ops.cuda import btd_solve as kb
    from continuum_robot_tpu_torch.ops.cuda import fused_rollout as kf
    from continuum_robot_tpu_torch.ops.cuda import modal_rollout as kr
    from continuum_robot_tpu_torch.ops.cuda import rom_rollout as rk

    dev = torch.device(DEVICE, 0)
    card = card_line()
    print(f"phase 1 device: {card} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)

    args = sys.argv[1:]
    if "--profile" in args:
        which = args[args.index("--profile") + 1:][:1]
        if which == ["implicit"]:
            profile_implicit(crt, kb, dev, card)
        elif which == ["dense"]:
            profile_dense(crt, dev, card)
        elif which == ["highest"]:
            profile_rom(crt, dev, card, "highest")
        elif which == ["fused"]:
            profile_fused(crt, dev, card)
        else:
            profile_rom(crt, dev, card)
        return 0
    if "--control" in args:
        control_paths(crt, dev, card, (kr, rk, kb, kf))
        return 0
    if "--parallel" in args:
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s", flush=True)
        btd, modal, step_ms, _ = parallel_paths(crt, kb, kr, dev, card)
        print(f"parallel launches by path: btd_solve {btd}, {modal}; SPIKE ms a step "
              f"{step_ms}; total {time.time() - t_start:.1f} s", flush=True)
        return 0
    if "--cards" in args:
        n_cards = int((args[args.index("--cards") + 1:] or ["0"])[0])
        require(n_cards == N_CARDS, f"--cards takes {N_CARDS} (sp = 4, dp x sp = 2 x 2)")
        found = torch.cuda.device_count()
        require(found >= n_cards, f"--cards {n_cards} needs {n_cards} cards, found {found}")
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s", flush=True)
        if "--examples" in args:  # phase 54 alone
            by_path = {"btd_solve": phase_cards_example(card, n_cards)}
            print(json.dumps({"launches_by_path": by_path}), flush=True)
            print(f"phase 54 done; total {time.time() - t_start:.1f} s", flush=True)
            print(card)
            return 0
        by_path = cards_paths(crt, kb, kr, dev, card, n_cards)
        by_path["btd_solve"].update(phase_cards_example(card, n_cards))
        print(json.dumps({"launches_by_path": by_path}), flush=True)
        print(f"four-card phases done; total {time.time() - t_start:.1f} s", flush=True)
        print(card)
        return 0
    if "--sweep" in args:
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s", flush=True)
        out = sweep_paths(crt, kb, dev, card)
        rec = out["record"]
        print(json.dumps({"btd_solve_adjoint": {k: rec[k] for k in (
            "launches", "launches_by_path") + ADJOINT_KEYS},
            "btd_solve_launches_by_path": out["btd_paths"]}), flush=True)
        print(f"sweep phases done; total {time.time() - t_start:.1f} s", flush=True)
        return 0
    if "--adjoint" in args:
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s", flush=True)
        lin_model = crt.DynamicEulerBernoulliBeam(bench_beam_dataframe(N_ELEMENTS, "linear"))
        rec = phase_btd_adjoint(kb, lin_model, dev, card)
        print(json.dumps({"btd_solve_adjoint": {k: rec[k] for k in ADJOINT_KEYS}}), flush=True)
        print(f"phase 45 done; total {time.time() - t_start:.1f} s", flush=True)
        return 0
    if "--examples" in args:
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s ({_build.build_seconds})", flush=True)
        rec, by_path = example_paths(crt, (kr, rk, kb, kf), dev, card,
                                     {k: v["full"] for k, v in EXAMPLES.items()})
        print(json.dumps({"fma_chain": {k: rec[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound")},
            "launches_by_path": by_path}), flush=True)
        print(f"example phases done; total {time.time() - t_start:.1f} s; profiler traces "
              f"without device events: {EMPTY_TRACES or 'none'}", flush=True)
        print(card)
        return 0
    if "--rom-tier" in args:
        t0 = time.time()
        _build.build_all()
        print(f"phase 2 build: {time.time() - t0:.1f} s", flush=True)
        tier = rom_tier_paths(crt, rk, dev, card, (kr, rk, kb, kf))
        print(f"ROM tier launches by path: {tier}; total {time.time() - t_start:.1f} s",
              flush=True)
        return 0

    t0 = time.time()
    libs = _build.build_all()
    build_s = time.time() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text()
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print(f"phase 2 build {name}: ptxas: {' | '.join(regs)}", flush=True)
        for ln in log.splitlines():  # e.g. wgmma serialisation
            if "arning" in ln:
                print(f"phase 2 build {name}: {ln.strip()}", flush=True)
    print(f"phase 2 build: {build_s:.1f} s for {len(libs)} sources in parallel "
          f"({_build.build_seconds})", flush=True)

    err = phase_kernels(kr, dev)
    records, lin_model, lin_ms = linear_paths(crt, kr, dev, card)
    print(f"linear paths done; {time.time() - t_start:.1f} s so far", flush=True)
    for name in REPLACES:
        records[name].update(max_abs_err=err[name], source=SOURCE,
                             replaces=REPLACES[name])

    engines = small_rom_engines(crt, dev)
    small_err = phase_rom_small(engines, rk, dev)
    rom_records, rom_main = rom_paths(crt, rk, dev, card, engines["nonlinear/diag"][0])
    for rec in rom_records.values():
        rec.update(source=ROM_SOURCE, replaces=ROM_REPLACES)
    records.update(rom_records)
    print(f"ROM small-size worst max|kernel-plain|/scale {small_err:.3e}; "
          f"{time.time() - t_start:.1f} s so far", flush=True)
    records["btd_solve"] = implicit_paths(crt, kb, dev, card, lin_model, lin_ms)
    print(f"implicit paths done; {time.time() - t_start:.1f} s so far", flush=True)
    records.update(fused_paths(crt, kf, kb, dev, card))
    print(f"fused paths done; {time.time() - t_start:.1f} s so far", flush=True)
    records["btd_solve"]["launches_by_path"].update(adaptive_paths(crt, kb, dev, card))
    print(f"adaptive paths done; {time.time() - t_start:.1f} s so far", flush=True)
    control_paths(crt, dev, card, (kr, rk, kb, kf))
    print(f"control paths done; {time.time() - t_start:.1f} s so far", flush=True)
    tier = rom_tier_paths(crt, rk, dev, card, (kr, rk, kb, kf), rom_main)
    for name in rom_records:
        records[name]["launches_by_path"].update({p: c[name] for p, c in tier.items()})
    print(f"ROM tier done; {time.time() - t_start:.1f} s so far", flush=True)
    btd, modal, _, _ = parallel_paths(crt, kb, kr, dev, card)
    records["btd_solve"]["launches_by_path"].update(btd)
    records["modal_frames"]["launches_by_path"]["simulate_sharded:pallas"] = modal[
        "modal_frames"]
    records["affine_frames"]["launches_by_path"]["simulate_sharded:power"] = modal[
        "affine_frames"]
    sweep = sweep_paths(crt, kb, dev, card, lin_model, rom_main)
    records["btd_solve"]["launches_by_path"].update(sweep["btd_paths"])
    records["btd_solve_adjoint"] = sweep["record"]
    print(f"sweep paths done; {time.time() - t_start:.1f} s so far", flush=True)
    records["fma_chain"], examples = example_paths(
        crt, (kr, rk, kb, kf), dev, card, {k: v["full"] for k, v in EXAMPLES.items()}, lin_ms)
    for path, counts in examples.items():
        for name, n in counts.items():
            records[name]["launches_by_path"][f"example:{path}"] = n
    print(f"total {time.time() - t_start:.1f} s; profiler traces without device events: "
          f"{EMPTY_TRACES or 'none'}", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": rec["source"],
         "replaces": rec["replaces"], "launches": rec["launches"],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
         "bound_by": rec["bound"][1], "library_ms": rec["library_ms"],
         "launches_by_path": rec["launches_by_path"],
         **({k: rec[k] for k in ("device_ms", "device_ms_by") if k in rec}),
         **({k: rec[k] for k in ("dispatch_us", "full_width") if k in rec}),
         **({"rn_bound_ms": rec["rn_bound_ms"]} if "rn_bound_ms" in rec else {}),
         **({"design": rec["design"]} if "design" in rec else {}),
         **({"note": rec["note"]} if "note" in rec else {})}
        for name, rec in records.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

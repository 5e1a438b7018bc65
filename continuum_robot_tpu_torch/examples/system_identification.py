"""Gradient-based system identification from a measured tip trajectory.

Counterpart of the JAX package's ``examples/system_identification.py``. The
rollout is differentiable in every physical parameter
(``parallel.sweep.parametric_rollout`` over ``override_arrays``), so the
elastic modulus of a 4-segment Nitinol cantilever struck at the tip is
recovered from its (optionally noisy) tip-displacement trace by gradient
descent on ``log E`` from a 40% misestimate, with ``torch.optim.Adam`` at
the JAX script's ``optax.adam(3e-2)`` settings (betas 0.9 and 0.999, eps
1e-8, 150 iterations).

Usage: python -m continuum_robot_tpu_torch.examples.system_identification
[--plot] [--noise SIGMA] [--device cpu]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import DynamicEulerBernoulliBeam
from ..parallel.sweep import override_arrays, parametric_rollout
from .example_utilities import (
    cleanup_temp_files,
    create_csv_file,
    example_parser,
    host,
    parsed_placement,
    placement,
    pyplot,
)

TRUE_E = 75e9
N_SEGMENTS = 4
T_FINAL, DT = 0.02, 2e-4
SUBSTEPS = 20
LEARNING_RATE = 3e-2
ITERATIONS = 150


def build_model():
    f = create_csv_file(["linear"] * N_SEGMENTS, ["FIXED"] + ["NONE"] * (N_SEGMENTS - 1))
    try:
        return DynamicEulerBernoulliBeam(f)
    finally:
        cleanup_temp_files(f)


def make_tip_trace_fn(model, t_final=T_FINAL, dt=DT, substeps=SUBSTEPS, device=None,
                      dtype=None):
    """Differentiable map ``log E (0-d tensor) -> tip-displacement trace``."""
    device, dtype = placement(device, dtype)
    bc_info = model.beam_model.bc_info
    arrays = model.beam_model.arrays
    n = model.n_pos_states
    x0 = torch.zeros((1, 2 * n), dtype=dtype, device=device)
    tip_impulse = torch.zeros(n, dtype=dtype, device=device)
    tip_impulse[-2] = 0.1
    rest = torch.zeros_like(tip_impulse)

    def u(t):
        return tip_impulse if t < 0.002 else rest

    def tip_trace(log_E):
        batch = override_arrays(arrays, elastic_modulus=torch.exp(log_E)[None, None])
        _, ys = parametric_rollout(bc_info, batch, x0, t_final, dt, u=u, substeps=substeps)
        return ys[:, 0, n - 2]

    return tip_trace


def make_loss(tip_trace, y_obs):
    """``loss(log E)``: the mean squared trace mismatch over max |y_obs|."""
    scale = float(y_obs.abs().max())

    def loss(log_E):
        return torch.mean(((tip_trace(log_E) - y_obs) / scale) ** 2)

    return loss


def run(noise=0.0, iters=ITERATIONS, lr=LEARNING_RATE, t_final=T_FINAL, dt=DT,
        substeps=SUBSTEPS, plot=False, device=None, dtype=None, verbose=False) -> dict:
    device, dtype = placement(device, dtype)
    say = print if verbose else (lambda *a: None)
    model = build_model()
    tip_trace = make_tip_trace_fn(model, t_final, dt, substeps, device, dtype)

    rng = np.random.default_rng(0)
    with torch.no_grad():
        y_obs = host(tip_trace(torch.tensor(math.log(TRUE_E), dtype=dtype, device=device)))
    if noise > 0:
        y_obs = y_obs + noise * np.abs(y_obs).max() * rng.normal(size=y_obs.shape)
    y_obs = torch.as_tensor(y_obs, dtype=dtype, device=device)
    loss = make_loss(tip_trace, y_obs)

    log_E = torch.tensor(math.log(0.6 * TRUE_E), dtype=dtype, device=device,
                         requires_grad=True)  # a 40% misestimate
    say(f"true E = {TRUE_E:.4e}, initial guess = {math.exp(log_E.item()):.4e}")
    opt = torch.optim.Adam([log_E], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history, path = [], []
    for it in range(iters):
        opt.zero_grad()
        v = loss(log_E)
        v.backward()
        history.append((v.item(), log_E.grad.item()))
        opt.step()
        path.append(log_E.item())
        if it % 25 == 0 or it == iters - 1:
            say(f"  iter {it:3d}: loss {history[-1][0]:.3e}, E = {math.exp(path[-1]):.4e}")

    E_hat = math.exp(log_E.item())
    rel_err = abs(E_hat - TRUE_E) / TRUE_E
    say(f"\nrecovered E = {E_hat:.4e}  (relative error {rel_err:.2e})")
    if plot:
        plt = pyplot()
        ts = dt * np.arange(y_obs.shape[0])
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(ts, host(y_obs), "k.", ms=3, label="observed")
        with torch.no_grad():
            ax.plot(ts, host(tip_trace(log_E)), label="fitted model")
        ax.set(xlabel="t [s]", ylabel="tip w [m]")
        ax.legend()
        fig.tight_layout()
        fig.savefig("system_identification.png", dpi=120)
        say("wrote system_identification.png")
    return {"E_hat": E_hat, "rel_err": rel_err, "history": history, "log_E_path": path,
            "log_E": log_E.item(), "y_obs": host(y_obs)}


def main(argv=None):
    parser = example_parser(__doc__)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--noise", type=float, default=0.0)
    args = parser.parse_args(argv)
    return run(noise=args.noise, plot=args.plot, verbose=True, **parsed_placement(args))


if __name__ == "__main__":
    main()

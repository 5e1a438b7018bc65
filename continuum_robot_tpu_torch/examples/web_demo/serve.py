"""Browser-facing simulation service: the beam rollout served as JSON.

Counterpart of the JAX package's ``examples/web_demo/serve.py``. The
rollout (a 6-segment linear cantilever, a tip impulse, 0.5 s of implicit
Newmark with 20 substeps a frame) runs on the card and the browser gets the
``{times, x_coords, y_coords, tip_displacement}`` payload, drawn by
``index.html``. On the card ``make_newmark_operator`` solves each Newmark
system with the hand-written ``btd_solve`` kernel.

Run: ``python -m continuum_robot_tpu_torch.examples.web_demo.serve [port]
[--device cpu]`` (default port 8765), then open http://localhost:8765/.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ...models import DynamicEulerBernoulliBeam
from ...models.simulate import simulate
from ..example_utilities import (
    cleanup_temp_files,
    create_csv_file,
    get_material_properties,
    host,
    placement,
)

PAGE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "index.html")

_CACHE = {}
_CACHE_LOCK = threading.Lock()


def run_simulation(n_segments=6, t_final=0.5, dt=0.001, impulse=0.1, device=None,
                   dtype=None):
    """The demo's workload as one rollout on ``device`` (None: the card) in
    ``dtype`` (None: float64); returns the JSON payload. Memoized on the
    arguments, the device and the dtype."""
    device, dtype = placement(device, dtype)
    key = (n_segments, t_final, dt, impulse, str(device), dtype)
    with _CACHE_LOCK:
        if key in _CACHE:
            return _CACHE[key]

    csv = create_csv_file(
        ["linear"] * n_segments, ["FIXED"] + ["NONE"] * (n_segments - 1)
    )
    try:
        beam = DynamicEulerBernoulliBeam(csv)
    finally:
        cleanup_temp_files(csv)
    n = beam.n_pos_states
    tip = torch.zeros(n, dtype=dtype, device=device)
    tip[-2] = impulse
    rest = torch.zeros_like(tip)

    def u(t):
        return tip if t < 0.01 else rest

    res = simulate(beam, torch.zeros(2 * n, dtype=dtype, device=device), t_final, dt,
                   method="newmark", u=u, substeps=20)
    ys = host(res.ys)
    w = ys[:, 1:n:3][:, :n_segments]
    props = get_material_properties()
    payload = {
        "times": host(res.ts).tolist(),
        "x_coords": (np.arange(n_segments + 1) * props["length"]).tolist(),
        "y_coords": np.concatenate([np.zeros((ys.shape[0], 1)), w], axis=1).tolist(),
        "tip_displacement": w[:, -1].tolist(),
    }
    with _CACHE_LOCK:
        _CACHE[key] = payload
    return payload


def make_handler(device=None, dtype=None, **simulation):
    """A request handler class serving ``run_simulation(device=, dtype=,
    **simulation)``: ``/simulate`` (JSON), ``/`` and ``/index.html`` (the
    page), 404 else."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/simulate"):
                payload = run_simulation(device=device, dtype=dtype, **simulation)
                body = json.dumps(payload).encode()
                self._send(200, "application/json", body)
            elif self.path in ("/", "/index.html"):
                with open(PAGE, "rb") as f:
                    self._send(200, "text/html", f.read())
            else:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    return Handler


def make_server(port=8765, host_name="127.0.0.1", device=None, dtype=None, **simulation):
    """An HTTP server bound to ``host_name:port`` (port 0: any free port,
    read back from ``server.server_address``) whose ``/simulate`` answers
    ``run_simulation(device=, dtype=, **simulation)``; call
    ``serve_forever()``."""
    return ThreadingHTTPServer((host_name, port), make_handler(device, dtype, **simulation))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve the beam rollout as JSON.")
    parser.add_argument("port", nargs="?", type=int, default=8765)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    print("warming up the rollout...")
    run_simulation(device=args.device)
    server = make_server(args.port, device=args.device)
    print(f"serving on http://localhost:{server.server_address[1]}/  "
          "(GET /simulate for JSON)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

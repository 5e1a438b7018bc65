"""The port's examples: the JAX package's example scripts on PyTorch.

Each module runs as ``python -m continuum_robot_tpu_torch.examples.<name>``
with the JAX script's own arguments and ``--device cpu`` for the CPU (the
card otherwise), and exposes ``run(..., device=None, dtype=None, **sizes)``,
which returns the numbers the script prints, and ``main(argv=None)``. The
web demo server is ``examples.web_demo.serve``. Importing this package
imports no example.
"""

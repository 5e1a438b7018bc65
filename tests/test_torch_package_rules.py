"""Rules the PyTorch port keeps: no JAX, true float32 matmuls, honest timing.

* No module of ``continuum_robot_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax`` or the JAX package ``continuum_robot_tpu``; only tests
  import both.
* Importing the port turns TF32 off (docs/design.md, Precision).
* A timing helper that finds no card raises instead of timing the CPU.
"""

import ast
import pathlib

import pytest
import torch

import continuum_robot_tpu_torch
from continuum_robot_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "continuum_robot_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "continuum_robot_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in PORT_FILES}
    assert {"simulate.py", "forces.py", "modal_rollout.py", "_build.py", "convert.py",
            "chip_smoke.py"} <= names


def test_tf32_off_after_import():
    assert continuum_robot_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_timing_helpers():
    x = torch.ones(3)
    out = (x, {"y": [x]})
    assert profiling.force_completion(out) is out
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.cuda_event_times(lambda: None)

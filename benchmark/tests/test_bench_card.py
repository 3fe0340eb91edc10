"""On the card: each cell runs and proves correct, and its control (the
program's lower-precision path: int4 for the int8 cell, int8 for the bf16
cell) comes out not correct. Short windows at the cells' own sizes; run on
the chip with ``python3 -m pytest -m cuda benchmark/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, *extra):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "8", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_and_control_not(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")
    assert _run(cell)["correct"] is True
    assert _run(cell, "--control")["correct"] is False

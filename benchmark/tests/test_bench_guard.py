"""The import check compares whole top-level names: the port
(``t5gemma_tts_tpu_torch``) passes, JAX and the JAX package do not; the
plain reference imports nothing of either; a checkout without the program
fails and prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import guard

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "t5gemma_tts_tpu", "t5gemma_tts_tpu.models.t5gemma",
             "t5gemma_tts_tpu_torch", "t5gemma_tts_tpu_torch.ops.quant",
             "jaxtyping", "flaxen", "torch", "benchmark.run"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "t5gemma_tts_tpu", "t5gemma_tts_tpu.models.t5gemma"]
    assert guard.forbidden_modules(["t5gemma_tts_tpu_torch.models"]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_program_nor_jax():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "t5gemma_tts_tpu",
                               "t5gemma_tts_tpu_torch"), (path, name)


def test_no_harness_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)


def test_checkout_without_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    cell = json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

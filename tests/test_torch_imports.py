"""Import hygiene of the port: in a fresh interpreter, importing every module
of ``t5gemma_tts_tpu_torch`` (``decode/speculative.py``,
``decode/continuous.py``, ``codec/streaming.py``, ``inference/server.py``,
``asr/``, ``inference/http_server.py``, ``inference/gradio_app.py``,
``inference/transcribe.py``, the training modules under ``train/``,
``data/`` (``data/preprocess.py`` too) and ``utils/`` (``safetensors_io``,
``snapshot``), ``export/``, ``ops/chunked_ce.py`` and the one-segment paged
attention of ``ops/paged_attn.py`` among them) and ``chip_smoke.py`` (as a module,
without running it) loads neither ``jax`` nor anything of
``t5gemma_tts_tpu``, nor ``safetensors``, ``orbax``, ``gradio`` or
``transformers``, which only the functions that need them import. No
source file of the package (``export/templates/`` aside, which exports
ship and the package never imports) and not ``chip_smoke.py`` has an
import of ``jax``, ``orbax``, ``safetensors`` or ``t5gemma_tts_tpu``
anywhere, inside a function or not. The entry points (the pipeline, the synthesis and train CLIs, ``Trainer``)
run on ``cuda`` by default and raise, rather than run on the CPU, when
there is no card; the train CLI does so before it imports a tokenizer."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import torch
torch.cuda.is_available = lambda: False        # a machine with no card
import t5gemma_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "t5gemma_tts_tpu",
                                    "gradio", "transformers", "safetensors",
                                    "orbax"))
assert not bad, bad
assert len(names) >= 20, names
for mod in ("decode.speculative", "decode.continuous", "codec.streaming",
            "inference.server", "asr.mel", "asr.model", "asr.convert",
            "inference.http_server", "inference.gradio_app",
            "inference.transcribe", "ops.chunked_ce", "train.optim",
            "train.lora", "train.train_step", "train.checkpoint",
            "train.logging_utils", "train.diagnostics", "train.trainer",
            "train.cli", "data.manifest", "data.batching", "data.stretch",
            "data.dataset", "data.preprocess", "utils.profiling",
            "utils.tree", "utils.safetensors_io", "utils.snapshot",
            "export.hf_export", "export.convert_reference_bundle",
            "parallel", "parallel.mesh", "parallel.tensor"):
    assert "t5gemma_tts_tpu_torch." + mod in names, (mod, names)
from t5gemma_tts_tpu_torch.ops import paged_attn
for fn in ("paged_attention_reference", "paged_flash_parts",
           "paged_flash_parts_plain", "merge_attention_parts",
           "merge_attention_parts_chain", "paged_gqa_attention"):
    assert callable(getattr(paged_attn, fn)), fn

from t5gemma_tts_tpu_torch.config import tiny_voice_config
from t5gemma_tts_tpu_torch.inference import cli
from t5gemma_tts_tpu_torch.inference.pipeline import TTSPipeline
from t5gemma_tts_tpu_torch.models import voice
from t5gemma_tts_tpu_torch.train import cli as train_cli
from t5gemma_tts_tpu_torch.train.trainer import Trainer, TrainerConfig
refused = 0
for call in (lambda: TTSPipeline({}, tiny_voice_config(), list),
             lambda: voice.init_params(0, tiny_voice_config()),
             lambda: cli.main(["--random_codec"]),
             lambda: Trainer(tiny_voice_config(), TrainerConfig(), None),
             lambda: train_cli.main(["--dataset_dir", "none"])):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
        refused += 1
assert refused == 5
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "t5gemma_tts_tpu",
                                    "transformers", "safetensors", "orbax"))
assert not bad, bad
print("CLEAN", len(names))
"""

BANNED = ("jax", "jaxlib", "orbax", "safetensors", "t5gemma_tts_tpu")


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_orbax_or_safetensors():
    """Imports inside functions count too: a lazy import of a banned
    package would still fail on a machine without it. The scan takes in
    ``parallel/`` and the gloo ranks' workers and the card's parallel
    tests, which run with torch and the port alone."""
    pkg = os.path.join(ROOT, "t5gemma_tts_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "tests", f) for f in (
            "torch_parallel_worker.py", "test_torch_parallel_cuda.py",
            "torch_parallel_serve_worker.py",
            "test_torch_serve_tp_cuda.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
        if f.endswith(".py") and "templates" not in d.split(os.sep)]
    assert len(files) > 60
    for name in ("__init__.py", "mesh.py", "tensor.py"):
        assert os.path.join(pkg, "parallel", name) in files, name
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        found += [(os.path.relpath(path, ROOT), m) for m in _imported(tree)
                  if m.split(".")[0] in BANNED]
    assert not found, found

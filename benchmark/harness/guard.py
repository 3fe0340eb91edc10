"""The run's own rules: caches inside the checkout, a card or nothing, and no
module of the JAX package (or JAX itself) in the process that prints the
result."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

# top-level module names a run may not load, compared whole: the port
# (``t5gemma_tts_tpu_torch``) shares the JAX package's prefix and is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "t5gemma_tts_tpu")


def set_environment(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    nvcc libraries into ``t5gemma_tts_tpu_torch/_build`` by itself), and
    libraries kept from loading JAX."""
    cache = root / "_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv_compute"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def check_cards(chips: int) -> str:
    """Raises unless ``chips`` CUDA cards are visible; their name."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs only on a card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return torch.cuda.get_device_name(0)

"""Finite Scalar Quantization decode (counterpart of
``t5gemma_tts_tpu/codec/fsq.py``): index -> codes by closed-form digit
arithmetic, then ``project_out``. The encode path comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FSQConfig:
    levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4, 4, 4)
    dim: int = 2048  # outer dim projected in/out of the codebook space

    @property
    def codebook_dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))


def init_params(gen: torch.Generator, cfg: FSQConfig, dtype=torch.float32,
                device=None) -> Dict:
    d, cd = cfg.dim, cfg.codebook_dim

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    return {
        "project_in": {"w": normal(d, cd, std=d ** -0.5),
                       "b": torch.zeros((cd,), dtype=dtype, device=device)},
        "project_out": {"w": normal(cd, d, std=cd ** -0.5),
                        "b": torch.zeros((d,), dtype=dtype, device=device)},
    }


def indices_to_codes(cfg: FSQConfig, indices: torch.Tensor) -> torch.Tensor:
    """int indices [...] -> normalized codes [..., d] in [-1, 1]."""
    dev = indices.device
    levels = torch.tensor(cfg.levels, dtype=torch.int64, device=dev)
    basis = torch.tensor(np.concatenate([[1], np.cumprod(cfg.levels[:-1])]),
                         dtype=torch.int64, device=dev)
    half = torch.tensor([l // 2 for l in cfg.levels], dtype=torch.float32,
                        device=dev)
    digits = torch.div(indices.long()[..., None], basis,
                       rounding_mode="floor") % levels
    return (digits.float() - half) / half


def decode(params: Dict, cfg: FSQConfig, indices: torch.Tensor) -> torch.Tensor:
    """indices [...] -> dequantized embeddings [..., dim]."""
    w = params["project_out"]["w"]
    return indices_to_codes(cfg, indices).to(w.dtype) @ w + \
        params["project_out"]["b"]

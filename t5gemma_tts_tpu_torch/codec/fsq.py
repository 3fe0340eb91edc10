"""Finite Scalar Quantization (counterpart of
``t5gemma_tts_tpu/codec/fsq.py``), the XCodec2 single-codebook quantizer:

  bound(z) = tanh(z + shift) * half_l - offset        (per dim)
  digits   = round(bound(z))
  code     = digits / half_width   in [-1, 1]
  index    = sum_d (digit_d + half_width_d) * basis_d,  basis = cumprod(levels)

Encode is ``project_in`` -> bound -> round -> index; decode is index ->
codes by closed-form digit arithmetic, then ``project_out``.
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


def _levels(cfg: FSQConfig, device) -> torch.Tensor:
    return torch.tensor(cfg.levels, dtype=torch.float32, device=device)


def _basis(cfg: FSQConfig, device) -> torch.Tensor:
    return torch.tensor(np.concatenate([[1], np.cumprod(cfg.levels[:-1])]),
                        dtype=torch.int64, device=device)


def _half_width(cfg: FSQConfig, device) -> torch.Tensor:
    return torch.tensor([l // 2 for l in cfg.levels], dtype=torch.float32,
                        device=device)


def bound(cfg: FSQConfig, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """z [..., codebook_dim] -> the bounded values that are rounded."""
    levels = _levels(cfg, z.device)
    half_l = (levels - 1) * (1 + eps) / 2
    offset = torch.where(levels % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z.float() + shift) * half_l - offset


def rounding_margin(cfg: FSQConfig, z: torch.Tensor) -> torch.Tensor:
    """[...]: the least distance, over the codebook dims, of ``bound(z)``
    from a rounding boundary (a half-integer). Two computations of one code
    that differ in the last bits can round to two codes only where this is
    small."""
    bounded = bound(cfg, z)
    return (0.5 - (bounded - torch.round(bounded)).abs()).amin(dim=-1)


def quantize(cfg: FSQConfig, z: torch.Tensor) -> torch.Tensor:
    """z [..., codebook_dim] -> normalized codes in [-1, 1]."""
    return torch.round(bound(cfg, z)) / _half_width(cfg, z.device)


def codes_to_indices(cfg: FSQConfig, codes: torch.Tensor) -> torch.Tensor:
    """Normalized codes [..., d] -> int64 indices [...]."""
    half = _half_width(cfg, codes.device)
    digits = torch.round(codes * half + half).long()
    return (digits * _basis(cfg, codes.device)).sum(dim=-1)


def encode(params: Dict, cfg: FSQConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., dim] -> (quantized [..., dim], indices [...])."""
    codes = quantize(cfg, x @ params["project_in"]["w"]
                     + params["project_in"]["b"])
    w = params["project_out"]["w"]
    return (codes.to(w.dtype) @ w + params["project_out"]["b"],
            codes_to_indices(cfg, codes))


def indices_to_codes(cfg: FSQConfig, indices: torch.Tensor) -> torch.Tensor:
    """int indices [...] -> normalized codes [..., d] in [-1, 1]."""
    dev = indices.device
    half = _half_width(cfg, dev)
    digits = torch.div(indices.long()[..., None], _basis(cfg, dev),
                       rounding_mode="floor") % _levels(cfg, dev).long()
    return (digits.float() - half) / half


def decode(params: Dict, cfg: FSQConfig, indices: torch.Tensor) -> torch.Tensor:
    """indices [...] -> dequantized embeddings [..., dim]."""
    w = params["project_out"]["w"]
    return indices_to_codes(cfg, indices).to(w.dtype) @ w + \
        params["project_out"]["b"]

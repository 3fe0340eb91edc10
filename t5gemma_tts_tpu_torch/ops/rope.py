"""Rotary position embeddings with float (progress) position ids.

Counterpart of ``t5gemma_tts_tpu/ops/rope.py``: standard RoPE in
self-attention and PM-RoPE (progress-monitoring RoPE) in cross-attention,
whose positions are the float fraction of the target duration elapsed,
scaled by ``progress_scale``. cos/sin are computed in float32 and cast to
the activation dtype at application.
"""

from __future__ import annotations

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] float32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., T] -> (cos, sin), each [..., T, head_dim] float32,
    with the HF layout emb = concat(freqs, freqs)."""
    inv = rope_inv_freq(head_dim, theta, positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, hd]; cos/sin: [B, T, hd] -> broadcast over heads."""
    c = cos[:, None].to(x.dtype)
    s = sin[:, None].to(x.dtype)
    return x * c + rotate_half(x) * s


def progress_position_ids(lengths: torch.Tensor, max_len: int,
                          progress_scale: float) -> torch.Tensor:
    """PM position ids pos / (len - 1) * scale (length clamped to >= 2),
    0 beyond each length. float32 [B, max_len]."""
    pos = torch.arange(max_len, dtype=torch.float32,
                       device=lengths.device)[None, :]
    denom = lengths.clamp_min(2).float()[:, None] - 1.0
    ids = pos / denom * progress_scale
    return torch.where(pos < lengths[:, None].float(), ids, 0.0)


def decode_step_position(current_index: torch.Tensor, est_total: torch.Tensor,
                         progress_scale: float) -> torch.Tensor:
    """PM position of one generated token at absolute ``current_index``:
    idx / max(1, est_total - 1) * scale, clamped to at most the scale."""
    denom = (est_total - 1).clamp_min(1).float()
    val = current_index.float() / denom * progress_scale
    return val.clamp_max(progress_scale)

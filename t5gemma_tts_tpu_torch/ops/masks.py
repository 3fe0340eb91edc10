"""Attention masks as additive f32 biases [B, 1, Tq, Tk] (0 = attend,
NEG_INF = blocked). Counterpart of ``t5gemma_tts_tpu/ops/masks.py``."""

from __future__ import annotations

from typing import Optional

import torch

# Large-negative instead of -inf: fully masked softmax rows stay finite.
NEG_INF = -2.0 ** 30


def pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at padded positions. lengths [B] -> bool [B, max_len]."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def _key_valid(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return (~pad_mask(lengths, t))[:, None, None, :]


def _bias(ok: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def encoder_self_bias(lengths, t: int, dtype=torch.float32):
    """Bidirectional full attention: key must be non-pad."""
    return _bias(_key_valid(lengths, t), dtype)


def encoder_sliding_bias(lengths, t: int, window: int, dtype=torch.float32):
    """Bidirectional sliding window |q - k| < window, key non-pad."""
    q = torch.arange(t, device=lengths.device)[:, None]
    k = torch.arange(t, device=lengths.device)[None, :]
    near = (q - window < k) & (k < q + window)
    return _bias(near[None, None] & _key_valid(lengths, t), dtype)


def decoder_self_bias(lengths, t: int, dtype=torch.float32):
    """Causal + key padding."""
    q = torch.arange(t, device=lengths.device)[:, None]
    k = torch.arange(t, device=lengths.device)[None, :]
    return _bias((k <= q)[None, None] & _key_valid(lengths, t), dtype)


def decoder_sliding_bias(lengths, t: int, window: int, dtype=torch.float32):
    """Causal sliding window q - window < k <= q, + key padding."""
    q = torch.arange(t, device=lengths.device)[:, None]
    k = torch.arange(t, device=lengths.device)[None, :]
    causal = ((k <= q) & (q - window < k))[None, None]
    return _bias(causal & _key_valid(lengths, t), dtype)


def cross_bias(enc_lengths, tq: int, tk: int, dtype=torch.float32):
    """Decoder -> encoder: encoder key padding only, [B, 1, Tq, Tk]."""
    return _bias(_key_valid(enc_lengths, tk), dtype).expand(
        enc_lengths.shape[0], 1, tq, tk)


def step_self_bias(q_pos: torch.Tensor, t_max: int,
                   window: Optional[int] = None, dtype=torch.float32):
    """Single-step decode bias over a preallocated cache: keys k <= q and,
    with ``window``, q - window < k. Returns [B, 1, 1, t_max]."""
    k = torch.arange(t_max, device=q_pos.device)[None, :]
    q = q_pos[:, None]
    ok = k <= q
    if window is not None:
        ok = ok & (q - window < k)
    return _bias(ok[:, None, None, :], dtype)

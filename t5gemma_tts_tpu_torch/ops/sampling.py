"""Sampling filters: temperature -> min-p -> top-k -> top-p -> categorical.

Counterpart of ``t5gemma_tts_tpu/ops/sampling.py`` with the same filtering
semantics (top-k keeps ties at the threshold, top-p keeps the first token
that crosses it, min-p is active only when every row keeps a survivor and
then bypasses top-k/top-p). The draw takes its randomness from an explicit
``torch.Generator`` (Gumbel-max, like ``jax.random.categorical``); JAX's
threefry stream has no torch counterpart, so draws are held to the JAX
package by their distribution and greedy paths by token equality.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .masks import NEG_INF


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Descending order with ties in JAX's order (reversed stable argsort)."""
    return torch.argsort(x, dim=-1, stable=True).flip(-1)


def _apply_top_k(logits, top_k: int, min_tokens_to_keep: int):
    k = min(max(top_k, min_tokens_to_keep), logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, NEG_INF, logits)


def _shift_right(remove: torch.Tensor) -> torch.Tensor:
    """Always keep the first token that crosses the top-p threshold."""
    return torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                     dim=-1)


def _apply_top_p(logits, top_p: float, min_tokens_to_keep: int):
    order = _desc_order(logits)
    sorted_logits = torch.gather(logits, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum > top_p
    if min_tokens_to_keep > 1:
        remove_sorted[..., :min_tokens_to_keep] = False
    remove_sorted = _shift_right(remove_sorted)
    remove = torch.zeros_like(remove_sorted).scatter(-1, order, remove_sorted)
    return torch.where(remove, NEG_INF, logits)


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0,
                  min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Exact batched filter of [B, V] logits."""
    if logits.ndim != 2:
        raise ValueError("filter_logits expects [B, V]")
    filtered = logits
    if top_k and top_k > 0:
        filtered = _apply_top_k(filtered, top_k, min_tokens_to_keep)
    if top_p < 1.0:
        filtered = _apply_top_p(filtered, top_p, min_tokens_to_keep)
    if 0.0 < min_p < 1.0:
        remove = torch.softmax(logits, dim=-1) < min_p
        active = (remove.sum(-1) < logits.shape[-1]).all()
        minp_filtered = torch.where(remove, NEG_INF, logits)
        filtered = torch.where(active, minp_filtered, filtered)
    return filtered


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick ->
    int64 [B]."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_(min=tiny, max=1.0 - 2 ** -24)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
           temperature: float = 1.0) -> torch.Tensor:
    """Temperature + filter + categorical draw -> int32 [B]."""
    if temperature != 1.0:
        logits = logits / temperature
    filtered = filter_logits(logits, top_k=top_k, top_p=top_p, min_p=min_p)
    return categorical(filtered, generator).to(torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_candidates(vals: torch.Tensor, idx: torch.Tensor, top_k: int,
                      top_p: float = 1.0, temperature: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filtering half of :func:`sample_from_candidates`: candidate
    logits [B, K] (any order) -> (kept logits sorted descending with
    removed entries at NEG_INF, their token ids)."""
    if not (top_k > 0 and vals.shape[-1] >= top_k):
        raise ValueError("need 0 < top_k <= number of candidates")
    if temperature != 1.0:
        vals = vals / temperature
    order = _desc_order(vals)
    vals = torch.gather(vals, -1, order)
    idx = torch.gather(idx, -1, order)
    thresh = vals[..., top_k - 1:top_k]
    kept = torch.where(vals < thresh, NEG_INF, vals)
    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(kept, dim=-1), dim=-1)
        kept = torch.where(_shift_right(cum > top_p), NEG_INF, kept)
    return kept, idx


def sample_from_candidates(generator: Optional[torch.Generator],
                           vals: torch.Tensor, idx: torch.Tensor, top_k: int,
                           top_p: float = 1.0,
                           temperature: float = 1.0) -> torch.Tensor:
    """Sampling over a pre-extracted top-(k+2) candidate set -> int32 [B].
    The engine's logit adjustments only lower at most two tokens, so the
    adjusted top-k lies inside the raw top-(k+2) and filtering here equals
    adjust-then-filter over the whole vocabulary."""
    kept, idx = filter_candidates(vals, idx, top_k, top_p, temperature)
    choice = categorical(kept, generator)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)

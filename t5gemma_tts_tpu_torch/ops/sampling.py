"""Sampling filters: temperature -> min-p -> top-k -> top-p -> categorical.

Counterpart of ``t5gemma_tts_tpu/ops/sampling.py`` with the same filtering
semantics (top-k keeps ties at the threshold, top-p keeps the first token
that crosses it, min-p is active only when every row keeps a survivor and
then bypasses top-k/top-p). The draw is Gumbel-max, like
``jax.random.categorical``, over uniforms that the caller passes in.

The decode engine's uniforms come from :func:`step_uniform`, a
counter-based hash of (seed, step, row, column) computed in integer tensor
ops (the counterpart of JAX's ``fold_in(rng, step)``): no generator state,
so a CUDA graph captures it with the seed and the step in device tensors,
and the CPU and the card draw the same bits. JAX's threefry stream has no
torch counterpart, so draws are held to the JAX package by their
distribution and greedy paths by token equality.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .masks import NEG_INF

_M32 = 0xFFFFFFFF
IntLike = Union[int, torch.Tensor]


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche finaliser on int64 lanes that hold uint32 values.
    Both multipliers are odd and below 2**31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    return x ^ (x >> 16)


def _absorb(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mix a 32-bit word ``v`` into the hash state ``h``."""
    return _fmix32(h ^ _fmix32((v + 0x9E3779B9) & _M32))


def as_int64(v: IntLike, device) -> torch.Tensor:
    """An int, or an integer tensor, as int64 on ``device`` (a Python int
    is taken modulo 2**64, as a signed 64-bit value)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    v = (int(v) + 2 ** 63) % 2 ** 64 - 2 ** 63
    return torch.full((), v, dtype=torch.int64, device=device)


def step_uniform(seed: IntLike, step: IntLike, rows: int, cols: int,
                 device=None, row0: IntLike = 0) -> torch.Tensor:
    """Uniforms [rows, cols] f32 in (0, 1), a function of (seed, step, row,
    column) alone: a counter-based hash, so the draws of a decode step do
    not depend on which pass makes them, nor on the device. ``seed`` (64
    bits) and ``step`` may be ints or 0-dim device tensors. Each value is
    ``(2 m + 1) / 2**24`` for the hash's top 23 bits ``m``: exact in f32,
    never 0 or 1. The rows are global rows ``row0 .. row0 + rows - 1`` (an
    int or a 0-dim device tensor: a data-parallel rank's first row), so a
    rank draws its rows of the whole batch's draws."""
    if device is None:
        device = next((v.device for v in (seed, step)
                       if isinstance(v, torch.Tensor)), "cpu")
    seed, step = as_int64(seed, device), as_int64(step, device)
    h = _absorb(_fmix32(seed & _M32), (seed >> 32) & _M32)
    h = _absorb(h, step & _M32)
    r = _absorb(h, torch.arange(rows, dtype=torch.int64, device=device)
                + as_int64(row0, device))
    c = _fmix32(torch.arange(cols, dtype=torch.int64, device=device)
                + 0x632BE5AB)
    x = _fmix32(r[:, None] ^ c[None, :])
    return ((x >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def row_uniform(seeds: torch.Tensor, steps: torch.Tensor,
                cols: int) -> torch.Tensor:
    """Per-request draws (continuous batching): uniforms [B, cols] whose row
    r is bit for bit row 0 of ``step_uniform(seeds[r], steps[r], 1,
    cols)``, so a request draws the same numbers in any slot as it would
    alone at batch 1. ``seeds`` and ``steps`` are [B] integer tensors."""
    seeds = seeds.to(torch.int64)
    h = _absorb(_fmix32(seeds & _M32), (seeds >> 32) & _M32)
    h = _absorb(h, steps.to(torch.int64) & _M32)
    r = _absorb(h, torch.zeros_like(h))
    c = _fmix32(torch.arange(cols, dtype=torch.int64, device=seeds.device)
                + 0x632BE5AB)
    x = _fmix32(r[:, None] ^ c[None, :])
    return ((x >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def fold_seed(seed: int, data: int) -> int:
    """A 64-bit seed derived from ``seed`` and the count ``data`` by the
    same hash as the draws (the counterpart of JAX's ``fold_in(key,
    data)``), as a signed 64-bit int."""
    t = torch.tensor([as_int64(seed, "cpu").item(), data], dtype=torch.int64)
    h = _absorb(_fmix32(t[:1] & _M32), (t[:1] >> 32) & _M32)
    lo = _absorb(h, t[1:] & _M32)
    hi = _absorb(lo, torch.ones_like(lo))
    return as_int64(int(hi[0]) << 32 | int(lo[0]), "cpu").item()


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


def categorical(logits: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick over
    ``uniforms`` (logits' shape, values in (0, 1)) -> int64 [B]."""
    return torch.argmax(logits.float() - torch.log(-torch.log(uniforms)),
                        dim=-1)


def sample(logits: torch.Tensor, uniforms: torch.Tensor, top_k: int = 0,
           top_p: float = 1.0, min_p: float = 0.0,
           temperature: float = 1.0) -> torch.Tensor:
    """Temperature + filter + categorical draw -> int32 [B]."""
    if temperature != 1.0:
        logits = logits / temperature
    filtered = filter_logits(logits, top_k=top_k, top_p=top_p, min_p=min_p)
    return categorical(filtered, uniforms).to(torch.int32)


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


def sample_from_candidates(uniforms: torch.Tensor,
                           vals: torch.Tensor, idx: torch.Tensor, top_k: int,
                           top_p: float = 1.0,
                           temperature: float = 1.0) -> torch.Tensor:
    """Sampling over a pre-extracted top-(k+2) candidate set -> int32 [B].
    The engine's logit adjustments only lower at most two tokens, so the
    adjusted top-k lies inside the raw top-(k+2) and filtering here equals
    adjust-then-filter over the whole vocabulary. ``uniforms`` [B, K] in
    (0, 1) drive the draw, one per candidate slot in sorted order."""
    kept, idx = filter_candidates(vals, idx, top_k, top_p, temperature)
    choice = categorical(kept, uniforms)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)

"""LoRA fine-tuning: low-rank adapters over the backbone projections.

Counterpart of ``t5gemma_tts_tpu/train/lora.py``. The adapters live in a
tree of their own that mirrors the parameters, ``{"a": [L, d_in, r], "b":
[L, r, d_out]}`` at each adapted stacked projection and ``None`` at every
other leaf. :func:`wrap` hands the model factored :class:`LoraWeight`
leaves over the detached base, which ``ops/quant.q_matmul`` multiplies as
``x @ W + ((x @ A) @ B) * scale``: the base stays frozen in place and the
backward touches only adapter-sized tensors. :func:`apply` materializes
``W + (alpha / r) A B`` (validation), :func:`merge` folds the adapters into
plain weights (export, or serving after ``fuse_for_decode``).

Under tensor parallelism the adapters stay whole on every rank while the
base holds this rank's block (``parallel/tensor.py``). On a column-split
base leaf the rank adds ``(x @ A) @ B[:, its columns]``; on a row-split one
(``o``, ``down``) ``(x_block @ A[its rows]) @ B``, a partial sum that the
product's own all-reduce completes. Both factors enter through
``tp.copy_to_model``, so their gradients are summed over the model group
and come out whole and equal on every rank. :func:`apply` cuts the update
to the base's block; :func:`merge` takes whole leaves
(``parallel.gather_params``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..parallel import tensor as tp

PyTree = Any

DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


@dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    # adapt backbone attention + mlp only
    subtrees: Tuple[str, ...] = ("encoder", "decoder")

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _is_target(path, cfg: LoraConfig) -> bool:
    keys = list(path)
    if not keys or keys[0] not in cfg.subtrees:
        return False
    if "layers" not in keys:
        return False
    return keys[-1] in cfg.targets and any(
        k in ("self_attn", "cross_attn", "mlp") for k in keys)


def init_adapters(gen: torch.Generator, params: PyTree,
                  cfg: LoraConfig) -> PyTree:
    """Adapter tree with A ~ N(0, 1/r) and B = 0 (the standard LoRA init),
    drawn from ``gen`` in the tree's sorted-key order on ``gen``'s device;
    ``None`` marks the leaves that are not adapted."""

    def make(path, leaf):
        if isinstance(leaf, dict):
            return {k: make(path + (k,), leaf[k]) for k in sorted(leaf)}
        if not _is_target(path, cfg) or leaf.ndim != 3:
            return None
        n_layers, d_in, d_out = leaf.shape
        a = torch.randn((n_layers, d_in, cfg.r), generator=gen,
                        dtype=torch.float32, device=gen.device) / cfg.r
        b = torch.zeros((n_layers, cfg.r, d_out), dtype=leaf.dtype,
                        device=leaf.device)
        return {"a": a.to(leaf.dtype).to(leaf.device), "b": b}

    return make((), params)


def _combine_trees(params: PyTree, adapters: Optional[PyTree],
                   fn: Callable) -> PyTree:
    if isinstance(params, dict):
        return {k: _combine_trees(v, None if adapters is None
                                  else adapters.get(k), fn)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_combine_trees(v, None if adapters is None else adapters[i],
                               fn) for i, v in enumerate(params)]
    return fn(params, adapters)


class LoraWeight:
    """A factored LoRA leaf: ``q_matmul`` computes x@W + ((x@A)@B) * scale;
    ``models/t5gemma.layer_params`` slices it per layer."""

    def __init__(self, w, a, b, scale: float):
        self.w, self.a, self.b = w, a, b
        self.scale = scale

    @property
    def ndim(self):
        return self.w.ndim

    @property
    def shape(self):
        return self.w.shape

    def layer(self, li: int) -> "LoraWeight":
        return LoraWeight(self.w[li], self.a[li], self.b[li], self.scale)


def wrap(params: PyTree, adapters: PyTree, cfg: LoraConfig) -> PyTree:
    """Params with adapted leaves replaced by :class:`LoraWeight` over the
    detached base; the other leaves detached."""
    def combine(p, ad):
        if ad is None:
            return p.detach()
        a, b = ad["a"], ad["b"]
        rows, cols = p.shape[-2] != a.shape[-2], p.shape[-1] != b.shape[-1]
        if rows or cols:                # a tensor-parallel block of p
            a = tp.local_block(a, -2) if rows else tp.copy_to_model(a)
            b = tp.local_block(b, -1) if cols else tp.copy_to_model(b)
        return LoraWeight(p.detach(), a, b, cfg.scale)

    return _combine_trees(params, adapters, combine)


def _delta(ad, cfg: LoraConfig) -> torch.Tensor:
    return torch.einsum("lir,lro->lio", ad["a"].float(),
                        ad["b"].float()) * cfg.scale


def _block(delta: torch.Tensor, like: torch.Tensor,
           rank: int) -> torch.Tensor:
    """``delta`` cut to the shape of ``like``, a model rank's block of it
    (the whole of it outside tensor parallelism)."""
    for d in (-2, -1):
        n = like.shape[d]
        if delta.shape[d] != n:
            delta = delta.narrow(d, rank * n, n)
    return delta


def apply(params: PyTree, adapters: PyTree, cfg: LoraConfig,
          tp_rank: int = 0) -> PyTree:
    """Effective params: frozen base + scaled low-rank update (``params``
    may hold model rank ``tp_rank``'s blocks)."""
    def combine(p, ad):
        if ad is None:
            return p.detach()
        return p.detach() + _block(_delta(ad, cfg), p, tp_rank).to(p.dtype)

    return _combine_trees(params, adapters, combine)


def merge(params: PyTree, adapters: PyTree, cfg: LoraConfig) -> PyTree:
    """Fold the adapters into plain weights (export and serving)."""
    def combine(p, ad):
        if ad is None:
            return p
        with torch.no_grad():
            return (p.float() + _delta(ad, cfg)).to(p.dtype)

    return _combine_trees(params, adapters, combine)

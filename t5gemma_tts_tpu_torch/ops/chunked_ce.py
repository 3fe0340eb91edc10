"""Chunked-vocabulary cross-entropy through the prediction head.

Counterpart of ``t5gemma_tts_tpu/ops/chunked_ce.py`` (an XLA custom VJP,
no Pallas kernel): the per-token nll and top-10 hit of the 2-layer head
over ``hidden`` are computed in vocab blocks of ``chunk`` columns with an
online logsumexp, the target logit gathered from the block that holds it
and a running top-10 of values, so the ``[B, T, Va]`` logits never exist.
The backward (:class:`HeadNllTop10`) recomputes each block's logits and
feeds ``d nll / d logits = softmax - onehot`` block by block; it recomputes
the head's first layer under autograd for the ``w1`` / ``b1`` / ``hidden``
pulls and casts ``dlogits`` to the model dtype where the JAX backward does.

Top-10 ties: a target whose logit equals the 10th largest value counts as
a hit (rank by value), where the dense ``token_loss`` ranks by index.

Under tensor parallelism (``parallel/tensor.py``) ``w1`` / ``b1`` hold a
column block of the head's hidden and ``w2`` the matching row block: each
block's logits are this rank's partial product summed over the model group
before the bias, the log-sum-exp and the top 10; in the backward the
hidden's pull ``dlogits @ w2_blockᵀ`` stays local and the head's input
gathers its gradient through ``tp.copy_to_model``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..parallel import mesh as mesh_mod
from ..parallel import tensor as tp


def _h2(w1, b1, hidden):
    """Post-GELU intermediate of the head (model dtype, exact erf GELU)."""
    return F.gelu(hidden @ w1 + b1)


def _block_logits(w2, b2, h2, st: int, en: int, group=None) -> torch.Tensor:
    """f32 logits for vocab columns [st, en): the product in the model
    dtype, then upcast, as the dense path does (``group``: the partial
    products summed over the model group first)."""
    if group is None:
        return (h2 @ w2[:, st:en] + b2[st:en]).float()
    part = mesh_mod.all_reduce((h2 @ w2[:, st:en]).contiguous(), group)
    return (part + b2[st:en]).float()


def _blocks(va: int, chunk: int) -> List[Tuple[int, int]]:
    return [(st, min(st + chunk, va)) for st in range(0, va, chunk)]


def _compute(chunk: int, w1, b1, w2, b2, hidden, targets, group=None):
    """One pass over the vocab blocks -> (nll, top10 hit, lse)."""
    h2 = _h2(w1, b1, hidden)
    va = w2.shape[1]
    b, t = targets.shape
    k = min(10, va)
    dev = hidden.device
    m = torch.full((b, t), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros((b, t), dtype=torch.float32, device=dev)
    tgt = torch.zeros((b, t), dtype=torch.float32, device=dev)
    run_k = torch.full((b, t, k), float("-inf"), dtype=torch.float32,
                       device=dev)
    targets = targets.long()
    for st, en in _blocks(va, chunk):
        logits = _block_logits(w2, b2, h2, st, en, group)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, :, None]).sum(dim=-1)
        m = m_new
        in_blk = (targets >= st) & (targets < en)
        idx = (targets - st).clamp(0, en - st - 1)
        tl = torch.gather(logits, -1, idx[:, :, None])[..., 0]
        tgt = tgt + torch.where(in_blk, tl, torch.zeros_like(tl))
        blk_top = torch.topk(logits, min(k, en - st), dim=-1).values
        run_k = torch.topk(torch.cat([run_k, blk_top], dim=-1), k,
                           dim=-1).values
    lse = m + torch.log(s)
    nll = lse - tgt
    hit = tgt >= run_k[..., k - 1]
    return nll, hit, lse


class HeadNllTop10(torch.autograd.Function):
    """(nll [B, T] f32, top10 hit [B, T] bool) with the chunked backward."""

    @staticmethod
    def forward(ctx, chunk, w1, b1, w2, b2, hidden, targets, group=None):
        nll, hit, lse = _compute(chunk, w1, b1, w2, b2, hidden, targets,
                                 group)
        ctx.chunk = chunk
        ctx.group = group
        ctx.save_for_backward(w1, b1, w2, b2, hidden, targets, lse)
        ctx.mark_non_differentiable(hit)
        return nll, hit

    @staticmethod
    def backward(ctx, g_nll, _g_hit):
        w1, b1, w2, b2, hidden, targets, lse = ctx.saved_tensors
        need = ctx.needs_input_grad     # (chunk, w1, b1, w2, b2, hidden, -)
        g_nll = g_nll.float()
        targets = targets.long()
        va = w2.shape[1]
        with torch.enable_grad():
            first = [t.detach().requires_grad_(n)
                     for t, n in zip((w1, b1, hidden),
                                     (need[1], need[2], need[5]))]
            h2 = _h2(*first)
        h2d = h2.detach()
        dw2, db2 = [], []
        dh2 = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        for st, en in _blocks(va, ctx.chunk):
            logits = _block_logits(w2, b2, h2d, st, en, ctx.group)
            softmax = torch.exp(logits - lse[:, :, None])
            cols = torch.arange(st, en, device=logits.device)
            onehot = (targets[:, :, None] == cols).float()
            # d nll / d logits, cast to the model dtype at the boundary of
            # the dense path's logits.astype(f32)
            dlogits = (g_nll[:, :, None] * (softmax - onehot)).to(h2.dtype)
            if need[3]:
                dw2.append(torch.einsum("btd,btv->dv", h2d, dlogits)
                           .to(w2.dtype))
            if need[4]:
                db2.append(dlogits.sum(dim=(0, 1)).to(b2.dtype))
            dh2 = dh2 + (dlogits @ w2[:, st:en].T).float()
        wanted = [t for t in first if t.requires_grad]
        pulled = iter(torch.autograd.grad(h2, wanted, dh2.to(h2.dtype))
                      if wanted else ())
        dw1, db1, dhidden = (next(pulled) if t.requires_grad else None
                             for t in first)
        return (None,
                dw1.to(w1.dtype) if dw1 is not None else None,
                db1.to(b1.dtype) if db1 is not None else None,
                torch.cat(dw2, dim=1) if need[3] else None,
                torch.cat(db2, dim=0) if need[4] else None,
                dhidden, None, None)


def head_nll_top10(chunk: int, head: Dict[str, torch.Tensor],
                   hidden: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll [B, T] f32, top10 hit [B, T] bool) of the 2-layer prediction
    head over ``hidden`` [B, T, D] against integer ``targets`` [B, T], in
    vocab blocks of ``chunk`` columns (never materializing [B, T, Va])."""
    group = None
    if tp.splits(head["w1"], hidden.shape[-1]):
        hidden = tp.copy_to_model(hidden)
        group = tp.active().model_group
    return HeadNllTop10.apply(chunk, head["w1"], head["b1"], head["w2"],
                              head["b2"], hidden, targets, group)

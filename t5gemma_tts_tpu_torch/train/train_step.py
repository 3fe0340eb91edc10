"""The training step: gradient accumulation, NaN guard, optimizer update.

Counterpart of ``t5gemma_tts_tpu/train/train_step.py``. A step runs the
forward and backward of each micro-batch (the leading axis of the batch's
tensors), accumulates the gradients in f32 weighted by each micro-batch's
counted tokens, divides by their total, takes the global grad norm, and
updates. A step whose norm is not finite keeps the old parameters and
optimizer state and counts a skip.

:func:`make_train_step` trains the whole parameter tree;
:func:`make_lora_train_step` trains an adapter tree over a frozen base
(``lora.wrap``: factored leaves, the base detached).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..config import VoiceConfig
from ..models import voice
from ..utils.tree import flatten as _flat
from ..utils.tree import unflatten as _unflat
from . import optim

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: Any                   # ScaledAdamState | AdamWState
    step: torch.Tensor         # completed optimizer steps (0-dim int32)
    nan_skips: torch.Tensor    # skipped (non-finite) steps (0-dim int32)


def opt_init(params: PyTree, ocfg) -> Any:
    if isinstance(ocfg, optim.AdamWConfig):
        return optim.adamw_init(params)
    return optim.init(params, ocfg)


def opt_update(grads, opt_state, params, lr, ocfg):
    if isinstance(ocfg, optim.AdamWConfig):
        return optim.adamw_update(grads, opt_state, params, lr, ocfg)
    return optim.update(grads, opt_state, params, lr, ocfg)


def _int0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_state(params: PyTree, ocfg) -> TrainState:
    dev = _flat(params)[1][0].device
    return TrainState(params=params, opt=opt_init(params, ocfg),
                      step=_int0(dev), nan_skips=_int0(dev))


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    mean_ce: torch.Tensor
    perplexity: torch.Tensor
    top10acc: torch.Tensor
    ntokens: torch.Tensor
    grad_norm: torch.Tensor
    nan_step: torch.Tensor
    lr: torch.Tensor


def _micro(batch: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batch.items()}


def accumulate_grads(target: PyTree, batch: Dict[str, torch.Tensor],
                     forward: Callable[[PyTree, Dict], voice.VoiceOutputs]):
    """The forward and backward of each micro-batch of ``batch`` (its
    tensors' leading axis) -> (gradients of ``target``, token-weighted and
    divided by the total in f32; sums: loss, token-weighted CE, top-10 hits
    and counted tokens)."""
    leaves = _flat(target)[1]
    dev = leaves[0].device
    live = [t.detach().requires_grad_(True) for t in leaves]
    tree = _unflat(target, live)
    acc_g = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
             for t in leaves]
    f32 = dict(dtype=torch.float32, device=dev)
    sums = dict(loss=torch.zeros((), **f32), ce=torch.zeros((), **f32),
                top10=torch.zeros((), dtype=torch.int64, device=dev),
                ntok=torch.zeros((), **f32))
    n_micro = next(iter(batch.values())).shape[0]
    for i in range(n_micro):
        with torch.enable_grad():
            out = forward(tree, _micro(batch, i))
            ntok = out.effective_ntokens.float()
            loss = out.loss / torch.clamp(ntok, min=1.0)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        for a, g in zip(acc_g, grads):
            if g is not None:
                a.addcmul_(g.float(), ntok)
        sums["loss"] = sums["loss"] + out.loss.detach()
        sums["ce"] = sums["ce"] + out.mean_ce.detach() * ntok
        sums["top10"] = sums["top10"] + out.top10acc
        sums["ntok"] = sums["ntok"] + ntok
    ntok = torch.clamp(sums["ntok"], min=1.0)
    return _unflat(target, [g.div_(ntok) for g in acc_g]), sums


def apply_grads(target: PyTree, opt_state, grads: PyTree, sums, lr, ocfg):
    """The optimizer update from :func:`accumulate_grads`' output, under
    the NaN guard -> (new target, new opt state, metrics). The guard reads
    the grad norm's finiteness to the host: a non-finite step keeps the old
    parameters and optimizer state (the JAX step computes the update on
    zeroed gradients and selects the old values; the result is the same)."""
    flat = _flat(grads)[1]
    dev = flat[0].device
    grad_norm = torch.sqrt(sum((g * g).sum() for g in flat))
    finite = torch.isfinite(grad_norm)
    if bool(finite):
        new_target, new_opt = opt_update(grads, opt_state, target, lr, ocfg)
    else:
        new_target, new_opt = target, opt_state
    ntok = torch.clamp(sums["ntok"], min=1.0)
    metrics = StepMetrics(
        loss=sums["loss"] / ntok, mean_ce=sums["ce"] / ntok,
        perplexity=torch.exp(sums["ce"] / ntok),
        top10acc=sums["top10"].float() / ntok, ntokens=sums["ntok"],
        grad_norm=grad_norm, nan_step=(~finite).to(torch.int32),
        lr=torch.as_tensor(lr, dtype=torch.float32, device=dev))
    return new_target, new_opt, metrics


def _step(target: PyTree, opt_state, batch, lr, ocfg,
          forward: Callable[[PyTree, Dict], voice.VoiceOutputs]):
    """One optimizer step of ``target`` (the tree that trains) over the
    micro-batches of ``batch`` -> (new target, new opt state, metrics)."""
    grads, sums = accumulate_grads(target, batch, forward)
    return apply_grads(target, opt_state, grads, sums, lr, ocfg)


def make_train_step(cfg: VoiceConfig, ocfg):
    """fn(state, batch, lr) -> (state, metrics); ``batch`` tensors are
    [n_micro, per_micro, ...]."""

    def forward(params, mb):
        return voice.forward(params, cfg, mb)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr) -> Tuple[TrainState, StepMetrics]:
        params, opt, metrics = _step(state.params, state.opt, batch, lr,
                                     ocfg, forward)
        return TrainState(params=params, opt=opt, step=state.step + 1,
                          nan_skips=state.nan_skips + metrics.nan_step), \
            metrics

    return train_step


def make_eval_step(cfg: VoiceConfig):
    @torch.no_grad()
    def eval_step(params, batch) -> StepMetrics:
        out = voice.forward(params, cfg, batch)
        ntok = torch.clamp(out.effective_ntokens.float(), min=1.0)
        zero = torch.zeros((), dtype=torch.float32, device=ntok.device)
        return StepMetrics(
            loss=out.loss / ntok, mean_ce=out.mean_ce,
            perplexity=out.perplexity,
            top10acc=out.top10acc.float() / ntok,
            ntokens=out.effective_ntokens.float(), grad_norm=zero,
            nan_step=torch.zeros((), dtype=torch.int32, device=ntok.device),
            lr=zero)

    return eval_step


def make_lora_train_step(cfg: VoiceConfig, ocfg, lcfg):
    """fn(adapters, opt_state, base_params, batch, lr) -> (adapters,
    opt_state, metrics): the optimizer runs over the adapters only, the
    base stays frozen."""
    from . import lora as lora_mod

    def train_step(adapters, opt_state, base_params, batch, lr):
        def forward(ads, mb):
            return voice.forward(lora_mod.wrap(base_params, ads, lcfg), cfg,
                                 mb)

        return _step(adapters, opt_state, batch, lr, ocfg, forward)

    return train_step

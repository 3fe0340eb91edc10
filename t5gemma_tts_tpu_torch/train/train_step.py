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

Over a mesh (a ``parallel.Layout`` of the trained tree) each rank runs its
rows of the global batch, split over the model group where the leaves are
(``parallel/tensor.py``). Each micro-batch's CE weight and token counts are
summed over the data group, so each rank weighs its gradient by its share
of the global mean CE; the weighted gradient sums and the metrics' sums are
all-reduced over the data group and divided by the global token count. The
step is the one-process step over the same global batch, up to the order of
summation (at one rank, the same arithmetic). The grad norm counts a
replicated leaf once across the model group, so every rank reads the same
finiteness and takes the same branch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..config import VoiceConfig
from ..models import voice
from ..parallel import mesh as mesh_mod
from ..parallel import tensor as tp
from ..utils.tree import flatten as _flat
from ..utils.tree import unflatten as _unflat
from . import optim

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: Any                   # ScaledAdamState | AdamWState
    step: torch.Tensor         # completed optimizer steps (0-dim int32)
    nan_skips: torch.Tensor    # skipped (non-finite) steps (0-dim int32)


def opt_init(params: PyTree, ocfg, layout=None) -> Any:
    if isinstance(ocfg, optim.AdamWConfig):
        return optim.adamw_init(params, layout)
    return optim.init(params, ocfg, layout)


def opt_update(grads, opt_state, params, lr, ocfg, layout=None):
    if isinstance(ocfg, optim.AdamWConfig):
        return optim.adamw_update(grads, opt_state, params, lr, ocfg, layout)
    return optim.update(grads, opt_state, params, lr, ocfg, layout)


def _int0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_state(params: PyTree, ocfg, layout=None) -> TrainState:
    dev = _flat(params)[1][0].device
    return TrainState(params=params, opt=opt_init(params, ocfg, layout),
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


def _micro_grads(target: PyTree, batch: Dict[str, torch.Tensor],
                 forward: Callable[[PyTree, Dict], voice.VoiceOutputs]):
    """(outputs, counted tokens, gradients of ``target``'s leaves) of each
    micro-batch of ``batch`` (its tensors' leading axis): the gradient of
    the loss over its counted tokens."""
    live = [t.detach().requires_grad_(True) for t in _flat(target)[1]]
    tree = _unflat(target, live)
    for i in range(next(iter(batch.values())).shape[0]):
        with torch.enable_grad():
            out = forward(tree, _micro(batch, i))
            ntok = out.effective_ntokens.float()
            loss = out.loss / torch.clamp(ntok, min=1.0)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        yield out, ntok, grads


def _zeros(target: PyTree):
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in _flat(target)[1]]


def _add(acc_g, grads, weight) -> None:
    for a, g in zip(acc_g, grads):
        if g is not None:
            a.addcmul_(g.float(), weight)


def _data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed in place over the data group (no mesh: ``x``)."""
    return x if mesh is None else mesh_mod.all_reduce(x, mesh.data_group)


def accumulate_grads(target: PyTree, batch: Dict[str, torch.Tensor],
                     forward: Callable[[PyTree, Dict], voice.VoiceOutputs],
                     mesh=None):
    """The forward and backward of each micro-batch of ``batch`` (its
    tensors' leading axis) -> (gradients of ``target``, token-weighted and
    divided by the total in f32; sums: loss, token-weighted CE, top-10 hits
    and counted tokens). Each micro-batch's gradient is weighed by the
    global token count times this rank's share of the global CE weight;
    without a mesh the share is 1 and the weight the micro-batch's token
    count. ``mesh``: ``batch`` holds this rank's rows, and the gradients
    and sums come out global (module docstring)."""
    acc_g = _zeros(target)
    ce_parts, top10, ntoks = [], [], []
    with tp.model_parallel(mesh):
        for out, ntok, grads in _micro_grads(target, batch, forward):
            tot = _data_sum(torch.stack(
                [out.ce_weight.float(), ntok]).double(), mesh).float()
            share = out.ce_weight.float() / torch.clamp(tot[0], min=1e-8)
            _add(acc_g, grads, tot[1] * share)
            ce_parts.append(out.mean_ce.detach() * share)
            top10.append(out.top10acc)
            ntoks.append(tot[1])
    for a in acc_g:
        _data_sum(a, mesh)
    parts = _data_sum(torch.stack(
        [c.double() for c in ce_parts]
        + [torch.stack(top10).sum().double()]), mesh)
    f32 = dict(dtype=torch.float32, device=acc_g[0].device)
    sums = dict(loss=torch.zeros((), **f32), ce=torch.zeros((), **f32),
                top10=parts[-1].long(), ntok=torch.zeros((), **f32))
    for ce, ntok in zip(parts[:-1].float(), ntoks):
        sums["loss"] = sums["loss"] + ce * ntok
        sums["ce"] = sums["ce"] + ce * ntok
        sums["ntok"] = sums["ntok"] + ntok
    ntok = torch.clamp(sums["ntok"], min=1.0)
    return _unflat(target, [g.div_(ntok) for g in acc_g]), sums


def grad_norm_of(flat, layout=None) -> torch.Tensor:
    """The global gradient norm (over a mesh: a replicated leaf once)."""
    return torch.sqrt(optim._model_total(
        [(i, (g * g).sum()) for i, g in enumerate(flat)], layout))


def apply_grads(target: PyTree, opt_state, grads: PyTree, sums, lr, ocfg,
                layout=None):
    """The optimizer update from :func:`accumulate_grads`' output, under
    the NaN guard -> (new target, new opt state, metrics). The guard reads
    the grad norm's finiteness to the host: a non-finite step keeps the old
    parameters and optimizer state (the JAX step computes the update on
    zeroed gradients and selects the old values; the result is the same).
    ``layout``: the trained tree's place on the mesh."""
    flat = _flat(grads)[1]
    dev = flat[0].device
    grad_norm = grad_norm_of(flat, layout)
    finite = torch.isfinite(grad_norm)
    if bool(finite):
        new_target, new_opt = opt_update(grads, opt_state, target, lr, ocfg,
                                         layout)
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
          forward: Callable[[PyTree, Dict], voice.VoiceOutputs], layout=None):
    """One optimizer step of ``target`` (the tree that trains) over the
    micro-batches of ``batch`` -> (new target, new opt state, metrics)."""
    grads, sums = accumulate_grads(target, batch, forward,
                                   None if layout is None else layout.mesh)
    return apply_grads(target, opt_state, grads, sums, lr, ocfg, layout)


def make_train_step(cfg: VoiceConfig, ocfg, layout=None):
    """fn(state, batch, lr) -> (state, metrics); ``batch`` tensors are
    [n_micro, per_micro, ...] (over a mesh, this rank's rows)."""

    def forward(params, mb):
        return voice.forward(params, cfg, mb)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr) -> Tuple[TrainState, StepMetrics]:
        params, opt, metrics = _step(state.params, state.opt, batch, lr,
                                     ocfg, forward, layout)
        return TrainState(params=params, opt=opt, step=state.step + 1,
                          nan_skips=state.nan_skips + metrics.nan_step), \
            metrics

    return train_step


def make_eval_step(cfg: VoiceConfig, mesh=None):
    """fn(params, batch) -> StepMetrics of one batch; over a mesh
    (``batch`` this rank's rows) the metrics are the global batch's."""

    @torch.no_grad()
    def eval_step(params, batch) -> StepMetrics:
        with tp.model_parallel(mesh):
            out = voice.forward(params, cfg, batch)
        mean_ce, top10 = out.mean_ce, out.top10acc.float()
        ntokens = out.effective_ntokens.float()
        if mesh is not None:
            tot = mesh_mod.all_reduce(torch.stack(
                [mean_ce * out.ce_weight, out.ce_weight, top10,
                 ntokens]).double(), mesh.data_group).float()
            mean_ce = tot[0] / torch.clamp(tot[1], min=1e-8)
            top10, ntokens = tot[2], tot[3]
        ntok = torch.clamp(ntokens, min=1.0)
        zero = torch.zeros((), dtype=torch.float32, device=ntok.device)
        return StepMetrics(
            loss=mean_ce * ntokens / ntok, mean_ce=mean_ce,
            perplexity=torch.exp(mean_ce), top10acc=top10 / ntok,
            ntokens=ntokens, grad_norm=zero,
            nan_step=torch.zeros((), dtype=torch.int32, device=ntok.device),
            lr=zero)

    return eval_step


def make_lora_train_step(cfg: VoiceConfig, ocfg, lcfg, layout=None):
    """fn(adapters, opt_state, base_params, batch, lr) -> (adapters,
    opt_state, metrics): the optimizer runs over the adapters only, the
    base stays frozen (over a mesh: this rank's blocks of the base,
    ``layout`` the adapters')."""
    from . import lora as lora_mod

    def train_step(adapters, opt_state, base_params, batch, lr):
        def forward(ads, mb):
            return voice.forward(lora_mod.wrap(base_params, ads, lcfg), cfg,
                                 mb)

        return _step(adapters, opt_state, batch, lr, ocfg, forward, layout)

    return train_step

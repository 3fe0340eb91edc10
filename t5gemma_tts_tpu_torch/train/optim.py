"""ScaledAdam + Eden, AdamW and Eve, as pure functions over tensor trees.

Counterpart of ``t5gemma_tts_tpu/train/optim.py`` (icefall's ScaledAdam:
parameter-rms-scaled updates, a learned per-tensor scale refreshed every
``size_update_period`` steps, median-based adaptive clipping over the last
``clipping_update_period`` norms, one ``delta`` momentum; plain Adam for
"scalarish" leaves). ``init`` builds the state, ``update`` maps (grads,
state, params, lr) to (new params, new state) without touching its inputs.

Leaves under a ``layers`` / ``blocks`` key carry a leading stack axis
(``_is_stacked``): each layer's slice is its own tensor for the rms, the
scale and the scalarish test. The step-dependent factors (``beta2 **
(step + 1)``, the bias corrections, the Eden factor) are f32 tensors, as in
the JAX functions. ScaledAdam reads its step counter to the host once an
update and takes its periodic branches (the rms refresh, the learned-scale
step, the clip threshold's refresh) only on their steps, where the JAX
function selects with ``where``: the same values, without the work and
the full-size temporaries of the branches not taken.

Over a mesh (``layout``, a ``parallel.Layout``) each rank holds its
tensor-parallel block of every leaf and, under ZeRO-1, only its slice of
the moments: a leaf's reductions (the rms, ``sum(p * g)``, Eve's norm) are
summed over the model group where the leaf is split, the model-wide sums
(the clipping norm, AdamW's gradient norm) count a replicated leaf once,
the elementwise update runs on this rank's slice, and the new parameter
slices are all-gathered over the data group. Without a layout nothing of
this runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..utils.tree import flatten as _flat
from ..utils.tree import keystr
from ..utils.tree import unflatten as _unflat

PyTree = Any
F32 = torch.float32


@dataclass(frozen=True)
class ScaledAdamConfig:
    betas: Tuple[float, float] = (0.9, 0.95)
    clipping_scale: Optional[float] = 2.0
    scalar_lr_scale: float = 0.1
    eps: float = 1e-8
    param_min_rms: float = 1e-5
    param_max_rms: float = 3.0
    scalar_max: float = 10.0
    size_update_period: int = 4
    clipping_update_period: int = 600


class ScaledAdamState(NamedTuple):
    step: torch.Tensor              # 0-dim int32
    delta: PyTree                   # momentum of updates, like params
    exp_avg_sq: PyTree              # like params
    param_rms: PyTree               # per-tensor rms, stack axis kept
    scale_exp_avg_sq: PyTree        # like param_rms
    scale_grads: PyTree             # [size_update_period, *param_rms.shape]
    model_norms: torch.Tensor       # [clipping_update_period] ring buffer
    norm_threshold: torch.Tensor    # 0-dim f32 clipping threshold


def _is_stacked(path) -> bool:
    """Leaves under a 'layers' / 'blocks' key carry a leading stack axis."""
    return any(k in ("layers", "blocks") for k in path)


def _reduce_dims(leaf: torch.Tensor, stacked: bool) -> Tuple[int, ...]:
    start = 1 if (stacked and leaf.ndim >= 1) else 0
    return tuple(range(start, leaf.ndim))


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    return x.mean(dim=dims, keepdim=True) if dims else x


def _sum(x: torch.Tensor, dims) -> torch.Tensor:
    return x.sum(dim=dims, keepdim=True) if dims else x


def _is_scalarish(p: torch.Tensor, stacked: bool, shape=None) -> bool:
    """One element per real tensor (plain Adam for these); ``shape``: the
    whole leaf's, where ``p`` is a block of it."""
    shape = tuple(p.shape if shape is None else shape)
    numel = 1
    for n in shape:
        numel *= n
    if stacked:
        return numel == (shape[0] if shape else 1)
    return numel == 1


def _leaf_mean(x: torch.Tensor, dims, layout, i: int) -> torch.Tensor:
    """``_mean`` over the whole leaf ``i`` (its blocks summed over the
    model group where it is split)."""
    if layout is None or not layout.split(i):
        return _mean(x, dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return layout.model_sum(x.sum(dim=dims, keepdim=True), i) / (
        count * layout.mesh.tp)


def _rms(p: torch.Tensor, stacked: bool, layout=None, i: int = 0
         ) -> torch.Tensor:
    """The rms of leaf ``i`` (each layer's, where stacked)."""
    return torch.sqrt(_leaf_mean(p.float() ** 2, _reduce_dims(p, stacked),
                                 layout, i))


def _leaf_sum(x: torch.Tensor, dims, layout, i: int) -> torch.Tensor:
    s = _sum(x, dims)
    return s if layout is None else layout.model_sum(s, i)


def _model_total(parts, layout) -> torch.Tensor:
    """sum(parts) over the whole model: ``parts`` holds each leaf's
    (index, value); a replicated leaf counts once across the model group."""
    if layout is None:
        return sum(v for _, v in parts)
    total = sum((v for i, v in parts if layout.counted_here(i)),
                torch.zeros((), dtype=F32, device=parts[0][1].device))
    return layout.model_sum(total)


def _slicer(layout, i: int, like: torch.Tensor):
    return (lambda x: x) if layout is None else layout.slicer(i, like)


def _gathered(layout, leaves):
    if layout is None:
        return leaves
    return [layout.gather_slice(i, x) for i, x in enumerate(leaves)]


def _scalar(x, like: torch.Tensor, dtype=F32) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=like.device)


def init(params: PyTree, cfg: ScaledAdamConfig,
         layout=None) -> ScaledAdamState:
    """``layout``: ``params`` are this rank's blocks (the moments its
    ZeRO-1 slices)."""
    paths, leaves = _flat(params)
    dev = leaves[0].device
    rms = [_rms(p, _is_stacked(path), layout, i)
           for i, (path, p) in enumerate(zip(paths, leaves))]
    zeros = [torch.zeros(_slicer(layout, i, p)(p).shape, dtype=F32,
                         device=p.device) for i, p in enumerate(leaves)]
    return ScaledAdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        delta=_unflat(params, zeros),
        exp_avg_sq=_unflat(params, [z.clone() for z in zeros]),
        param_rms=_unflat(params, rms),
        scale_exp_avg_sq=_unflat(params, [torch.zeros_like(r) for r in rms]),
        scale_grads=_unflat(params, [
            torch.zeros((cfg.size_update_period, *r.shape), dtype=F32,
                        device=r.device) for r in rms]),
        model_norms=torch.zeros((cfg.clipping_update_period,), dtype=F32,
                                device=dev),
        norm_threshold=torch.zeros((), dtype=F32, device=dev),
    )


@torch.no_grad()
def update(grads: PyTree, state: ScaledAdamState, params: PyTree,
           lr: torch.Tensor, cfg: ScaledAdamConfig, layout=None
           ) -> Tuple[PyTree, ScaledAdamState]:
    beta1, beta2 = cfg.betas
    period = cfg.size_update_period
    s = int(state.step)         # the step's branches, decided on the host
    step = state.step
    paths, leaves_p = _flat(params)
    stacked = [_is_stacked(p) for p in paths]
    leaves_g = [g.float() for g in _flat(grads)[1]]
    leaves_p32 = [p.float() for p in leaves_p]
    shapes = ([None] * len(leaves_p) if layout is None else layout.shapes)
    rms_list = _flat(state.param_rms)[1]
    dev = step.device
    lr = torch.as_tensor(lr, dtype=F32, device=dev)
    stepf = torch.tensor(s, dtype=F32, device=dev)

    # adaptive clipping
    model_norms, norm_threshold = state.model_norms, state.norm_threshold
    if cfg.clipping_scale is not None:
        tot_norm = torch.sqrt(_model_total(
            [(i, (g * g).sum() if _is_scalarish(p, st, shapes[i])
              else ((g * r) ** 2).sum())
             for i, (g, r, p, st) in enumerate(zip(
                 leaves_g, rms_list, leaves_p32, stacked))], layout))
        cup = cfg.clipping_update_period
        model_norms = model_norms.clone()
        model_norms[s % cup] = tot_norm
        if s % cup == 0 and s > 0:      # refresh the threshold
            median = torch.sort(model_norms).values[(cup // 4) * 2]
            norm_threshold = cfg.clipping_scale * median
        if s >= cup:
            clip = torch.clamp(norm_threshold / (tot_norm + 1e-20), max=1.0)
            leaves_g = [g * clip for g in leaves_g]

    delta_list = _flat(state.delta)[1]
    eas_list = _flat(state.exp_avg_sq)[1]
    seas_list = _flat(state.scale_exp_avg_sq)[1]
    sg_list = _flat(state.scale_grads)[1]
    new_p, new_delta, new_eas, new_rms, new_seas, new_sg = ([] for _ in
                                                            range(6))
    is_rms_step = s % period == period - 1
    do_size = is_rms_step and s > 0
    bias2m = 1 - beta2 ** (stepf + 1)
    # 1 - beta2 ** (s + 1) < 0.99 until step 89 (beta2 0.95)
    corrected = 1 - beta2 ** (s + 1) < 0.99

    for i, (p, g, delta, eas, rms, seas, sgrads, st) in enumerate(zip(
            leaves_p32, leaves_g, delta_list, eas_list, rms_list, seas_list,
            sg_list, stacked)):
        zs = _slicer(layout, i, p)      # this rank's ZeRO-1 slice
        gz = zs(g)
        delta = beta1 * delta
        eas = (beta2 * eas).addcmul_(gz, gz, value=1 - beta2)
        if _is_scalarish(p, st, shapes[i]):
            # plain Adam for scalars
            denom = torch.sqrt(eas / bias2m) + cfg.eps
            delta = delta - lr * cfg.scalar_lr_scale * (1 - beta1) * gz / denom
            new_p.append(torch.clamp(zs(p), -cfg.scalar_max, cfg.scalar_max)
                         + delta)
            new_delta.append(delta)
            new_eas.append(eas)
            new_rms.append(rms)
            new_seas.append(seas)
            new_sg.append(sgrads)
            continue

        dims = _reduce_dims(p, st)
        sgrads = sgrads.clone()
        sgrads[s % period] = _leaf_sum(p * g, dims, layout, i)
        if is_rms_step:                 # periodic rms refresh
            rms = torch.sqrt(_leaf_mean(p * p, dims, layout, i))
        if do_size:                     # the learned-scale step
            beta2c = beta2 ** period
            seas = beta2c * seas + (1 - beta2c) * (sgrads ** 2).mean(dim=0)
            size_step = torch.tensor((s + 1) // period, dtype=F32,
                                     device=dev)
            bias2 = 1 - beta2c ** size_step
            size_lr = lr * cfg.scalar_lr_scale
            scale_step = (-size_lr * torch.sqrt(torch.clamp(bias2, min=0.0))
                          * sgrads.sum(dim=0) / (torch.sqrt(seas) + cfg.eps))
            scale_step = torch.where(rms < cfg.param_min_rms,
                                     torch.zeros_like(scale_step), scale_step)
            scale_step = torch.where(rms > cfg.param_max_rms,
                                     (-size_lr * period).expand_as(scale_step),
                                     scale_step)
            delta.add_((1 - beta1) * zs(p) * zs(scale_step))

        # main rms-scaled Adam step
        denom = (eas / torch.clamp(bias2m, min=1e-8) if corrected
                 else eas.clone()).sqrt_().add_(cfg.eps)
        alpha = -lr * (1 - beta1) * torch.clamp(rms, min=cfg.param_min_rms)
        delta.add_(torch.div(gz, denom, out=denom).mul_(zs(alpha)))
        new_p.append(zs(p) + delta)
        new_delta.append(delta)
        new_eas.append(eas)
        new_rms.append(rms)
        new_seas.append(seas)
        new_sg.append(sgrads)

    cast = _gathered(layout, [n.to(o.dtype) for n, o in zip(new_p, leaves_p)])
    return _unflat(params, cast), ScaledAdamState(
        step=step + 1,
        delta=_unflat(params, new_delta),
        exp_avg_sq=_unflat(params, new_eas),
        param_rms=_unflat(params, new_rms),
        scale_exp_avg_sq=_unflat(params, new_seas),
        scale_grads=_unflat(params, new_sg),
        model_norms=model_norms,
        norm_threshold=norm_threshold,
    )


# ---------------------------------------------------------------------------
# AdamW and Eve
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


@dataclass(frozen=True)
class AdamWConfig:
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-2
    grad_clip: float = 1.0


def adamw_init(params: PyTree, layout=None) -> AdamWState:
    leaves = _flat(params)[1]

    def zeros():
        return _unflat(params, [
            torch.zeros(_slicer(layout, i, p)(p).shape, dtype=F32,
                        device=p.device) for i, p in enumerate(leaves)])

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      mu=zeros(), nu=zeros())


def _adam_moments(g, m, v, b1, b2):
    g = g.float()
    return b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree,
                 lr: torch.Tensor, cfg: AdamWConfig, layout=None):
    b1, b2 = cfg.betas
    flat_g = _flat(grads)[1]
    if cfg.grad_clip and cfg.grad_clip > 0:
        gsq = _model_total([(i, (g.float() ** 2).sum())
                            for i, g in enumerate(flat_g)], layout)
        scale = torch.clamp(cfg.grad_clip / (torch.sqrt(gsq) + 1e-6), max=1.0)
        flat_g = [g * scale for g in flat_g]
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=F32, device=step.device)
    out_p, out_m, out_v = [], [], []
    for i, (p, g, m, v) in enumerate(zip(_flat(params)[1], flat_g,
                                         _flat(state.mu)[1],
                                         _flat(state.nu)[1])):
        zs = _slicer(layout, i, p)
        m, v = _adam_moments(zs(g), m, v, b1, b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = zs(p).float()
        p32 = p32 - lr * (upd + cfg.weight_decay * p32)
        out_p.append(p32.to(p.dtype))
        out_m.append(m)
        out_v.append(v)
    out_p = _gathered(layout, out_p)
    return _unflat(params, out_p), AdamWState(
        step=step, mu=_unflat(params, out_m), nu=_unflat(params, out_v))


@dataclass(frozen=True)
class EveConfig:
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    weight_decay: float = 1e-3
    target_rms: float = 0.1


def eve_init(params: PyTree, layout=None) -> AdamWState:
    return adamw_init(params, layout)


@torch.no_grad()
def eve_update(grads: PyTree, state: AdamWState, params: PyTree,
               lr: torch.Tensor, cfg: EveConfig, layout=None):
    """AdamW whose weight decay applies only while a tensor's rms exceeds
    ``target_rms``."""
    b1, b2 = cfg.betas
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=F32, device=step.device)
    out_p, out_m, out_v = [], [], []
    for i, (p, g, m, v) in enumerate(zip(_flat(params)[1], _flat(grads)[1],
                                         _flat(state.mu)[1],
                                         _flat(state.nu)[1])):
        zs = _slicer(layout, i, p)
        m, v = _adam_moments(zs(g), m, v, b1, b2)
        denom = torch.sqrt(v) * bc2 ** -0.5 + cfg.eps
        p32 = p.float()
        numel = p.numel() * (1 if layout is None or not layout.split(i)
                             else layout.mesh.tp)
        if numel > 1:
            if layout is None or not layout.split(i):
                norm = torch.linalg.vector_norm(p32.reshape(-1))
            else:
                norm = torch.sqrt(layout.model_sum((p32 * p32).sum(), i))
            above = norm > cfg.target_rms * numel ** 0.5
            p32 = zs(p32) * (1 - cfg.weight_decay * above.float())
        else:
            p32 = zs(p32)
        p32 = p32 - (lr / bc1) * m / denom
        out_p.append(p32.to(p.dtype))
        out_m.append(m)
        out_v.append(v)
    out_p = _gathered(layout, out_p)
    return _unflat(params, out_p), AdamWState(
        step=step, mu=_unflat(params, out_m), nu=_unflat(params, out_v))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def eden_lr(base_lr: float, batch, epoch, lr_batches: float,
            lr_epochs: float, warmup_batches: float) -> torch.Tensor:
    """Eden schedule, an f32 0-dim tensor; the trainer maps epoch = step //
    pseudo_epoch_size + 1."""
    batch = torch.as_tensor(batch, dtype=F32)
    epoch = torch.as_tensor(epoch, dtype=F32)
    factor = (((batch ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
              * (((epoch ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25))
    warmup = torch.where(batch >= warmup_batches, _scalar(1.0, batch),
                         0.5 + 0.5 * batch / max(warmup_batches, 1e-8))
    return base_lr * factor * warmup


def linear_warmup_decay_lr(base_lr: float, step, total_steps: int,
                           warmup_steps: float) -> torch.Tensor:
    """Linear warmup then linear decay (the AdamW path)."""
    step = torch.as_tensor(step, dtype=F32)
    warm = step / max(float(warmup_steps), 1.0)
    decay = torch.clamp((total_steps - step)
                        / max(float(total_steps - warmup_steps), 1.0),
                        min=0.0)
    return base_lr * torch.where(step < warmup_steps, warm, decay)


def dominant_parameter_report(grads: PyTree, state: ScaledAdamState,
                              params: PyTree, top_k: int = 3):
    """Which tensors dominate the clipped quantity sum((grad * param_rms)^2):
    ``[{name, proportion, sumsq, grad_sumsq, rms_sq}, ...]`` sorted by
    proportion, names in ``jax.tree_util.keystr``'s form. Host-side, for
    logging."""
    paths, leaves_p = _flat(params)
    leaves_g = _flat(grads)[1]
    rms_list = _flat(state.param_rms)[1]
    rows = []
    for path, p, g, r in zip(paths, leaves_p, leaves_g, rms_list):
        g = g.detach().float().cpu()
        if _is_scalarish(p, _is_stacked(path)):
            sumsq = float((g ** 2).sum())
            rms_sq = 1.0
        else:
            r = r.detach().float().cpu()
            sumsq = float(((g * r) ** 2).sum())
            rms_sq = float((r ** 2).mean())
        rows.append({"name": keystr(path), "sumsq": sumsq,
                     "grad_sumsq": float((g ** 2).sum()), "rms_sq": rms_sq})
    tot = max(sum(row["sumsq"] for row in rows), 1e-30)
    for row in rows:
        row["proportion"] = row["sumsq"] / tot
    rows.sort(key=lambda row: row["proportion"], reverse=True)
    return rows[:top_k]

"""Tensor-parallel collectives under autograd (Megatron-style).

The training forward reads the model group from :func:`model_parallel`'s
context and a leaf's block shape from the tree: a projection whose block is
narrower than the whole leaf is split. A column-split product takes its
input through :func:`copy_to_model` (identity forward, all-reduce of the
gradient), a row-split product's output goes through
:func:`reduce_from_model` (all-reduce forward, identity backward), and a
vocabulary-split embedding is a masked lookup followed by that all-reduce.
Outside the context (or at ``tp == 1``) every function here is the plain
computation, so the one-device paths are unchanged.

Serving runs the same forward without autograd, and adds what decoding
needs: the inference collectives (:func:`model_sum` in f32 or int32,
:func:`model_max`), :func:`row_product` (a row-split product as the
one-process product gives it: bf16 partials summed in f32 and cast once,
W8A8 / W4A8 blocks through ``ops/quant``'s row-split kernels),
:func:`decode_stack` (the int8 / int4 decoder stack in parts, the model
group's reductions handed to ``ops/megakernel``, which knows no mesh) and
the rank's head counts read from its leaves (:func:`attention_dims`,
:func:`mlp_split`). A leaf narrower than its model's width outside
:func:`model_parallel` raises: a shard is never run as a whole model.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import megakernel, quant
from ..ops.quant import Int4Weight, QuantWeight
from . import mesh as mesh_mod

# the mesh whose model group the enclosed forward is split over. A module
# value, not a per-thread one: autograd runs a CUDA backward, and with it a
# rematerialized layer's forward, on a thread of its own, which must see it
_STATE = {"mesh": None}


@contextlib.contextmanager
def model_parallel(mesh: Optional[mesh_mod.Mesh]):
    """Run the enclosed forward (and backward, and decode) split over
    ``mesh``'s model group; a mesh with ``tp == 1`` (or None) splits
    nothing, and gives a data-parallel decode its first row
    (:func:`first_row`)."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = prev


def active() -> Optional[mesh_mod.Mesh]:
    """The enclosing mesh when it splits the model (``tp > 1``)."""
    mesh = _STATE["mesh"]
    return mesh if mesh is not None and mesh.tp > 1 else None


def first_row(rows: int) -> int:
    """The global index of this rank's first batch row, for a batch of
    ``rows`` rows a rank (:func:`mesh.shard_batch`'s spans): 0 outside a
    mesh."""
    mesh = _STATE["mesh"]
    return 0 if mesh is None else mesh.dp_rank * rows


# ---------------------------------------------------------------------------
# the inference collectives: no autograd; nothing at tp == 1
# ---------------------------------------------------------------------------


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group: floats in f32 (cast back to
    ``x``'s dtype once), integers in int32. A new tensor; ``x`` itself
    outside a split."""
    mesh = active()
    if mesh is None:
        return x
    with torch.no_grad():
        if x.is_floating_point():
            buf = x.to(torch.float32, copy=True).contiguous()
        else:
            buf = x.to(torch.int32, copy=True).contiguous()
        mesh_mod.all_reduce(buf, mesh.model_group)
    return buf.to(x.dtype)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elementwise maximum over the model group (a new tensor;
    ``x`` itself outside a split)."""
    mesh = active()
    if mesh is None:
        return x
    with torch.no_grad():
        buf = x.clone().contiguous()
        mesh_mod.all_reduce(buf, mesh.model_group, op="max")
    return buf


# ---------------------------------------------------------------------------
# a rank's widths, from its leaves
# ---------------------------------------------------------------------------


def in_width(w) -> int:
    """K of a [..., K, N] weight leaf: a tensor, a LoRA leaf, or an int8
    ``QuantWeight`` / int4 ``Int4Weight`` (stored [..., N, K])."""
    if isinstance(w, Int4Weight):
        return 2 * w.packed.shape[-1]
    if isinstance(w, QuantWeight):
        return w.values.shape[-1]
    return w.shape[-2]


def out_width(w) -> int:
    """N of a [..., K, N] weight leaf."""
    if isinstance(w, (QuantWeight, Int4Weight)):
        return w.n
    return w.shape[-1]


def is_block(local: int, full: int, what: str) -> bool:
    """Whether a leaf ``local`` wide is a block of ``full``; a block
    outside :func:`model_parallel` raises."""
    if local == full:
        return False
    if active() is None:
        raise ValueError(
            f"{what} is {local} wide against the model's {full}: a tensor-"
            f"parallel shard, which runs only inside "
            f"parallel.tensor.model_parallel(mesh)")
    return True


def attention_dims(p, dims):
    """(``dims`` with this rank's ``num_heads`` and ``num_kv_heads``,
    split?) for the attention leaves ``p`` (q/k/v/o, or fused qkv and o):
    the heads are read from the leaves, whole heads by the specs' rule."""
    hd = dims.head_dim
    heads = in_width(p["o"]) // hd
    if not is_block(heads, dims.num_heads, "an attention's o"):
        return dims, False
    if "k" in p:
        kv = out_width(p["k"]) // hd
    else:
        kv = (out_width(p["qkv"]) - heads * hd) // (2 * hd)
    return dataclasses.replace(dims, num_heads=heads, num_kv_heads=kv), True


def mlp_split(p, dims) -> bool:
    """Whether the MLP leaves ``p`` hold a block of the intermediate."""
    return is_block(in_width(p["down"]), dims.intermediate_size,
                    "an MLP's down")


def local_dims(layers, dims):
    """(``dims`` with the heads and the intermediate width of a stack's
    layer leaves ``layers``: a rank's own, which size its caches and its
    decode-layer kernels; whether the heads are split; whether F is)."""
    adims, attn = attention_dims(layers["self_attn"], dims)
    mlp = mlp_split(layers["mlp"], dims)
    return (dataclasses.replace(
        adims, intermediate_size=in_width(layers["mlp"]["down"])), attn, mlp)


def row_product(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a row-split leaf ``w`` (this rank's K rows) and ``x``
    its columns of the activations, summed over the model group. While
    autograd records (training): the product, then the all-reduce pair.
    Without it (serving): the one-process product's value, W8A8 / W4A8
    blocks through ``quant.rows_matmul`` (the group's scales, int32 sums),
    a bf16 leaf as f32 partial products summed in f32 and cast once (one
    rounding, as the one-process product has)."""
    mesh = active()
    if mesh is None:
        return quant.q_matmul(x, w)
    if torch.is_grad_enabled():
        return reduce_from_model(quant.q_matmul(x, w))
    if isinstance(w, (QuantWeight, Int4Weight)):
        if isinstance(w, QuantWeight) and w.act_bits == 16:
            raise ValueError("W8A16 weights under tensor parallelism are "
                             "ROADMAP Queue 1 item 15 part D")
        *lead, k = x.shape
        out = quant.rows_matmul(x.reshape(-1, k), w, model_max, model_sum)
        return out.reshape(*lead, w.n)
    if isinstance(w, torch.Tensor) and x.dtype != torch.float32:
        return model_sum(_f32_product(x, w)).to(x.dtype)
    return model_sum(quant.q_matmul(x, w))


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 (or f16) operands with the f32 accumulator as the
    result: on the card one GEMM over the weight as it is stored (no f32
    copy of it), on the CPU the product of f32 copies."""
    if x.device.type != "cuda":
        return x.float() @ w.float()
    *lead, k = x.shape
    out = torch.mm(x.reshape(-1, k), w, out_dtype=torch.float32)
    return out.reshape(*lead, w.shape[-1])


def decode_stack(layers, dims, ldims, **args):
    """``megakernel.decode_stack_tp`` of this rank's decoder block (its
    widths ``ldims``: :func:`local_dims`) with the model group's reductions
    between the parts; the arguments as ``megakernel.decode_stack``'s."""
    f = ldims.intermediate_size
    k0 = active().tp_rank * f if f != dims.intermediate_size else 0
    return megakernel.decode_stack_tp(layers, dims, ldims, k0=k0,
                                      group_max=model_max,
                                      group_sum=model_sum, **args)


def refuse(what: str) -> None:
    """Raise for a path that does not run under tensor parallelism yet."""
    if active() is not None:
        raise ValueError(f"{what} under tensor parallelism (tp > 1) is "
                         f"ROADMAP Queue 1 item 15 part D")


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return mesh_mod.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split product: ``x`` forward, its gradient
    summed over the model group."""
    mesh = active()
    return x if mesh is None else _Copy.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-split product's partial output summed over the model group."""
    mesh = active()
    return x if mesh is None else _Reduce.apply(x, mesh.model_group)


def local_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of a replicated tensor along ``dim``, its
    gradient summed over the model group (so the whole tensor's gradient
    is complete on every rank)."""
    mesh = active()
    n = x.shape[dim] // mesh.tp
    return copy_to_model(x).narrow(dim, mesh.tp_rank * n, n)


def splits(leaf, full: int) -> bool:
    """Whether ``leaf`` (a [..., in, out] weight) holds a column block of a
    projection ``full`` columns wide on this rank."""
    return active() is not None and leaf.shape[-1] != full


def vocab_embedding(ids: torch.Tensor, weight: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """``F.embedding(ids, weight)`` over a table of ``vocab`` rows, of
    which this rank may hold one block: the rows it holds looked up, the
    others zero, summed over the model group."""
    ids = ids.long()
    mesh = active()
    if mesh is None or weight.shape[0] == vocab:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids - mesh.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), weight)
    out = out * inside[..., None].to(out.dtype)
    return reduce_from_model(out)

"""Tensor-parallel collectives under autograd (Megatron-style).

The training forward reads the model group from :func:`model_parallel`'s
context and a leaf's block shape from the tree: a projection whose block is
narrower than the whole leaf is split. A column-split product takes its
input through :func:`copy_to_model` (identity forward, all-reduce of the
gradient), a row-split product's output goes through
:func:`reduce_from_model` (all-reduce forward, identity backward), and a
vocabulary-split embedding is a masked lookup followed by that all-reduce.
Outside the context (or at ``tp == 1``) every function here is the plain
computation, so the one-device paths and the decode paths are unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import mesh as mesh_mod

# the mesh whose model group the enclosed forward is split over. A module
# value, not a per-thread one: autograd runs a CUDA backward, and with it a
# rematerialized layer's forward, on a thread of its own, which must see it
_STATE = {"mesh": None}


@contextlib.contextmanager
def model_parallel(mesh: Optional[mesh_mod.Mesh]):
    """Run the enclosed forward (and backward) split over ``mesh``'s model
    group; a mesh with ``tp == 1`` (or None) changes nothing."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh if mesh is not None and mesh.tp > 1 else None
    try:
        yield
    finally:
        _STATE["mesh"] = prev


def active() -> Optional[mesh_mod.Mesh]:
    return _STATE["mesh"]


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


def attention_dims(p, dims):
    """(the head counts of this rank's attention block, split?) for the
    q/k/v/o leaves ``p``: whole heads, so ``dims`` with this rank's
    ``num_heads`` and ``num_kv_heads``."""
    if active() is None or "q" not in p:
        return dims, False
    heads = p["q"].shape[-1] // dims.head_dim
    if heads == dims.num_heads:
        return dims, False
    return dataclasses.replace(
        dims, num_heads=heads,
        num_kv_heads=p["k"].shape[-1] // dims.head_dim), True


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

"""Process groups and sharding rules: data- and tensor-parallel training.

Counterpart of ``t5gemma_tts_tpu/parallel/mesh.py``. The JAX package runs
one SPMD program over a device mesh and lets GSPMD place the collectives;
here every rank is a process of its own (``torchrun``: one rank per card,
NCCL; ``--device cpu``: gloo), holds its shard of each leaf and calls the
collectives itself. The mesh is the JAX mesh's ``(data, model)`` grid:
``np.arange(world).reshape(dp, tp)``, so the ranks of one data-parallel row
are contiguous and each process's batch rows are one span.

- ``data``: the batch is split over the data group (:func:`shard_batch`);
  gradients are all-reduced over it, and under ZeRO-1 the optimizer's
  moments are split over it too (:func:`zero_spec`), each rank updating its
  slice and all-gathering the new parameters.
- ``model``: Megatron-style tensor parallelism (``parallel/tensor.py``):
  attention heads, the MLP hidden, the text vocabulary and the head's
  hidden are split, with one all-reduce after each row-split product.

:func:`param_specs` names each leaf's split axis by JAX's rules (by path,
with JAX's divisibility fallback) and two rules of its own, because a rank
here computes with whole tensors where GSPMD may gather inside a program:

- q/k/v/o leaves are split only into whole heads: where ``tp`` does not
  divide a stack's kv-head count, the four leaves of that attention stay
  replicated (JAX may split inside a head);
- the head's ``b1`` is split with ``w1``'s columns (JAX keeps it
  replicated).

The serving half: :func:`serving_shard` turns the whole one-process
decode tree into a rank's serving tree (quantized whole first, so a
row-split block keeps the per-channel scales of the whole K; then cut by
the same rules, the fused ``qkv`` / ``gate_up`` leaves segment by segment,
so that a rank's fused leaf is ``[q_r | k_r | v_r]`` / ``[gate_r | up_r]``);
:func:`serving_dims` gives a rank's head counts for its caches; and
:func:`shard_slot_state` splits a dense continuous-batching state over the
data axis (JAX ``shard_slot_state``). The decode paths then run a rank's
shard inside ``parallel.tensor.model_parallel(mesh)``.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.tree import flatten, tree_map, tree_map_with_path, unflatten

PyTree = Any

DATA_AXIS = "data"
MODEL_AXIS = "model"
_MOMENT_FIELDS = ("delta", "exp_avg_sq", "mu", "nu")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups.

    ``data_group`` holds the ranks of this rank's column (same model
    index), ``model_group`` those of its row. A mesh without groups (the
    tests' stand-in for another rank) serves the pure functions."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def lead(self) -> bool:
        """Rank 0: the one that logs and writes."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.dp if axis == DATA_AXIS else self.tp

    def index(self, axis: str) -> int:
        return self.dp_rank if axis == DATA_AXIS else self.tp_rank

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# the process group's timeout, which the mesh's groups take too
_TIMEOUT: Dict[str, Optional[timedelta]] = {"value": None}
# this rank's device, as init_distributed chose it
_DEVICE: Dict[str, Optional[torch.device]] = {"value": None}


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     timeout: Optional[timedelta] = None,
                     gloo_on_cuda: bool = False) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; rank 0 of 1 without them) and return
    this rank's device: NCCL on ``cuda:LOCAL_RANK``, gloo only when the
    caller passes ``cpu``. A failing NCCL start
    raises; there is no fallback to gloo. ``gloo_on_cuda`` asks for gloo
    over CUDA tensors instead of NCCL, for ranks that share one card (NCCL
    refuses two ranks on one device): a harness's choice, never the
    port's. ``timeout`` bounds every collective of the group and of
    :func:`make_mesh`'s groups (a rank that never arrives fails the others
    instead of hanging them)."""
    import torch.distributed as dist

    from ..device import resolve_device

    dev = resolve_device(device)
    rank = _env_int("RANK", 0)
    world = _env_int("WORLD_SIZE", 1)
    if dev.type == "cuda":
        dev = torch.device("cuda", _env_int("LOCAL_RANK", rank))
        torch.cuda.set_device(dev)
        backend = "gloo" if gloo_on_cuda else "nccl"
    else:
        backend = "gloo"
    _DEVICE["value"] = dev
    if not dist.is_initialized():
        _TIMEOUT["value"] = timeout
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kw)
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The (data, model) mesh over the initialized process group, all
    ranks data-parallel by default. Every rank calls it (group creation
    is collective)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({world})")
    grid = np.arange(world).reshape(dp, tp)
    groups = {}
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for line in lines:
            g = dist.new_group([int(r) for r in line],
                               timeout=_TIMEOUT["value"])
            if rank in line:
                groups[axis] = g
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = _DEVICE["value"] or torch.device("cpu")
    return Mesh(dp=dp, tp=tp, rank=rank, device=device,
                data_group=groups[DATA_AXIS], model_group=groups[MODEL_AXIS])


# ---------------------------------------------------------------------------
# collectives, counted
# ---------------------------------------------------------------------------

# collectives called and the bytes of their payloads (an all-reduce's
# tensor, an all-gather's output), for the chip check's report
COUNTS: Dict[str, int] = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    COUNTS.update(calls=0, bytes=0)


def _note(t: torch.Tensor) -> None:
    COUNTS["calls"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the maximum of) ``t`` in place over ``group``."""
    import torch.distributed as dist

    _note(t)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's pieces of ``t`` joined along ``dim``, in group-rank
    order."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _note(out)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    """One leaf's split: ``axes[d]`` is ``"model"``, ``"data"`` or None
    for each dimension (a ``PartitionSpec`` padded to the leaf's rank)."""

    axes: Tuple[Optional[str], ...]

    def dim(self, axis: str) -> Optional[int]:
        return self.axes.index(axis) if axis in self.axes else None


def replicated(ndim: int) -> Spec:
    return Spec((None,) * ndim)


def _stack_axes(path, ndim: int) -> Tuple[Optional[str], ...]:
    """JAX's ``_stack_spec``: the named axes for one leaf by its path."""
    keys = list(path)
    name = keys[-1]
    in_layers = "layers" in keys or "blocks" in keys
    if "self_attn" in keys or "cross_attn" in keys:
        if name in ("q", "k", "v"):
            return (None, None, MODEL_AXIS)
        if name == "o":
            return (None, MODEL_AXIS, None)
    if "mlp" in keys:
        if name in ("gate", "up"):
            return (None, None, MODEL_AXIS)
        if name == "down":
            return (None, MODEL_AXIS, None)
    if name == "embed" and not in_layers:
        return (MODEL_AXIS, None)
    if keys[-2:] == ["head", "w1"]:
        return (None, MODEL_AXIS)
    if keys[-2:] == ["head", "w2"]:
        return (MODEL_AXIS, None) if ndim == 2 else ()
    if name == "audio_embed":
        return (MODEL_AXIS, None)
    return ()


def _divisible(axes, shape, sizes: Dict[str, int]) -> Spec:
    """JAX's ``_respect_divisibility``: an axis that does not divide its
    dimension becomes replication."""
    axes = tuple(axes) + (None,) * (len(shape) - len(axes))
    return Spec(tuple(a if a is not None and shape[d] % sizes[a] == 0
                      else None for d, a in enumerate(axes)))


def _kv_heads(cfg, path) -> Optional[int]:
    """The kv-head count of the attention a q/k/v/o leaf belongs to."""
    keys = list(path)
    if not any(k in ("self_attn", "cross_attn") for k in keys):
        return None
    if keys[-1] not in ("q", "k", "v", "o"):
        return None
    stack = cfg.backbone.encoder if keys[0] == "encoder" else \
        cfg.backbone.decoder
    return stack.num_kv_heads


def _leaf_spec(path, shape, cfg, tp: int) -> Spec:
    """One leaf's :class:`Spec` by :func:`param_specs`' rules (``shape``
    its [..., K, N] shape)."""
    shape = tuple(shape)
    out = _divisible(_stack_axes(path, len(shape)), shape,
                     {MODEL_AXIS: tp, DATA_AXIS: 1})
    heads = _kv_heads(cfg, path)
    if heads is not None and heads % tp:
        out = replicated(len(shape))
    if list(path[-2:]) == ["head", "b1"] and len(shape) == 1 \
            and cfg.backbone.hidden_size % tp == 0:
        out = Spec((MODEL_AXIS,))
    return out


def param_specs(params: PyTree, cfg, tp: int) -> PyTree:
    """A tree of :class:`Spec` beside ``params`` (leaves with ``.shape``:
    tensors, ``meta`` tensors): JAX's rules at model size ``tp``, plus the
    whole-head rule and ``b1`` split with ``w1`` (module docstring)."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf.shape, cfg, tp), params)


def zero_spec(spec: Spec, shape: Sequence[int], dp: int) -> Spec:
    """JAX's ``_zero_spec``: ``spec`` with the data axis on the first
    unsplit dimension that ``dp`` divides (ZeRO-1)."""
    if dp <= 1 or len(shape) == 0:
        return spec
    axes = list(spec.axes)
    for d, ax in enumerate(axes):
        if ax is None and shape[d] % dp == 0 and shape[d] >= dp:
            axes[d] = DATA_AXIS
            break
    return Spec(tuple(axes))


def local_part(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a copy, so the whole can go)."""
    out = full
    for d, axis in enumerate(spec.axes):
        if axis is not None and mesh.size(axis) > 1:
            n = full.shape[d] // mesh.size(axis)
            out = out.narrow(d, mesh.index(axis) * n, n)
    return out.clone() if out is not full else out


def gather_leaf(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's block: all-gathered over the data
    group, then over the model group (collective over both)."""
    out = local
    for axis in (DATA_AXIS, MODEL_AXIS):
        d = spec.dim(axis)
        if d is not None and mesh.size(axis) > 1:
            out = all_gather(out, d, mesh.group(axis), mesh.size(axis))
    return out.contiguous()


def shard_params(params: PyTree, mesh: Mesh, specs: PyTree) -> PyTree:
    """This rank's blocks of a whole parameter tree."""
    return tree_map(lambda x, s: local_part(x, s, mesh), params, specs)


def gather_params(params: PyTree, mesh: Mesh, specs: PyTree) -> PyTree:
    """Whole leaves from the ranks' blocks, one leaf at a time (saves,
    export, the generation hook). Collective."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), params, specs)


def shard_opt_state(opt, mesh: Mesh, specs) -> Any:
    """The moment fields of an optimizer state built over this rank's
    parameter blocks, cut to this rank's ZeRO-1 slice (``specs`` from
    :func:`opt_state_specs`)."""
    fields = {
        name: tree_map(lambda x, s: local_part(
            x, Spec(tuple(a if a == DATA_AXIS else None for a in s.axes)),
            mesh), getattr(opt, name), getattr(specs, name))
        for name in _MOMENT_FIELDS if hasattr(opt, name)}
    return opt._replace(**fields) if fields else opt


# ---------------------------------------------------------------------------
# a trained tree's layout, for the optimizer and the step
# ---------------------------------------------------------------------------


class Layout:
    """How each leaf of a trained tree (parameters or adapters) lies on
    the mesh, in tree order: its tensor-parallel dimension, its ZeRO-1
    dimension (moments only) and its whole shape. The optimizer reads it
    to sum a leaf's reductions over the model group, to count a replicated
    leaf once in model-wide sums, and to update only this rank's slice of
    the moments."""

    def __init__(self, mesh: Mesh, specs: PyTree, params: PyTree,
                 zero: bool = False):
        """``params``: this rank's blocks of the trained tree (a leaf's
        ZeRO-1 dimension is the same by its block's shape or its whole
        one: the data axis never takes a split dimension)."""
        self.mesh = mesh
        self.zero = zero
        self.specs = specs
        flat = flatten(specs)[1]
        local = [tuple(p.shape) for p in flatten(params)[1]]
        if len(local) != len(flat):
            raise ValueError("the specs and the tree differ in structure")
        self.tp_dims = [s.dim(MODEL_AXIS) if mesh.tp > 1 else None
                        for s in flat]
        self.shapes = [tuple(n * mesh.tp if d == self.tp_dims[i] else n
                             for d, n in enumerate(shp))
                       for i, shp in enumerate(local)]
        self._moments = [zero_spec(s, shp, mesh.dp) if zero else s
                         for s, shp in zip(flat, self.shapes)]
        self.zero_dims = [s.dim(DATA_AXIS) for s in self._moments]

    def split(self, i: int) -> bool:
        """Leaf ``i`` is split over the model group."""
        return self.tp_dims[i] is not None

    def counted_here(self, i: int) -> bool:
        """Whether this rank adds leaf ``i`` into a model-wide sum: a split
        leaf on every rank, a replicated one on model rank 0 only."""
        return self.split(i) or self.mesh.tp_rank == 0

    def model_sum(self, x: torch.Tensor, i: Optional[int] = None
                  ) -> torch.Tensor:
        """``x`` summed over the model group: a leaf's partial reduction
        (``i`` given: only when the leaf is split) or a model-wide total."""
        if self.mesh.tp == 1 or (i is not None and not self.split(i)):
            return x
        return all_reduce(x, self.mesh.model_group)

    def slicer(self, i: int, like: torch.Tensor):
        """fn(x) -> this rank's ZeRO-1 slice of x (x the full local leaf or
        a per-leaf quantity broadcast against it)."""
        d = self.zero_dims[i]
        if d is None:
            return lambda x: x
        n = like.shape[d] // self.mesh.dp
        lo = self.mesh.dp_rank * n
        full = like.shape[d]

        def cut(x):
            if x.ndim > d and x.shape[d] == full:
                return x.narrow(d, lo, n)
            return x

        return cut

    def gather_slice(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The full local leaf from the data group's ZeRO-1 slices."""
        d = self.zero_dims[i]
        if d is None:
            return x
        return all_gather(x, d, self.mesh.data_group,
                          self.mesh.dp).contiguous()

    def moment_specs(self) -> PyTree:
        return unflatten(self.specs, list(self._moments))


def opt_state_specs(opt, layout: Layout) -> Any:
    """JAX's ``opt_state_shardings``: specs for an optimizer state (a
    NamedTuple) over a tree laid out as ``layout``: the param-shaped moment
    trees (``_MOMENT_FIELDS``) as :meth:`Layout.moment_specs`, everything
    else replicated."""
    return type(opt)(**{
        name: layout.moment_specs() if name in _MOMENT_FIELDS
        else tree_map(lambda x: replicated(x.ndim), getattr(opt, name))
        for name in opt._fields})


def state_specs(state, layout: Layout) -> Any:
    """Specs for a ``TrainState`` whose ``params`` (the trained tree) lie
    as ``layout`` says: the optimizer's as :func:`opt_state_specs`, the
    counters replicated."""
    return type(state)(
        params=layout.specs,
        opt=None if state.opt is None else opt_state_specs(state.opt, layout),
        step=replicated(state.step.ndim),
        nan_skips=replicated(state.nan_skips.ndim))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of a global batch dimension of ``n``
    rows: the span of its row of the grid. JAX's check stays: the rows a
    process owns must be one span (here a process is one rank of the
    grid, whose rows are contiguous by construction)."""
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not divide over "
                         f"dp={mesh.dp}")
    per = n // mesh.dp
    grid = np.arange(mesh.world).reshape(mesh.dp, mesh.tp)
    owned = np.argwhere(grid == mesh.rank)[:, 0]
    lo, hi = int(owned.min()) * per, (int(owned.max()) + 1) * per
    if hi - lo != per * len(owned):
        raise ValueError(
            "shard_batch needs each process's batch rows to be contiguous "
            f"along the data axis; got grid rows {owned.tolist()}")
    return lo, hi


def shard_batch(batch: PyTree, mesh: Mesh, axis: int = 0) -> PyTree:
    """This rank's contiguous rows of the identical global numpy batch
    that every rank's seeded sampler builds (train batches are
    ``[n_micro, B, ...]``: ``axis=1``). No data crosses ranks."""
    def take(x):
        x = np.asarray(x)
        dim = min(axis, x.ndim - 1)
        lo, hi = batch_rows(x.shape[dim], mesh)
        return x[(slice(None),) * dim + (slice(lo, hi),)]

    return tree_map(take, batch)


def shard_slot_state(state, mesh: Mesh):
    """This rank's slots of a continuous-batching ``SlotState`` (JAX
    ``shard_slot_state``): the resident batch's B slots split over the
    data axis, so each data-parallel rank decodes B / dp of them (its span,
    :func:`batch_rows`; ``SlotState.slot0`` its first global slot). Dense
    caches only: the ``DecoderCache`` slabs are [L, B, ...] (slots at dim
    1), every other leaf carries slots at dim 0. The paged cache's
    [Hkv, L*B, ...] slabs fold the batch layer-major, so a data-axis split
    would land on layer boundaries: it raises, and a paged state serves
    tensor parallelism replicated instead."""
    import dataclasses as dc

    from ..models import t5gemma

    if not isinstance(state.cache, t5gemma.DecoderCache):
        raise ValueError(
            "shard_slot_state supports dense-cache SlotStates only: the "
            "paged cache's [Hkv, L*B, ...] slabs fold batch layer-major, "
            "so a data-axis split lands on layer boundaries. Use tensor "
            "parallelism (serving_shard) with a replicated state instead.")
    b = state.tokens.shape[0]
    if b % mesh.dp:
        raise ValueError(f"slot count {b} not divisible by dp={mesh.dp}")
    lo, hi = batch_rows(b, mesh)

    def cut(x, dim):
        return x.narrow(dim, lo, hi - lo).clone()

    cache = dc.replace(state.cache, **{
        f.name: cut(getattr(state.cache, f.name), 1)
        for f in dc.fields(state.cache)})
    rest = {f.name: cut(getattr(state, f.name), 0)
            for f in dc.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}
    return dc.replace(state, cache=cache, slot0=state.slot0 + lo, **rest)


# ---------------------------------------------------------------------------
# serving trees
# ---------------------------------------------------------------------------


def serving_dims(dims, mesh: Optional[Mesh]):
    """``dims`` with a rank's head counts at ``mesh``'s model size: whole
    heads, as :func:`param_specs` splits them (all heads where ``tp`` does
    not divide the kv heads)."""
    tp = 1 if mesh is None else mesh.tp
    if tp == 1 or dims.num_kv_heads % tp:
        return dims
    return dataclasses.replace(dims, num_heads=dims.num_heads // tp,
                               num_kv_heads=dims.num_kv_heads // tp)


def _logical_shape(leaf) -> Tuple[int, ...]:
    """A weight leaf's [..., K, N] shape (quantized leaves store [..., N, K]
    levels, int4 two to a byte)."""
    from ..ops.quant import Int4Weight, QuantWeight

    if isinstance(leaf, Int4Weight):
        lead = tuple(leaf.packed.shape[:-2])
        return lead + (2 * leaf.packed.shape[-1], leaf.n)
    if isinstance(leaf, QuantWeight):
        return tuple(leaf.values.shape[:-2]) + (leaf.values.shape[-1],
                                                leaf.n)
    return tuple(leaf.shape)


def _take_columns(leaf, idx: torch.Tensor):
    """Output channels ``idx`` of a [..., K, N] weight leaf (a copy)."""
    from ..ops.quant import Int4Weight, QuantWeight

    if isinstance(leaf, Int4Weight):
        return leaf._replace(packed=leaf.packed.index_select(-2, idx),
                             scale=leaf.scale.index_select(-1, idx),
                             n=int(idx.numel()))
    if isinstance(leaf, QuantWeight):
        return leaf._replace(values=leaf.values.index_select(-2, idx),
                             scale=leaf.scale.index_select(-1, idx),
                             n=int(idx.numel()))
    return leaf.index_select(-1, idx)


def _take_rows(leaf, lo: int, n: int):
    """Input rows ``lo .. lo + n`` of a [..., K, N] weight leaf (a copy);
    int4 levels keep whole packed bytes (8 levels fill 4 of them, so ``lo``
    and ``n`` must be multiples of 8) in their nibble order."""
    from ..ops.quant import Int4Weight, QuantWeight

    if isinstance(leaf, Int4Weight):
        if lo % 8 or n % 8:
            raise ValueError(f"an int4 weight splits along K in groups of 8 "
                             f"levels, not at {lo} + {n}")
        return leaf._replace(
            packed=leaf.packed.narrow(-1, lo // 2, n // 2).contiguous())
    if isinstance(leaf, QuantWeight):
        return leaf._replace(values=leaf.values.narrow(-1, lo, n).contiguous())
    return leaf.narrow(-2, lo, n).clone()


def _fused_segments(path, cfg) -> Optional[Tuple[int, ...]]:
    """The segment widths along N of a fused decode leaf ([q | k | v],
    [gate | up]), else None."""
    name = path[-1]
    if name not in ("qkv", "gate_up"):
        return None
    stack = cfg.backbone.encoder if path[0] == "encoder" else \
        cfg.backbone.decoder
    if name == "qkv":
        q, kv = (stack.num_heads * stack.head_dim,
                 stack.num_kv_heads * stack.head_dim)
        return q, kv, kv
    return (stack.intermediate_size,) * 2


def serving_shard(params: PyTree, cfg, mesh: Mesh, *, quantize: bool = False,
                  act_bits: int = 8, weight_bits: int = 8,
                  head_bits: Optional[int] = None) -> PyTree:
    """This rank's serving tree from the whole one-process tree ``params``
    (fused or not, quantized or not): fused whole
    (``t5gemma.fuse_for_decode``), with ``quantize`` quantized whole
    (``quant.quantize_params_for_decode``: a row-split block keeps the
    per-channel scale computed over the whole K), then cut by
    :func:`param_specs`' rules at ``mesh.tp``. A fused leaf is cut segment
    by segment ([q | k | v], [gate | up]), which is fusing the rank's own
    q/k/v and gate/up: per-channel scales make the two orders equal. W8A16
    leaves (``act_bits=16``) are cut as W8A8 leaves are."""
    from ..models import t5gemma
    from ..ops import quant

    tree = params
    if "qkv" not in tree["decoder"]["layers"]["self_attn"]:
        tree = t5gemma.fuse_for_decode(tree)
    if quantize:
        tree = quant.quantize_params_for_decode(
            tree, act_bits=act_bits, weight_bits=weight_bits,
            head_bits=head_bits)
    tp, r = mesh.tp, mesh.tp_rank

    def cut(path, leaf):
        if isinstance(leaf, dict):
            return {k: cut(path + (k,), v) for k, v in leaf.items()}
        if tp == 1:
            return leaf
        shape = _logical_shape(leaf)
        widths = _fused_segments(path, cfg)
        if widths is not None:
            # the parts' own rule: q/k/v by whole kv heads, gate/up by
            # divisibility of their columns
            part = "q" if path[-1] == "qkv" else "gate"
            spec = _leaf_spec(path[:-1] + (part,),
                              shape[:-1] + (widths[0],), cfg, tp)
            if spec.dim(MODEL_AXIS) is None or any(w % tp for w in widths):
                return leaf
            starts = np.cumsum((0,) + widths[:-1])
            dev = _any_tensor(leaf).device
            idx = torch.cat([torch.arange(int(s0) + r * (w // tp),
                                          int(s0) + (r + 1) * (w // tp),
                                          device=dev)
                             for s0, w in zip(starts, widths)])
            return _take_columns(leaf, idx)
        spec = _leaf_spec(path, shape, cfg, tp)
        d = spec.dim(MODEL_AXIS)
        if d is None:
            return leaf
        n = shape[d] // tp
        if d == len(shape) - 1 and len(shape) >= 2:
            dev = _any_tensor(leaf).device
            return _take_columns(leaf, torch.arange(r * n, (r + 1) * n,
                                                    device=dev))
        if d == len(shape) - 2:
            return _take_rows(leaf, r * n, n)
        return local_part(leaf, spec, mesh)

    return cut((), tree)


def _any_tensor(leaf) -> torch.Tensor:
    """The tensor holding a weight leaf's levels (the leaf itself if
    plain)."""
    from ..ops.quant import Int4Weight, QuantWeight

    if isinstance(leaf, Int4Weight):
        return leaf.packed
    return leaf.values if isinstance(leaf, QuantWeight) else leaf

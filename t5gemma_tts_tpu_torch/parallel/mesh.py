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

The serving half of the JAX module (``shard_slot_state``) is ROADMAP
Queue 1 item 15 part C and raises here.
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
SERVING_REFUSAL = ("the mesh's serving half (tensor-parallel decode, "
                   "dp-sharded continuous segments, shard_slot_state) is "
                   "ROADMAP Queue 1 item 15 part C")


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


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     timeout: Optional[timedelta] = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; rank 0 of 1 without them) and return
    this rank's device: NCCL on ``cuda:LOCAL_RANK``, gloo only when the
    caller passes ``cpu``. A failing NCCL start raises; there is no
    fallback to gloo. ``timeout`` bounds every collective of the group
    and of :func:`make_mesh`'s groups (a rank that never arrives fails the
    others instead of hanging them)."""
    import torch.distributed as dist

    from ..device import resolve_device

    dev = resolve_device(device)
    rank = _env_int("RANK", 0)
    world = _env_int("WORLD_SIZE", 1)
    if dev.type == "cuda":
        dev = torch.device("cuda", _env_int("LOCAL_RANK", rank))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
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
        device = torch.device("cpu")
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


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``."""
    import torch.distributed as dist

    _note(t)
    dist.all_reduce(t, group=group)
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


def param_specs(params: PyTree, cfg, tp: int) -> PyTree:
    """A tree of :class:`Spec` beside ``params`` (leaves with ``.shape``:
    tensors, ``meta`` tensors): JAX's rules at model size ``tp``, plus the
    whole-head rule and ``b1`` split with ``w1`` (module docstring)."""
    sizes = {MODEL_AXIS: tp, DATA_AXIS: 1}

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        out = _divisible(_stack_axes(path, len(shape)), shape, sizes)
        heads = _kv_heads(cfg, path)
        if heads is not None and heads % tp:
            out = replicated(len(shape))
        if list(path[-2:]) == ["head", "b1"] and len(shape) == 1 \
                and cfg.backbone.hidden_size % tp == 0:
            out = Spec((MODEL_AXIS,))
        return out

    return tree_map_with_path(spec, params)


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
    """The continuous-serving state split over the data axis: the serving
    half of the mesh, not ported yet."""
    raise NotImplementedError(SERVING_REFUSAL)

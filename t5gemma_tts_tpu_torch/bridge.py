"""Weight bridge: parameter trees of the JAX package (as numpy) <-> the port.

Training state crosses too: a LoRA adapter tree (``None`` at the frozen
leaves) through :func:`params_from_jax`, an optimizer state through
:func:`opt_state_from_jax`.

The port keeps the JAX tree's key names and its stacked ``[L, ...]`` layer
axis (``voice.init_params``, ``codec.model.init_decoder_params``), so the
bridge renames nothing: it maps every numpy leaf to a tensor, byte for byte
(bfloat16 and float8 e4m3 leaves, which numpy holds as ``ml_dtypes`` types,
travel as their bit patterns). Lists (the speculative draft heads are a
list of dicts) map element by element. The Whisper tree (``asr/model.py``)
keeps the JAX tree's keys and layer axis too, so it crosses unchanged.

Int8 leaves. A JAX ``QuantWeight`` (a NamedTuple ``values, scale, n,
act_bits, layout``, as ``jax.tree_util.tree_map(np.asarray, tree)`` leaves
it) becomes the port's ``ops.quant.QuantWeight``: its ``[..., K, N_pad]``
values ("kn"), ``[L, N_pad/T, K, T]`` ("tiled_n") or ``[L, K/T, T, N_pad]``
("tiled_k") are un-tiled, cut to the true width ``n`` and stored
``[..., n, K]``. :func:`params_to_numpy` inverts it into a
:class:`NumpyQuantWeight` with the JAX field order, padded back to the
512-column tile with zeros, in the "kn" layout or, with
``streaming_tiled=True``, in the tiling the JAX package's
``retile_for_streaming`` gives each decoder weight: both round trips are
byte-equal.

Int4 leaves. A JAX ``Lanes4Weight`` (``packed, scale, n, layout``) becomes
the port's ``ops.quant.Int4Weight``: its nibbles are decoded as
``dequantize_lanes4`` decodes them (byte ``p = 16 q_hi + (q_lo + 8)``) from
the "l4n" layout ``[..., NT, K, T/2]`` (byte column c of tile j pairs
channels ``j T + c`` and ``j T + T/2 + c``) or the "l4k" layout
``[..., KT, TK, N_pad/2]`` (byte column c pairs channels c and
``c + N_pad/2``), cut to ``n`` channels and repacked. :func:`params_to_numpy`
packs them back into a :class:`NumpyLanes4Weight`, "l4k" for the o and down
products and "l4n" for the rest, byte-equal to ``quantize_weight_lanes4``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.quant import Int4Weight, QuantWeight, int4_levels, pack_int4

N_TILE = 512     # the JAX package's output-width padding and weight tile
_K_MAJOR = ("o", "down")   # the products the JAX lanes4 layout stores "l4k"


class NumpyQuantWeight(NamedTuple):
    """A JAX ``QuantWeight``'s fields as numpy (same order)."""

    values: np.ndarray
    scale: np.ndarray
    n: int
    act_bits: int = 8
    layout: str = "kn"


class NumpyLanes4Weight(NamedTuple):
    """A JAX ``Lanes4Weight``'s fields as numpy (same order)."""

    packed: np.ndarray
    scale: np.ndarray
    n: int
    layout: str


def _to_tensor(arr: np.ndarray, device, dtype) -> torch.Tensor:
    # ascontiguousarray makes a 0-dim array 1-dim: keep the shape
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _is_jax_quant(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in NumpyQuantWeight._fields)


def _quant_from_jax(leaf, device) -> QuantWeight:
    v = np.asarray(leaf.values)
    if leaf.layout == "tiled_n":           # [L, NT, K, T] -> [L, K, NT*T]
        v = np.moveaxis(v, -3, -2)
        v = v.reshape(*v.shape[:-2], -1)
    elif leaf.layout == "tiled_k":         # [L, KT, T, N] -> [L, KT*T, N]
        v = v.reshape(*v.shape[:-3], -1, v.shape[-1])
    elif leaf.layout != "kn":
        raise NotImplementedError(f"QuantWeight layout {leaf.layout!r}")
    n = int(leaf.n)
    v = np.swapaxes(v[..., :n], -1, -2)
    scale = np.asarray(leaf.scale, np.float32)[..., :n]
    return QuantWeight(_to_tensor(v, device, None),
                       _to_tensor(scale, device, None), n,
                       int(leaf.act_bits))


def _is_jax_lanes4(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in NumpyLanes4Weight._fields)


def _lanes4_levels(packed: np.ndarray, layout: str) -> np.ndarray:
    """The int4 levels of lanes4 bytes, ``[..., K, N_pad]`` int8."""
    p = np.asarray(packed).astype(np.int32)
    ul = p & 15                                    # q_lo + 8
    q = np.concatenate([ul - 8, (p - ul) // 16], axis=-1)
    if layout == "l4n":            # [..., NT, K, T] -> [..., K, NT*T]
        q = np.moveaxis(q, -3, -2)
        q = q.reshape(*q.shape[:-2], -1)
    elif layout == "l4k":          # [..., KT, TK, N_pad] -> [..., K, N_pad]
        q = q.reshape(*q.shape[:-3], -1, q.shape[-1])
    else:
        raise NotImplementedError(f"Lanes4Weight layout {layout!r}")
    return q.astype(np.int8)


def _int4_from_jax(leaf, device) -> Int4Weight:
    n = int(leaf.n)
    q = np.swapaxes(_lanes4_levels(leaf.packed, leaf.layout)[..., :n], -1, -2)
    scale = np.asarray(leaf.scale, np.float32)[..., :n]
    packed = pack_int4(torch.from_numpy(np.ascontiguousarray(q)))
    return Int4Weight(packed.to(device), _to_tensor(scale, device, None), n)


def params_from_jax(tree: Any, device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays (and JAX ``QuantWeight`` /
    ``Lanes4Weight`` leaves) -> the same dict of tensors (and port
    ``QuantWeight`` / ``Int4Weight`` leaves) on ``device``. With ``dtype``
    floating leaves are cast; without it they keep theirs. ``None`` stays
    ``None`` (a LoRA adapter tree's frozen leaves)."""
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v, dev, dtype) for v in tree]
    if _is_jax_quant(tree):
        return _quant_from_jax(tree, dev)
    if _is_jax_lanes4(tree):
        return _int4_from_jax(tree, dev)
    return _to_tensor(np.asarray(tree), dev, dtype)


def opt_state_from_jax(state: Any, device: DeviceLike = "cuda") -> Any:
    """A JAX optimizer state as numpy (``ScaledAdamState`` or
    ``AdamWState``, e.g. ``jax.tree_util.tree_map(np.asarray, state)``) ->
    the port's state of the same name, leaf for leaf."""
    from .train import optim

    cls = {"ScaledAdamState": optim.ScaledAdamState,
           "AdamWState": optim.AdamWState}[type(state).__name__]
    return cls(*(params_from_jax(v, device) for v in state))


def _tiling(path, k: int, ndim: int) -> str:
    """The layout ``retile_for_streaming`` gives a stacked weight."""
    name = path[-1]
    if ndim != 3:
        return "kn"
    if name in ("qkv", "gate_up") or (name == "q" and "cross_attn" in path):
        return "tiled_n"
    if name in ("o", "down") and k % N_TILE == 0:
        return "tiled_k"
    return "kn"


def _quant_to_numpy(w: QuantWeight, layout: str) -> NumpyQuantWeight:
    v = np.swapaxes(w.values.detach().cpu().numpy(), -1, -2)   # [..., K, n]
    scale = w.scale.detach().cpu().numpy()
    n = w.n
    n_pad = -(-n // N_TILE) * N_TILE
    if n_pad != n:
        lead = [(0, 0)] * (v.ndim - 1)
        v = np.pad(v, lead + [(0, n_pad - n)])
        scale = np.pad(scale, [(0, 0)] * (scale.ndim - 1) + [(0, n_pad - n)])
    v = np.ascontiguousarray(v)
    if layout == "tiled_n":
        l, k, _ = v.shape
        v = np.ascontiguousarray(
            v.reshape(l, k, n_pad // N_TILE, N_TILE).transpose(0, 2, 1, 3))
    elif layout == "tiled_k":
        l, k, _ = v.shape
        v = v.reshape(l, k // N_TILE, N_TILE, n_pad)
    return NumpyQuantWeight(v, scale, n, w.act_bits, layout)


def _pack_pair(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(q_lo, q_hi) levels -> the lanes4 byte ``16 q_hi + (q_lo + 8)``."""
    return (((hi & 15) << 4) | (lo + 8)).astype(np.uint8).view(np.int8)


def _int4_to_numpy(w: Int4Weight, layout: str) -> NumpyLanes4Weight:
    q = np.swapaxes(int4_levels(w.packed.detach().cpu()).numpy(), -1, -2)
    q = q.astype(np.int32)                                       # [..., K, n]
    scale = w.scale.detach().cpu().numpy()
    n, k = w.n, q.shape[-2]
    n_pad = -(-n // N_TILE) * N_TILE
    if n_pad != n:
        q = np.pad(q, [(0, 0)] * (q.ndim - 1) + [(0, n_pad - n)])
        scale = np.pad(scale, [(0, 0)] * (scale.ndim - 1) + [(0, n_pad - n)])
    lead = q.shape[:-2]
    if layout == "l4k":
        half = n_pad // 2
        tk = N_TILE if k % N_TILE == 0 else k
        packed = _pack_pair(q[..., :half], q[..., half:]).reshape(
            *lead, k // tk, tk, half)
    else:
        qt = q.reshape(*lead, k, n_pad // N_TILE, N_TILE)
        half = N_TILE // 2
        packed = np.moveaxis(_pack_pair(qt[..., :half], qt[..., half:]),
                             -2, -3)                     # [..., NT, K, T/2]
    return NumpyLanes4Weight(np.ascontiguousarray(packed), scale, n, layout)


def params_to_numpy(tree: Any, streaming_tiled: bool = False,
                    _path: tuple = ()) -> Any:
    """Inverse of :func:`params_from_jax` (bf16 and float8 leaves as their
    ml_dtypes types when ml_dtypes is installed, else as float32;
    ``QuantWeight``
    leaves as :class:`NumpyQuantWeight`, tiled as the JAX package tiles
    them for its megakernel when ``streaming_tiled``; ``Int4Weight`` leaves
    as :class:`NumpyLanes4Weight`)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v, streaming_tiled, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v, streaming_tiled, _path) for v in tree]
    if isinstance(tree, Int4Weight):
        k_major = tree.packed.ndim == 3 and _path[-1] in _K_MAJOR
        return _int4_to_numpy(tree, "l4k" if k_major else "l4n")
    if isinstance(tree, QuantWeight):
        layout = "kn"
        if streaming_tiled:
            layout = _tiling(_path, tree.values.shape[-1], tree.values.ndim)
        return _quant_to_numpy(tree, layout)
    t = tree.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()

"""Int8 and int4 weight quantization for the decode path, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/ops/quant.py``:

- W8A8: per-output-channel absmax int8 weights (:func:`quantize_weight`),
  per-row absmax int8 activations (:func:`quantize_act`), and the int8 x
  int8 product with exact int32 accumulation and an f32 rescale
  ``(f32(acc[m, n]) * sx[m]) * sw[n]`` (:func:`w8a8_matmul`);
- W8A16 (``act_bits=16``): the same int8 weights against bf16 activations,
  ``f32(bf16(x) @ levels) * s[n]`` with f32 accumulation
  (:func:`w8a16_matmul`; the JAX ``_qmm_2d`` / ``_qmm_kernel``);
- W4A8, the batch-1 latency mode: per-output-channel absmax int4 weights
  (levels -7..7, scale ``absmax / 7``; :func:`quantize_weight_int4_lanes`,
  the levels and scales of the JAX ``quantize_weight_lanes4``) and the same
  product over the int4 levels (:func:`w4a8_matmul`; the JAX
  ``_w4a8_2d_xla`` / ``_w4a8_kernel``);
- the grouped int4 reference (:class:`Quant4Weight`, :func:`q4_matmul`):
  per-(K-group, channel) scales, plain PyTorch only, as the JAX package has
  no kernel for it.

A tensor-parallel rank's row-split block of a W8A8 or W4A8 product
(:func:`rows_matmul`: its K columns of the product) takes
the group's row absmax before it quantizes and sums its exact int32
partial products over the group before the one rescale, so its result is
the one-process product's, bit for bit. A row-split W8A16 block
(:func:`rows_matmul_a16`) quantizes no activation: its f32 product at the
rank's K is summed over the group in f32 and cast once, equal to the
one-process product but for the order of its f32 sums.

On a CUDA tensor :func:`w8a8_matmul`, :func:`w4a8_matmul`,
:func:`w8a16_matmul`, :func:`quantize_act` and the row-split products
launch the hand-written
kernels of ``csrc/w8a8_matmul.cu`` / ``csrc/w4a8_matmul.cu`` /
``csrc/w8a16_matmul.cu`` (built with nvcc at first use, see
ops/cuda_build.py) or raise; on a CPU tensor they run their plain versions.
``.launches`` on each wrapper counts kernel launches.

Layout. The levels and scales are bit-identical to the JAX package's, but
the port stores a weight channel-major: ``QuantWeight.values [..., N, K]``
and ``Int4Weight.packed [..., N, K/2]`` (each output channel's K weights
contiguous, which is what the weight-streaming kernels read), with no
padding of N. The JAX ``[..., K, N_pad]`` layouts, their
``tiled_n``/``tiled_k`` re-tilings and the lanes4 ``l4n``/``l4k`` nibble
pairings (TPU DMA and Mosaic constraints) are translated by ``bridge.py``.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from .fused_attn import _check, _ptr, absmax_scale

PyTree = Any
log = logging.getLogger(__name__)


class QuantWeight(NamedTuple):
    values: torch.Tensor   # int8 [..., N, K] (K contiguous)
    scale: torch.Tensor    # f32  [..., N]
    n: int                 # output width (== values.shape[-2])
    act_bits: int = 8      # 8 = W8A8; 16 = W8A16 (bf16 activations)


class Int4Weight(NamedTuple):
    """Per-channel int4 weights (levels -7..7) for the W4A8 product.

    ``packed`` int8 [..., N, K/2]: each channel's K levels, two to a byte,
    in groups of 8 consecutive K: byte ``4 g + j`` (j < 4) holds level
    ``8 g + j`` in its low nibble and level ``8 g + 4 + j`` in its high
    nibble, both as 4-bit two's complement. So one 32-bit word holds 8
    levels whose low nibbles line up with the 4 activation bytes of one
    int8x4 word and whose high nibbles with the next word's (see
    csrc/w8a8.cuh). ``scale`` f32 [..., N]."""

    packed: torch.Tensor
    scale: torch.Tensor
    n: int                 # output width (== packed.shape[-2])


Weight = Union[QuantWeight, Int4Weight]


def map_weight(w: Weight,
               fn: Callable[[torch.Tensor], torch.Tensor]) -> Weight:
    """``w`` with ``fn`` applied to each of its tensors (device moves,
    layer slices)."""
    if isinstance(w, Int4Weight):
        return w._replace(packed=fn(w.packed), scale=fn(w.scale))
    return w._replace(values=fn(w.values), scale=fn(w.scale))


def _check_act_bits(act_bits: int) -> None:
    if act_bits not in (8, 16):
        raise ValueError(f"act_bits must be 8 (W8A8) or 16 (W8A16), got "
                         f"{act_bits}")


def quantize_weight(w: torch.Tensor, act_bits: int = 8) -> QuantWeight:
    """Per-output-channel absmax int8 quantization of ``w [..., K, N]``
    (the JAX ``quantize_weight`` levels and scales, stored [..., N, K]);
    ``act_bits`` only picks the product (8: W8A8, 16: W8A16)."""
    _check_act_bits(act_bits)
    wf = w.float()
    scale = absmax_scale(wf.abs().amax(dim=-2))                # [..., N]
    q = torch.round(wf / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return QuantWeight(q.transpose(-1, -2).contiguous(), scale, w.shape[-1],
                       act_bits)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 levels in [-8, 7] ``[..., K]`` (K a multiple of 8) -> the
    :class:`Int4Weight` bytes ``[..., K/2]``."""
    *lead, k = q.shape
    if k % 8:
        raise ValueError(f"int4 packing needs K % 8 == 0 (got K={k})")
    g = q.to(torch.int32).reshape(*lead, k // 8, 2, 4)
    packed = (g[..., 0, :] & 15) | (g[..., 1, :] << 4)         # in [-128, 127]
    return packed.reshape(*lead, k // 2).to(torch.int8)


def int4_levels(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., K/2]`` bytes -> int8 levels
    ``[..., K]``."""
    *lead, kh = packed.shape
    p = packed.to(torch.int32).reshape(*lead, kh // 4, 4)
    lo = ((p & 15) ^ 8) - 8                                     # sign-extend
    hi = p >> 4                                                 # arithmetic
    return torch.cat([lo, hi], dim=-1).reshape(*lead, 2 * kh).to(torch.int8)


def quantize_weight_int4_lanes(w: torch.Tensor) -> Int4Weight:
    """Per-output-channel absmax int4 quantization of ``w [..., K, N]``:
    the levels (``round`` half to even, clipped to -7..7) and scales
    (``max(absmax, 1e-8) / 7``) of the JAX ``quantize_weight_lanes4``, in
    the :class:`Int4Weight` layout."""
    wf = w.float()
    scale = absmax_scale(wf.abs().amax(dim=-2), 7.0)           # [..., N]
    q = torch.round(wf / scale[..., None, :]).clamp(-7, 7).to(torch.int8)
    return Int4Weight(pack_int4(q.transpose(-1, -2)).contiguous(), scale,
                      w.shape[-1])


def weight_levels(w: Weight) -> torch.Tensor:
    """The int8 levels of a weight, ``[..., N, K]``."""
    if isinstance(w, Int4Weight):
        return int4_levels(w.packed)
    return w.values


def dequantize(w: Weight) -> torch.Tensor:
    """Reference dequantization -> f32 [..., K, N] (for tests)."""
    return (weight_levels(w).float() * w.scale[..., None]).transpose(-1, -2)


def quantize_act_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization: [M, K] -> (int8 [M, K],
    f32 [M, 1]); ``round`` is half to even, as ``jnp.round``."""
    xf = x.float()
    sx = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    x8 = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return x8, sx


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_act_plain` on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return quantize_act_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act: no kernel for {x.device}")
    m, k = x.shape
    x = x.contiguous()
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = _bind("w8a8_matmul", "t5g_quantize_rows")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
                 x8.data_ptr(), sx.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_act kernel launch failed: CUDA error {err}")
    quantize_act.launches += 1
    return x8, sx


quantize_act.launches = 0


def int_matmul_exact(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact integer product ``x8 [M, K] @ w8[N, K].T`` -> int32 [M, N]:
    int32 on the CPU, float64 on the card (exact: |sum| <= 127^2 K < 2^53)."""
    if x8.device.type == "cpu":
        return x8.int() @ w8.int().t()
    return (x8.double() @ w8.double().t()).to(torch.int32)


def _plain(x: torch.Tensor, w: Weight,
           out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``(f32(x8 @ levels) * sx) * s`` in ``out_dtype`` (default
    ``x.dtype``); the rescale order of the JAX ``_w8a8_2d_xla`` and
    ``_w4a8_2d_xla``."""
    x8, sx = quantize_act_plain(x)
    acc = int_matmul_exact(x8, weight_levels(w)).float()
    return (acc * sx * w.scale[None, :]).to(out_dtype or x.dtype)


def w8a8_matmul_plain(x: torch.Tensor, w: QuantWeight,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """x [M, K] -> ``(f32(x8 @ w8) * sx) * sw`` [M, N]."""
    return _plain(x, w, out_dtype)


def w4a8_matmul_plain(x: torch.Tensor, w: Int4Weight,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """x [M, K] -> ``(f32(x8 @ q4) * sx) * s`` [M, N] over the int4 levels
    unpacked to int8 (the JAX ``_w4a8_2d_xla``)."""
    return _plain(x, w, out_dtype)


def w8a8_matmul(x: torch.Tensor, w: QuantWeight,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 product of ``x [M, K]`` (f32 or bf16) and a 2-D
    :class:`QuantWeight` -> [M, N] in ``out_dtype`` (default ``x.dtype``).
    On the card one call quantizes the rows and runs the int8 product."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: no kernel for {x.device}")
    out = _launch(x, w, out_dtype or x.dtype)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w4a8_matmul(x: torch.Tensor, w: Int4Weight,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W4A8 product of ``x [M, K]`` (f32 or bf16) and a 2-D
    :class:`Int4Weight` -> [M, N] in ``out_dtype`` (default ``x.dtype``).
    On the card one call quantizes the rows and runs the int4 product."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: no kernel for {x.device}")
    out = _launch(x, w, out_dtype or x.dtype)
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0


def w8a16_matmul_plain(x: torch.Tensor, w: QuantWeight,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """x [M, K] -> ``(bf16(x) @ levels) * s`` [M, N] in ``out_dtype``
    (default ``x.dtype``): x is rounded to bf16 first, as ``_qmm_2d`` does
    for f32 x; the bf16 x int8 products are exact in f32 and summed in f32;
    the scale multiplies the f32 sum."""
    acc = x.to(torch.bfloat16).float() @ w.values.float().t()
    return (acc * w.scale[None, :]).to(out_dtype or x.dtype)


def w8a16_matmul(x: torch.Tensor, w: QuantWeight,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A16 product of ``x [M, K]`` (f32 or bf16, rounded to bf16) and a
    2-D :class:`QuantWeight` -> [M, N] in ``out_dtype`` (default
    ``x.dtype``)."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: no kernel for {x.device}")
    out = _launch(x, w, out_dtype or x.dtype)
    w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0


# ---------------------------------------------------------------------------
# a tensor-parallel rank's row-split block (csrc/w8a8_matmul.cu,
# csrc/w4a8_matmul.cu)
# ---------------------------------------------------------------------------


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each row's absmax of ``x [M, K]``, f32 [M]."""
    if x.device.type == "cpu":
        return x.float().abs().amax(dim=-1)
    m, k = x.shape
    x = x.contiguous()
    amax = torch.empty((m,), dtype=torch.float32, device=x.device)
    _run(_bind("w8a8_matmul", "t5g_row_absmax"), "row absmax", x.device,
         x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, amax.data_ptr())
    return amax


def quantize_act_amax(x: torch.Tensor, amax: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_act_plain` at a given row absmax ``amax`` [M] (the
    group's) -> (int8 [M, K], f32 [M, 1])."""
    if x.device.type == "cpu":
        sx = absmax_scale(amax.float())[:, None]
        x8 = torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8)
        return x8, sx
    m, k = x.shape
    x = x.contiguous()
    amax = amax.float().contiguous()
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _run(_bind("w8a8_matmul", "t5g_quantize_rows_amax"), "quantize rows",
         x.device, x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
         amax.data_ptr(), x8.data_ptr(), sx.data_ptr())
    return x8, sx


def int_product(x8: torch.Tensor, w: Weight) -> torch.Tensor:
    """The exact int32 sums ``x8 [M, K] @ levels(w)^T`` -> [M, N]: on the
    card the W8A8 or W4A8 kernel's route for M, without its rescale."""
    if x8.device.type == "cpu":
        return int_matmul_exact(x8, weight_levels(w))
    w4 = isinstance(w, Int4Weight)
    name = "w4a8" if w4 else "w8a8"
    wt = w.packed if w4 else w.values
    m, k = x8.shape
    n = wt.shape[0]
    _check("weight", wt, x8.device, torch.int8, (n, k // 2 if w4 else k))
    if k % 16 or wt.data_ptr() % 16:
        raise ValueError(f"{name} rows: K={k} must be a multiple of 16 and "
                         f"the weight 16-byte aligned")
    x8 = x8.contiguous()
    if x8.data_ptr() % 16:
        x8 = x8.clone()
    splits = _bind(f"{name}_matmul", f"t5g_{name}_plan")(m, n, k, None)
    if splits < 0:
        raise ValueError(f"{name}: the tensor-core route refuses M={m}, K={k}")
    part = (torch.empty((splits, m, n), dtype=torch.int32, device=x8.device)
            if splits else None)
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    _run(_bind(f"{name}_matmul", f"t5g_{name}_int"), f"{name} int product",
         x8.device, x8.data_ptr(), m, k, wt.data_ptr(), n, out.data_ptr(),
         None if part is None else part.data_ptr())
    return out


def rescale_rows(acc: torch.Tensor, sx: torch.Tensor, w: Weight,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``(f32(acc) * sx) * s`` [M, N] in ``out_dtype``: the W8A8 / W4A8
    rescale, on the group's integer sums ``acc`` [M, N]."""
    if acc.device.type == "cpu":
        return (acc.float() * sx * w.scale[None, :]).to(out_dtype)
    m, n = acc.shape
    acc, sx = acc.contiguous(), sx.float().contiguous()
    _check("scale", w.scale, acc.device, torch.float32, (n,))
    out = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    _run(_bind("w8a8_matmul", "t5g_rescale_rows"), "rescale", acc.device,
         acc.data_ptr(), sx.data_ptr(), w.scale.data_ptr(), m, n,
         out.data_ptr(), int(out_dtype == torch.bfloat16))
    return out


def rows_matmul(x: torch.Tensor, w: Weight, group_max: Callable,
                group_sum: Callable, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """A rank's row-split block of the W8A8 (``QuantWeight``) or W4A8
    (``Int4Weight``) product: ``x [M, K_r]`` (this rank's columns of the
    activations) and ``w`` (its K_r rows of the weight) -> the whole
    product [M, N], :func:`w8a8_matmul` / :func:`w4a8_matmul` of the whole
    x and w bit for bit. ``group_max`` / ``group_sum`` all-reduce a row
    absmax [M] (MAX) and the int32 sums [M, N] (SUM) over the group. On the
    card it adds one launch a call to the counter of the product's kernel
    (``w8a8_matmul.launches`` or ``w4a8_matmul.launches``; four kernels:
    absmax, quantize, the int32 product, the rescale)."""
    amax = group_max(row_absmax(x))
    x8, sx = quantize_act_amax(x, amax)
    acc = group_sum(int_product(x8, w))
    out = rescale_rows(acc, sx, w, out_dtype or x.dtype)
    if x.device.type == "cuda":
        (w4a8_matmul if isinstance(w, Int4Weight) else w8a8_matmul
         ).launches += 1
    return out


def rows_matmul_a16(x: torch.Tensor, w: QuantWeight, group_sum: Callable,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A rank's row-split block of the W8A16 product: ``x [M, K_r]`` (this
    rank's columns of the activations) and ``w`` (its K_r rows, the
    per-channel scales of the whole K) -> the whole product [M, N] in
    ``out_dtype`` (default ``x.dtype``): :func:`w8a16_matmul` at the rank's
    K with an f32 result (``(bf16(x_r) @ levels_r) * s``), summed over the
    group in f32 by ``group_sum``, cast once. Each rank scales its partial
    sum before the group adds them, so the result is the one-process
    product's within the order of its f32 sums. On the card one launch of
    kernel 6 a call (``w8a16_matmul.launches``)."""
    out = group_sum(w8a16_matmul(x, w, torch.float32))
    return out.to(out_dtype or x.dtype)


def q_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Drop-in for ``x @ w`` over [..., K] activations: a plain tensor is
    multiplied as is; a :class:`QuantWeight` takes the W8A8 product
    (``act_bits=8``) or the W8A16 one (``act_bits=16``), and an
    :class:`Int4Weight` the W4A8 product, all back in ``x.dtype``. A
    factored LoRA leaf (``train/lora.py``'s ``LoraWeight``) computes
    ``x @ W + ((x @ A) @ B) * scale``, never materializing ``W + A B``."""
    if hasattr(w, "a") and hasattr(w, "b") and hasattr(w, "w"):
        upd = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
        return q_matmul(x, w.w) + upd * w.scale
    if isinstance(w, Int4Weight):
        product = w4a8_matmul
    elif isinstance(w, QuantWeight):
        product = w8a16_matmul if w.act_bits == 16 else w8a8_matmul
    else:
        return x @ w
    *lead, k = x.shape
    out = product(x.reshape(-1, k), w)
    return out.reshape(*lead, w.n)


_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down", "w1", "w2",
               "qkv", "gate_up")
_W4_KEYS = ("qkv", "o", "gate_up", "down")   # + the cross-attention "q"


def _decoder_widths(params: PyTree) -> Optional[Tuple[int, int, int]]:
    """(hidden, heads x head_dim, intermediate) of a stacked decoder tree,
    or None where it has no such layers."""
    try:
        lay = params["decoder"]["layers"]
        _, ho, d = lay["self_attn"]["o"].shape
        _, f, _ = lay["mlp"]["down"].shape
    except (KeyError, TypeError, ValueError):
        return None
    return d, ho, f


def quantize_params_for_decode(params: PyTree, act_bits: int = 8,
                               weight_bits: int = 8,
                               head_bits: Optional[int] = None,
                               quantize_encoder: bool = False) -> PyTree:
    """Quantize the matmuls the decode loop reads every step: the decoder's
    stacked projections (cross K/V included) and the head's ``w1``/``w2``
    become int8 :class:`QuantWeight`; the encoder stays as it is unless
    ``quantize_encoder``. ``act_bits`` picks their product: 8 for W8A8, 16
    for W8A16 (bf16 activations). Returns a new tree (the quantization
    runs on the tensors' device).

    ``weight_bits=4`` is the batch-1 latency mode: the six decode-layer
    products (fused qkv, self o, cross q, cross o, gate_up, down) become
    :class:`Int4Weight`, and so does the head's ``w2`` unless
    ``head_bits=8`` (default: follow ``weight_bits``); cross K/V and the
    head's ``w1`` stay int8 with ``act_bits``. Where the decoder's widths
    do not fit the decode-layer kernels (``megakernel.widths_fit``) it
    warns and quantizes int8."""
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    head_bits = weight_bits if head_bits is None else head_bits
    if head_bits not in (8, 4):
        raise ValueError(f"head_bits must be 8 or 4, got {head_bits}")
    _check_act_bits(act_bits)
    from .megakernel import widths_fit   # megakernel imports this module

    widths = _decoder_widths(params)
    if weight_bits == 4 and not (widths and widths_fit(*widths)):
        log.warning("weight_bits=4 requested but the decoder's widths %s do "
                    "not fit the decode-layer kernels "
                    "(megakernel.widths_fit); quantizing int8 instead",
                    widths)
        weight_bits = 8

    def int8(w):
        return quantize_weight(w, act_bits)

    def stacked(leaf, quantize):
        # one layer at a time: the f32 temporaries stay one layer's size
        parts = [quantize(leaf[i]) for i in range(leaf.shape[0])]
        return parts[0]._replace(**{
            f: torch.stack([getattr(p, f) for p in parts])
            for f in parts[0]._fields[:2]})

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        top, name = path[0], path[-1]
        if weight_bits == 4:
            if (top == "head" and name == "w2" and tree.ndim == 2
                    and head_bits == 4):
                return quantize_weight_int4_lanes(tree)
            if top == "decoder" and tree.ndim == 3 and (
                    name in _W4_KEYS
                    or (name == "q" and "cross_attn" in path)):
                return stacked(tree, quantize_weight_int4_lanes)
        if (top == "decoder" or (quantize_encoder and top == "encoder")) \
                and name in _QUANT_KEYS and tree.ndim == 3:
            return stacked(tree, int8)
        if top == "head" and name in ("w1", "w2"):
            return int8(tree)
        return tree

    return walk(params, ())


# ---------------------------------------------------------------------------
# the grouped int4 reference (plain PyTorch: the JAX package has no kernel)
# ---------------------------------------------------------------------------


class Quant4Weight(NamedTuple):
    """Grouped int4 weights, the JAX ``Quant4Weight`` without its N
    padding: ``packed`` int8 [..., K/2, N] in the halves layout (byte row
    i holds K row i in its low nibble and K row i + K/2 in its high
    nibble), ``scale`` f32 [..., K/group, N] per (K group, channel)."""

    packed: torch.Tensor
    scale: torch.Tensor
    n: int
    group: int = 128


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Quant4Weight:
    """Per-(K-group, channel) absmax int4 quantization of ``w [..., K, N]``
    (levels -7..7, scale ``max(absmax, 1e-8) / 7``), nibble-packed."""
    *lead, k, n = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs even K (got {k})")
    if k % group:
        raise ValueError(f"K ({k}) must be a multiple of group ({group})")
    grouped = w.float().reshape(*lead, k // group, group, n)
    scale = absmax_scale(grouped.abs().amax(dim=-2), 7.0)      # [..., K/g, N]
    q = torch.round(grouped / scale[..., None, :]).clamp(-7, 7)
    q = q.to(torch.int32).reshape(*lead, k, n)
    packed = (q[..., :k // 2, :] & 15) | (q[..., k // 2:, :] << 4)
    return Quant4Weight(packed.to(torch.int8), scale, n, group)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 [..., K/2, N] (halves layout) -> int8 levels [..., K, N]."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8
    return torch.cat([lo, p >> 4], dim=-2).to(torch.int8)


def dequantize_int4(qw: Quant4Weight) -> torch.Tensor:
    """Reference dequantization -> f32 [..., K, N]."""
    w8 = unpack_int4(qw.packed).float()
    *lead, k, n = w8.shape
    g = qw.group
    return (w8.reshape(*lead, k // g, g, n)
            * qw.scale[..., :, None, :]).reshape(*lead, k, n)


def q4_matmul(x: torch.Tensor, qw: Quant4Weight) -> torch.Tensor:
    """Reference grouped W4A8 product: per-row int8 activations, an exact
    integer dot per K group rescaled by its group scale, f32 accumulation
    across groups in order, then the row scale."""
    *lead, k = x.shape
    x8, sx = quantize_act_plain(x.reshape(-1, k))
    w8 = unpack_int4(qw.packed)                                 # [K, N]
    g = qw.group
    acc = torch.zeros((x8.shape[0], qw.n), device=x.device)
    for gi in range(k // g):
        part = int_matmul_exact(x8[:, gi * g:(gi + 1) * g],
                                w8[gi * g:(gi + 1) * g].t())
        acc = acc + part.float() * qw.scale[gi][None, :]
    return (acc * sx).to(x.dtype).reshape(*lead, qw.n)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/w8a8_matmul.cu, csrc/w4a8_matmul.cu,
# csrc/w8a16_matmul.cu)
# ---------------------------------------------------------------------------


def _bind(lib: str, name: str):
    from . import cuda_build

    fn = getattr(cuda_build.load(lib), name)
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "t5g_quantize_rows":
            fn.argtypes = [vp, i32, i32, i32, vp, vp, vp]
        elif name == "t5g_row_absmax":
            fn.argtypes = [vp, i32, i32, i32, vp, vp]
        elif name == "t5g_quantize_rows_amax":
            fn.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp]
        elif name.endswith("_int"):
            fn.argtypes = [vp, i32, i32, vp, i32, vp, vp, vp]
        elif name == "t5g_rescale_rows":
            fn.argtypes = [vp, vp, vp, i32, i32, vp, i32, vp]
        elif name == "t5g_w8a16_matmul":
            fn.argtypes = [vp, i32, i32, i32, vp, vp, i32, vp, i32, i32, vp,
                           vp, vp]
        elif name.endswith("_plan"):
            fn.argtypes = [i32, i32, i32, vp]
        elif name == "t5g_w8a8_gemv":
            fn.argtypes = [vp, i32, i32, i32, vp, vp, i32, vp, i32, vp, vp,
                           i32, vp]
        else:
            fn.argtypes = [vp, i32, i32, i32, vp, vp, i32, vp, i32, vp, vp,
                           vp, vp]
        fn.restype = ctypes.c_int
    return fn


def gemv_route(x: torch.Tensor, w: Weight,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The W8A8 / W4A8 product on the GEMV of ``csrc/w8a8.cuh`` at any M:
    the route that the kernels take only for small M, kept callable so
    that a measurement can time it beside the tensor-core route. No caller
    on the main path; counts no launch."""
    if x.device.type != "cuda":
        raise ValueError(f"gemv_route: no kernel for {x.device}")
    if isinstance(w, QuantWeight) and w.act_bits == 16:
        raise ValueError("gemv_route takes W8A8 or W4A8 weights")
    return _launch(x, w, out_dtype or x.dtype, gemv=True)


def product_plan(m: int, w: Weight) -> dict:
    """How the card computes a quantized product of ``m`` rows with ``w``:
    ``route`` "gemv" or "tensor_cores", and for the latter its tiling
    (wgmma width ``ni``, row tiles, channel tiles, K tiles, K splits, CTAs
    per SM): ``csrc/w8a8_tc.cuh``'s for W8A8 / W4A8,
    ``csrc/w8a16_matmul.cu``'s for W8A16 (tensor cores at every M).
    Builds the kernel library."""
    w4 = isinstance(w, Int4Weight)
    name = "w4a8" if w4 else ("w8a16" if w.act_bits == 16 else "w8a8")
    n = w.n
    k = w.packed.shape[-1] * 2 if w4 else w.values.shape[-1]
    plan = (ctypes.c_int * 6)()
    splits = _bind(f"{name}_matmul", f"t5g_{name}_plan")(m, n, k,
                                                         ctypes.byref(plan))
    if splits < 0:
        raise ValueError(f"{name}: the tensor-core route refuses K={k}")
    keys = ("ni", "rowtiles", "ntiles", "ktiles", "splits", "per_sm")
    out = dict(zip(keys, list(plan)))
    out["route"] = "tensor_cores" if out["ni"] else "gemv"
    return out


def _run(fn, what: str, dev: torch.device, *args) -> None:
    """Call a library entry on ``dev``'s current stream; raise on an error."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch(x: torch.Tensor, w: Weight, out_dtype: torch.dtype, *,
            gemv: bool = False):
    """The W8A8, W4A8 or W8A16 kernel, by the weight's format; ``gemv``
    takes the GEMV route of a W8A8 / W4A8 product at any M."""
    dev = x.device
    w4 = isinstance(w, Int4Weight)
    a16 = not w4 and w.act_bits == 16
    name = "w4a8_matmul" if w4 else ("w8a16_matmul" if a16 else "w8a8_matmul")
    wt = w.packed if w4 else w.values
    if x.ndim != 2 or wt.ndim != 2:
        raise ValueError("the quantized product takes x [M, K] and a 2-D "
                         "weight")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x has dtype {x.dtype}, expected f32 or bf16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} is not f32 or bf16")
    m, k = x.shape
    n = wt.shape[0]
    if k % 16:
        raise ValueError(f"K={k} must be a multiple of 16 (one 16-byte load "
                         f"of activations, 16 weights a load)")
    if w4 and k > 65536:
        raise ValueError(f"K={k}: the W4A8 kernel's int32 sums of 16 q x "
                         f"are exact up to K = 65536")
    x = x.contiguous()
    if x.data_ptr() % 16:          # a view at an odd offset: the kernels
        x = x.clone()              # load x 16 bytes at a time
    _check("weight", wt, dev, torch.int8, (n, k // 2 if w4 else k))
    _check("scale", w.scale, dev, torch.float32, (n,))
    if wt.data_ptr() % 16:
        raise ValueError("the weight must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    args = [x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
            wt.data_ptr(), w.scale.data_ptr(), n, out.data_ptr(),
            int(out_dtype == torch.bfloat16)]
    if not a16:                    # the int8 activations' workspace
        x8 = torch.empty((m, k), dtype=torch.int8, device=dev)
        sx = torch.empty((m,), dtype=torch.float32, device=dev)
        args += [x8.data_ptr(), sx.data_ptr()]
    with torch.cuda.device(dev):
        if a16:
            fn = _bind(name, "t5g_" + name)
            # one scratch: x rounded to bf16 (f32 x), then the split-K
            # partials [splits, M, N] f32
            splits = _bind(name, "t5g_w8a16_plan")(m, n, k, None)
            xb = 0 if x.dtype == torch.bfloat16 else -(-m * k // 128) * 256
            nbytes = xb + 4 * splits * m * n
            scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
                       if nbytes else None)
            base = _ptr(scratch)
            args += [0,              # 0: the plan's K splits
                     base if xb else None, base + xb if splits else None]
        elif gemv:
            fn = _bind("w8a8_matmul", "t5g_w8a8_gemv")
            args.append(int(w4))
        else:
            fn = _bind(name, "t5g_" + name)
        if not (gemv or a16):
            # the tensor-core route's split-K scratch, [splits, M, N] int32
            splits = _bind(name, f"t5g_{name[:4]}_plan")(m, n, k, None)
            if splits < 0:
                raise ValueError(
                    f"{name}: the tensor-core route refuses M={m}, K={k} "
                    f"(K must be a multiple of {32 if w4 else 16}: TMA reads "
                    f"the {'packed int4' if w4 else 'int8'} weight rows, "
                    f"whose stride must be a multiple of 16 bytes)")
            part = (torch.empty((splits, m, n), dtype=torch.int32,
                                device=dev) if splits else None)
            args.append(part.data_ptr() if part is not None else None)
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out

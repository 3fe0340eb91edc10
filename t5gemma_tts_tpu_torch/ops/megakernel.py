"""The int8- and int4-weight decode layer: hand-written CUDA kernels and
their plain PyTorch version.

Counterpart of ``t5gemma_tts_tpu/ops/megakernel.py`` for W8A8 weights and
for its w4 variant (int4 weights, the batch-1 latency mode), with its
``chain`` variant (the speculative verify pass): :func:`supports`,
:func:`decode_layer` (one layer) and :func:`decode_stack` (all layers). On
a CUDA tensor both launch ``csrc/decode_layer.cu`` (built with nvcc at
first use, see ops/cuda_build.py; ``decode_stack`` is one host call per
decode step or verify pass) or raise; on a CPU tensor they run
:func:`decode_layer_plain`.
``.launches`` on each wrapper counts calls into the CUDA library.

What a layer computes (the TPU kernel's semantics, all in f32; the hidden
state is never rounded between layers):

- RMSNorm ``(x * rsqrt(mean(x^2) + eps)) * (1 + w)``;
- per-row int8 activations (``round`` half to even) and products
  ``(f32(x8 @ w) * sx) * s`` over int8 levels (``QuantWeight``) or int4
  levels (``Int4Weight``; the TPU kernel's lanes4 AND-mask dots recover the
  same exact integer sums); the o / cross-o products sum exactly over all
  of K before the one rescale;
- RoPE on the f32 projections, q scaled after RoPE; the cross query uses
  the PM-RoPE tables; the in-flight k/v are the unrounded f32 post-RoPE k
  and v, returned as ``k_new``/``v_new``;
- attention over 128-token blocks of the prompt and generation slabs (self)
  or the encoder slab (cross, length clamped to >= 1) with bf16 q for the
  page dots, bf16 p (int8 pages: bf16 ``p * v_scale``) for the PV dot, int8
  logits scaled by the k scale after the dot, the tanh soft cap before the
  ``-0.7 * f32max`` mask, and the in-flight token folded in last with the
  unrounded q;
- GeGLU whose intermediate is quantized per 512-wide F tile (one tile of
  width F when F < 512), the down product summed in f32 in tile order.

Slabs are the cache's identity layout ``[Hkv, L*B, T, hd]`` (layer li, row
b is slab row ``li * B + b``), bf16 or int8 with per-token f32 scale planes
``[Hkv, L*B, T]``.

On the card the attention is split-KV: :func:`attention_plan` cuts the
slabs' capacity (never the lengths, so a launch needs no host sync and a
CUDA graph captures it) into chunks of one CTA each, whose partials a merge
kernel combines with the in-flight token. A first pass writes the logits
and each chunk's maximum, so that the second rounds p relative to the
running max of its 128-token block, as the plain version does.

``chain = S > 1``: h and the per-row inputs carry ``B * S`` pseudo-rows, the
S chain positions of each cache row in order; pseudo-row b reads the slabs
of cache row ``b // S``, and its in-flight part is its chain prefix
j = 0 .. i (i = b mod S): positions j < i store-rounded as the cache holds
them (bf16, with int8 pages also the per-token quantize-dequantize) and
dotted with the bf16-rounded q, position i raw with the raw q.

The TPU kernel's 32-row batch padding, its int8-KV ``batch % 8`` gate and
its tiled weight layouts have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from .fused_attn import MASK_VALUE, _check, quantize_kv, split_plan
from .quant import (Int4Weight, QuantWeight, int4_levels, int_matmul_exact,
                    quantize_act_plain)

WTILE = 512      # GeGLU tile width (the TPU kernel's weight tile)
TBLOCK = 128     # attention time block (= the cache's page size)

_NORMS = ("pre_self_attn_norm", "post_self_attn_norm", "pre_cross_attn_norm",
          "post_cross_attn_norm", "pre_ff_norm", "post_ff_norm")


def _weights(layers: Dict[str, Any]):
    """(qkv, o, cross q, cross o, gate_up, down) of the layer tree."""
    sa, ca, mlp = layers["self_attn"], layers["cross_attn"], layers["mlp"]
    return (sa.get("qkv"), sa.get("o"), ca.get("q"), ca.get("o"),
            mlp.get("gate_up"), mlp.get("down"))


def ftile_of(f: int) -> int:
    return WTILE if f % WTILE == 0 else f


def widths_fit(d: int, ho: int, f: int) -> bool:
    """Whether the kernels take a decoder's widths: hidden ``d``, heads x
    head_dim ``ho`` and intermediate ``f`` multiples of 16 (one 8-byte
    load of int4 weights is 16 levels), and an ``f`` that tiles by 512 or
    is below it."""
    return all(w % 16 == 0 for w in (d, ho, f)) and ftile_of(f) <= WTILE


def supports(params_layers: Dict[str, Any], dims, cache) -> bool:
    """Whether the decode-layer path applies: fused W8A8 weights of every
    projection, or int4 weights of every projection (mixed int4 and int8
    is refused), bf16 pages or int8 pages with scale planes, widths the
    kernels take (:func:`widths_fit`) and a head_dim that is a multiple of
    8 up to 256."""
    ws = _weights(params_layers)
    w8 = all(isinstance(w, QuantWeight) and w.act_bits == 8
             and w.values.ndim == 3 for w in ws)
    w4 = all(isinstance(w, Int4Weight) and w.packed.ndim == 3 for w in ws)
    if not (w8 or w4):
        return False
    pages = cache.gen_k.dtype
    if not (pages == torch.bfloat16
            or (pages == torch.int8 and cache.gen_k_scale is not None)):
        return False
    hd = dims.head_dim
    return (widths_fit(dims.hidden_size, dims.num_heads * hd,
                       dims.intermediate_size)
            and hd % 8 == 0 and hd <= 256)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def _levels(w, li: int) -> torch.Tensor:
    """Layer ``li``'s int8 levels [N, K] (int4 weights unpacked)."""
    if isinstance(w, Int4Weight):
        return int4_levels(w.packed[li])
    return w.values[li]


def _w8a8(x8, sx, w, li: int) -> torch.Tensor:
    """(f32(x8 @ w[li]) * sx) * s[li] -> f32."""
    return int_matmul_exact(x8, _levels(w, li)).float() * sx * w.scale[li]


def _rope(x, cos, sin):
    """x [B, n, hd] f32, cos/sin [B, hd] -> x * cos + rot_half(x) * sin."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), operation for operation."""
    inner = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _segment_blocks(slab, scale, lens, li: int, chain: int):
    """Yield (k, k_scale, v, v_scale, valid) per 128-token block of one
    segment for all (pseudo-)rows: k/v [B, Hkv, TBLOCK, hd] f32, scales
    [B, Hkv, TBLOCK] or None, valid [B, TBLOCK]."""
    k_slab, v_slab = slab
    ks_slab, vs_slab = scale if scale is not None else (None, None)
    t = k_slab.shape[2]
    b = lens.shape[0]
    rows = li * (b // chain) + torch.arange(b, device=lens.device) // chain
    pages = t // TBLOCK
    nblocks = int((lens.max().clamp_min(0) + TBLOCK - 1) // TBLOCK)
    col = torch.arange(TBLOCK, device=lens.device)
    for i in range(nblocks):
        # a length past the slab re-reads its last page, as the TPU kernel does
        tok = slice(min(i, pages - 1) * TBLOCK, (min(i, pages - 1) + 1) * TBLOCK)
        k = k_slab[:, rows, tok].transpose(0, 1).float()
        v = v_slab[:, rows, tok].transpose(0, 1).float()
        ks = vs = None
        if ks_slab is not None:
            ks = ks_slab[:, rows, tok].transpose(0, 1)
            vs = vs_slab[:, rows, tok].transpose(0, 1)
        valid = (i * TBLOCK + col)[None, :] < lens[:, None]
        yield k, ks, v, vs, valid


def _store_round(x: torch.Tensor, int8_pages: bool) -> torch.Tensor:
    """A fresh k or v [..., hd] f32 as the cache gives it back: bf16, and
    with int8 pages the per-token quantize-dequantize."""
    xb = x.to(torch.bfloat16).float()
    if not int8_pages:
        return xb
    levels, scale = quantize_kv(xb)
    return levels.float() * scale[..., None]


def slab_attention_plain(q, segments, soft_cap: Optional[float], li: int,
                         k_cur=None, v_cur=None, chain: int = 1
                         ) -> torch.Tensor:
    """The decode layer's attention, block by block as the kernel walks it.
    q [B, H, hd] f32 (roped, scaled); ``segments`` a list of
    ((k_slab, v_slab), scales or None, lengths [B]); k_cur/v_cur
    [B, Hkv, hd] f32 or None (with ``chain``, pseudo-row b folds in the
    chain prefix of its cache row) -> [B, H * hd] f32."""
    b, h, hd = q.shape
    hkv = segments[0][0][0].shape[0]
    g = h // hkv
    qf = q.reshape(b, hkv, g, hd)
    qb = qf.to(torch.bfloat16).float()
    m = torch.full((b, hkv, g, 1), MASK_VALUE, device=q.device)
    l = torch.zeros((b, hkv, g, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, hd), device=q.device)

    def capped(x):
        return x if soft_cap is None else torch.tanh(x / soft_cap) * soft_cap

    for slab, scale, lens in segments:
        for k, ks, v, vs, valid in _segment_blocks(slab, scale, lens, li,
                                                   chain):
            raw = torch.einsum("bkgh,bkth->bkgt", qb, k)
            if ks is not None:
                raw = raw * ks[:, :, None, :]
            valid4 = valid[:, None, None, :]
            logits = torch.where(valid4, capped(raw), MASK_VALUE)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.where(valid4, torch.exp(logits - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = p * vs[:, :, None, :] if vs is not None else p
            blk = torch.einsum("bkgt,bkth->bkgh",
                               pv.to(torch.bfloat16).float(), v)
            acc = acc * alpha + blk
            m = m_new
    if k_cur is not None:
        rows = torch.arange(b, device=q.device)
        base, pos_in = rows - rows % chain, rows % chain
        int8_pages = segments[0][1] is not None
        for j in range(chain):
            use = (j <= pos_in)[:, None, None, None]
            self_ = (j == pos_in)[:, None, None, None]
            ck, cv = k_cur[base + j], v_cur[base + j]
            if chain > 1:
                own = self_[..., 0]
                ck = torch.where(own, ck, _store_round(ck, int8_pages))
                cv = torch.where(own, cv, _store_round(cv, int8_pages))
            qj = torch.where(self_, qf, qb)
            cur = capped((qj * ck[:, :, None, :]).sum(dim=-1, keepdim=True))
            m_new = torch.maximum(m, cur)
            pc = torch.exp(cur - m_new)
            alpha = torch.exp(m - m_new)
            l = torch.where(use, l * alpha + pc, l)
            acc = torch.where(use, acc * alpha + pc * cv[:, :, None, :], acc)
            m = torch.where(use, m_new, m)
    out = acc / torch.where(l > 0.0, l, 1.0)
    return out.reshape(b, h * hd)


def decode_layer_plain(params_layers, dims, *, h, cos, sin, qcos, qsin, li,
                       plens, glens, elens, prompt_k, prompt_v, gen_k, gen_v,
                       cross_k, cross_v, kv_scales=None, chain: int = 1):
    """Whole-tensor PyTorch version of one layer (same arguments as
    :func:`decode_layer`) -> (h [B, D], k_new [B, Hkv, hd],
    v_new [B, Hkv, hd]), all f32."""
    eps = dims.rms_norm_eps
    n_heads, hkv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    b = h.shape[0]
    ho, nkv = n_heads * hd, hkv * hd
    cap = dims.attn_logit_softcap
    n0, n1, n2, n3, n4, n5 = (params_layers[n][li].float() for n in _NORMS)
    w_qkv, w_o, w_cq, w_co, w_gu, w_dn = _weights(params_layers)
    sc = kv_scales or (None,) * 6
    h = h.float()

    x8, sx = quantize_act_plain(_rms(h, n0, eps))
    qkv = _w8a8(x8, sx, w_qkv, li)
    q = _rope(qkv[:, :ho].reshape(b, n_heads, hd), cos, sin) * dims.q_scale
    k_new = _rope(qkv[:, ho:ho + nkv].reshape(b, hkv, hd), cos, sin)
    v_new = qkv[:, ho + nkv:ho + 2 * nkv].reshape(b, hkv, hd)
    attn = slab_attention_plain(
        q, [((prompt_k, prompt_v), _pair(sc[0], sc[1]), plens),
            ((gen_k, gen_v), _pair(sc[2], sc[3]), glens)],
        cap, li, k_new, v_new, chain)
    a8, sa = quantize_act_plain(attn)
    h = h + _rms(_w8a8(a8, sa, w_o, li), n1, eps)

    x8, sx = quantize_act_plain(_rms(h, n2, eps))
    cq = _rope(_w8a8(x8, sx, w_cq, li).reshape(b, n_heads, hd), qcos, qsin)
    attn = slab_attention_plain(
        cq * dims.q_scale,
        [((cross_k, cross_v), _pair(sc[4], sc[5]), elens.clamp_min(1))],
        cap, li, chain=chain)
    a8, sa = quantize_act_plain(attn)
    h = h + _rms(_w8a8(a8, sa, w_co, li), n3, eps)

    x8, sx = quantize_act_plain(_rms(h, n4, eps))
    gu = _w8a8(x8, sx, w_gu, li)
    f = dims.intermediate_size
    ft = ftile_of(f)
    acc = torch.zeros((b, w_dn.n), device=h.device)
    dn = _levels(w_dn, li)
    for j in range(f // ft):
        g = gu[:, j * ft:(j + 1) * ft]
        u = gu[:, f + j * ft:f + (j + 1) * ft]
        t8, st = quantize_act_plain(gelu_tanh(g) * u)
        acc = acc + int_matmul_exact(
            t8, dn[:, j * ft:(j + 1) * ft]).float() * st
    h = h + _rms(acc * w_dn.scale[li], n5, eps)
    return h, k_new, v_new


def decode_stack_plain(params_layers, dims, *, h, **args):
    """:func:`decode_layer_plain` over all layers in order -> (h [B, D],
    k_new [L, B, Hkv, hd], v_new [L, B, Hkv, hd])."""
    ks, vs = [], []
    for li in range(dims.num_layers):
        h, k, v = decode_layer_plain(params_layers, dims, h=h, li=li, **args)
        ks.append(k)
        vs.append(v)
    return h, torch.stack(ks), torch.stack(vs)


def _pair(a, b):
    return None if a is None else (a, b)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def decode_layer(params_layers, dims, *, h, cos, sin, qcos, qsin, li: int,
                 plens, glens, elens, prompt_k, prompt_v, gen_k, gen_v,
                 cross_k, cross_v, kv_scales=None, chain: int = 1):
    """Decoder layer ``li`` of the stacked int8 or int4 layer tree.

    h [B, D]; cos/sin/qcos/qsin [B, hd] f32; plens/glens/elens [B] int32;
    slabs the cache's [Hkv, L*Bc, T, hd] buffers (Bc = B / chain cache
    rows), with ``kv_scales`` the six [Hkv, L*Bc, T] scale planes (prompt
    k, prompt v, gen k, gen v, cross k, cross v) when the pages are int8.
    Returns (h [B, D], k_new [B, Hkv, hd], v_new [B, Hkv, hd]), all f32."""
    args = dict(h=h, cos=cos, sin=sin, qcos=qcos, qsin=qsin, plens=plens,
                glens=glens, elens=elens, prompt_k=prompt_k,
                prompt_v=prompt_v, gen_k=gen_k, gen_v=gen_v, cross_k=cross_k,
                cross_v=cross_v, kv_scales=kv_scales, chain=chain)
    if h.device.type == "cpu":
        return decode_layer_plain(params_layers, dims, li=li, **args)
    if h.device.type != "cuda":
        raise ValueError(f"decode_layer: no kernel for {h.device}")
    hout, k_new, v_new = _launch(params_layers, dims, li=li, **args)
    decode_layer.launches += 1
    return hout, k_new[0], v_new[0]


decode_layer.launches = 0


def decode_stack(params_layers, dims, *, h, cos, sin, qcos, qsin, plens,
                 glens, elens, prompt_k, prompt_v, gen_k, gen_v, cross_k,
                 cross_v, kv_scales=None, chain: int = 1):
    """All decoder layers in order (same arguments as :func:`decode_layer`
    without ``li``) -> (h [B, D], k_new [L, B, Hkv, hd], v_new), f32. On
    the card this is one call into the CUDA library."""
    args = dict(h=h, cos=cos, sin=sin, qcos=qcos, qsin=qsin, plens=plens,
                glens=glens, elens=elens, prompt_k=prompt_k,
                prompt_v=prompt_v, gen_k=gen_k, gen_v=gen_v, cross_k=cross_k,
                cross_v=cross_v, kv_scales=kv_scales, chain=chain)
    if h.device.type == "cpu":
        return decode_stack_plain(params_layers, dims, **args)
    if h.device.type != "cuda":
        raise ValueError(f"decode_stack: no kernel for {h.device}")
    out = _launch(params_layers, dims, li=None, **args)
    decode_stack.launches += 1
    return out


decode_stack.launches = 0


# ---------------------------------------------------------------------------
# the CUDA library (csrc/decode_layer.cu)
# ---------------------------------------------------------------------------

_vp, _i32 = ctypes.c_void_p, ctypes.c_int


class _DecodeArgs(ctypes.Structure):
    """Field by field the ``DecodeArgs`` struct of csrc/decode_layer.cu."""

    _fields_ = ([(n, _vp) for n in ("h", "cos", "sin", "qcos", "qsin",
                                    "plens", "glens", "elens")]
                + [(n, _vp * 6) for n in ("w", "ws", "norms", "slab",
                                          "slab_scale")]
                + [(n, _vp) for n in ("k_new", "v_new", "x8", "sx", "proj",
                                      "qbuf", "dout", "attn_logits",
                                      "part_cmax", "part_acc", "part_m",
                                      "part_l")]
                + [(n, _i32) for n in ("B", "D", "H", "Hkv", "hd", "F", "L",
                                       "ftile", "Tp", "Tg", "Tx",
                                       "kv_quant", "w4", "chain",
                                       "chunk_self", "splits_self",
                                       "chunk_cross", "splits_cross")]
                + [(n, ctypes.c_float) for n in ("eps", "soft_cap",
                                                 "q_scale")])


def attention_plan(dims, prompt_k: torch.Tensor, gen_k: torch.Tensor,
                   cross_k: torch.Tensor) -> Dict[str, Tuple[int, int]]:
    """(chunk, splits) of the layer's self and cross attention, from the
    slabs' shapes alone ([Hkv, L*Bc, T, hd]: Bc x Hkv (cache row, kv head)
    pairs over the prompt + generation capacity, and over the encoder's)."""
    hkv, rows = prompt_k.shape[:2]
    pairs = hkv * (rows // dims.num_layers)
    return {"self": split_plan(pairs, prompt_k.shape[2] + gen_k.shape[2],
                               TBLOCK),
            "cross": split_plan(pairs, cross_k.shape[2], TBLOCK)}


def _bind(name: str):
    from . import cuda_build

    fn = getattr(cuda_build.load("decode_layer"), name)
    if fn.argtypes is None:
        args = [ctypes.POINTER(_DecodeArgs)]
        fn.argtypes = args + ([_i32, _vp] if name == "t5g_decode_layer"
                              else [_vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(params_layers, dims, *, h, cos, sin, qcos, qsin, li, plens, glens,
            elens, prompt_k, prompt_v, gen_k, gen_v, cross_k, cross_v,
            kv_scales, chain
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = h.device
    b, d = h.shape
    if chain < 1 or b % chain:
        raise ValueError(f"{b} rows do not hold whole chains of {chain}")
    n_heads, hkv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    f, n_layers = dims.intermediate_size, dims.num_layers
    ho, nkv = n_heads * hd, hkv * hd
    ft = ftile_of(f)
    shapes = ((ho + 2 * nkv, d), (d, ho), (ho, d), (d, ho), (2 * f, d), (d, f))
    weights = _weights(params_layers)
    w4 = isinstance(weights[0], Int4Weight)
    for name, w, (n, k) in zip(("qkv", "o", "cross q", "cross o", "gate_up",
                                "down"), weights, shapes):
        if isinstance(w, Int4Weight) != w4:
            raise ValueError("the six products mix int4 and int8 weights")
        _check(f"{name} weights", w.packed if w4 else w.values, dev,
               torch.int8, (n_layers, n, k // 2 if w4 else k))
        _check(f"{name} scale", w.scale, dev, torch.float32, (n_layers, n))
    norms = [params_layers[n].float().contiguous() for n in _NORMS]
    for name, t in zip(_NORMS, norms):
        _check(name, t, dev, torch.float32, (n_layers, d))
    quant = kv_scales is not None
    slabs = (prompt_k, prompt_v, gen_k, gen_v, cross_k, cross_v)
    for i, s in enumerate(slabs):
        _check(f"slab {i}", s, dev, torch.int8 if quant else torch.bfloat16)
        if (s.shape[0] != hkv or s.shape[1] != n_layers * (b // chain)
                or s.shape[3] != hd):
            raise ValueError(f"slab {i} has shape {tuple(s.shape)}")
        if s.shape[2] % TBLOCK or s.data_ptr() % 16:
            raise ValueError(f"slab {i} must hold whole pages, 16-byte aligned")
        if quant:
            _check(f"scale plane {i}", kv_scales[i], dev, torch.float32,
                   s.shape[:3])
    tabs = [t.float().contiguous() for t in (cos, sin, qcos, qsin)]
    for t in tabs:
        _check("rope table", t, dev, torch.float32, (b, hd))
    lens = [x.to(torch.int32).contiguous() for x in (plens, glens, elens)]
    for x in lens:
        _check("lengths", x, dev, torch.int32, (b,))

    plan = attention_plan(dims, prompt_k, gen_k, cross_k)
    splits = max(plan["self"][1], plan["cross"][1])
    run = n_layers if li is None else 1
    hout = h.float().clone()
    k_new = torch.empty((run, b, hkv, hd), dtype=torch.float32, device=dev)
    v_new = torch.empty_like(k_new)
    ws = dict(
        x8=torch.empty((b, max(d, ho, f)), dtype=torch.int8, device=dev),
        sx=torch.empty((b, max(1, f // ft)), dtype=torch.float32, device=dev),
        proj=torch.empty((b, max(ho + 2 * nkv, 2 * f)), dtype=torch.float32,
                         device=dev),
        qbuf=torch.empty((b, ho), dtype=torch.float32, device=dev),
        dout=torch.empty((b, d), dtype=torch.float32, device=dev),
        part_acc=torch.empty((b // chain, hkv, splits,
                              chain * (n_heads // hkv), hd),
                             dtype=torch.float32, device=dev),
        part_m=torch.empty((b // chain, hkv, splits, chain * (n_heads // hkv)),
                           dtype=torch.float32, device=dev),
        attn_logits=torch.empty(
            (b // chain, hkv, chain * (n_heads // hkv),
             max(prompt_k.shape[2] + gen_k.shape[2], cross_k.shape[2])),
            dtype=torch.float32, device=dev))
    ws["part_l"] = torch.empty_like(ws["part_m"])
    ws["part_cmax"] = torch.empty_like(ws["part_m"])
    a = _DecodeArgs(
        h=hout.data_ptr(), cos=tabs[0].data_ptr(), sin=tabs[1].data_ptr(),
        qcos=tabs[2].data_ptr(), qsin=tabs[3].data_ptr(),
        plens=lens[0].data_ptr(), glens=lens[1].data_ptr(),
        elens=lens[2].data_ptr(),
        w=(_vp * 6)(*((w.packed if w4 else w.values).data_ptr()
                      for w in weights)),
        ws=(_vp * 6)(*(w.scale.data_ptr() for w in weights)),
        norms=(_vp * 6)(*(t.data_ptr() for t in norms)),
        slab=(_vp * 6)(*(s.data_ptr() for s in slabs)),
        slab_scale=(_vp * 6)(*((s.data_ptr() for s in kv_scales) if quant
                               else (None,) * 6)),
        k_new=k_new.data_ptr(), v_new=v_new.data_ptr(),
        **{k: v.data_ptr() for k, v in ws.items()},
        B=b, D=d, H=n_heads, Hkv=hkv, hd=hd, F=f, L=n_layers, ftile=ft,
        Tp=prompt_k.shape[2], Tg=gen_k.shape[2], Tx=cross_k.shape[2],
        kv_quant=int(quant), w4=int(w4), chain=chain,
        chunk_self=plan["self"][0], splits_self=plan["self"][1],
        chunk_cross=plan["cross"][0], splits_cross=plan["cross"][1],
        eps=dims.rms_norm_eps,
        soft_cap=dims.attn_logit_softcap or 0.0, q_scale=dims.q_scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if li is None:
            err = _bind("t5g_decode_stack")(ctypes.byref(a), stream)
        else:
            err = _bind("t5g_decode_layer")(ctypes.byref(a), int(li), stream)
    if err != 0:
        raise RuntimeError(f"decode layer kernels failed: CUDA error {err}")
    return hout, k_new, v_new


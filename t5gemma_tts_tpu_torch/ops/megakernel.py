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

Tensor parallelism: a rank's layers (its heads, its F columns) run as
seven parts a layer (:class:`TpLayers`, ``t5g_decode_layer_part``; plain
twin :func:`decode_layer_part_plain`), split where the one-process layer
sums over heads or over F, and the model group reduces between them: the
attention rows' absmax (MAX) before the o / cross-o quantization, the o /
cross-o int32 sums (SUM), the GeGLU tiles' absmax (MAX; a tile may span
ranks) and down's per-tile int32 sums (SUM), whose f32 sum then runs in
the one-process tile order. The attention's split-KV plan is the
one-process call's (:func:`attention_plan` over the whole model's kv
heads), so each (row, kv head) pair's partial sums are the one-process
kernel's too: a rank's arithmetic is the one-process layer's, on the card
as on the CPU. With ``chain = S`` (a verify pass) the parts run over the
B = Bc * S pseudo-rows as the one call does, and the reductions over
their rows. The caller runs a rank's block through
:func:`decode_stack_tp` with its rank's widths and the group's reductions
(``group_max`` / ``group_sum``); this module knows no mesh. :func:`decode_stack` stays the one call of the whole model, and
refuses a rank's block.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .fused_attn import MASK_VALUE, _check, quantize_kv, split_plan
from .quant import (Int4Weight, QuantWeight, absmax_scale, int4_levels,
                    int_matmul_exact, quantize_act_amax, quantize_act_plain)

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


def supports(params_layers: Dict[str, Any], dims, cache,
             rank_dims=None) -> bool:
    """Whether the decode-layer path applies: fused W8A8 weights of every
    projection, or int4 weights of every projection (mixed int4 and int8
    is refused), bf16 pages or int8 pages with scale planes, widths the
    kernels take (:func:`widths_fit`) and a head_dim that is a multiple of
    8 up to 256. ``dims`` are the whole model's, on a tensor-parallel rank
    too; ``rank_dims``, a rank's heads and F when the leaves are its block:
    a block whose split the parts cannot run (:class:`TpLayers`) raises
    instead of leaving the path."""
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
    if not (widths_fit(dims.hidden_size, dims.num_heads * hd,
                       dims.intermediate_size)
            and hd % 8 == 0 and hd <= 256):
        return False
    if rank_dims is not None:
        _check_rank(params_layers, rank_dims)
    return True


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
    _check_whole(params_layers, dims)
    if h.device.type == "cpu":
        return decode_stack_plain(params_layers, dims, **args)
    if h.device.type != "cuda":
        raise ValueError(f"decode_stack: no kernel for {h.device}")
    out = _launch(params_layers, dims, li=None, **args)
    decode_stack.launches += 1
    return out


decode_stack.launches = 0


# ---------------------------------------------------------------------------
# a tensor-parallel rank's layers, in parts
# ---------------------------------------------------------------------------

PARTS = 7
# after each part: the buffer the group reduces, and how ("amax": the row
# or tile absmax, MAX; "isum": the int32 sums, SUM), and whether it is the
# attention's (a split of the heads) or the MLP's (a split of F)
PART_REDUCE = {0: ("amax", "attn"), 1: ("isum", "attn"), 2: ("amax", "attn"),
               3: ("isum", "attn"), 4: ("amax", "mlp"), 5: ("isum", "mlp")}


def _in_width(w) -> int:
    """K of a quantized [L, N, K] leaf (int4: two levels a byte)."""
    return 2 * w.packed.shape[-1] if isinstance(w, Int4Weight) \
        else w.values.shape[-1]


def _check_whole(params_layers, dims) -> None:
    """Raise where the leaves are a tensor-parallel rank's block."""
    _, o, _, _, _, down = _weights(params_layers)
    if (_in_width(o) != dims.num_heads * dims.head_dim
            or _in_width(down) != dims.intermediate_size):
        raise ValueError(
            "decode_stack: the leaves are a tensor-parallel shard's, which "
            "runs only inside parallel.tensor.model_parallel(mesh), through "
            "decode_stack_tp")


def _check_rank(params_layers, rank_dims) -> None:
    """Raise where the parts cannot run a rank's block."""
    hd, f = rank_dims.head_dim, rank_dims.intermediate_size
    if f % 16 or (rank_dims.num_heads * hd) % 16:
        raise ValueError(
            f"tensor-parallel decode layers need a rank's F ({f}) and heads "
            f"x head_dim ({rank_dims.num_heads * hd}) to be multiples of 16")
    if isinstance(params_layers["mlp"]["down"], Int4Weight) and f % 32:
        raise ValueError(f"int4 down weights split along F in whole 32-level "
                         f"rows: a rank's F is {f}")


class TpLayers:
    """A tensor-parallel rank's decoder layers as :data:`PARTS` parts a
    layer (csrc/decode_layer.cu, ``run_part``), with the buffers the model
    group reduces between parts (:meth:`reduce_view`). ``dims``: the whole
    model's; ``ldims``: the rank's heads and F (its leaves' widths), its
    first column of F is ``k0``; ``chain`` as :func:`decode_layer`'s. On a
    CPU tensor each part runs its plain version
    (:func:`decode_layer_part_plain`), on a CUDA tensor its kernels."""

    def __init__(self, params_layers, dims, ldims, *, h, cos, sin, qcos,
                 qsin, plens, glens, elens, prompt_k, prompt_v, gen_k, gen_v,
                 cross_k, cross_v, kv_scales=None, chain: int = 1,
                 k0: int = 0):
        _check_rank(params_layers, ldims)
        self.attn_split = ldims.num_heads != dims.num_heads
        self.mlp_split = ldims.intermediate_size != dims.intermediate_size
        self.params, self.dims, self.ldims = params_layers, dims, ldims
        self.tile = ftile_of(dims.intermediate_size)
        self.nt = dims.intermediate_size // self.tile
        self.k0, self.chain = k0, chain
        b, d = h.shape
        dev = h.device
        ho = ldims.num_heads * ldims.head_dim
        self.args = dict(cos=cos, sin=sin, qcos=qcos, qsin=qsin, plens=plens,
                         glens=glens, elens=elens, prompt_k=prompt_k,
                         prompt_v=prompt_v, gen_k=gen_k, gen_v=gen_v,
                         cross_k=cross_k, cross_v=cross_v,
                         kv_scales=kv_scales)
        nt = max(1, self.nt)
        self.amax = torch.zeros((b * nt,), dtype=torch.float32, device=dev)
        self.isum = torch.zeros((b * nt * d,), dtype=torch.int32, device=dev)
        self.attn = torch.empty((b, ho), dtype=torch.float32, device=dev)
        self.gbuf = torch.empty((b, ldims.intermediate_size),
                                dtype=torch.float32, device=dev)
        self.b, self.d = b, d
        if dev.type == "cpu":
            self.h = h.float().clone()
            self.st = {}
            shape = (dims.num_layers, b, ldims.num_kv_heads, ldims.head_dim)
            self.k_new = torch.empty(shape, dtype=torch.float32)
            self.v_new = torch.empty_like(self.k_new)
            return
        if dev.type != "cuda":
            raise ValueError(f"decode_layer_part: no kernel for {dev}")
        (self.a, self.h, self.k_new, self.v_new,
         self._keep) = _decode_args(
            params_layers, ldims, h=h, chain=chain,
            layers_out=dims.num_layers, ftile=self.tile, tiles=nt,
            plan_hkv=dims.num_kv_heads, **self.args)
        self.t = _PartArgs(attn=self.attn.data_ptr(),
                           amax=self.amax.data_ptr(),
                           isum=self.isum.data_ptr(),
                           gbuf=self.gbuf.data_ptr(), k0=k0, tile=self.tile,
                           NT=nt)

    def run(self, li: int, part: int) -> None:
        """Part ``part`` of layer ``li``."""
        if self.h.device.type == "cpu":
            decode_layer_part_plain(self, li, part)
            return
        decode_layer_part(self, li, part)

    def reduce_view(self, part: int):
        """(the buffer the group reduces after ``part``, "max" or "sum"), or
        None where the part's sum is this rank's alone."""
        if part not in PART_REDUCE:
            return None
        what, owner = PART_REDUCE[part]
        if not (self.attn_split if owner == "attn" else self.mlp_split):
            return None
        rows = self.b * (self.nt if part == 4 or part == 5 else 1)
        if what == "amax":
            return self.amax[:rows], "max"
        return self.isum[:rows * self.d], "sum"

    def outputs(self):
        """(h [B, D], k_new [L, B, Hkv, hd], v_new), f32."""
        return self.h, self.k_new, self.v_new


def decode_layer_part(layers: TpLayers, li: int, part: int) -> None:
    """Part ``part`` of layer ``li`` of a tensor-parallel rank on the card:
    one call into the CUDA library (``t5g_decode_layer_part``)."""
    dev = layers.h.device
    with torch.cuda.device(dev):
        err = _bind("t5g_decode_layer_part")(
            ctypes.byref(layers.a), ctypes.byref(layers.t), int(li),
            int(part), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode layer part {part} failed: CUDA error "
                           f"{err}")
    decode_layer_part.launches += 1


decode_layer_part.launches = 0


def decode_layer_part_plain(layers: TpLayers, li: int, part: int) -> None:
    """The plain version of ``run_part`` (csrc/decode_layer.cu): the steps
    of :func:`decode_layer_plain` split at the points where the one-process
    layer sums over heads or over F, over the same buffers as the card's
    parts. At tp 1 the seven parts give decode_layer_plain's bits."""
    p, dims, ld = layers.params, layers.dims, layers.ldims
    chain = layers.chain
    args, st = layers.args, layers.st
    eps, hd = dims.rms_norm_eps, dims.head_dim
    b, d = layers.b, layers.d
    n_heads, hkv = ld.num_heads, ld.num_kv_heads
    ho, nkv, f = n_heads * hd, hkv * hd, ld.intermediate_size
    cap = dims.attn_logit_softcap
    n0, n1, n2, n3, n4, n5 = (p[n][li].float() for n in _NORMS)
    w_qkv, w_o, w_cq, w_co, w_gu, w_dn = _weights(p)
    sc = args["kv_scales"] or (None,) * 6
    h = layers.h
    tile, nt, k0 = layers.tile, max(1, layers.nt), layers.k0

    def rescale(w, tiles):
        acc = torch.zeros((b, d))
        isum = layers.isum[:b * tiles * d].view(b, tiles, d)
        for j in range(tiles):
            acc = acc + isum[:, j].float() * st["sx"][:, j:j + 1]
        return acc * w.scale[li]

    def attention_rows(out):
        layers.attn.copy_(out)
        layers.amax[:b] = out.abs().amax(dim=-1)

    def tiles_of_f():
        """(global tile j, local column slice) of each touched tile."""
        j0, j1 = k0 // tile, (k0 + f - 1) // tile
        return [(j, slice(max(j * tile - k0, 0), min((j + 1) * tile - k0, f)))
                for j in range(j0, j1 + 1)]

    if part == 0:
        x8, sx = quantize_act_plain(_rms(h, n0, eps))
        qkv = _w8a8(x8, sx, w_qkv, li)
        q = _rope(qkv[:, :ho].reshape(b, n_heads, hd), args["cos"],
                  args["sin"]) * dims.q_scale
        k_new = _rope(qkv[:, ho:ho + nkv].reshape(b, hkv, hd), args["cos"],
                      args["sin"])
        v_new = qkv[:, ho + nkv:ho + 2 * nkv].reshape(b, hkv, hd)
        layers.k_new[li], layers.v_new[li] = k_new, v_new
        attention_rows(slab_attention_plain(
            q, [((args["prompt_k"], args["prompt_v"]), _pair(sc[0], sc[1]),
                 args["plens"]),
                ((args["gen_k"], args["gen_v"]), _pair(sc[2], sc[3]),
                 args["glens"])],
            cap, li, k_new, v_new, chain))
    elif part in (1, 3):
        x8, st["sx"] = quantize_act_amax(layers.attn, layers.amax[:b])
        layers.isum[:b * d] = int_matmul_exact(
            x8, _levels(w_o if part == 1 else w_co, li)).reshape(-1)
    elif part == 2:
        h += _rms(rescale(w_o, 1), n1, eps)
        x8, sx = quantize_act_plain(_rms(h, n2, eps))
        cq = _rope(_w8a8(x8, sx, w_cq, li).reshape(b, n_heads, hd),
                   args["qcos"], args["qsin"])
        attention_rows(slab_attention_plain(
            cq * dims.q_scale,
            [((args["cross_k"], args["cross_v"]), _pair(sc[4], sc[5]),
              args["elens"].clamp_min(1))], cap, li, chain=chain))
    elif part == 4:
        h += _rms(rescale(w_co, 1), n3, eps)
        x8, sx = quantize_act_plain(_rms(h, n4, eps))
        gu = _w8a8(x8, sx, w_gu, li)
        layers.gbuf.copy_(gelu_tanh(gu[:, :f]) * gu[:, f:])
        amax = layers.amax[:b * nt].view(b, nt)
        amax.zero_()
        for j, cols in tiles_of_f():
            amax[:, j] = layers.gbuf[:, cols].abs().amax(dim=-1)
    elif part == 5:
        amax = layers.amax[:b * nt].view(b, nt)
        st["sx"] = absmax_scale(amax)
        isum = layers.isum[:b * nt * d].view(b, nt, d)
        isum.zero_()
        dn = _levels(w_dn, li)
        for j, cols in tiles_of_f():
            t8 = torch.round(layers.gbuf[:, cols] / st["sx"][:, j:j + 1]
                             ).clamp(-127, 127).to(torch.int8)
            isum[:, j] = int_matmul_exact(t8, dn[:, cols])
    elif part == 6:
        h += _rms(rescale(w_dn, nt), n5, eps)
    else:
        raise ValueError(f"a layer has parts 0-{PARTS - 1}, not {part}")


def decode_stack_tp(params_layers, dims, ldims, *, k0: int,
                    group_max: Callable, group_sum: Callable, **args):
    """:func:`decode_stack` of a tensor-parallel rank (its widths
    ``ldims``, its first column of F ``k0``; the other arguments, ``chain``
    included, as :func:`decode_stack`'s): every layer in
    :data:`PARTS` parts, ``group_max`` / ``group_sum`` reducing a part's
    absmax (MAX) and int32 sums (SUM) over the model group between them ->
    (h [B, D], k_new [L, B, Hkv, hd], v_new), f32, equal to the
    one-process stack's."""
    layers = TpLayers(params_layers, dims, ldims, k0=k0, **args)
    for li in range(dims.num_layers):
        for part in range(PARTS):
            layers.run(li, part)
            view = layers.reduce_view(part)
            if view is not None:
                buf, op = view
                buf.copy_((group_max if op == "max" else group_sum)(buf))
    return layers.outputs()


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
                   cross_k: torch.Tensor, plan_hkv: Optional[int] = None
                   ) -> Dict[str, Tuple[int, int]]:
    """(chunk, splits) of the layer's self and cross attention, from the
    slabs' shapes alone ([Hkv, L*Bc, T, hd]: Bc x Hkv (cache row, kv head)
    pairs over the prompt + generation capacity, and over the encoder's);
    ``plan_hkv`` counts the pairs with that many kv heads (a tensor-parallel
    rank plans as the whole model does)."""
    hkv, rows = prompt_k.shape[:2]
    pairs = (plan_hkv or hkv) * (rows // dims.num_layers)
    return {"self": split_plan(pairs, prompt_k.shape[2] + gen_k.shape[2],
                               TBLOCK),
            "cross": split_plan(pairs, cross_k.shape[2], TBLOCK)}


class _PartArgs(ctypes.Structure):
    """Field by field the ``PartArgs`` struct of csrc/decode_layer.cu."""

    _fields_ = ([(n, _vp) for n in ("attn", "amax", "isum", "gbuf")]
                + [(n, _i32) for n in ("k0", "tile", "NT")])


def _bind(name: str):
    from . import cuda_build

    fn = getattr(cuda_build.load("decode_layer"), name)
    if fn.argtypes is None:
        args = [ctypes.POINTER(_DecodeArgs)]
        if name == "t5g_decode_layer":
            args += [_i32, _vp]
        elif name == "t5g_decode_layer_part":
            args += [ctypes.POINTER(_PartArgs), _i32, _i32, _vp]
        else:
            args += [_vp]
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def _decode_args(params_layers, dims, *, h, cos, sin, qcos, qsin, plens,
                 glens, elens, prompt_k, prompt_v, gen_k, gen_v, cross_k,
                 cross_v, kv_scales, chain, layers_out: int, ftile: int,
                 tiles: int = 1, plan_hkv: Optional[int] = None):
    """The ``DecodeArgs`` of a call (``dims``: the heads and F of the
    leaves), with its outputs and workspaces: (args, h [B, D] f32 updated
    in place, k_new / v_new [layers_out, B, Hkv, hd] f32, the tensors the
    args point into). ``tiles``: the activation scales a row of the GeGLU
    holds (a tensor-parallel rank's: the whole F's); ``plan_hkv``: the kv
    heads its attention plan counts (:func:`attention_plan`)."""
    dev = h.device
    b, d = h.shape
    if chain < 1 or b % chain:
        raise ValueError(f"{b} rows do not hold whole chains of {chain}")
    n_heads, hkv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    f, n_layers = dims.intermediate_size, dims.num_layers
    ho, nkv = n_heads * hd, hkv * hd
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

    plan = attention_plan(dims, prompt_k, gen_k, cross_k, plan_hkv)
    splits = max(plan["self"][1], plan["cross"][1])
    hout = h.float().clone()
    k_new = torch.empty((layers_out, b, hkv, hd), dtype=torch.float32,
                        device=dev)
    v_new = torch.empty_like(k_new)
    ws = dict(
        x8=torch.empty((b, max(d, ho, f)), dtype=torch.int8, device=dev),
        sx=torch.empty((b, max(1, f // ftile, tiles)), dtype=torch.float32,
                       device=dev),
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
        B=b, D=d, H=n_heads, Hkv=hkv, hd=hd, F=f, L=n_layers, ftile=ftile,
        Tp=prompt_k.shape[2], Tg=gen_k.shape[2], Tx=cross_k.shape[2],
        kv_quant=int(quant), w4=int(w4), chain=chain,
        chunk_self=plan["self"][0], splits_self=plan["self"][1],
        chunk_cross=plan["cross"][0], splits_cross=plan["cross"][1],
        eps=dims.rms_norm_eps,
        soft_cap=dims.attn_logit_softcap or 0.0, q_scale=dims.q_scale)
    return a, hout, k_new, v_new, (norms, tabs, lens, ws)


def _launch(params_layers, dims, *, li, **args
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = args["h"].device
    a, hout, k_new, v_new, _keep = _decode_args(
        params_layers, dims, layers_out=dims.num_layers if li is None else 1,
        ftile=ftile_of(dims.intermediate_size), **args)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if li is None:
            err = _bind("t5g_decode_stack")(ctypes.byref(a), stream)
        else:
            err = _bind("t5g_decode_layer")(ctypes.byref(a), int(li), stream)
    if err != 0:
        raise RuntimeError(f"decode layer kernels failed: CUDA error {err}")
    return hout, k_new, v_new

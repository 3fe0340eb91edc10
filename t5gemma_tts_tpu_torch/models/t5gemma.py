"""T5Gemma encoder-decoder with PM-RoPE cross-attention, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/models/t5gemma.py``. Parameters are nested
dicts of tensors with the JAX tree's key names and its stacked ``[L, ...]``
layer axis (kernels [in, out]); layers run as a Python loop over that axis.
RMSNorm computes in f32 with a (1 + w) scale, attention logits are f32 with
a tanh soft cap, embeddings are scaled by sqrt(hidden) in the compute dtype.

Two decode caches:

- the dense cache (:func:`init_cache` + :func:`decoder_forward`), which
  ``kv_cache="auto"`` takes on the CPU or when prompt + generation exceed
  the sliding window;
- the paged cache (:class:`PagedDecoderCache`, :func:`paged_prefill`,
  :func:`paged_decode_step`), bf16, float8 e4m3 or int8 pages, whose
  attention reads go through the kernel that ``T5G_FUSED_ATTN`` picks
  (:func:`_fused_attn_mode`): by default ``ops/fused_attn.
  batch_paged_attention``, twice per layer.

The speculative verify pass runs S tokens per row at once: over the dense
cache through :func:`decoder_forward` (an S-token block at ``cache_pos``),
over the paged cache through :func:`paged_decode_multi`.

Projections go through ``ops/quant.q_matmul``: plain weights multiply as
they are, int8 ``QuantWeight`` leaves (``quantize_params_for_decode``) take
the W8A8 product and int4 ``Int4Weight`` leaves the W4A8 product. With W8A8
or int4 decoder weights over bf16 or int8 pages the paged decode step (and
the verify pass) runs all layers through ``ops/megakernel.decode_stack``
instead of the layer loop; W8A16 leaves (``act_bits=16``) take the layer
loop.

Unlike the JAX package, the caches are updated in place (the step writes
one token per layer into preallocated buffers instead of returning copies).

Tensor parallelism (``parallel/tensor.py``): every layer loop takes its
head counts and widths from the leaves, so a rank's shard runs its own
heads and columns, and reduces over the model group after self o, cross o
and down (``tp.row_product``: bf16 / f32 partials summed in f32 and cast
once, W8A8 / W4A8 blocks with the group's scales and int32 sums); its
caches are sized with its kv heads (``tp.local_dims``). Every attention
mode, every page type and the verify pass run at ``tp > 1``: the kernels
take a rank's heads from their tensors, and a W8A16 row block sums its f32
partial products over the group (``tp.row_product``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModuleDims
from ..ops import fused_attn, megakernel
from ..ops import paged_attn
from ..ops import rope as rope_ops
from ..ops.paged_attn import identity_page_indices
from ..ops.quant import Int4Weight, QuantWeight, map_weight
from ..ops.quant import q_matmul as _mm
from ..parallel import tensor as tp

PyTree = Any
PAGE_SIZE = 128


# ---------------------------------------------------------------------------
# primitive blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5Gemma RMSNorm: f32 compute, (1 + w) scale, cast back."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        dims: Optional[ModuleDims] = None) -> torch.Tensor:
    """GeGLU: act(x @ gate) * (x @ up) @ down (one gate_up matmul when the
    params are fused for decode). Under tensor parallelism (``dims`` given,
    ``parallel/tensor.py``) gate/up (or gate_up) hold a column block and
    down the matching row block: the output is summed over the model
    group."""
    split = dims is not None and tp.mlp_split(p, dims)
    if split:
        x = tp.copy_to_model(x)
    if "gate_up" in p:
        g, u = _mm(x, p["gate_up"]).chunk(2, dim=-1)
        h = gelu_tanh(g) * u
    else:
        h = gelu_tanh(_mm(x, p["gate"])) * _mm(x, p["up"])
    return _out_proj(h, p["down"], split)


def _out_proj(x: torch.Tensor, w, split: bool) -> torch.Tensor:
    """``x @ w``; a row-split ``w`` summed over the model group."""
    return tp.row_product(x, w) if split else _mm(x, w)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _embed_scale(x: torch.Tensor, dims: ModuleDims) -> torch.Tensor:
    """x * sqrt(hidden), the scale rounded to x's dtype first."""
    s = torch.tensor(math.sqrt(dims.hidden_size), dtype=x.dtype).item()
    return x * s


def gqa_attention(q, k, v, bias, scale: float, softcap: Optional[float]):
    """Grouped-query attention with f32 logits and softmax.
    q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd], bias [B,1,Tq,Tk] -> [B,H,Tq,hd]."""
    b, h, tq, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, tq, hd)
    logits = torch.einsum("bkgth,bksh->bkgts", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + bias[:, :, None].float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksh->bkgth", weights, v)
    return out.reshape(b, h, tq, hd)


def _qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor, dims: ModuleDims):
    """q/k/v projections; one fused matmul when the params carry "qkv". The
    head counts are the leaves' (a tensor-parallel rank's own heads)."""
    dims = tp.attention_dims(p, dims)[0]
    if "qkv" in p:
        qh = dims.num_heads * dims.head_dim
        kh = dims.num_kv_heads * dims.head_dim
        qkv = _mm(x, p["qkv"])
        q = _split_heads(qkv[..., :qh], dims.num_heads, dims.head_dim)
        k = _split_heads(qkv[..., qh:qh + kh], dims.num_kv_heads, dims.head_dim)
        v = _split_heads(qkv[..., qh + kh:], dims.num_kv_heads, dims.head_dim)
    else:
        q = _split_heads(_mm(x, p["q"]), dims.num_heads, dims.head_dim)
        k = _split_heads(_mm(x, p["k"]), dims.num_kv_heads, dims.head_dim)
        v = _split_heads(_mm(x, p["v"]), dims.num_kv_heads, dims.head_dim)
    return q, k, v


def self_attention(p, x, cos, sin, bias, dims: ModuleDims) -> torch.Tensor:
    """Self-attention with RoPE over this call's own keys. Under tensor
    parallelism this rank computes its whole heads (``tp.attention_dims``)
    and the output projection's partial sums are reduced."""
    dims, split = tp.attention_dims(p, dims)
    if split:
        x = tp.copy_to_model(x)
    q, k, v = _qkv_proj(p, x, dims)
    q = rope_ops.apply_rope(q, cos, sin)
    k = rope_ops.apply_rope(k, cos, sin)
    out = gqa_attention(q, k, v, bias, dims.q_scale, dims.attn_logit_softcap)
    return _out_proj(_merge_heads(out), p["o"], split)


def cross_attention(p, x, kv_cache, bias, dims: ModuleDims,
                    q_cos=None, q_sin=None) -> torch.Tensor:
    """PM-RoPE cross-attention over precomputed encoder K/V; the query gets
    rotary with progress positions when q_cos/q_sin are given."""
    dims, split = tp.attention_dims(p, dims)
    if split:
        x = tp.copy_to_model(x)
    q = _split_heads(_mm(x, p["q"]), dims.num_heads, dims.head_dim)
    if q_cos is not None:
        q = rope_ops.apply_rope(q, q_cos, q_sin)
    k, v = kv_cache
    out = gqa_attention(q, k.to(x.dtype), v.to(x.dtype), bias, dims.q_scale,
                        dims.attn_logit_softcap)
    return _out_proj(_merge_heads(out), p["o"], split)


def cross_kv(p, memory, dims: ModuleDims, k_cos=None, k_sin=None):
    """Encoder memory -> cross K/V [B, Hkv, Tenc, hd]; keys get PM rotary.
    Under tensor parallelism, this rank's kv heads (the caller takes
    ``memory`` through ``tp.copy_to_model`` once for all layers)."""
    dims = tp.attention_dims(p, dims)[0]
    k = _split_heads(_mm(memory, p["k"]), dims.num_kv_heads, dims.head_dim)
    v = _split_heads(_mm(memory, p["v"]), dims.num_kv_heads, dims.head_dim)
    if k_cos is not None:
        k = rope_ops.apply_rope(k, k_cos, k_sin)
    return k, v


def layer_params(tree: PyTree, li: int) -> PyTree:
    """Layer ``li`` of a stacked [L, ...] parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, li) for k, v in tree.items()}
    if isinstance(tree, (QuantWeight, Int4Weight)):
        return map_weight(tree, lambda t: t[li])
    if hasattr(tree, "layer"):          # train/lora.py's LoraWeight
        return tree.layer(li)
    return tree[li]


# ---------------------------------------------------------------------------
# parameter init (seeded, on the target device)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, dtype, device, std=0.02):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def init_stack(gen: torch.Generator, dims: ModuleDims, *, is_decoder: bool,
               with_embed: bool, dtype=torch.bfloat16, device=None,
               cross_hidden: Optional[int] = None) -> PyTree:
    """Random-init parameters for one stack, layer-stacked along axis 0."""
    d, f = dims.hidden_size, dims.intermediate_size
    qh = dims.num_heads * dims.head_dim
    kh = dims.num_kv_heads * dims.head_dim
    ch = cross_hidden or d
    n = dims.num_layers

    def lin(*shape):
        return _normal(gen, (n, *shape), dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers: Dict[str, Any] = {
        "pre_self_attn_norm": zeros(n, d),
        "post_self_attn_norm": zeros(n, d),
        "pre_ff_norm": zeros(n, d),
        "post_ff_norm": zeros(n, d),
        "self_attn": {"q": lin(d, qh), "k": lin(d, kh), "v": lin(d, kh),
                      "o": lin(qh, d)},
        "mlp": {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)},
    }
    if is_decoder:
        layers["pre_cross_attn_norm"] = zeros(n, d)
        layers["post_cross_attn_norm"] = zeros(n, d)
        layers["cross_attn"] = {"q": lin(d, qh), "k": lin(ch, kh),
                                "v": lin(ch, kh), "o": lin(qh, d)}
    params: Dict[str, Any] = {"layers": layers, "final_norm": zeros(d)}
    if with_embed:
        params["embed"] = _normal(gen, (dims.vocab_size, d), dtype, device)
    return params


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _layer_runner(remat: bool):
    """Calls a layer function as it is, or, with ``remat`` while autograd
    records, through ``torch.utils.checkpoint`` (non-reentrant): the
    layer's activations are recomputed in the backward instead of kept."""
    if not (remat and torch.is_grad_enabled()):
        return lambda fn, *args: fn(*args)
    from torch.utils.checkpoint import checkpoint

    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)


def _encoder_layer(h, lp, bias, cos, sin, dims: ModuleDims):
    eps = dims.rms_norm_eps
    a = self_attention(lp["self_attn"],
                       rms_norm(h, lp["pre_self_attn_norm"], eps),
                       cos, sin, bias, dims)
    h = h + rms_norm(a, lp["post_self_attn_norm"], eps)
    m = mlp(lp["mlp"], rms_norm(h, lp["pre_ff_norm"], eps), dims)
    return h + rms_norm(m, lp["post_ff_norm"], eps)


def encoder_forward(params: PyTree, dims: ModuleDims, *, input_ids=None,
                    inputs_embeds=None, full_bias, sliding_bias,
                    position_ids, remat: bool = False) -> torch.Tensor:
    """Bidirectional encoder; returns the last hidden state [B, T, D].
    ``remat`` rematerializes each layer in the backward."""
    if inputs_embeds is None:
        inputs_embeds = tp.vocab_embedding(input_ids, params["embed"],
                                           dims.vocab_size)
    h = _embed_scale(inputs_embeds, dims)
    cos, sin = rope_ops.rope_cos_sin(position_ids, dims.head_dim,
                                     dims.rope_theta)
    run = _layer_runner(remat)
    for li, sliding in enumerate(dims.sliding_flags):
        lp = layer_params(params["layers"], li)
        bias = sliding_bias if sliding else full_bias
        h = run(lambda h_, lp=lp, bias=bias: _encoder_layer(
            h_, lp, bias, cos, sin, dims), h)
    return rms_norm(h, params["final_norm"], dims.rms_norm_eps)


# ---------------------------------------------------------------------------
# decoder, dense cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecoderCache:
    """Preallocated dense KV cache: self_* [L, B, Hkv, Tmax, hd]; cross_*
    [L, B, Hkv, Tenc, hd] computed once at prefill."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def init_cache(dims: ModuleDims, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device=None) -> DecoderCache:
    """A zero dense cache of ``dims.num_kv_heads`` heads (a tensor-parallel
    rank's own: ``tp.local_dims``)."""
    shape_self = (dims.num_layers, batch, dims.num_kv_heads, max_len,
                  dims.head_dim)
    shape_cross = (dims.num_layers, batch, dims.num_kv_heads, enc_len,
                   dims.head_dim)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return DecoderCache(z(shape_self), z(shape_self), z(shape_cross),
                        z(shape_cross))


def build_cross_kv(params: PyTree, dims: ModuleDims, memory: torch.Tensor,
                   pm_encoder_positions: Optional[torch.Tensor]):
    """All layers' cross K/V from encoder memory -> [L, B, Hkv, Tenc, hd]."""
    if pm_encoder_positions is not None:
        k_cos, k_sin = rope_ops.rope_cos_sin(pm_encoder_positions,
                                             dims.head_dim, dims.rope_theta)
    else:
        k_cos = k_sin = None
    cp = params["layers"]["cross_attn"]
    if tp.attention_dims(cp, dims)[1]:
        memory = tp.copy_to_model(memory)
    ks, vs = zip(*(cross_kv(layer_params(cp, li), memory, dims, k_cos, k_sin)
                   for li in range(dims.num_layers)))
    return torch.stack(ks), torch.stack(vs)


def _rope_tables(position_ids, pm_decoder_positions, dims: ModuleDims):
    cos, sin = rope_ops.rope_cos_sin(position_ids, dims.head_dim,
                                     dims.rope_theta)
    if pm_decoder_positions is not None:
        q_cos, q_sin = rope_ops.rope_cos_sin(pm_decoder_positions,
                                             dims.head_dim, dims.rope_theta)
    else:
        q_cos = q_sin = None
    return cos, sin, q_cos, q_sin


def _cross_and_mlp(h, lp, xk, xv, cross_bias, dims, q_cos, q_sin):
    eps = dims.rms_norm_eps
    a = cross_attention(lp["cross_attn"],
                        rms_norm(h, lp["pre_cross_attn_norm"], eps),
                        (xk, xv), cross_bias, dims, q_cos, q_sin)
    h = h + rms_norm(a, lp["post_cross_attn_norm"], eps)
    m = mlp(lp["mlp"], rms_norm(h, lp["pre_ff_norm"], eps), dims)
    return h + rms_norm(m, lp["post_ff_norm"], eps)


def decoder_forward(params: PyTree, dims: ModuleDims, *, inputs_embeds,
                    self_full_bias, self_sliding_bias, cross_bias,
                    position_ids, pm_decoder_positions, cross_k, cross_v,
                    cache: Optional[DecoderCache] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    remat: bool = False):
    """Decoder stack. Without ``cache``: full-sequence forward (the
    training path, no in-place writes; ``remat`` rematerializes each layer
    in the backward). With ``cache``: prefill (``cache_pos`` None, writes
    the first T slots) or a step of T tokens (``cache_pos`` [B]: row b
    writes slots cache_pos[b] .. cache_pos[b] + T - 1), attending over the
    whole cache; the cache is updated in place and returned."""
    h = _embed_scale(inputs_embeds, dims)
    cos, sin, q_cos, q_sin = _rope_tables(position_ids, pm_decoder_positions,
                                          dims)
    eps = dims.rms_norm_eps
    if cache is None:
        run = _layer_runner(remat)
        for li, sliding in enumerate(dims.sliding_flags):
            lp = layer_params(params["layers"], li)
            bias = self_sliding_bias if sliding else self_full_bias

            def layer(h_, xk, xv, lp=lp, bias=bias):
                a = self_attention(lp["self_attn"],
                                   rms_norm(h_, lp["pre_self_attn_norm"], eps),
                                   cos, sin, bias, dims)
                h_ = h_ + rms_norm(a, lp["post_self_attn_norm"], eps)
                return _cross_and_mlp(h_, lp, xk, xv, cross_bias, dims,
                                      q_cos, q_sin)

            h = run(layer, h, cross_k[li], cross_v[li])
        return rms_norm(h, params["final_norm"], eps), None
    rows = torch.arange(h.shape[0], device=h.device)[:, None]
    if cache_pos is not None:
        slots = cache_pos[:, None] + torch.arange(h.shape[1], device=h.device)
    split = tp.attention_dims(params["layers"]["self_attn"], dims)[1]
    for li, sliding in enumerate(dims.sliding_flags):
        lp = layer_params(params["layers"], li)
        bias = self_sliding_bias if sliding else self_full_bias
        hn = rms_norm(h, lp["pre_self_attn_norm"], eps)
        q, k, v = _qkv_proj(lp["self_attn"], hn, dims)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        ck, cv = cache.self_k[li], cache.self_v[li]
        if cache_pos is None:
            t = k.shape[2]
            ck[:, :, :t] = k.to(ck.dtype)
            cv[:, :, :t] = v.to(cv.dtype)
        else:
            ck[rows, :, slots] = k.transpose(1, 2).to(ck.dtype)
            cv[rows, :, slots] = v.transpose(1, 2).to(cv.dtype)
        k, v = ck.to(h.dtype), cv.to(h.dtype)
        out = gqa_attention(q, k, v, bias, dims.q_scale,
                            dims.attn_logit_softcap)
        a = _out_proj(_merge_heads(out), lp["self_attn"]["o"], split)
        h = h + rms_norm(a, lp["post_self_attn_norm"], eps)
        h = _cross_and_mlp(h, lp, cross_k[li], cross_v[li], cross_bias, dims,
                           q_cos, q_sin)
    h = rms_norm(h, params["final_norm"], eps)
    cache.cross_k, cache.cross_v = cross_k, cross_v
    return h, cache


# ---------------------------------------------------------------------------
# decoder, paged cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedDecoderCache:
    """Decode KV cache for the paged-attention step.

    Three slabs, each folding all layers into one tensor so per-layer reads
    address pages through per-layer page indices (never a slice copy):

      prompt_k/v [Hkv, L*B, Wp, hd]: prompt, written once at prefill;
      gen_k/v    [Hkv, L*B, Tg, hd]: generated tokens, STEP-indexed (a row's
                 step-s token lives at slot s);
      cross_k/v  [Hkv, L*B, Tx, hd]: encoder K/V, written at prefill.

    ``pending_k/v`` [L, B, Hkv, hd] (bf16) hold the newest token's K/V; the
    next step flushes them into slot max(step - 1, 0) of gen_k/v before it
    reads the cache. Pages are bf16, float8 e4m3, or int8 with a per-token
    f32 scale plane [Hkv, L*B, T] for each slab. ``page_indices`` holds each region's [L, B, pages]
    page table into the slab's [Hkv, L*B*T/128, 128, hd] view.
    """

    prompt_k: torch.Tensor
    prompt_v: torch.Tensor
    gen_k: torch.Tensor
    gen_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    pending_k: torch.Tensor
    pending_v: torch.Tensor
    page_indices: Dict[str, torch.Tensor]
    prompt_k_scale: Optional[torch.Tensor] = None
    prompt_v_scale: Optional[torch.Tensor] = None
    gen_k_scale: Optional[torch.Tensor] = None
    gen_v_scale: Optional[torch.Tensor] = None
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def init_paged_cache(dims: ModuleDims, batch: int, prompt_len: int,
                     gen_len: int, enc_len: int, *,
                     store_dtype=torch.bfloat16,
                     device=None) -> PagedDecoderCache:
    """Allocate the paged cache (region lengths padded to page multiples)
    with ``dims.num_kv_heads`` heads (a tensor-parallel rank's own:
    ``tp.local_dims``)."""
    total = _pad_to(prompt_len, PAGE_SIZE) + _pad_to(gen_len, PAGE_SIZE)
    if total > dims.sliding_window:
        raise ValueError(
            f"paged KV cache supports prompt+gen <= sliding_window "
            f"({dims.sliding_window}); got {total}. Use the dense cache.")
    wp = _pad_to(prompt_len, PAGE_SIZE)
    tg = _pad_to(gen_len, PAGE_SIZE)
    tx = _pad_to(enc_len, PAGE_SIZE)
    l, hkv, hd = dims.num_layers, dims.num_kv_heads, dims.head_dim
    lb = l * batch
    quant = store_dtype == torch.int8

    def slab(t):
        return torch.zeros((hkv, lb, t, hd), dtype=store_dtype, device=device)

    def scale(t):
        if not quant:
            return None
        return torch.zeros((hkv, lb, t), dtype=torch.float32, device=device)

    def table(t):
        pps = t // PAGE_SIZE
        ident = identity_page_indices(batch, pps, device)
        layer = torch.arange(l, dtype=torch.int32, device=device)
        return ident[None] + layer[:, None, None] * (batch * pps)

    pending = (l, batch, hkv, hd)
    return PagedDecoderCache(
        prompt_k=slab(wp), prompt_v=slab(wp), gen_k=slab(tg), gen_v=slab(tg),
        cross_k=slab(tx), cross_v=slab(tx),
        pending_k=torch.zeros(pending, dtype=torch.bfloat16, device=device),
        pending_v=torch.zeros(pending, dtype=torch.bfloat16, device=device),
        page_indices={"prompt": table(wp), "gen": table(tg),
                      "cross": table(tx)},
        prompt_k_scale=scale(wp), prompt_v_scale=scale(wp),
        gen_k_scale=scale(tg), gen_v_scale=scale(tg),
        cross_k_scale=scale(tx), cross_v_scale=scale(tx),
    )


def _pages_view(buf: torch.Tensor) -> torch.Tensor:
    """[Hkv, L*B, T, hd] -> [Hkv, L*B*(T/ps), ps, hd] (a view)."""
    hkv, lb, t, hd = buf.shape
    return buf.view(hkv, lb * (t // PAGE_SIZE), PAGE_SIZE, hd)


def _scale_pages_view(buf: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[Hkv, L*B, T] -> [Hkv, L*B*(T/ps), ps] (a view)."""
    if buf is None:
        return None
    hkv, lb, t = buf.shape
    return buf.view(hkv, lb * (t // PAGE_SIZE), PAGE_SIZE)


def _write_region(buf, kv, li, scale_buf):
    """Write [B, Hkv, W, hd] K or V (prompt or encoder) of layer ``li``
    into its slab rows; int8 slabs also get the per-token scales."""
    b, _, w, _ = kv.shape
    rows = slice(li * b, (li + 1) * b)
    if scale_buf is not None:
        qv, sc = fused_attn.quantize_kv(kv.to(torch.bfloat16))
        buf[:, rows, :w] = qv.transpose(0, 1)
        scale_buf[:, rows, :w] = sc.transpose(0, 1)
    else:
        buf[:, rows, :w] = kv.transpose(0, 1).to(buf.dtype)


def paged_prefill(params: PyTree, dims: ModuleDims, *, inputs_embeds,
                  self_full_bias, self_sliding_bias, cross_bias, position_ids,
                  pm_decoder_positions, cross_k, cross_v,
                  cache: PagedDecoderCache):
    """Prompt prefill for the paged path: attention over this call's own
    [W, W] block (nothing beyond the prompt exists yet); the fresh K/V and
    the encoder K/V land in the cache slabs (in place)."""
    h = _embed_scale(inputs_embeds, dims)
    cos, sin, q_cos, q_sin = _rope_tables(position_ids, pm_decoder_positions,
                                          dims)
    eps = dims.rms_norm_eps
    split = tp.attention_dims(params["layers"]["self_attn"], dims)[1]
    for li, sliding in enumerate(dims.sliding_flags):
        lp = layer_params(params["layers"], li)
        bias = self_sliding_bias if sliding else self_full_bias
        hn = rms_norm(h, lp["pre_self_attn_norm"], eps)
        q, k, v = _qkv_proj(lp["self_attn"], hn, dims)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        _write_region(cache.prompt_k, k, li, cache.prompt_k_scale)
        _write_region(cache.prompt_v, v, li, cache.prompt_v_scale)
        out = gqa_attention(q, k, v, bias, dims.q_scale,
                            dims.attn_logit_softcap)
        a = _out_proj(_merge_heads(out), lp["self_attn"]["o"], split)
        h = h + rms_norm(a, lp["post_self_attn_norm"], eps)
        h = _cross_and_mlp(h, lp, cross_k[li], cross_v[li], cross_bias, dims,
                           q_cos, q_sin)
        _write_region(cache.cross_k, cross_k[li], li, cache.cross_k_scale)
        _write_region(cache.cross_v, cross_v[li], li, cache.cross_v_scale)
    return rms_norm(h, params["final_norm"], eps), cache


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the integer dtype of its element size (an
    ``index_copy_`` then moves bytes, whatever the page dtype)."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _write_slots(buf, block, start):
    """``buf[:, :, start:start + S] = block``, written by ``index_copy_``:
    ``start`` (an int or a 0-dim device tensor) stays on the device, so the
    host reads nothing (a CUDA graph captures it)."""
    idx = torch.arange(block.shape[2], device=buf.device) + start
    _bits(buf).index_copy_(2, idx, _bits(block))


def _flush_block(buf, pending, scale_buf, start):
    """Write a pending [L, B, S, Hkv, hd] bf16 block into gen slots
    start .. start + S - 1 (int8 pages: quantized per token, with its
    scale-plane block); ``start`` an int or a 0-dim device tensor."""
    hkv, lb, _, hd = buf.shape
    s_len = pending.shape[2]
    if scale_buf is not None:
        pending, sc = fused_attn.quantize_kv(pending)
        _write_slots(scale_buf, sc.permute(3, 0, 1, 2).reshape(
            hkv, lb, s_len), start)
    _write_slots(buf, pending.permute(3, 0, 1, 2, 4).reshape(
        hkv, lb, s_len, hd).to(buf.dtype), start)


def _write_row_slots(buf, block, positions):
    """``buf[:, l * B + r, positions[r]] = block[:, l * B + r]`` for every
    layer l and row r: one ``index_copy_`` over the slab's (row, slot) axis
    at device indices, so the host reads nothing (a CUDA graph captures
    it). ``buf`` [Hkv, L*B, T, ...], ``block`` [Hkv, L*B, ...], ``positions``
    [B]."""
    hkv, lb, t = buf.shape[:3]
    rows = torch.arange(lb, device=buf.device)
    idx = rows * t + positions.long().repeat(lb // positions.shape[0])
    flat = _bits(buf).view(hkv, lb * t, *buf.shape[3:])
    flat.index_copy_(1, idx, _bits(block))


def _flush_rows(buf, pending, scale_buf, positions):
    """Write a pending [L, B, Hkv, hd] bf16 block into each row's own gen
    slot ``positions[r]`` (int8 pages: quantized per token, with its
    scale-plane entry)."""
    hkv, lb, _, hd = buf.shape
    if scale_buf is not None:
        pending, sc = fused_attn.quantize_kv(pending)
        _write_row_slots(scale_buf, sc.permute(2, 0, 1).reshape(hkv, lb),
                         positions)
    _write_row_slots(buf, pending.permute(2, 0, 1, 3).reshape(
        hkv, lb, hd).to(buf.dtype), positions)


def _fused_attn_mode(cache: PagedDecoderCache) -> int:
    """The paged decode step's attention kernels, by ``T5G_FUSED_ATTN`` (the
    JAX package's selector, with its meanings):

    - 0: self-attention as two ``paged_flash_parts`` launches (prompt and
      generation pages) joined with the in-flight token by
      ``merge_attention_parts``; cross attention ``paged_gqa_attention``;
    - 1: self-attention ``fused_decode_attention`` (the v1 kernel); cross
      attention ``paged_gqa_attention``;
    - 2: ``batch_paged_attention`` for both;
    - 3 (default): ``megakernel.decode_stack`` where ``megakernel.supports``
      holds, else 2.

    int8 pages force 2 unless the mode is 3, as in the JAX package: only
    kernel 1 and the decode layer read scale planes. The JAX gates
    ``head_dim % 128`` and ``num_heads % 8`` are Mosaic's tiling limits and
    are not carried over; neither is its rule off the TPU (modes 1 and 2
    run as 0 there): here every mode runs as asked, through its kernels on
    the card and their plain versions on the CPU."""
    mode = int(os.environ.get("T5G_FUSED_ATTN", "3"))
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"T5G_FUSED_ATTN must be 0, 1, 2 or 3, got {mode}")
    if cache.gen_k.dtype == torch.int8 and mode != 3:
        return 2
    return mode


def paged_decode_step(params: PyTree, dims: ModuleDims, *, inputs_embeds,
                      position_ids, pm_decoder_positions,
                      cache: PagedDecoderCache, step, prompt_lengths,
                      enc_lengths, gen_lengths=None, flush_positions=None):
    """One decode step over the paged cache.

    ``step`` is an int or a 0-dim int32 device tensor (the engine's step
    counter: then the step reads nothing on the host, and a CUDA graph
    captures it). Flushes the previous step's pending K/V into gen slot
    max(step - 1, 0) (on the first step slot 0 gets zeros, invisible at gen
    length 0) at a device index, then
    runs the layers: self-attention over the prompt pages, the ``step``
    generated tokens and the in-flight token (unrounded), and
    cross-attention over the encoder pages, through the kernels of the
    attention mode (:func:`_fused_attn_mode`; by default one
    ``batch_paged_attention`` call each). The new token's K/V become the
    pending block (bf16, written into ``cache.pending_k/v`` in place).
    ``prompt_lengths``/``enc_lengths`` are int32 [B].

    In mode 3, when ``megakernel.supports`` the decoder's (W8A8 or int4)
    layers and the pages (bf16 or int8; float8 pages take the loop), one
    ``decode_stack`` call replaces the layer loop: the hidden state enters
    it in f32 and stays f32 across the layers, and its unrounded k/v come
    back as the new pending block.

    Per-row clocks (continuous batching, JAX ``gen_lengths`` /
    ``flush_positions``): with ``flush_positions`` [B] each row flushes its
    pending K/V (and, on int8 pages, its scale) at its own slot, by one
    device-side scatter per slab, and with ``gen_lengths`` [B] each row
    attends over its own generated count; ``step`` is then not read."""
    b = inputs_embeds.shape[0]
    h = _embed_scale(inputs_embeds, dims)
    cos, sin, q_cos, q_sin = _rope_tables(position_ids, pm_decoder_positions,
                                          dims)
    if (flush_positions is None or gen_lengths is None) and not isinstance(
            step, torch.Tensor):
        step = torch.full((), step, dtype=torch.int32, device=h.device)
    if flush_positions is not None:
        _flush_rows(cache.gen_k, cache.pending_k, cache.gen_k_scale,
                    flush_positions)
        _flush_rows(cache.gen_v, cache.pending_v, cache.gen_v_scale,
                    flush_positions)
    else:
        slot = (step - 1).clamp_min(0)
        _flush_block(cache.gen_k, cache.pending_k[:, :, None],
                     cache.gen_k_scale, slot)
        _flush_block(cache.gen_v, cache.pending_v[:, :, None],
                     cache.gen_v_scale, slot)
    if gen_lengths is None:
        gen_lengths = step.to(torch.int32).reshape(1).expand(b).contiguous()
    else:
        gen_lengths = gen_lengths.to(torch.int32)
    mode = _fused_attn_mode(cache)
    if mode == 3:
        ldims, attn_split, mlp_split = tp.local_dims(params["layers"], dims)
        rank_dims = ldims if attn_split or mlp_split else None
        if megakernel.supports(params["layers"], dims, cache, rank_dims):
            return _decode_step_stacked(params, dims, h, cos, sin, q_cos,
                                        q_sin, cache, prompt_lengths,
                                        gen_lengths, enc_lengths, rank_dims)
        mode = 2

    layers = params["layers"]
    self_split = tp.attention_dims(layers["self_attn"], dims)[1]
    cdims, cross_split = tp.attention_dims(layers["cross_attn"], dims)
    prompt_kp, prompt_vp, gen_kp, gen_vp, cross_kp, cross_vp = _page_views(
        cache)
    prompt_s = (_scale_pages_view(cache.prompt_k_scale),
                _scale_pages_view(cache.prompt_v_scale))
    gen_s = (_scale_pages_view(cache.gen_k_scale),
             _scale_pages_view(cache.gen_v_scale))
    cross_s = (_scale_pages_view(cache.cross_k_scale),
               _scale_pages_view(cache.cross_v_scale))
    tables = cache.page_indices
    cap = dims.attn_logit_softcap
    eps = dims.rms_norm_eps
    k_new, v_new = [], []
    for li in range(dims.num_layers):
        lp = layer_params(params["layers"], li)
        hn = rms_norm(h, lp["pre_self_attn_norm"], eps)
        q, k, v = _qkv_proj(lp["self_attn"], hn, dims)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        qv = q[:, :, 0].float() * dims.q_scale
        k_cur, v_cur = k[:, :, 0], v[:, :, 0]
        p_idx, g_idx = tables["prompt"][li], tables["gen"][li]
        if mode == 2:
            attn = fused_attn.batch_paged_attention(
                qv, k_cur, v_cur, prompt_kp, prompt_vp, gen_kp, gen_vp,
                prompt_lengths, gen_lengths, p_idx, g_idx, *prompt_s,
                *gen_s, attn_logits_soft_cap=cap, include_current=True)
        elif mode == 1:
            attn = fused_attn.fused_decode_attention(
                qv, k_cur, v_cur, prompt_kp, prompt_vp, gen_kp, gen_vp,
                prompt_lengths, gen_lengths, p_idx, g_idx,
                attn_logits_soft_cap=cap)
        else:
            parts = [paged_attn.paged_flash_parts(
                         qv, kp, vp, lens, idx, attn_logits_soft_cap=cap)
                     for kp, vp, lens, idx in (
                         (prompt_kp, prompt_vp, prompt_lengths, p_idx),
                         (gen_kp, gen_vp, gen_lengths, g_idx))]
            attn = paged_attn.merge_attention_parts(parts, qv, k_cur, v_cur,
                                                    cap, torch.float32)
        a = _out_proj(attn.to(h.dtype).reshape(b, 1, -1),
                      lp["self_attn"]["o"], self_split)
        h = h + rms_norm(a, lp["post_self_attn_norm"], eps)

        hn = rms_norm(h, lp["pre_cross_attn_norm"], eps)
        cq = _split_heads(_mm(hn, lp["cross_attn"]["q"]), cdims.num_heads,
                          dims.head_dim)
        if q_cos is not None:
            cq = rope_ops.apply_rope(cq, q_cos, q_sin)
        cqv = cq[:, :, 0].float() * dims.q_scale
        if mode == 2:
            cattn = fused_attn.batch_paged_attention(
                cqv, None, None, cross_kp, cross_vp, None, None, enc_lengths,
                None, tables["cross"][li], None, *cross_s, None, None,
                attn_logits_soft_cap=cap)
        else:
            cattn = paged_attn.paged_gqa_attention(
                cqv, cross_kp, cross_vp, enc_lengths,
                page_indices=tables["cross"][li], attn_logits_soft_cap=cap)
        a = _out_proj(cattn.to(h.dtype).reshape(b, 1, -1),
                      lp["cross_attn"]["o"], cross_split)
        h = h + rms_norm(a, lp["post_cross_attn_norm"], eps)

        m = mlp(lp["mlp"], rms_norm(h, lp["pre_ff_norm"], eps), dims)
        h = h + rms_norm(m, lp["post_ff_norm"], eps)
        k_new.append(k[:, :, 0])
        v_new.append(v[:, :, 0])
    h = rms_norm(h, params["final_norm"], eps)
    cache.pending_k.copy_(torch.stack(k_new))
    cache.pending_v.copy_(torch.stack(v_new))
    return h, cache


def _page_views(cache: PagedDecoderCache):
    """(prompt k, prompt v, gen k, gen v, cross k, cross v) page views."""
    return tuple(_pages_view(x) for x in (
        cache.prompt_k, cache.prompt_v, cache.gen_k, cache.gen_v,
        cache.cross_k, cache.cross_v))


def paged_decode_multi(params: PyTree, dims: ModuleDims, *, inputs_embeds,
                       position_ids, pm_decoder_positions,
                       cache: PagedDecoderCache, pending_k, pending_v,
                       flush_start: int, step: int, prompt_lengths,
                       enc_lengths):
    """One S-token verify pass over the paged cache (speculative decoding).

    ``inputs_embeds`` [B, S, D] and ``position_ids`` [B, S] are the chain;
    ``pending_k/v`` [L, B, S, Hkv, hd] bf16 the previous pass's chain K/V,
    flushed first into gen slots ``flush_start`` .. ``flush_start + S - 1``
    (slots past the accepted prefix hold K/V that the next flush overwrites
    before the visible length reaches them; prefill's ``cache_slack`` keeps
    the block inside the slab). Every chain position sees the same segment
    lengths (prompt; generation = ``step``), so the segments run once over
    B * S pseudo-rows that share their cache row's lengths and page tables,
    and each position attends causally to its own chain prefix.

    With W8A8 or int4 decoder weights over bf16 or int8 pages
    (``megakernel.supports``), in attention mode 3 or over int8 pages (the
    JAX rule), the pass is one ``decode_stack(chain=S)`` call. int8 pages
    run only there: without such weights ``paged_i8`` raises. Otherwise
    (bf16 or W8A16 weights, float8 pages, or modes 0-2) each layer runs the
    one-segment kernel over the prompt and the generation pages
    (``paged_flash_parts``), joins the chain through
    ``merge_attention_parts_chain`` and takes cross attention through
    ``paged_gqa_attention``, both at ``chain=S`` over the cache rows'
    lengths and page tables.

    A tensor-parallel rank runs its own heads and F columns: the fused
    pass through ``tp.decode_stack(chain=S)`` (kernel 2's parts, the model
    group reducing between them), the unfused one with its o / cross-o /
    down products summed over the group (``tp.row_product``).

    Returns (hidden [B, S, D], cache, chain_k, chain_v) with chain_k/v
    [L, B, S, Hkv, hd] bf16 (a rank's Hkv), the next pass's pending
    block."""
    b, s_len, _ = inputs_embeds.shape
    h = _embed_scale(inputs_embeds, dims)
    cos, sin, q_cos, q_sin = _rope_tables(position_ids, pm_decoder_positions,
                                          dims)
    _flush_block(cache.gen_k, pending_k, cache.gen_k_scale, flush_start)
    _flush_block(cache.gen_v, pending_v, cache.gen_v_scale, flush_start)
    quant = cache.gen_k.dtype == torch.int8
    layers = params["layers"]
    ldims, attn_split, mlp_split = tp.local_dims(layers, dims)
    rank_dims = ldims if attn_split or mlp_split else None
    fused = ((_fused_attn_mode(cache) == 3 or quant)
             and megakernel.supports(layers, dims, cache, rank_dims))
    if quant and not fused:
        raise ValueError(
            "the paged_i8 verify pass runs only through the megakernel path "
            "(ops/megakernel.decode_stack with int8 or int4 decode weights): "
            "the one-segment kernel has no int8 scale planes")

    eps, hd = dims.rms_norm_eps, dims.head_dim
    if fused:
        def rep(x):        # [B] -> [B*S], chain-position-major
            return x.repeat_interleave(s_len, dim=0)

        flat = (lambda t: t.reshape(b * s_len, hd))  # noqa: E731
        qc, qs = (q_cos, q_sin) if q_cos is not None else (cos, sin)
        kv_scales = None
        if quant:
            kv_scales = (cache.prompt_k_scale, cache.prompt_v_scale,
                         cache.gen_k_scale, cache.gen_v_scale,
                         cache.cross_k_scale, cache.cross_v_scale)
        args = dict(
            h=h.reshape(b * s_len, dims.hidden_size).float(),
            cos=flat(cos), sin=flat(sin), qcos=flat(qc), qsin=flat(qs),
            plens=rep(prompt_lengths),
            glens=torch.full((b * s_len,), step, dtype=torch.int32,
                             device=h.device),
            elens=rep(enc_lengths),
            prompt_k=cache.prompt_k, prompt_v=cache.prompt_v,
            gen_k=cache.gen_k, gen_v=cache.gen_v, cross_k=cache.cross_k,
            cross_v=cache.cross_v, kv_scales=kv_scales, chain=s_len)
        if rank_dims is None:
            h3, k_new, v_new = megakernel.decode_stack(layers, dims, **args)
        else:
            h3, k_new, v_new = tp.decode_stack(layers, dims, rank_dims,
                                               **args)
        h3 = rms_norm(h3, params["final_norm"], eps)
        chain = (dims.num_layers, b, s_len, ldims.num_kv_heads, hd)
        return (h3.reshape(b, s_len, -1).to(h.dtype), cache,
                k_new.reshape(chain).to(torch.bfloat16),
                v_new.reshape(chain).to(torch.bfloat16))

    prompt_kp, prompt_vp, gen_kp, gen_vp, cross_kp, cross_vp = _page_views(
        cache)
    tables = cache.page_indices
    cap = dims.attn_logit_softcap
    n_heads = ldims.num_heads
    cdims, cross_split = tp.attention_dims(layers["cross_attn"], dims)
    gen_lengths = torch.full((b,), step, dtype=torch.int32, device=h.device)
    k_new, v_new = [], []
    for li in range(dims.num_layers):
        lp = layer_params(params["layers"], li)
        hn = rms_norm(h, lp["pre_self_attn_norm"], eps)
        q, k, v = _qkv_proj(lp["self_attn"], hn, dims)   # [B, H|Hkv, S, hd]
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        qv = (q.float() * dims.q_scale).transpose(1, 2)  # [B, S, H, hd]
        k_c, v_c = k.transpose(1, 2), v.transpose(1, 2)  # [B, S, Hkv, hd]
        q2 = qv.reshape(b * s_len, n_heads, hd)
        parts = [paged_attn.paged_flash_parts(
                     q2, kp, vp, lens, tables[name][li],
                     attn_logits_soft_cap=cap, chain=s_len)
                 for kp, vp, lens, name in (
                     (prompt_kp, prompt_vp, prompt_lengths, "prompt"),
                     (gen_kp, gen_vp, gen_lengths, "gen"))]
        attn = paged_attn.merge_attention_parts_chain(
            parts, qv, k_c, v_c, cap, h.dtype, store_dtype=cache.gen_k.dtype)
        a = _out_proj(attn.reshape(b, s_len, -1), lp["self_attn"]["o"],
                      attn_split)
        h = h + rms_norm(a, lp["post_self_attn_norm"], eps)

        hn = rms_norm(h, lp["pre_cross_attn_norm"], eps)
        cq = _split_heads(_mm(hn, lp["cross_attn"]["q"]), cdims.num_heads,
                          hd)
        if q_cos is not None:
            cq = rope_ops.apply_rope(cq, q_cos, q_sin)
        cq2 = (cq.float() * dims.q_scale).transpose(1, 2).reshape(
            b * s_len, cdims.num_heads, hd)
        cattn = paged_attn.paged_gqa_attention(
            cq2, cross_kp, cross_vp, enc_lengths,
            page_indices=tables["cross"][li], attn_logits_soft_cap=cap,
            out_dtype=h.dtype, chain=s_len)
        a = _out_proj(cattn.reshape(b, s_len, -1), lp["cross_attn"]["o"],
                      cross_split)
        h = h + rms_norm(a, lp["post_cross_attn_norm"], eps)

        m = mlp(lp["mlp"], rms_norm(h, lp["pre_ff_norm"], eps), dims)
        h = h + rms_norm(m, lp["post_ff_norm"], eps)
        k_new.append(k_c)
        v_new.append(v_c)
    h = rms_norm(h, params["final_norm"], eps)
    return (h, cache, torch.stack(k_new).to(torch.bfloat16),
            torch.stack(v_new).to(torch.bfloat16))


def _decode_step_stacked(params, dims, h, cos, sin, q_cos, q_sin, cache,
                         prompt_lengths, gen_lengths, enc_lengths,
                         rank_dims=None):
    """The step's layers as one ``megakernel.decode_stack`` call (the JAX
    package's mode 3, stacked); a tensor-parallel rank's block (its widths
    ``rank_dims``) through ``tp.decode_stack``, the model group reducing
    between its parts."""
    cos1, sin1 = cos[:, 0], sin[:, 0]
    if q_cos is not None:
        qc1, qs1 = q_cos[:, 0], q_sin[:, 0]
    else:
        qc1, qs1 = cos1, sin1
    kv_scales = None
    if cache.gen_k_scale is not None:
        kv_scales = (cache.prompt_k_scale, cache.prompt_v_scale,
                     cache.gen_k_scale, cache.gen_v_scale,
                     cache.cross_k_scale, cache.cross_v_scale)
    args = dict(h=h[:, 0].float(), cos=cos1, sin=sin1, qcos=qc1, qsin=qs1,
                plens=prompt_lengths, glens=gen_lengths, elens=enc_lengths,
                prompt_k=cache.prompt_k, prompt_v=cache.prompt_v,
                gen_k=cache.gen_k, gen_v=cache.gen_v, cross_k=cache.cross_k,
                cross_v=cache.cross_v, kv_scales=kv_scales)
    if rank_dims is None:
        h3, k_new, v_new = megakernel.decode_stack(params["layers"], dims,
                                                   **args)
    else:
        h3, k_new, v_new = tp.decode_stack(params["layers"], dims, rank_dims,
                                           **args)
    h3 = rms_norm(h3, params["final_norm"], dims.rms_norm_eps)
    cache.pending_k.copy_(k_new)
    cache.pending_v.copy_(v_new)
    return h3[:, None, :].to(h.dtype), cache


def fuse_for_decode(params: PyTree) -> PyTree:
    """Concatenate q/k/v -> qkv and gate/up -> gate_up in both stacks (fewer
    matmuls per decoder layer). Returns a new tree; inference only."""
    def fuse_stack(stack):
        stack = dict(stack)
        layers = dict(stack["layers"])
        sa = dict(layers["self_attn"])
        sa["qkv"] = torch.cat([sa.pop("q"), sa.pop("k"), sa.pop("v")], dim=-1)
        layers["self_attn"] = sa
        m = dict(layers["mlp"])
        m["gate_up"] = torch.cat([m.pop("gate"), m.pop("up")], dim=-1)
        layers["mlp"] = m
        stack["layers"] = layers
        return stack

    out = dict(params)
    out["encoder"] = fuse_stack(params["encoder"])
    out["decoder"] = fuse_stack(params["decoder"])
    return out

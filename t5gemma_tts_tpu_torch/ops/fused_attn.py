"""Fused paged decode attention: the hand-written CUDA kernels and their
plain PyTorch versions.

Counterpart of ``t5gemma_tts_tpu/ops/fused_attn.py``: :func:`quantize_kv`,
:func:`batch_paged_attention` (the decode step's attention mode 2, called
twice per layer: self-attention with A = prompt pages, B = generation pages
plus the in-flight token, and cross-attention with A = encoder pages alone)
and :func:`fused_decode_attention` (mode 1's self-attention, the v1 kernel).

On a CUDA tensor the wrappers launch ``csrc/batch_paged_attention.cu`` /
``csrc/fused_decode_attention.cu`` (built with nvcc at first use, see
ops/cuda_build.py) or raise; on a CPU tensor they run
:func:`batch_paged_attention_plain` / :func:`fused_decode_attention_plain`,
which compute the same functions with whole-tensor PyTorch ops.
``.launches`` on each wrapper counts kernel launches.

The two-segment kernel is split-KV: :func:`batch_attention_plan` cuts the
segments' capacity (pages per row x page size, never the lengths, so the
launch needs no host sync and a CUDA graph captures it) into chunks of one
CTA each (:func:`split_plan`), and a second kernel merges a row's partials.

Semantics carried over from the TPU kernel: logits in f32, soft cap before
the length mask, mask value -0.7 * f32max with masked probabilities 0,
segment A clamped to at least one token, int8 pages dequantized per token
as ``int8 * scale``, float8 e4m3 pages widened to f32 (no scales), output
``acc / (l if l > 0 else 1)``. A segment's
length must not exceed its pages per row times the page size. The v1
kernel computes the same function over a prompt and a generation segment
and the in-flight token, but reads no page of an empty prompt segment (no
clamp) and takes bf16 or e4m3 pages only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
WAVE = 132       # CTAs of one wave: one on each of an H100's SMs


def split_plan(pairs: int, capacity: int, page: int) -> Tuple[int, int]:
    """(chunk, splits) of a split-KV attention launch: ``pairs`` (row, kv
    head) pairs over ``capacity`` tokens of whole ``page``-token pages. The
    chunk is the largest divisor of the page, halving from the page, at
    which ``pairs * splits`` CTAs fill one wave (or the smallest halving);
    the splits cover the capacity exactly once and never straddle a page."""
    chunk = page
    while chunk % 2 == 0 and pairs * (capacity // chunk) < WAVE:
        chunk //= 2
    return chunk, capacity // chunk


def batch_attention_plan(a_k_pages: torch.Tensor,
                         a_page_indices: torch.Tensor,
                         b_page_indices: Optional[torch.Tensor]
                         ) -> Tuple[int, int]:
    """The two-segment kernel's (chunk, splits) for one call, from shapes
    alone: B x Hkv pairs over both segments' pages per row."""
    hkv, _, ps, _ = a_k_pages.shape
    b, pp_a = a_page_indices.shape
    pp_b = 0 if b_page_indices is None else b_page_indices.shape[1]
    return split_plan(b * hkv, (pp_a + pp_b) * ps, ps)


def absmax_scale(amax: torch.Tensor, levels: float = 127.0) -> torch.Tensor:
    """``max(amax, 1e-8) / levels`` as an f32 division. (On the card
    PyTorch turns a division by a Python number into a multiplication by
    its reciprocal, which can round the scale, and through it a quantized
    level, differently.)"""
    return amax.clamp_min(1e-8) / torch.full_like(amax, levels)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over the last (head) dim:
    x [..., hd] -> (int8 [..., hd], scale [...] f32), dequantized as
    ``int8 * scale``."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = absmax_scale(amax)
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _segment(qg, k_pages, v_pages, k_scales, v_scales, lengths, page_indices,
             soft_cap):
    """Gather one segment's pages -> (logits [B,Hkv,G,T], valid [B,1,1,T],
    values [B,Hkv,T,hd])."""
    hkv, _, ps, hd = k_pages.shape
    b, pp = page_indices.shape
    idx = page_indices.long()
    k = k_pages[:, idx].float()                       # [Hkv, B, PP, ps, hd]
    v = v_pages[:, idx].float()
    if k_scales is not None:
        k = k * k_scales[:, idx][..., None]
        v = v * v_scales[:, idx][..., None]
    k = k.reshape(hkv, b, pp * ps, hd).transpose(0, 1)
    v = v.reshape(hkv, b, pp * ps, hd).transpose(0, 1)
    logits = torch.einsum("bkgh,bkth->bkgt", qg, k)
    if soft_cap is not None:
        logits = torch.tanh(logits / soft_cap) * soft_cap
    t = torch.arange(pp * ps, device=qg.device)
    valid = (t[None, :] < lengths[:, None].to(t.dtype))[:, None, None, :]
    return logits, valid, v


def _attend(qg, parts, k_cur, v_cur, soft_cap) -> torch.Tensor:
    """Softmax attention of ``qg`` [B, Hkv, G, hd] over the segments'
    (logits, valid, values) and, when ``k_cur`` is given, the in-flight
    token -> acc / l [B, Hkv, G, hd] f32 (l replaced by 1 where it is 0)."""
    logits = torch.cat([p[0] for p in parts], dim=-1)
    valid = torch.cat([p[1] for p in parts], dim=-1)
    values = torch.cat([p[2] for p in parts], dim=2)
    logits = torch.where(valid, logits, MASK_VALUE)
    if k_cur is not None:
        cur = torch.einsum("bkgh,bkh->bkg", qg, k_cur.float())
        if soft_cap is not None:
            cur = torch.tanh(cur / soft_cap) * soft_cap
        logits = torch.cat([logits, cur[..., None]], dim=-1)
        valid = torch.cat(
            [valid, torch.ones_like(valid[..., :1])], dim=-1)
        values = torch.cat([values, v_cur.float()[:, :, None]], dim=2)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgt,bkth->bkgh", p, values)
    return acc / torch.where(l > 0.0, l, 1.0)


def batch_paged_attention_plain(
    q, k_cur, v_cur, a_k_pages, a_v_pages, b_k_pages, b_v_pages,
    a_lengths, b_lengths, a_page_indices, b_page_indices,
    a_k_scales=None, a_v_scales=None, b_k_scales=None, b_v_scales=None,
    *, attn_logits_soft_cap: Optional[float] = None,
    include_current: bool = False,
) -> torch.Tensor:
    """Whole-tensor PyTorch version of the kernel (same arguments as
    :func:`batch_paged_attention`) -> [B, H, hd] f32."""
    b, h, hd = q.shape
    hkv = a_k_pages.shape[0]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, hd)
    parts = [_segment(qg, a_k_pages, a_v_pages, a_k_scales, a_v_scales,
                      a_lengths.clamp_min(1), a_page_indices,
                      attn_logits_soft_cap)]
    if b_k_pages is not None:
        parts.append(_segment(qg, b_k_pages, b_v_pages, b_k_scales,
                              b_v_scales, b_lengths, b_page_indices,
                              attn_logits_soft_cap))
    out = _attend(qg, parts, k_cur if include_current else None, v_cur,
                  attn_logits_soft_cap)
    return out.reshape(b, h, hd)


def batch_paged_attention(
    q: torch.Tensor,                 # [B, H, hd] f32, roped + pre-scaled
    k_cur: Optional[torch.Tensor],   # [B, Hkv, hd] in-flight K, or None
    v_cur: Optional[torch.Tensor],
    a_k_pages: torch.Tensor,         # [Hkv, NPa, ps, hd] bf16, f8 or int8
    a_v_pages: torch.Tensor,
    b_k_pages: Optional[torch.Tensor],   # [Hkv, NPb, ps, hd] or None
    b_v_pages: Optional[torch.Tensor],
    a_lengths: torch.Tensor,         # [B] int32
    b_lengths: Optional[torch.Tensor],
    a_page_indices: torch.Tensor,    # [B, PPa] int32
    b_page_indices: Optional[torch.Tensor],
    a_k_scales: Optional[torch.Tensor] = None,   # [Hkv, NPa, ps] f32 (int8)
    a_v_scales: Optional[torch.Tensor] = None,
    b_k_scales: Optional[torch.Tensor] = None,
    b_v_scales: Optional[torch.Tensor] = None,
    *,
    attn_logits_soft_cap: Optional[float] = None,
    include_current: bool = False,
) -> torch.Tensor:
    """Flash attention over up to two paged segments (+ the in-flight
    token) -> [B, H, hd] f32, normalized. Segment B is absent when
    ``b_k_pages`` is None; without ``include_current`` the caller passes
    no current token. With ``a_k_scales`` the pages are int8."""
    args = (q, k_cur, v_cur, a_k_pages, a_v_pages, b_k_pages, b_v_pages,
            a_lengths, b_lengths, a_page_indices, b_page_indices,
            a_k_scales, a_v_scales, b_k_scales, b_v_scales)
    if q.device.type == "cpu":
        return batch_paged_attention_plain(
            *args, attn_logits_soft_cap=attn_logits_soft_cap,
            include_current=include_current)
    if q.device.type != "cuda":
        raise ValueError(f"batch_paged_attention: no kernel for {q.device}")
    out = _launch(*args, soft_cap=attn_logits_soft_cap,
                  include_current=include_current)
    batch_paged_attention.launches += 1
    return out


batch_paged_attention.launches = 0


def fused_decode_attention_plain(
    q, k_cur, v_cur, prompt_k_pages, prompt_v_pages, gen_k_pages,
    gen_v_pages, prompt_lengths, gen_lengths, prompt_page_indices,
    gen_page_indices, *, attn_logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Whole-tensor PyTorch version of the v1 kernel (same arguments as
    :func:`fused_decode_attention`) -> [B, H, hd] f32."""
    b, h, hd = q.shape
    hkv = prompt_k_pages.shape[0]
    qg = q.float().reshape(b, hkv, h // hkv, hd)
    parts = [_segment(qg, k, v, None, None, lens, idx, attn_logits_soft_cap)
             for k, v, lens, idx in (
                 (prompt_k_pages, prompt_v_pages, prompt_lengths,
                  prompt_page_indices),
                 (gen_k_pages, gen_v_pages, gen_lengths, gen_page_indices))]
    return _attend(qg, parts, k_cur, v_cur,
                   attn_logits_soft_cap).reshape(b, h, hd)


def fused_decode_attention(
    q: torch.Tensor,                     # [B, H, hd] f32, roped + pre-scaled
    k_cur: torch.Tensor,                 # [B, Hkv, hd] in-flight K
    v_cur: torch.Tensor,
    prompt_k_pages: torch.Tensor,        # [Hkv, NPp, ps, hd] bf16 or f8
    prompt_v_pages: torch.Tensor,
    gen_k_pages: torch.Tensor,           # [Hkv, NPg, ps, hd]
    gen_v_pages: torch.Tensor,
    prompt_lengths: torch.Tensor,        # [B] int32
    gen_lengths: torch.Tensor,           # [B] int32
    prompt_page_indices: torch.Tensor,   # [B, PPp] int32
    gen_page_indices: torch.Tensor,      # [B, PPg] int32
    *,
    attn_logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over prompt pages + generation pages + the in-flight
    token in one flash pass -> [B, H, hd] f32, normalized (the JAX v1
    kernel). Pages are bf16 or float8 e4m3; int8 pages raise."""
    args = (q, k_cur, v_cur, prompt_k_pages, prompt_v_pages, gen_k_pages,
            gen_v_pages, prompt_lengths, gen_lengths, prompt_page_indices,
            gen_page_indices)
    for pages in args[3:7]:
        if pages.dtype not in (torch.bfloat16, torch.float8_e4m3fn):
            raise ValueError(f"fused_decode_attention: pages of dtype "
                             f"{pages.dtype} (bf16 or float8_e4m3fn; int8 "
                             f"pages take batch_paged_attention)")
    if q.device.type == "cpu":
        return fused_decode_attention_plain(
            *args, attn_logits_soft_cap=attn_logits_soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: no kernel for {q.device}")
    out = _launch_fused(*args, soft_cap=attn_logits_soft_cap)
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0


# the C PageType of csrc/paged_pages.cuh
PAGE_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _bind():
    from . import cuda_build

    lib = cuda_build.load("batch_paged_attention")
    fn = lib.t5g_batch_paged_attention
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([vp] * 3 + [vp] * 6 + [i32, i64] + [vp] * 6
                       + [i32, i64] + [vp] * 4 + [i32] * 7
                       + [ctypes.c_float, i32, i32, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_cur, v_cur, a_k, a_v, b_k, b_v, a_len, b_len, a_idx, b_idx,
            a_ks, a_vs, b_ks, b_vs, *, soft_cap, include_current):
    dev = q.device
    b, h, hd = q.shape
    hkv, _, ps, _ = a_k.shape
    if h % hkv or hd % 8 or hd > 256:
        raise ValueError(f"unsupported heads/head_dim H={h} Hkv={hkv} hd={hd}")
    quant = a_ks is not None
    page_dtype = torch.int8 if quant else a_k.dtype
    page_type = PAGE_TYPES.get(page_dtype)
    if page_type is None or (page_dtype == torch.int8) != quant:
        raise ValueError(f"pages of dtype {a_k.dtype}: bf16, float8_e4m3fn, "
                         f"or int8 with scale planes")
    _check("q", q, dev, torch.float32, (b, h, hd))
    segs = [(a_k, a_v, a_ks, a_vs, a_len, a_idx)]
    if b_k is not None:
        segs.append((b_k, b_v, b_ks, b_vs, b_len, b_idx))
    for si, (k, v, ks, vs, ln, idx) in enumerate(segs):
        pre = "ab"[si]
        _check(f"{pre}_k_pages", k, dev, page_dtype)
        _check(f"{pre}_v_pages", v, dev, page_dtype, k.shape)
        if k.shape[0] != hkv or k.shape[2] != ps or k.shape[3] != hd:
            raise ValueError(f"{pre}_k_pages shape {tuple(k.shape)} mismatch")
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(f"{pre} pages must be 16-byte aligned")
        if quant:
            _check(f"{pre}_k_scales", ks, dev, torch.float32, k.shape[:3])
            _check(f"{pre}_v_scales", vs, dev, torch.float32, k.shape[:3])
        _check(f"{pre}_lengths", ln, dev, torch.int32, (b,))
        _check(f"{pre}_page_indices", idx, dev, torch.int32)
        if idx.ndim != 2 or idx.shape[0] != b:
            raise ValueError(f"{pre}_page_indices must be [B, PP]")
    if include_current:
        k_cur = k_cur.float().contiguous()
        v_cur = v_cur.float().contiguous()
        _check("k_cur", k_cur, dev, torch.float32, (b, hkv, hd))
        _check("v_cur", v_cur, dev, torch.float32, (b, hkv, hd))
    else:
        k_cur = v_cur = None
    has_b = b_k is not None
    chunk, splits = batch_attention_plan(a_k, a_idx, b_idx if has_b else None)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    # the split partials (acc [B, Hkv, splits, G, hd], then m and l), one
    # allocation addressed by offsets (views would cost host time per call)
    n_ml = b * h * splits
    part = torch.empty((n_ml * (hd + 2),), dtype=torch.float32, device=dev)
    acc_ptr = part.data_ptr()
    m_ptr = acc_ptr + 4 * n_ml * hd
    fn = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), _ptr(k_cur), _ptr(v_cur),
            a_k.data_ptr(), a_v.data_ptr(), _ptr(a_ks), _ptr(a_vs),
            a_len.data_ptr(), a_idx.data_ptr(), a_idx.shape[1], a_k.shape[1],
            _ptr(b_k) if has_b else None, _ptr(b_v) if has_b else None,
            _ptr(b_ks) if has_b else None, _ptr(b_vs) if has_b else None,
            b_len.data_ptr() if has_b else None,
            b_idx.data_ptr() if has_b else None,
            b_idx.shape[1] if has_b else 0, b_k.shape[1] if has_b else 0,
            out.data_ptr(), acc_ptr, m_ptr, m_ptr + 4 * n_ml,
            chunk, splits, b, h, hkv, hd, ps,
            float(soft_cap) if soft_cap is not None else 0.0,
            int(include_current), page_type, stream)
    if err != 0:
        raise RuntimeError(f"batch_paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


def _bind_fused():
    from . import cuda_build

    fn = cuda_build.load("fused_decode_attention").t5g_fused_decode_attention
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([vp] * 3 + [vp] * 4 + [i32, i64] + [vp] * 4
                       + [i32, i64] + [vp] + [i32] * 5
                       + [ctypes.c_float, i32, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch_fused(q, k_cur, v_cur, p_k, p_v, g_k, g_v, p_len, g_len, p_idx,
                  g_idx, *, soft_cap):
    dev = q.device
    b, h, hd = q.shape
    hkv, _, ps, _ = p_k.shape
    if h % hkv or hd % 8 or hd > 256:
        raise ValueError(f"unsupported heads/head_dim H={h} Hkv={hkv} hd={hd}")
    _check("q", q, dev, torch.float32, (b, h, hd))
    segs = []
    for pre, k, v, ln, idx in (("prompt", p_k, p_v, p_len, p_idx),
                               ("gen", g_k, g_v, g_len, g_idx)):
        _check(f"{pre}_k_pages", k, dev, p_k.dtype)
        _check(f"{pre}_v_pages", v, dev, p_k.dtype, k.shape)
        if k.shape[0] != hkv or k.shape[2] != ps or k.shape[3] != hd:
            raise ValueError(f"{pre}_k_pages shape {tuple(k.shape)} mismatch")
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(f"{pre} pages must be 16-byte aligned")
        _check(f"{pre}_lengths", ln, dev, torch.int32, (b,))
        _check(f"{pre}_page_indices", idx, dev, torch.int32)
        if idx.ndim != 2 or idx.shape[0] != b:
            raise ValueError(f"{pre}_page_indices must be [B, PP]")
        segs += [k.data_ptr(), v.data_ptr(), ln.data_ptr(), idx.data_ptr(),
                 idx.shape[1], k.shape[1]]
    k_cur = k_cur.float().contiguous()
    v_cur = v_cur.float().contiguous()
    _check("k_cur", k_cur, dev, torch.float32, (b, hkv, hd))
    _check("v_cur", v_cur, dev, torch.float32, (b, hkv, hd))
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _bind_fused()
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(), *segs,
                 out.data_ptr(), b, h, hkv, hd, ps,
                 float(soft_cap) if soft_cap is not None else 0.0,
                 PAGE_TYPES[p_k.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out

"""Paged KV-cache attention over one segment: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``t5gemma_tts_tpu/ops/paged_attn.py``: the page store
dtypes, the identity page table of a [Hkv, L*B*pages, ps, hd] slab view,
:func:`paged_flash_parts` (flash attention over one paged segment ->
normalized ``out`` and its ``m``/``l`` statistics), :func:`paged_gqa_attention`
(the same, ``out`` alone), and the two flash merges
:func:`merge_attention_parts` and :func:`merge_attention_parts_chain`, which
are XLA code in the JAX package and plain PyTorch here.

On a CUDA tensor :func:`paged_flash_parts` and :func:`paged_gqa_attention`
launch ``csrc/paged_flash_parts.cu`` (built with nvcc at first use, see
ops/cuda_build.py) or raise; on a CPU tensor they run their plain versions
(:func:`paged_flash_parts_plain`, :func:`paged_attention_reference`).
``paged_flash_parts.launches`` counts kernel launches of both wrappers.

The kernel is split-KV: :func:`parts_plan` cuts the segment's capacity
(pages per row x page size, never the lengths, so the launch needs no host
sync and a CUDA graph captures it) into chunks (:func:`fused_attn.split_plan`),
one CTA per (chunk, kv head, cache row), and a second kernel merges a row's
partials. With ``chain = S`` (the speculative verify pass) q holds S
pseudo-rows per cache row, chain-position-major, over the cache row's one
length and page table: a CTA serves all S chain positions, so each page is
read once per cache row.

Pages are bf16 or float8 e4m3 (widened exactly to f32); logits are f32 with
the tanh soft cap before the length mask. A row of length 0 gives
``(0, -inf, 0)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .fused_attn import PAGE_TYPES, _check, _split_workspace, split_plan

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

KV_STORE_DTYPES = {
    "bf16": torch.bfloat16,
    "f8": torch.float8_e4m3fn,
    "i8": torch.int8,    # + per-token scale planes (ops/fused_attn.quantize_kv)
}

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def identity_page_indices(batch: int, pages_per_seq: int,
                          device=None) -> torch.Tensor:
    """[B, pages_per_seq] int32: row b owns pages b*pps ... b*pps + pps - 1."""
    rows = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(pages_per_seq, dtype=torch.int32, device=device)[None]
    return rows * pages_per_seq + cols


def _gather(q, k_pages, v_pages, lengths, page_indices, soft_cap):
    """Dense view of one segment -> (logits [B,Hkv,G,T], valid [B,1,1,T],
    values [B,Hkv,T,hd])."""
    b, h, hd = q.shape
    hkv, _, ps, _ = k_pages.shape
    pp = page_indices.shape[1]
    idx = page_indices.long()
    k = k_pages[:, idx].float().reshape(hkv, b, pp * ps, hd).transpose(0, 1)
    v = v_pages[:, idx].float().reshape(hkv, b, pp * ps, hd).transpose(0, 1)
    qg = q.float().reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bkgh,bkth->bkgt", qg, k)
    if soft_cap is not None:
        logits = torch.tanh(logits / soft_cap) * soft_cap
    t = torch.arange(pp * ps, device=q.device)
    valid = (t[None, :] < lengths[:, None].to(t.dtype))[:, None, None, :]
    return logits, valid, v


def parts_plan(k_pages: torch.Tensor,
               page_indices: torch.Tensor) -> Tuple[int, int]:
    """The kernel's (chunk, splits) for one call, from shapes alone: cache
    rows x Hkv pairs over the segment's pages per row."""
    hkv, _, ps, _ = k_pages.shape
    b, pp = page_indices.shape
    return split_plan(b * hkv, pp * ps, ps)


def _per_pseudo_row(lengths, page_indices, chain):
    """Cache rows' lengths and page tables repeated over their ``chain``
    pseudo-rows (chain-position-major)."""
    if chain == 1:
        return lengths, page_indices
    return (lengths.repeat_interleave(chain),
            page_indices.repeat_interleave(chain, dim=0))


def _check_chain(q, lengths, chain):
    if chain < 1 or q.shape[0] != chain * lengths.shape[0]:
        raise ValueError(f"q has {q.shape[0]} rows, expected chain {chain} x "
                         f"{lengths.shape[0]} cache rows")


def paged_attention_reference(q, k_pages, v_pages, lengths, *,
                              page_indices=None,
                              attn_logits_soft_cap: Optional[float] = None):
    """Dense softmax attention over a paged segment (the plain version of
    :func:`paged_gqa_attention`): masked logits take ``MASK_VALUE`` ->
    [B, H, hd] f32."""
    b, h, hd = q.shape
    if page_indices is None:
        page_indices = identity_page_indices(b, k_pages.shape[1] // b,
                                             q.device)
    logits, valid, v = _gather(q, k_pages, v_pages, lengths, page_indices,
                               attn_logits_soft_cap)
    w = torch.softmax(torch.where(valid, logits, MASK_VALUE), dim=-1)
    return torch.einsum("bkgt,bkth->bkgh", w, v).reshape(b, h, hd)


def paged_flash_parts_plain(q, k_pages, v_pages, lengths, page_indices, *,
                            attn_logits_soft_cap: Optional[float] = None,
                            chain: int = 1) -> Parts:
    """Whole-tensor PyTorch version of the kernel (same arguments as
    :func:`paged_flash_parts`) -> (out [B', H, hd], m [B', H], l [B', H]),
    f32, B' = B x chain."""
    lengths, page_indices = _per_pseudo_row(lengths, page_indices, chain)
    b, h, hd = q.shape
    logits, valid, v = _gather(q, k_pages, v_pages, lengths, page_indices,
                               attn_logits_soft_cap)
    logits = torch.where(valid, logits, -torch.inf)
    m = logits.amax(dim=-1)                             # -inf if empty
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(valid, torch.exp(logits - safe_m[..., None]), 0.0)
    l = e.sum(dim=-1)
    out = torch.einsum("bkgt,bkth->bkgh", e, v)
    out = out / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, h, hd), m.reshape(b, h), l.reshape(b, h)


def paged_flash_parts(
    q: torch.Tensor,             # [B * chain, H, hd] f32, roped + pre-scaled
    k_pages: torch.Tensor,       # [Hkv, NP, ps, hd] bf16 or float8 e4m3
    v_pages: torch.Tensor,
    lengths: torch.Tensor,       # [B] int32 valid-key count of each cache row
    page_indices: torch.Tensor,  # [B, PP] int32
    *,
    attn_logits_soft_cap: Optional[float] = None,
    chain: int = 1,
) -> Parts:
    """Flash attention over one paged key segment -> (out, m, l), all f32:
    ``out`` [B', H, hd] normalized over this segment, ``m``/``l`` [B', H]
    its running max and sum, so that segments (and in-flight tokens)
    compose exactly through :func:`merge_attention_parts`. B' = B x chain:
    q's rows are the ``chain`` positions of each cache row,
    chain-position-major, all over the row's length and page table. Rows of
    length 0 give (0, -inf, 0)."""
    _check_chain(q, lengths, chain)
    if q.device.type == "cpu":
        return paged_flash_parts_plain(
            q, k_pages, v_pages, lengths, page_indices,
            attn_logits_soft_cap=attn_logits_soft_cap, chain=chain)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_parts: no kernel for {q.device}")
    out = _launch(q, k_pages, v_pages, lengths, page_indices,
                  attn_logits_soft_cap, chain)
    paged_flash_parts.launches += 1
    return out


paged_flash_parts.launches = 0


def paged_gqa_attention(
    q: torch.Tensor,             # [B * chain, H, hd], roped + pre-scaled
    k_pages: torch.Tensor,       # [Hkv, NP, ps, hd] (NP may cover many layers)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,       # [B] int32 valid-key count of each cache row
    *,
    page_indices: Optional[torch.Tensor] = None,   # [B, PP]; identity if None
    attn_logits_soft_cap: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    chain: int = 1,
) -> torch.Tensor:
    """Decode attention over a paged cache -> [B * chain, H, hd] in
    ``out_dtype`` (default q's); ``chain`` as in :func:`paged_flash_parts`.
    On the card it is :func:`paged_flash_parts`' kernel with its ``out``
    taken as it is; on the CPU :func:`paged_attention_reference` (they
    differ only for a row of length 0, which the kernel leaves 0)."""
    _check_chain(q, lengths, chain)
    out_dtype = out_dtype or q.dtype
    b = lengths.shape[0]
    if page_indices is None:
        page_indices = identity_page_indices(b, k_pages.shape[1] // b,
                                             q.device)
    if q.device.type == "cpu":
        lengths, page_indices = _per_pseudo_row(lengths, page_indices, chain)
        out = paged_attention_reference(
            q, k_pages, v_pages, lengths, page_indices=page_indices,
            attn_logits_soft_cap=attn_logits_soft_cap)
    else:
        out = paged_flash_parts(q.float(), k_pages, v_pages, lengths,
                                page_indices,
                                attn_logits_soft_cap=attn_logits_soft_cap,
                                chain=chain)[0]
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# flash merges (plain PyTorch: XLA code in the JAX package)
# ---------------------------------------------------------------------------


def _capped(x, soft_cap):
    return x if soft_cap is None else torch.tanh(x / soft_cap) * soft_cap


def merge_attention_parts(parts: Sequence[Parts], q, k_cur, v_cur,
                          attn_logits_soft_cap: Optional[float], out_dtype):
    """Exact flash composition of key segments + the current token.
    ``parts`` (out [B,H,hd], m [B,H], l [B,H]); q [B, H, hd] f32
    pre-scaled; k_cur/v_cur [B, Hkv, hd]. The current token is always
    valid, so the denominator is nonzero even when every segment is
    empty."""
    b, h, hd = q.shape
    hkv = k_cur.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd)
    cur = torch.einsum("bkgh,bkh->bkg", qg, k_cur.float())
    cur = _capped(cur, attn_logits_soft_cap).reshape(b, h)
    m_new = cur
    for _, m, _ in parts:
        m_new = torch.maximum(m_new, m)
    beta = torch.exp(cur - m_new)
    vg = v_cur.float()[:, :, None].expand(b, hkv, g, hd).reshape(b, h, hd)
    num = vg * beta[..., None]
    den = beta
    for out, m, l in parts:
        w = torch.where(torch.isfinite(m), l * torch.exp(m - m_new), 0.0)
        num = num + out * w[..., None]
        den = den + w
    return (num / den[..., None]).to(out_dtype)


def merge_attention_parts_chain(parts: Sequence[Parts], q, k_chain, v_chain,
                                attn_logits_soft_cap: Optional[float],
                                out_dtype, store_dtype=None):
    """Flash composition of paged segments + an in-flight S-token chain.

    ``parts`` hold (out [B*S,H,hd], m [B*S,H], l [B*S,H]) of segments whose
    lengths are the same for every chain position; q [B, S, H, hd] f32
    pre-scaled; k_chain/v_chain [B, S, Hkv, hd]. Chain position i attends
    to positions j <= i, computed densely here. With ``store_dtype`` (the
    cache's page dtype) positions j < i round-trip f32 -> bf16 ->
    store_dtype -> f32, as the sequential engine reads them from the cache,
    while the diagonal j == i stays raw. Returns [B, S, H, hd]."""
    b, s_len, h, hd = q.shape
    hkv = k_chain.shape[2]
    g = h // hkv
    qg = q.reshape(b, s_len, hkv, g, hd)
    k32, v32 = k_chain.float(), v_chain.float()
    if store_dtype is not None:
        k_st = k_chain.to(torch.bfloat16).to(store_dtype).float()
        v_st = v_chain.to(torch.bfloat16).to(store_dtype).float()
    else:
        k_st, v_st = k32, v32
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k_st)   # [B,Hkv,G,S,S]
    diag = torch.einsum("bikgh,bikh->bkgi", qg, k32)
    eye = torch.eye(s_len, dtype=torch.bool, device=q.device)
    logits = torch.where(eye, diag[..., None], logits)
    logits = _capped(logits, attn_logits_soft_cap)
    ar = torch.arange(s_len, device=q.device)
    causal = ar[None, :] <= ar[:, None]
    logits = torch.where(causal, logits, -torch.inf)
    m_c = logits.amax(dim=-1)                               # [B,Hkv,G,S]
    e = torch.where(causal, torch.exp(logits - m_c[..., None]), 0.0)
    l_c = e.sum(dim=-1)
    e_off = torch.where(eye, 0.0, e)
    e_diag = torch.einsum("bkgij,ij->bkgi", e, eye.float())
    out_c = (torch.einsum("bkgij,bjkh->bkgih", e_off, v_st)
             + e_diag[..., None] * v32.permute(0, 2, 1, 3)[:, :, None])

    m_c = m_c.permute(0, 3, 1, 2).reshape(b, s_len, h)
    l_c = l_c.permute(0, 3, 1, 2).reshape(b, s_len, h)
    out_c = out_c.permute(0, 3, 1, 2, 4).reshape(b, s_len, h, hd)
    m_new = m_c
    for _, m, _ in parts:
        m_new = torch.maximum(m_new, m.reshape(b, s_len, h))
    beta = torch.exp(m_c - m_new)
    num = out_c * beta[..., None]
    den = l_c * beta
    for out, m, l in parts:
        m = m.reshape(b, s_len, h)
        w = torch.where(torch.isfinite(m),
                        l.reshape(b, s_len, h) * torch.exp(m - m_new), 0.0)
        num = num + out.reshape(b, s_len, h, hd) * w[..., None]
        den = den + w
    return (num / den[..., None]).to(out_dtype)


# ---------------------------------------------------------------------------
# the CUDA library (csrc/paged_flash_parts.cu)
# ---------------------------------------------------------------------------

def _bind():
    from . import cuda_build

    fn = cuda_build.load("paged_flash_parts").t5g_paged_flash_parts
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 5 + [i32, ctypes.c_int64] + [vp] * 6
                       + [i32] * 8 + [ctypes.c_float, i32, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pages, v_pages, lengths, page_indices, soft_cap,
            chain) -> Parts:
    dev = q.device
    rows, h, hd = q.shape
    b = lengths.shape[0]
    hkv, n_pages, ps, _ = k_pages.shape
    if h % hkv or hd % 8 or hd > 256:
        raise ValueError(f"unsupported heads/head_dim H={h} Hkv={hkv} hd={hd}")
    if k_pages.dtype not in (torch.bfloat16, torch.float8_e4m3fn):
        raise ValueError(f"paged_flash_parts: pages of dtype {k_pages.dtype} "
                         f"(bf16 or float8_e4m3fn)")
    _check("q", q, dev, torch.float32, (rows, h, hd))
    _check("k_pages", k_pages, dev, k_pages.dtype)
    _check("v_pages", v_pages, dev, k_pages.dtype, k_pages.shape)
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned")
    _check("lengths", lengths, dev, torch.int32, (b,))
    _check("page_indices", page_indices, dev, torch.int32)
    if page_indices.ndim != 2 or page_indices.shape[0] != b:
        raise ValueError("page_indices must be [B, PP]")
    chunk, splits = parts_plan(k_pages, page_indices)
    out = torch.empty((rows, h, hd), dtype=torch.float32, device=dev)
    m = torch.empty((rows, h), dtype=torch.float32, device=dev)
    l = torch.empty((rows, h), dtype=torch.float32, device=dev)
    part, parts = _split_workspace(rows, h, hd, splits, dev)
    fn = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 lengths.data_ptr(), page_indices.data_ptr(),
                 page_indices.shape[1], n_pages, out.data_ptr(),
                 m.data_ptr(), l.data_ptr(), *parts, b, chain, h, hkv, hd,
                 ps, chunk, splits,
                 float(soft_cap) if soft_cap is not None else 0.0,
                 PAGE_TYPES[k_pages.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_parts kernel launch failed: CUDA "
                           f"error {err}")
    return out, m, l

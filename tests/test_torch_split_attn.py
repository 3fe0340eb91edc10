"""The split-KV schedules of the attention kernels, on the CPU.

Kernels 1, 2, 5 and 7 cut a row's pages over CTAs
(``ops/fused_attn.py::split_plan``) and merge the partials. Here:

- the planners: every token of the capacity is covered exactly once, by
  chunks that divide the page and never straddle a page or segment; the
  plan reads shapes only (page tables and slabs on the ``meta`` device,
  which has no values, plan the same), so a launch needs no host sync; and
  at the main paths' shapes the grid holds at least one wave of 132 CTAs;
- kernel 1's schedule emulated with the port's plain pieces
  (``paged_flash_parts_plain`` on each split's tokens, merged by
  ``merge_attention_parts`` with the in-flight token) against the JAX
  package's ``batch_paged_attention`` (its Pallas kernel in interpret
  mode), to 1e-5, at lengths that leave splits empty;
- kernel 7 (the v1 fused self-attention) runs the same split and merge
  kernels over its prompt and generation segments without the clamp of
  segment A: its schedule, emulated the same way, against the JAX
  package's ``fused_decode_attention`` in interpret mode, to 1e-5, with
  empty splits and empty prompt segments;
- kernel 5 (the one-segment paged attention) emulated the same way: each
  split's tokens through ``paged_flash_parts_plain`` with the chain's
  queries sharing their cache row's chunk, the unnormalized partials, then
  the merge of the live splits in split order, against the JAX package's
  ``paged_flash_parts`` on the inputs repeated over the chain, to 1e-5,
  empty rows exactly (0, -inf, 0);
- kernel 2's attention under its two-pass schedule (see
  ``_split_slab_attention``: each split rounds p to bf16 relative to its
  128-token block's running max, the prefix max of the chunk maxima)
  against ``slab_attention_plain``, to f32 summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.ops import fused_attn as jfa
from t5gemma_tts_tpu.ops import paged_attn as jpa
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import paged_attn as tpa

torch.set_num_threads(1)
PS = 128
MASK = tfa.MASK_VALUE


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel1_plan(b, hkv, pp_a, pp_b):
    """Kernel 1's plan and segment capacities at B rows, Hkv heads."""
    plan = tfa.batch_attention_plan(
        _meta(hkv, b * max(pp_a, 1), PS, 16, dtype=torch.bfloat16),
        _meta(b, pp_a), _meta(b, pp_b) if pp_b else None)
    return plan, b * hkv, (pp_a * PS, pp_b * PS)


def _kernel5_plan(b, hkv, pp):
    """Kernel 5's plan and capacity at B cache rows of ``pp`` pages."""
    plan = tpa.parts_plan(_meta(hkv, b * pp, PS, 16, dtype=torch.bfloat16),
                          _meta(b, pp))
    return plan, b * hkv, (pp * PS,)


def _kernel2_plans(bc, hkv, tp, tg, tx, layers=26):
    dims = tconfig.backbone_preset("2b-2b").decoder
    assert dims.num_layers == layers and dims.num_kv_heads == hkv
    plans = tmk.attention_plan(
        dims, _meta(hkv, layers * bc, tp, 256, dtype=torch.bfloat16),
        _meta(hkv, layers * bc, tg, 256, dtype=torch.bfloat16),
        _meta(hkv, layers * bc, tx, 256, dtype=torch.bfloat16))
    return [(plans["self"], bc * hkv, (tp, tg)),
            (plans["cross"], bc * hkv, (tx,))]


# The main paths' shapes (2b-2b: Hkv = 4; the prompt slab one page, the
# generation slab the 512-frame bucket of a 4.0 s request, the encoder one
# page of text): kernel 1's bf16 batch of 4 and its e4m3 batch of 1,
# kernel 2's int8 batch of 4, int4 batch of 1 and the chain's one cache row.
MAIN_PATHS = {
    "k1 bf16 B=4 self": _kernel1_plan(4, 4, 1, 4),
    "k1 bf16 B=4 cross": _kernel1_plan(4, 4, 1, 0),
    "k1 e4m3 B=1 self": _kernel1_plan(1, 4, 1, 4),
    "k1 e4m3 B=1 cross": _kernel1_plan(1, 4, 1, 0),
    "k2 w8 B=4 self": _kernel2_plans(4, 4, 128, 512, 128)[0],
    "k2 w8 B=4 cross": _kernel2_plans(4, 4, 128, 512, 128)[1],
    "k2 w4 B=1 self": _kernel2_plans(1, 4, 128, 512, 128)[0],
    "k2 w4 B=1 cross": _kernel2_plans(1, 4, 128, 512, 128)[1],
    "k2 chain5 1 row self": _kernel2_plans(1, 4, 128, 512, 128)[0],
    # kernel 7 plans its prompt and generation pages as kernel 1 plans
    # segments A and B: 4g's bf16 (and e4m3) batch of 4
    "k7 B=4 self (4g)": _kernel1_plan(4, 4, 1, 4),
    # kernel 5: the 4e verify pass (one cache row; its prompt and encoder
    # segments one page, the generation segment four) and 4g's cross
    # attention (B = 4, one encoder page)
    "k5 4e prompt / cross": _kernel5_plan(1, 4, 1),
    "k5 4e gen": _kernel5_plan(1, 4, 4),
    "k5 4g cross B=4": _kernel5_plan(4, 4, 1),
}
OTHER = {
    "k1 hd16 3 rows": _kernel1_plan(3, 2, 2, 2),
    "k1 36 rows one page": _kernel1_plan(36, 4, 1, 0),
    "k1 long rows": _kernel1_plan(8, 4, 2, 32),
    "k7 hd16 5 rows": _kernel1_plan(5, 2, 2, 2),
    "k7 one row": _kernel1_plan(1, 4, 1, 4),
    "k2 36 rows": _kernel2_plans(36, 4, 128, 128, 128)[1],
    "k2 long slab": _kernel2_plans(2, 4, 256, 4096, 512)[0],
}


@pytest.mark.parametrize("name", list(MAIN_PATHS) + list(OTHER))
def test_split_plan_covers_the_capacity_once(name):
    (chunk, splits), pairs, caps = {**MAIN_PATHS, **OTHER}[name]
    assert PS % chunk == 0
    capacity = sum(caps)
    cover = np.zeros(capacity, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, (s + 1) * chunk
        cover[lo:hi] += 1
        assert lo // PS == (hi - 1) // PS              # inside one page
        assert (lo < caps[0]) == (hi - 1 < caps[0])    # inside one segment
    assert (cover == 1).all() and splits * chunk == capacity
    if name in MAIN_PATHS:
        assert pairs * splits >= tfa.WAVE, (chunk, splits)
        # the largest chunk that does: half of it would be more than needed
        if chunk < PS:
            assert pairs * (capacity // (2 * chunk)) < tfa.WAVE


def test_split_plan_reads_no_lengths():
    """The wrappers plan from shapes: meta tensors carry none of the
    values, and lengths are no argument. The plan is the same for any
    page table of the same shape."""
    real = tfa.batch_attention_plan(
        torch.zeros((4, 8, PS, 16), dtype=torch.bfloat16),
        torch.arange(8, dtype=torch.int32).reshape(4, 2), None)
    assert real == _kernel1_plan(4, 4, 2, 0)[0]
    # kernel 7's wrapper plans its prompt and generation page tables so
    assert tfa.batch_attention_plan(
        torch.zeros((4, 4, PS, 16), dtype=torch.bfloat16),
        torch.zeros((4, 1), dtype=torch.int32),
        torch.arange(16, dtype=torch.int32).reshape(4, 4)) == \
        _kernel1_plan(4, 4, 1, 4)[0]
    # kernel 5's: cache rows, not pseudo-rows, and no lengths
    assert tpa.parts_plan(torch.zeros((4, 3, PS, 16), dtype=torch.bfloat16),
                          torch.tensor([[2], [0], [1]], dtype=torch.int32)
                          ) == _kernel5_plan(3, 4, 1)[0]
    dims = tconfig.backbone_preset("test").decoder
    slab = torch.zeros((2, dims.num_layers * 3, PS, 16), dtype=torch.int8)
    meta = torch.empty(slab.shape, dtype=torch.int8, device="meta")
    assert (tmk.attention_plan(dims, slab, slab, slab)
            == tmk.attention_plan(dims, meta, meta, meta))


# ---------------------------------------------------------------------------
# kernel 1: its schedule from the plain pieces, against JAX
# ---------------------------------------------------------------------------

def _jax_case(seed, b, h, hkv, hd, a_lens, b_lens, pp):
    rng = np.random.default_rng(seed)

    def pages():
        x = rng.standard_normal((hkv, b * pp, PS, hd)).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))

    idx = np.asarray(jpa.identity_page_indices(b, pp))
    idx = idx[:, ::-1].copy()            # not the identity order
    c = dict(q=rng.standard_normal((b, h, hd)).astype(np.float32),
             k_cur=rng.standard_normal((b, hkv, hd)).astype(np.float32),
             v_cur=rng.standard_normal((b, hkv, hd)).astype(np.float32),
             a_k_pages=pages(), a_v_pages=pages(), b_k_pages=None,
             b_v_pages=None, a_lengths=np.asarray(a_lens, np.int32),
             b_lengths=None, a_page_indices=idx, b_page_indices=None)
    if b_lens is not None:
        c.update(b_k_pages=pages(), b_v_pages=pages(),
                 b_lengths=np.asarray(b_lens, np.int32), b_page_indices=idx)
    return c


def _torch(x):
    if x is None:
        return None
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _kernel1_schedule(c, cap, include_current, clamp_a=True):
    """Kernel 1 (kernel 7 without ``clamp_a``) as its CTAs compute it: each
    split's tokens through paged_flash_parts_plain (the chunk as a page of
    its own), then the merge of the partials (with merge_attention_parts
    when the in-flight token joins)."""
    t = {k: _torch(v) for k, v in c.items()}
    a_lens = t["a_lengths"].clamp_min(1 if clamp_a else 0)
    segs = [(t["a_k_pages"], t["a_v_pages"], a_lens, t["a_page_indices"])]
    if t["b_k_pages"] is not None:
        segs.append((t["b_k_pages"], t["b_v_pages"], t["b_lengths"],
                     t["b_page_indices"]))
    chunk, splits = tfa.batch_attention_plan(
        t["a_k_pages"], t["a_page_indices"], t["b_page_indices"])
    per_page = PS // chunk
    parts, empty = [], 0
    for s in range(splits):
        tok = s * chunk
        si = 0
        while tok >= segs[si][3].shape[1] * PS:
            tok -= segs[si][3].shape[1] * PS
            si += 1
        k, v, lens, idx = segs[si]
        hkv, n_pages, _, hd = k.shape
        sub = idx[:, tok // PS].long() * per_page + (tok % PS) // chunk
        lens = lens.clamp_max(idx.shape[1] * PS)
        n = (lens - tok).clamp(0, chunk).to(torch.int32)
        empty += int((n == 0).sum())
        parts.append(tpa.paged_flash_parts_plain(
            t["q"], k.reshape(hkv, n_pages * per_page, chunk, hd),
            v.reshape(hkv, n_pages * per_page, chunk, hd), n,
            sub[:, None].to(torch.int32), attn_logits_soft_cap=cap))
    if include_current:
        out = tpa.merge_attention_parts(parts, t["q"], t["k_cur"],
                                        t["v_cur"], cap, torch.float32)
    else:
        m = torch.stack([p[1] for p in parts]).amax(dim=0)
        w = [torch.where(torch.isfinite(p[1]), p[2] * torch.exp(p[1] - m),
                         0.0) for p in parts]
        out = (sum(p[0] * wi[..., None] for p, wi in zip(parts, w))
               / sum(w)[..., None])
    return out, (chunk, splits), empty


@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("form", ["self", "cross"])
def test_kernel1_schedule_matches_jax(form, cap):
    """Lengths 0 (clamped to 1 in segment A), 1, 127, 128 and 129 over two
    segments of two pages each: a chunk of 32 tokens, 16 splits a row,
    most of them empty."""
    lens = [0, 1, 127, 128, 129]
    self_form = form == "self"
    c = _jax_case(20 + self_form, 5, 4, 2, 16, lens,
                  lens[::-1] if self_form else None, 2)
    want = np.asarray(jfa.batch_paged_attention(
        *(None if v is None else jnp.asarray(v) for v in c.values()),
        attn_logits_soft_cap=cap, include_current=self_form,
        interpret=True))
    got, plan, empty = _kernel1_schedule(c, cap, self_form)
    assert plan == ((32, 16) if self_form else (16, 16))
    assert empty > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
def test_kernel7_schedule_matches_jax(cap):
    """Prompt lengths 0 (no clamp: the row reads no prompt page), 0, 1,
    128 and 129, generation lengths 129, 0, 127, 1 and 0 over two pages
    each: a chunk of 32 tokens, 16 splits a row, most of them empty, and a
    row whose only key is the in-flight token."""
    c = _jax_case(23, 5, 4, 2, 16, [0, 0, 1, 128, 129], [129, 0, 127, 1, 0],
                  2)
    want = np.asarray(jfa.fused_decode_attention(
        *(jnp.asarray(v) for v in c.values()), attn_logits_soft_cap=cap,
        interpret=True))
    got, plan, empty = _kernel1_schedule(c, cap, True, clamp_a=False)
    assert plan == (32, 16)
    assert empty > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the clamp would read token 0 of rows 0 and 1's first prompt page
    clamped, _, _ = _kernel1_schedule(c, cap, True)
    assert not np.allclose(clamped[:2].numpy(), want[:2], rtol=1e-3,
                           atol=1e-3)


# ---------------------------------------------------------------------------
# kernel 5: its schedule from the plain pieces, against JAX
# ---------------------------------------------------------------------------

def _kernel5_schedule(c, cap, chain):
    """Kernel 5 as its CTAs compute it: each split's tokens through
    paged_flash_parts_plain at ``chain`` (the chunk as a page of its own,
    the chain's queries sharing their cache row's chunk), the unnormalized
    partials (out * l, m, l), then each pseudo-row's live splits (those
    holding its row's tokens) merged in split order. Returns ((out, m, l),
    the plan, the number of neutral partials)."""
    t = {k: _torch(v) for k, v in c.items()}
    k, v, idx = t["k_pages"], t["v_pages"], t["page_indices"]
    hkv, n_pages, _, hd = k.shape
    chunk, splits = tpa.parts_plan(k, idx)
    per_page = PS // chunk
    lens = t["lengths"].clamp(0, idx.shape[1] * PS)
    parts, neutral = [], 0
    for s in range(splits):
        tok = s * chunk
        sub = idx[:, tok // PS].long() * per_page + (tok % PS) // chunk
        n = (lens - tok).clamp(0, chunk).to(torch.int32)
        out, m, l = tpa.paged_flash_parts_plain(
            t["q"], k.reshape(hkv, n_pages * per_page, chunk, hd),
            v.reshape(hkv, n_pages * per_page, chunk, hd), n,
            sub[:, None].to(torch.int32), attn_logits_soft_cap=cap,
            chain=chain)
        empty = (n == 0).repeat_interleave(chain)
        neutral += int(empty.sum())
        assert bool((out[empty] == 0).all() and (m[empty] == -torch.inf).all()
                    and (l[empty] == 0).all())
        parts.append((out * l[..., None], m, l))
    live = ((lens + chunk - 1) // chunk).repeat_interleave(chain)[:, None]
    m = torch.full_like(parts[0][1], -torch.inf)
    for s, (_, ms, _) in enumerate(parts):
        m = torch.where(s < live, torch.maximum(m, ms), m)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for s, (a, ms, ls) in enumerate(parts):
        w = torch.where(s < live, torch.exp(ms - m), 0.0)
        l = l + ls * w
        acc = acc + a * w[..., None]
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return (out, m, l), (chunk, splits), neutral


@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
def test_kernel5_schedule_matches_jax(cap):
    """Chain 3 over 5 cache rows of two pages in a permuted page table
    (H 4, Hkv 2, hd 16), lengths 0, 1, 127 (ends inside a chunk), 128 and
    256 (the capacity): a chunk of 16 tokens, 16 splits a row, most of the
    short rows' partials neutral."""
    chain, b, h, hkv, hd, pp = 3, 5, 4, 2, 16, 2
    rng = np.random.default_rng(25)

    def pages():
        x = rng.standard_normal((hkv, 2 * b * pp, PS, hd)).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))

    c = dict(q=(rng.standard_normal((b * chain, h, hd))
                * hd ** -0.5).astype(np.float32),
             k_pages=pages(), v_pages=pages(),
             lengths=np.asarray([0, 1, 127, 128, 256], np.int32),
             page_indices=rng.permutation(2 * b * pp)[:b * pp].reshape(
                 b, pp).astype(np.int32))
    want = jpa.paged_flash_parts(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]),
        jnp.asarray(c["v_pages"]), jnp.asarray(np.repeat(c["lengths"], chain)),
        jnp.asarray(np.repeat(c["page_indices"], chain, axis=0)),
        attn_logits_soft_cap=cap)
    got, plan, neutral = _kernel5_schedule(c, cap, chain)
    assert plan == (16, 16)
    assert neutral > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    empty = got[1][:chain] == -torch.inf          # cache row 0, length 0
    assert bool(empty.all()) and bool((got[2][:chain] == 0).all())
    assert bool((got[0][:chain] == 0).all())


# ---------------------------------------------------------------------------
# kernel 2: its attention under the schedule, against slab_attention_plain
# ---------------------------------------------------------------------------

def _split_slab_attention(q, segments, soft_cap, li, k_cur, v_cur, chain,
                          chunk):
    """slab_attention_plain as the kernel's two passes compute it: per
    cache row and chunk of the slabs' capacity, the chunk's logits (bf16 q)
    and largest valid logit; then p = exp(logit - M), M the largest chunk
    maximum up to the end of the chunk's page (in segment order), p (int8
    pages: p * v_scale) rounded to bf16 for P.V, a chunk in a slab's last
    page also taking the blocks past the slab that a longer length
    re-reads; the partials merged in split order; then the in-flight chain
    as the plain version folds it. Returns (out [B, H*hd], the same
    attention of |v|)."""
    b, h, hd = q.shape
    hkv = segments[0][0][0].shape[0]
    g = h // hkv
    bc = b // chain
    qb = q.reshape(b, hkv, g, hd).to(torch.bfloat16).float()
    capped = (lambda x: x) if soft_cap is None else (
        lambda x: torch.tanh(x / soft_cap) * soft_cap)
    rows = li * bc + torch.arange(bc)
    chunks = []                       # (logits, k/v/scales, lens, page info)
    for (k_slab, v_slab), scale, lens in segments:
        t_cap = k_slab.shape[2]
        for off in range(0, t_cap, chunk):
            tok = slice(off, off + chunk)

            def take(x):
                return x[:, rows, tok].repeat_interleave(chain, 1).transpose(
                    0, 1)

            k, v = take(k_slab).float(), take(v_slab).float()
            raw = torch.einsum("bkgh,bkth->bkgt", qb, k)
            vs = None
            if scale is not None:
                raw = raw * take(scale[0])[:, :, None]
                vs = take(scale[1])
            logits = capped(raw)
            valid = ((off + torch.arange(chunk))[None] < lens[:, None])[
                :, None, None]
            cmax = torch.where(valid, logits, MASK).amax(-1)
            chunks.append((logits, v, vs, lens, off, t_cap, cmax))
    per_page = PS // chunk
    m_all, l_all, acc_all, abs_all = [], [], [], []
    for i, (logits, v, vs, lens, off, t_cap, _) in enumerate(chunks):
        end = (i // per_page + 1) * per_page
        m = torch.stack([c[6] for c in chunks[:end]]).amax(0)
        page, last = off // PS, t_cap // PS - 1
        reps = max(1, -(-int(lens.max()) // PS) - last) if page == last else 1
        l = torch.zeros((b, hkv, g))
        acc = torch.zeros((b, hkv, g, hd))
        aab = torch.zeros((b, hkv, g, hd))
        for r in range(reps):
            pos = (page + r) * PS + off % PS + torch.arange(chunk)
            valid = (pos[None] < lens[:, None])[:, None, None]
            e = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
            l = l + e.sum(-1)
            pv = e * vs[:, :, None] if vs is not None else e
            acc = acc + torch.einsum("bkgt,bkth->bkgh",
                                     pv.to(torch.bfloat16).float(), v)
            vabs = v.abs() * (vs[..., None] if vs is not None else 1.0)
            aab = aab + torch.einsum("bkgt,bkth->bkgh", e, vabs)
        m_all.append(m)
        l_all.append(l)
        acc_all.append(acc)
        abs_all.append(aab)
    m = torch.stack(m_all).amax(0)
    w = [torch.exp(mi - m) for mi in m_all]
    l = sum(wi * li_ for wi, li_ in zip(w, l_all))
    acc = sum(wi[..., None] * a for wi, a in zip(w, acc_all))
    aab = sum(wi[..., None] * a for wi, a in zip(w, abs_all))
    if k_cur is not None:
        qf = q.reshape(b, hkv, g, hd)
        base = torch.arange(b) - torch.arange(b) % chain
        pos_in = torch.arange(b) % chain
        int8_pages = segments[0][1] is not None
        for j in range(chain):
            use = (j <= pos_in)[:, None, None]
            own = (j == pos_in)[:, None, None]
            ck, cv = k_cur[base + j], v_cur[base + j]
            if chain > 1:
                ck = torch.where(own, ck, tmk._store_round(ck, int8_pages))
                cv = torch.where(own, cv, tmk._store_round(cv, int8_pages))
            qj = torch.where(own[..., None], qf, qb)
            cur = capped((qj * ck[:, :, None]).sum(-1))
            m_new = torch.maximum(m, cur)
            pc = torch.exp(cur - m_new)
            alpha = torch.exp(m - m_new)
            l = torch.where(use, l * alpha + pc, l)
            acc = torch.where(use[..., None], acc * alpha[..., None]
                              + pc[..., None] * cv[:, :, None], acc)
            aab = torch.where(use[..., None], aab * alpha[..., None]
                              + pc[..., None] * cv[:, :, None].abs(), aab)
            m = torch.where(use, m_new, m)
    den = torch.where(l > 0, l, 1.0)[..., None]
    return (acc / den).reshape(b, h * hd), (aab / den).reshape(b, h * hd)


def _slab_case(seed, bc, chain, quant, tp, tg, plens, glens):
    """Two-layer slabs of one head group (H 4, Hkv 2, hd 16), layer 1."""
    rng = np.random.default_rng(seed)
    b, hkv, hd = bc * chain, 2, 16

    def slab(t):
        x = torch.from_numpy(rng.standard_normal(
            (hkv, 2 * bc, t, hd)).astype(np.float32))
        return tfa.quantize_kv(x) if quant else (x.to(torch.bfloat16), None)

    (pk, pks), (pv, pvs), (gk, gks), (gv, gvs) = (slab(t) for t in (tp, tp,
                                                                    tg, tg))
    segs = [((pk, pv), (pks, pvs) if quant else None,
             torch.tensor(np.repeat(plens, chain), dtype=torch.int32)),
            ((gk, gv), (gks, gvs) if quant else None,
             torch.tensor(np.repeat(glens, chain), dtype=torch.int32))]
    q = torch.from_numpy(rng.standard_normal((b, 4, hd)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (b, hkv, hd)).astype(np.float32)) for _ in range(2))
    return q, segs, kc, vc


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("case", ["lengths", "past-slab", "chain3"])
def test_kernel2_split_schedule_matches_plain(case, quant):
    """Each split's p is rounded relative to its block's running max as the
    plain version sees it, so both round p to the same bf16 values and
    only f32 sums in another order differ: within 1e-5 of the output's
    scale (the attention of |v|). Both the plan's chunk and the 128-token
    chunk (a split a page) are held; lengths 0, 1, 127, 129, lengths past
    the 256-token generation slab, and chain 3."""
    chain = 3 if case == "chain3" else 1
    glens = {"lengths": [0, 1, 127, 129], "past-slab": [40, 300, 256, 255],
             "chain3": [129, 5]}[case]
    plens = [37, 0, 128, 1][:len(glens)]
    q, segs, kc, vc = _slab_case(30 + len(case) + quant, len(glens), chain,
                                 quant, 128, 256, plens, glens)
    want = tmk.slab_attention_plain(q, segs, 50.0, 1, kc, vc, chain)
    dims = dataclasses.replace(tconfig.backbone_preset("test").decoder,
                               num_layers=2, layer_types=())
    plan = tmk.attention_plan(dims, segs[0][0][0], segs[1][0][0],
                              segs[0][0][0])["self"]
    assert plan[0] < PS
    for chunk in (plan[0], PS):
        got, att_abs = _split_slab_attention(q, segs, 50.0, 1, kc, vc, chain,
                                             chunk)
        err = (got - want).abs()
        assert bool((err <= 1e-5 * (want.abs() + att_abs) + 1e-7).all()), \
            float((err / (want.abs() + att_abs)).max())

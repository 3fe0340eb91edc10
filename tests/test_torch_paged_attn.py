"""The port's one-segment paged attention, its flash merges and float8
pages, against the JAX package.

- ``paged_flash_parts`` (on the CPU its plain version, the kernel's
  counterpart) against JAX ``paged_flash_parts``, whose only CPU path is its
  dense branch: ``out``, ``m`` and ``l`` for bf16 and float8 e4m3 pages,
  GQA, soft cap on and off, an empty row, and page tables repeated over the
  S pseudo-rows of a verify pass. Relative tolerance 1e-5 (f32 sums in
  another order); ``m = -inf`` and ``l = 0`` exactly for empty rows.
- ``paged_gqa_attention`` (its plain version, ``paged_attention_reference``)
  against JAX ``paged_gqa_attention``, 1e-5.
- ``merge_attention_parts`` and ``merge_attention_parts_chain`` (store
  dtype none, bf16 and float8) against JAX, 1e-5.
- ``batch_paged_attention`` with float8 pages (the plain version of kernel
  1's e4m3 variant) against JAX ``batch_paged_attention(interpret=True)``,
  1e-4 as tests/test_fused_attn.py holds float8 pages.

The CUDA kernels are held to these plain versions on a card by
tests/test_torch_spec_cuda.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.ops import fused_attn as jfa
from t5gemma_tts_tpu.ops import paged_attn as jpa
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import paged_attn as tpa

torch.set_num_threads(1)
PS = 128
REL = 1e-5
DTYPES = {"bf16": jnp.bfloat16, "f8": jnp.float8_e4m3fn}


def _t(x):
    return None if x is None else bridge.params_from_jax(np.asarray(x), "cpu")


def _pages(rng, hkv, n, hd, dtype):
    x = rng.standard_normal((hkv, n, PS, hd)).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(DTYPES[dtype]))


def _close(got, want, rel=REL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-30
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


def _parts_case(seed, dtype, *, b=3, s_len=1, h=4, hkv=2, hd=16, pp=3,
                lens=(0, 130, 300)):
    """numpy inputs of one paged_flash_parts call: b cache rows, each
    repeated over s_len pseudo-rows (the verify pass's page tables)."""
    rng = np.random.default_rng(seed)
    k = _pages(rng, hkv, 2 * b * pp, hd, dtype)
    v = _pages(rng, hkv, 2 * b * pp, hd, dtype)
    # layer 1 of a two-layer slab: the tables point past layer 0's pages
    idx = np.asarray(jpa.identity_page_indices(b, pp)) + b * pp
    return dict(q=rng.standard_normal((b * s_len, h, hd)).astype(np.float32),
                k_pages=k, v_pages=v,
                lengths=np.repeat(np.asarray(lens, np.int32), s_len),
                page_indices=np.repeat(idx, s_len, axis=0).astype(np.int32))


@pytest.mark.parametrize("dtype", ["bf16", "f8"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("shape", [
    dict(s_len=1, h=4, hkv=2, hd=16),             # GQA, hd 16
    dict(s_len=5, h=8, hkv=2, hd=32, lens=(0, 1, 384)),   # chain of 5
    dict(s_len=1, h=8, hkv=4, hd=256, b=2, pp=2, lens=(255, 0)),
], ids=["g2-hd16", "chain5", "hd256"])
def test_paged_flash_parts_matches_jax(dtype, cap, shape):
    c = _parts_case(3, dtype, **shape)
    want = jpa.paged_flash_parts(*(jnp.asarray(v) for v in c.values()),
                                 attn_logits_soft_cap=cap)
    before = tpa.paged_flash_parts.launches
    got = tpa.paged_flash_parts(*(_t(v) for v in c.values()),
                                attn_logits_soft_cap=cap)
    assert tpa.paged_flash_parts.launches == before   # plain on the CPU
    for g, w, name in zip(got, want, ("out", "m", "l")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        live = np.isfinite(w)
        _close(g[torch.from_numpy(live)], w[live])
    empty = c["lengths"] == 0
    assert empty.any()
    assert bool((got[1][torch.from_numpy(empty)] == -torch.inf).all())
    assert bool((got[2][torch.from_numpy(empty)] == 0).all())
    assert bool((got[0][torch.from_numpy(empty)] == 0).all())


@pytest.mark.parametrize("dtype", ["bf16", "f8"])
def test_paged_gqa_attention_matches_jax(dtype):
    c = _parts_case(4, dtype, s_len=2, h=8, hkv=4, hd=32, lens=(7, 129, 256))
    args = [c["q"], c["k_pages"], c["v_pages"], c["lengths"]]
    want = jpa.paged_gqa_attention(*map(jnp.asarray, args),
                                   page_indices=jnp.asarray(c["page_indices"]),
                                   attn_logits_soft_cap=50.0)
    got = tpa.paged_gqa_attention(*map(_t, args),
                                  page_indices=_t(c["page_indices"]),
                                  attn_logits_soft_cap=50.0)
    assert got.dtype == torch.float32
    _close(got, want)


def _merge_inputs(seed, b=2, s_len=4, h=8, hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    parts = []
    for empty_row in (0, 1):
        out = rng.standard_normal((b * s_len, h, hd)).astype(np.float32)
        m = rng.standard_normal((b * s_len, h)).astype(np.float32) * 3
        l = rng.uniform(0.5, 20, (b * s_len, h)).astype(np.float32)
        m[empty_row * s_len:(empty_row + 1) * s_len] = -np.inf
        l[empty_row * s_len:(empty_row + 1) * s_len] = 0
        out[empty_row * s_len:(empty_row + 1) * s_len] = 0
        parts.append((out, m, l))
    q = rng.standard_normal((b, s_len, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s_len, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s_len, hkv, hd)).astype(np.float32)
    return parts, q, k, v


@pytest.mark.parametrize("store", [None, "bf16", "f8"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
def test_merge_attention_parts_chain_matches_jax(store, cap):
    parts, q, k, v = _merge_inputs(5)
    want = jpa.merge_attention_parts_chain(
        [tuple(map(jnp.asarray, p)) for p in parts], jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), cap, jnp.float32,
        store_dtype=DTYPES.get(store))
    got = tpa.merge_attention_parts_chain(
        [tuple(map(_t, p)) for p in parts], _t(q), _t(k), _t(v), cap,
        torch.float32,
        store_dtype=tpa.KV_STORE_DTYPES.get(store))
    _close(got, want)


def test_merge_attention_parts_matches_jax():
    parts, q, k, v = _merge_inputs(6, s_len=1)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    want = jpa.merge_attention_parts(
        [tuple(map(jnp.asarray, p)) for p in parts], jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), 50.0, jnp.float32)
    got = tpa.merge_attention_parts([tuple(map(_t, p)) for p in parts],
                                    _t(q), _t(k), _t(v), 50.0, torch.float32)
    _close(got, want)


def test_one_segment_parts_and_merge_equal_the_two_segment_kernel():
    """Kernel 5 twice + the merge computes what kernel 1 computes (the
    sequential step and the verify pass take the two forms)."""
    rng = np.random.default_rng(7)
    b, h, hkv, hd = 3, 4, 2, 16
    ak, av = (_pages(rng, hkv, b, hd, "f8") for _ in range(2))
    bk, bv = (_pages(rng, hkv, 2 * b, hd, "f8") for _ in range(2))
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, h, hd), (b, hkv, hd), (b, hkv, hd)))
    a_len = torch.tensor([1, 50, 128], dtype=torch.int32)
    b_len = torch.tensor([0, 129, 7], dtype=torch.int32)
    a_idx = tpa.identity_page_indices(b, 1)
    b_idx = tpa.identity_page_indices(b, 2)
    ak, av, bk, bv = map(_t, (ak, av, bk, bv))
    want = tfa.batch_paged_attention(
        q, kc, vc, ak, av, bk, bv, a_len, b_len, a_idx, b_idx,
        attn_logits_soft_cap=50.0, include_current=True)
    parts = [tpa.paged_flash_parts(q, ak, av, a_len, a_idx,
                                   attn_logits_soft_cap=50.0),
             tpa.paged_flash_parts(q, bk, bv, b_len, b_idx,
                                   attn_logits_soft_cap=50.0)]
    got = tpa.merge_attention_parts(parts, q, kc, vc, 50.0, torch.float32)
    _close(got, want.numpy())


@pytest.mark.parametrize("gen", [[0, 99], [128, 256]], ids=["short", "full"])
@pytest.mark.parametrize("include_current", [True, False],
                         ids=["self", "cross"])
def test_batch_paged_attention_f8_pages_matches_jax(gen, include_current):
    """Kernel 1's e4m3 variant: its plain version against the JAX Pallas
    kernel in interpret mode (which widens the pages with ``astype``)."""
    rng = np.random.default_rng(8)
    b, h, hkv, hd = 2, 4, 2, 256
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, hkv, hd)).astype(np.float32)
              for _ in range(2))
    pk, pv = (_pages(rng, hkv, b, hd, "f8") for _ in range(2))
    gk, gv = (_pages(rng, hkv, 2 * b, hd, "f8") for _ in range(2))
    args = [q, kc, vc, pk, pv, gk, gv, np.asarray([30, PS], np.int32),
            np.asarray(gen, np.int32),
            np.asarray(jpa.identity_page_indices(b, 1)),
            np.asarray(jpa.identity_page_indices(b, 2))]
    if not include_current:
        args[1:3] = [None, None]
        args[5:7] = [None, None]
        args[8] = args[10] = None
    want = jfa.batch_paged_attention(
        *(None if a is None else jnp.asarray(a) for a in args),
        attn_logits_soft_cap=50.0, include_current=include_current,
        interpret=True)
    got = tfa.batch_paged_attention(*map(_t, args), attn_logits_soft_cap=50.0,
                                    include_current=include_current)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_wrappers_refuse_other_devices_and_page_types():
    q = torch.zeros((1, 2, 16), device="meta")
    pages = torch.zeros((1, 1, PS, 16), device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_flash_parts(q, pages, pages, lens, idx)
    assert tpa.KV_STORE_DTYPES["f8"] == torch.float8_e4m3fn

"""The speculative slice's kernels on a card against their plain versions:
the one-segment paged kernel (bf16 and float8 pages, chain 1 and 5), the
two-segment kernel's float8 pages, the float8 widening of both bit for bit,
and the decode layer's chain variant. This module
imports no JAX (a machine with a card need not have it); run it there with

    python -m pytest -o addopts= --noconftest tests/test_torch_spec_cuda.py

Without a card every test skips.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import paged_attn as tpa

PS = 128
TOL = 1e-4       # f32 sums in another order (abs + rel, as chip_smoke.py)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    live = torch.isfinite(want)
    err = (got[live] - want[live]).abs()
    assert bool((err <= TOL + TOL * want[live].abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "f8"])
@pytest.mark.parametrize("chain", [1, 5], ids=["chain1", "chain5"])
@pytest.mark.parametrize("b,h,hkv,hd,lens", [
    (6, 8, 4, 256, [0, 1, 130, 255, 300, 384]),
    (3, 4, 2, 16, [0, 100, 384])], ids=["hd256", "hd16"])
def test_cuda_paged_flash_parts_matches_plain(dtype, chain, b, h, hkv, hd,
                                              lens):
    """Three pages a cache row drawn from a two-layer slab in a random
    order; the plan's chunk is 64 (hd 256: 130 and 300 end inside a chunk)
    or 16 (hd 16, G 2: 100 does); 384 is the capacity; soft cap 50 and
    none. One wrapper call is one launch."""
    dev = _card()
    rng = np.random.default_rng(hd + chain)
    pp = 3

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    q = t(b * chain, h, hd)
    k, v = (t(hkv, 2 * b * pp, PS, hd).to(dtype) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    idx = torch.from_numpy(rng.permutation(2 * b * pp)[:b * pp].reshape(
        b, pp).astype(np.int32)).to(dev)
    assert tpa.parts_plan(k, idx)[0] == (64 if hd == 256 else 16)
    empty = (lengths == 0).repeat_interleave(chain)
    for cap in (None, 50.0):
        before = tpa.paged_flash_parts.launches
        got = tpa.paged_flash_parts(q, k, v, lengths, idx,
                                    attn_logits_soft_cap=cap, chain=chain)
        assert tpa.paged_flash_parts.launches == before + 1
        want = tpa.paged_flash_parts_plain(q, k, v, lengths, idx,
                                           attn_logits_soft_cap=cap,
                                           chain=chain)
        for g, w in zip(got, want):
            _close(g, w)
        assert bool((got[0][empty] == 0).all())
        assert bool((got[1][empty] == -torch.inf).all())
        assert bool((got[2][empty] == 0).all())


@pytest.mark.cuda
def test_cuda_e4m3_pages_widen_every_byte_exactly():
    """float8 pages widen two bytes an instruction (``load8<kE4m3>``): with
    zero keys and one valid token p = 1 and l = 1, so kernels 5 and 1 (its
    cross form) return that token's value row as widened. A row holding all
    256 byte values comes back as PyTorch widens them, bit for bit, NaN
    bytes as NaN; kernel 1 also against its plain version at its
    tolerance."""
    dev = _card()
    byte = torch.arange(256, dtype=torch.uint8, device=dev)
    want = byte.view(torch.float8_e4m3fn).float()
    nan = torch.isnan(want)
    assert int(nan.sum()) == 2                       # 0x7f and 0xff
    v = torch.zeros((1, 1, PS, 256), dtype=torch.uint8, device=dev)
    v[0, 0, 0] = byte
    v = v.view(torch.float8_e4m3fn)
    k = torch.zeros_like(v)
    q = torch.randn((1, 2, 256), device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    idx = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    got5 = tpa.paged_flash_parts(q, k, v, one, idx)[0][0]
    got1 = tfa.batch_paged_attention(q, None, None, k, v, None, None, one,
                                     None, idx, None,
                                     attn_logits_soft_cap=50.0)
    plain1 = tfa.batch_paged_attention_plain(q, None, None, k, v, None, None,
                                             one, None, idx, None,
                                             attn_logits_soft_cap=50.0)
    _close(got1, plain1)
    for row in (*got5, *got1[0]):
        assert torch.equal(torch.isnan(row), nan)
        assert torch.equal(row[~nan], want[~nan])


@pytest.mark.cuda
def test_cuda_batch_paged_attention_f8_pages_matches_plain():
    dev = _card()
    rng = np.random.default_rng(1)
    b, h, hkv, hd = 4, 8, 4, 256

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    pages = [t(hkv, b * 2, PS, hd).to(torch.float8_e4m3fn) for _ in range(4)]
    idx = tpa.identity_page_indices(b, 2, dev)
    args = (t(b, h, hd), t(b, hkv, hd), t(b, hkv, hd), *pages,
            torch.tensor([1, 128, 165, 256], dtype=torch.int32, device=dev),
            torch.tensor([0, 5, 129, 200], dtype=torch.int32, device=dev),
            idx, idx)
    got = tfa.batch_paged_attention(*args, attn_logits_soft_cap=50.0,
                                    include_current=True)
    want = tfa.batch_paged_attention_plain(*args, attn_logits_soft_cap=50.0,
                                           include_current=True)
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True], ids=["w8", "w4"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
def test_cuda_chain_decode_layer_matches_plain(int4, quant):
    """The decode layer at chain 5 over 2 cache rows (layer 1 of two)
    against its plain version, within the chip smoke's layer bounds (a
    rounding flip moves one pseudo-row's h); one call is one launch."""
    dev = _card()
    smoke = _smoke()
    dims = dataclasses.replace(tconfig.backbone_preset("test").decoder,
                               num_layers=2, layer_types=())
    layers = smoke.random_quant_layers(dims, 2, dev, seed=3, int4=int4)
    args = smoke.chain_layer_inputs(dims, 2, 5, quant, dev, seed=4)
    before = tmk.decode_layer.launches
    got = tmk.decode_layer(layers, dims, li=1, chain=5, **args)
    assert tmk.decode_layer.launches == before + 1
    want = tmk.decode_layer_plain(layers, dims, li=1, chain=5, **args)
    assert got[1].shape == (10, dims.num_kv_heads, dims.head_dim)
    errs = [smoke.rel_fro(g, w) for g, w in zip(got, want)]
    assert errs[0] <= smoke.REL_FRO_TOL_H, errs
    assert max(errs[1:]) <= smoke.REL_FRO_TOL_KV, errs

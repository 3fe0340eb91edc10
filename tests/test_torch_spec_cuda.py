"""The speculative slice's kernels on a card against their plain versions:
the one-segment paged kernel (bf16 and float8 pages), the two-segment
kernel's float8 pages and the decode layer's chain variant. This module
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
@pytest.mark.parametrize("b,h,hkv,hd,lens", [
    (10, 8, 4, 256, [0] * 5 + [1, 130, 255, 300, 384]),
    (3, 4, 2, 16, [0, 100, 200])], ids=["chain5-hd256", "hd16"])
def test_cuda_paged_flash_parts_matches_plain(dtype, b, h, hkv, hd, lens):
    dev = _card()
    rng = np.random.default_rng(hd)
    pp = 3

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    q = t(b, h, hd)
    k, v = (t(hkv, 2 * b * pp, PS, hd).to(dtype) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    idx = tpa.identity_page_indices(b, pp, dev) + b * pp
    for cap in (None, 50.0):
        before = tpa.paged_flash_parts.launches
        got = tpa.paged_flash_parts(q, k, v, lengths, idx,
                                    attn_logits_soft_cap=cap)
        assert tpa.paged_flash_parts.launches == before + 1
        want = tpa.paged_flash_parts_plain(q, k, v, lengths, idx,
                                           attn_logits_soft_cap=cap)
        for g, w in zip(got, want):
            _close(g, w)
        empty = lengths == 0
        assert bool((got[1][empty] == -torch.inf).all())
        assert bool((got[2][empty] == 0).all())


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

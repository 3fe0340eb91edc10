"""The split-KV attention kernels on a card against their plain versions at
the edges of their split plans: the two-segment paged kernel (bf16, int8
and float8 e4m3 pages), the v1 fused self-attention (bf16 and e4m3 pages,
empty prompt segments) and the decode layer (int8 and int4 weights, bf16
and int8 pages, chain 1 and 5).
This module imports no JAX (a machine with a card need not have it); run
it there with

    python -m pytest -o addopts= --noconftest tests/test_torch_split_cuda.py

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


# (name, attention_case arguments, the plan's (chunk, splits)) at the
# 2b-2b heads: lengths that leave splits empty and end on chunk and page
# edges; 36 rows over one page (one split a row); one row over one encoder
# page (chunk 2, the most splits a main path plans) and over a prompt page
# and four generation pages
KERNEL1_EDGES = [
    ("edges", dict(b=4, a_lens=[0, 1, 127, 128], b_lens=[129, 0, 255, 256],
                   pp_a=2, pp_b=2, include_current=True), (32, 16)),
    ("one-split", dict(b=36, a_lens=[1 + 4 * i for i in range(32)]
                       + [128] * 4, b_lens=None, pp_a=1, pp_b=0,
                       include_current=False), (128, 1)),
    ("widest-cross", dict(b=1, a_lens=[45], b_lens=None, pp_a=1, pp_b=0,
                          include_current=False), (2, 64)),
    ("widest-self", dict(b=1, a_lens=[1], b_lens=[225], pp_a=1, pp_b=4,
                         include_current=True), (16, 40)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("page", ["bf16", "i8", "f8"])
@pytest.mark.parametrize("case", KERNEL1_EDGES, ids=[c[0] for c in
                                                     KERNEL1_EDGES])
def test_cuda_batch_paged_attention_split_edges(case, page):
    dev = _card()
    smoke = _smoke()
    name, spec, plan = case
    args = smoke.attention_case(
        np.random.default_rng(len(name)), h=8, hkv=4, hd=256,
        quant=page == "i8", f8=page == "f8", layers=1, li=0, device=dev,
        **spec)
    assert smoke.attention_plan(args)[:2] == plan
    cur = spec["include_current"]
    before = tfa.batch_paged_attention.launches
    got = tfa.batch_paged_attention(**args, attn_logits_soft_cap=50.0,
                                    include_current=cur)
    assert tfa.batch_paged_attention.launches == before + 1
    want = tfa.batch_paged_attention_plain(**args, attn_logits_soft_cap=50.0,
                                           include_current=cur)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# (name, attention_case arguments, the plan's (chunk, splits)) for kernel 7
# (prompt = segment A, generation = segment B, the in-flight token always)
# at the 2b-2b heads: lengths that leave splits empty, with prompts of
# length 0 (no clamp: no prompt page is read) and a row whose only key is
# the in-flight token; 36 rows over a prompt and a generation page (one
# split a page); one row over two pages (chunk 4, 64 splits); every prompt
# empty
KERNEL7_EDGES = [
    ("edges", dict(b=4, a_lens=[0, 1, 127, 128], b_lens=[129, 0, 255, 256],
                   pp_a=2, pp_b=2), (32, 16)),
    ("one-split", dict(b=36, a_lens=[(5 * i) % 129 for i in range(36)],
                       b_lens=[(11 * i) % 129 for i in range(36)], pp_a=1,
                       pp_b=1), (128, 2)),
    ("widest", dict(b=1, a_lens=[0], b_lens=[45], pp_a=1, pp_b=1), (4, 64)),
    ("empty-prompt", dict(b=4, a_lens=[0, 0, 0, 0], b_lens=[0, 1, 128, 200],
                          pp_a=1, pp_b=2), (32, 12)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("page", ["bf16", "f8"])
@pytest.mark.parametrize("case", KERNEL7_EDGES, ids=[c[0] for c in
                                                     KERNEL7_EDGES])
def test_cuda_fused_decode_attention_split_edges(case, page):
    """Within 1e-4 abs + 1e-4 rel of the plain version, soft cap 50 and
    none; one launch a call."""
    dev = _card()
    smoke = _smoke()
    name, spec, plan = case
    base = smoke.attention_case(
        np.random.default_rng(7 + len(name)), h=8, hkv=4, hd=256,
        quant=False, f8=page == "f8", layers=1, li=0, include_current=True,
        device=dev, **spec)
    assert smoke.attention_plan(base)[:2] == plan
    args = smoke.fused_args(base)
    for cap in (50.0, None):
        before = tfa.fused_decode_attention.launches
        got = tfa.fused_decode_attention(**args, attn_logits_soft_cap=cap)
        assert tfa.fused_decode_attention.launches == before + 1
        want = tfa.fused_decode_attention_plain(**args,
                                                attn_logits_soft_cap=cap)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _dims(layers=2):
    return dataclasses.replace(tconfig.backbone_preset("test").decoder,
                               num_layers=layers, layer_types=())


# (name, rows, generated lengths, encoder lengths, generation slab) at the
# test preset's widths (Hkv = 2): lengths 0, 127, 128 and one past the
# slab (which re-reads its last page); 68 rows (one cross split a row); one
# row (the most splits)
KERNEL2_EDGES = [
    ("edges", 4, [0, 127, 128, 300], [1, 16, 128, 129], 256),
    ("one-split", 68, [(7 * i) % 129 for i in range(68)],
     [1 + (11 * i) % 128 for i in range(68)], 128),
    ("widest", 1, [225], [45], 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True], ids=["w8", "w4"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("case", KERNEL2_EDGES, ids=[c[0] for c in
                                                     KERNEL2_EDGES])
def test_cuda_decode_layer_split_edges(case, quant, int4):
    """Layer 1 of two against its plain version, within the chip smoke's
    layer bounds. p rounds to bf16 relative to the running max of its
    128-token block as the plain version sees it: a first pass writes each
    chunk's maximum, and the second takes the prefix max of those."""
    dev = _card()
    smoke = _smoke()
    name, b, gen_lens, enc_lens, gen_slab = case
    dims = _dims()
    layers = smoke.random_quant_layers(dims, 2, dev, seed=3, int4=int4)
    args = smoke.decode_layer_inputs(dims, b, quant, prompt=37,
                                     gen_lens=gen_lens, enc_lens=enc_lens,
                                     gen_slab=gen_slab, device=dev, seed=4)
    plans = smoke.layer_plans(dims, args)
    if name == "one-split":
        assert plans["cross"][:2] == (128, 1)
    before = tmk.decode_layer.launches
    got = tmk.decode_layer(layers, dims, li=1, **args)
    assert tmk.decode_layer.launches == before + 1
    want = tmk.decode_layer_plain(layers, dims, li=1, **args)
    errs = [smoke.rel_fro(g, w) for g, w in zip(got, want)]
    assert errs[0] <= smoke.REL_FRO_TOL_H, errs
    assert max(errs[1:]) <= smoke.REL_FRO_TOL_KV, errs


@pytest.mark.cuda
@pytest.mark.parametrize("int4", [False, True], ids=["w8", "w4"])
def test_cuda_chain5_int8_pages_split_edges(int4):
    """Chain 5 over 2 cache rows, int8 pages, generated lengths 0 and one
    past the slab: one CTA serves a cache row's five pseudo-rows."""
    dev = _card()
    smoke = _smoke()
    dims = _dims()
    layers = smoke.random_quant_layers(dims, 2, dev, seed=5, int4=int4)
    args = smoke.chain_layer_inputs(dims, 2, 5, True, dev, seed=6,
                                    gen=(0, 300), enc=(1, 128), gen_slab=256)
    got = tmk.decode_layer(layers, dims, li=1, chain=5, **args)
    want = tmk.decode_layer_plain(layers, dims, li=1, chain=5, **args)
    errs = [smoke.rel_fro(g, w) for g, w in zip(got, want)]
    assert errs[0] <= smoke.REL_FRO_TOL_H, errs
    assert max(errs[1:]) <= smoke.REL_FRO_TOL_KV, errs

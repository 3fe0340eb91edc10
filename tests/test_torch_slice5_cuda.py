"""Slice 5's kernels on a card against their plain versions: the W8A16
product (kernel 6: the bf16 tensor cores at every M, its plan, split K,
odd N, ragged K) and the v1 fused self-attention (kernel 7: bf16 and
float8 pages, empty segments, layer offsets). This module imports no JAX
(a machine with a card need not have it); run it there with

    python -m pytest -o addopts= --noconftest tests/test_torch_slice5_cuda.py

Without a card every test skips.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import quant as tquant


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


# (K, N): a ragged K (2320: no multiple of the 128-level K tile) with an
# odd N, the main path's down product (K = 9216) and the head's w2
# (N = 65541, odd)
W8A16_KN = [(2320, 1001), (9216, 2304), (2304, 65541)]

# The K splits of the plan on an H100 (132 SMs) at each decode product of
# the W8A16 main path, M = 4, by (K, N): qkv, o and cross o, cross q,
# gate_up, down, the head's w1 and w2. tests/test_torch_w8a16.py holds the
# split sums at these counts to the JAX kernel.
W8A16_MAIN_SPLITS = {(2304, 4096): 4, (2048, 2304): 7, (2304, 2048): 8,
                     (2304, 18432): 2, (9216, 2304): 7, (2304, 2304): 7,
                     (2304, 65541): 1}

# (M, K, N) of the W8A16 main path (2b-2b at batch 4: the decode products
# at M = 4, the prefill's at 4 x 65 rows and cross K/V at 256), the route's
# narrowest rows, and ragged K and N
PLAN_SHAPES = [(4, 2304, 4096), (4, 2048, 2304), (4, 2304, 2048),
               (4, 2304, 18432), (4, 9216, 2304), (4, 2304, 2304),
               (4, 2304, 65541), (260, 2304, 4096), (260, 2304, 18432),
               (260, 9216, 2304), (1, 2304, 4096), (2, 2320, 1001),
               (5, 2320, 1001), (16, 2320, 1001), (17, 2320, 1001),
               (256, 2304, 2048)]
TC_WIDTHS = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 144)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_w8a16_split_plan_covers_k_once(m, k, n):
    """The card's plan (``quant.product_plan``, from
    ``t5g_w8a16_plan``): tensor cores at every M, the narrowest wgmma
    width that holds the row tile, K tiles dealt out once over the splits,
    the grid split up to one wave of SMs where it is under one, in two
    where it is resident at once but more than the SMs; at the main
    path's decode shapes the splits of ``W8A16_MAIN_SPLITS``."""
    _card()
    w = tquant.QuantWeight(torch.zeros((n, k), dtype=torch.int8,
                                       device="cuda"),
                           torch.ones((n,), device="cuda"), n, 16)
    p = tquant.product_plan(m, w)
    ni, rowtiles, ntiles, ktiles = p["ni"], p["rowtiles"], p["ntiles"], \
        p["ktiles"]
    splits, per_sm = p["splits"], p["per_sm"]
    assert p["route"] == "tensor_cores"
    assert ni == min(w for w in TC_WIDTHS if w >= -(-m // rowtiles))
    assert rowtiles == -(-m // 144)
    assert ntiles * 128 >= n and ktiles * 128 >= k > (ktiles - 1) * 128
    assert per_sm == (2 if ni <= 32 else 1)
    cover = np.zeros(ktiles, np.int64)
    for sp in range(splits):
        lo, hi = sp * ktiles // splits, (sp + 1) * ktiles // splits
        assert hi - lo >= min(2, ktiles)
        cover[lo:hi] += 1
    assert (cover == 1).all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = ntiles * rowtiles
    if tiles < sms:      # under a wave of SMs: split up to one wave
        assert tiles * splits <= sms
        assert tiles * (splits + 1) > sms or splits == ktiles // 2
    elif tiles < sms * per_sm:     # resident, uneven over the SMs
        assert splits == min(2, ktiles // 2)
    else:
        assert splits == 1
    if m == 4 and sms == 132:
        assert splits == W8A16_MAIN_SPLITS[k, n]


@pytest.mark.cuda
@pytest.mark.parametrize("kn", W8A16_KN, ids=["K2320-N1001", "K9216",
                                               "N65541"])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 16, 17, 260])
def test_cuda_w8a16_matches_plain(m, kn):
    """From one row to two row tiles (the tensor cores at every M, split
    K where the plan splits): f32 output within
    1e-5 relative (Frobenius) of the plain version; bf16 output its own
    f32 output rounded, within one bf16 ulp of the plain version's beyond
    the f32 outputs' difference (chip_smoke's check_w8a16); f32 and bf16
    x."""
    dev = _card()
    smoke = _smoke()
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k)
    w = tquant.quantize_weight(
        torch.randn((k, n), generator=g, device=dev) * 0.05, act_bits=16)
    assert tquant.product_plan(m, w)["route"] == "tensor_cores"
    x = torch.randn((m, k), generator=g, device=dev) * 2.0
    for xd in (x, x.to(torch.bfloat16)):
        before = tquant.w8a16_matmul.launches
        smoke.check_w8a16(f"M={m} K={k} N={n}", xd, w)
        assert tquant.w8a16_matmul.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("f8", [False, True], ids=["bf16", "e4m3"])
@pytest.mark.parametrize("shape", [
    dict(b=4, h=8, hkv=4, hd=256, a_lens=[0, 128, 165, 256],
         b_lens=[7, 0, 129, 320], pp_a=2, pp_b=3),
    dict(b=3, h=4, hkv=2, hd=16, a_lens=[0, 100, 0], b_lens=[7, 0, 0],
         pp_a=2, pp_b=2)], ids=["hd256", "hd16-g2"])
def test_cuda_fused_decode_attention_matches_plain(f8, shape):
    """Within 1e-4 abs + 1e-4 rel of the plain version (as kernel 1), soft
    cap 50 and none, page tables at layer 1 of a two-layer buffer."""
    dev = _card()
    smoke = _smoke()
    base = smoke.attention_case(np.random.default_rng(0), device=dev,
                                quant=False, f8=f8, layers=2, li=1,
                                include_current=True, **shape)
    args = smoke.fused_args(base)
    for cap in (50.0, None):
        before = tfa.fused_decode_attention.launches
        got = tfa.fused_decode_attention(**args, attn_logits_soft_cap=cap)
        assert tfa.fused_decode_attention.launches == before + 1
        want = tfa.fused_decode_attention_plain(**args,
                                                attn_logits_soft_cap=cap)
        torch.cuda.synchronize()
        smoke.check_close(f"v1 cap {cap}", got, want)

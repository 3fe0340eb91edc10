"""Slice 5's kernels on a card against their plain versions: the W8A16
product (kernel 6: the GEMV for M <= 16, the tensor-core tile above, an
odd N) and the v1 fused self-attention (kernel 7: bf16 and float8 pages,
empty segments, layer offsets). This module imports no JAX (a machine with
a card need not have it); run it there with

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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 260])
def test_cuda_w8a16_matches_plain(m):
    """f32 output within 1e-5 relative (Frobenius) of the plain version;
    bf16 output its own f32 output rounded, within one bf16 ulp of the
    plain version's beyond the f32 outputs' difference (chip_smoke's
    check_w8a16); f32 and bf16 x; N odd, K = 2320 no multiple of 32 (the
    tile's half step) or of the GEMV's 1,024-wide slab."""
    dev = _card()
    smoke = _smoke()
    g = torch.Generator(device=dev).manual_seed(m)
    w = tquant.quantize_weight(
        torch.randn((2320, 1001), generator=g, device=dev) * 0.05,
        act_bits=16)
    x = torch.randn((m, 2320), generator=g, device=dev) * 2.0
    for xd in (x, x.to(torch.bfloat16)):
        before = tquant.w8a16_matmul.launches
        smoke.check_w8a16(f"M={m}", xd, w)
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

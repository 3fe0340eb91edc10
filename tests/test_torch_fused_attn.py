"""The port's batch_paged_attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs ``fused_attn.batch_paged_attention(..., interpret=True)``, i.e. the
Pallas kernel itself in interpret mode. The test marked ``cuda`` holds the
hand-written CUDA kernel against the plain version and runs only on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.ops import fused_attn as jfa
from t5gemma_tts_tpu.ops import paged_attn as jpa
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa

torch.set_num_threads(1)
PS = 128
TOL = 5e-5   # as tests/test_fused_attn.py: f32 sums in another order


def _case(seed, *, b=4, h=8, hkv=4, hd=256, quant=False, a_lens, b_lens,
          pp_a=2, pp_b=3, layers=1, li=0, include_current=True):
    """numpy inputs of one call (b_lens None = no segment B)."""
    rng = np.random.default_rng(seed)

    def pages(n):
        x = rng.standard_normal((hkv, n, PS, hd)).astype(np.float32)
        if quant:
            q, s = jfa.quantize_kv(jnp.asarray(x))
            return np.asarray(q), np.asarray(s)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)), None

    ak, aks = pages(layers * b * pp_a)
    av, avs = pages(layers * b * pp_a)
    c = dict(q=rng.standard_normal((b, h, hd)).astype(np.float32),
             k_cur=None, v_cur=None, a_k_pages=ak, a_v_pages=av,
             b_k_pages=None, b_v_pages=None,
             a_lengths=np.asarray(a_lens, np.int32), b_lengths=None,
             a_page_indices=(np.asarray(jpa.identity_page_indices(b, pp_a))
                             + li * b * pp_a),
             b_page_indices=None, a_k_scales=aks, a_v_scales=avs,
             b_k_scales=None, b_v_scales=None)
    if b_lens is not None:
        bk, bks = pages(layers * b * pp_b)
        bv, bvs = pages(layers * b * pp_b)
        c.update(b_k_pages=bk, b_v_pages=bv,
                 b_lengths=np.asarray(b_lens, np.int32),
                 b_page_indices=(np.asarray(jpa.identity_page_indices(b, pp_b))
                                 + li * b * pp_b),
                 b_k_scales=bks, b_v_scales=bvs)
    if include_current:
        c["k_cur"] = rng.standard_normal((b, hkv, hd)).astype(np.float32)
        c["v_cur"] = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    return c


def _torch(x, device="cpu"):
    if x is None:
        return None
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def _both(c, cap, include_current):
    want = jfa.batch_paged_attention(
        *(None if v is None else jnp.asarray(v) for v in c.values()),
        attn_logits_soft_cap=cap, include_current=include_current,
        interpret=True)
    got = tfa.batch_paged_attention(
        *(_torch(v) for v in c.values()), attn_logits_soft_cap=cap,
        include_current=include_current)
    return got.numpy(), np.asarray(want)


GEN_LENS = {"zero": [0, 0, 0, 0], "partial": [0, 5, 129, 320],
            "full": [384, 384, 384, 384]}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("gen", ["zero", "partial", "full"])
def test_self_attention_hd16(quant, cap, gen):
    """Self form (A + B + in-flight token) at hd=16, G=2, with A lengths
    0 (clamped to 1), one page, partial and two pages."""
    c = _case(10, h=4, hkv=2, hd=16, quant=quant, a_lens=[0, 128, 165, 256],
              b_lens=GEN_LENS[gen])
    got, want = _both(c, cap, True)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
def test_cross_attention_hd16_layer_offsets(quant, cap):
    """Cross form (A only, no current token) with layer-offset page
    indices into a 3-layer slab."""
    c = _case(11, h=4, hkv=2, hd=16, quant=quant, a_lens=[12, 128, 0, 256],
              b_lens=None, layers=3, li=2, include_current=False)
    got, want = _both(c, cap, False)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("include_current", [True, False],
                         ids=["current", "nocurrent"])
def test_two_segments_hd256(quant, include_current):
    """2b-2b head shapes (H=8, Hkv=4, hd=256), layer offsets, soft cap 50."""
    c = _case(12, quant=quant, a_lens=[1, 128, 165, 256],
              b_lens=[0, 77, 129, 384], layers=2, li=1,
              include_current=include_current)
    got, want = _both(c, 50.0, include_current)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_launch_counter_counts_only_kernel_launches():
    """On CPU tensors the wrapper runs the plain version and counts
    nothing."""
    c = _case(13, h=4, hkv=2, hd=16, a_lens=[3, 4, 5, 6], b_lens=[1, 2, 3, 4])
    before = tfa.batch_paged_attention.launches
    tfa.batch_paged_attention(*(_torch(v) for v in c.values()),
                              attn_logits_soft_cap=50.0, include_current=True)
    assert tfa.batch_paged_attention.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for quant in (False, True):
        for include_current, b_lens in ((True, [0, 5, 129, 320]),
                                        (False, None)):
            c = _case(14, quant=quant, a_lens=[1, 128, 165, 256],
                      b_lens=b_lens, layers=2, li=1,
                      include_current=include_current)
            args = [_torch(v, "cuda") for v in c.values()]
            before = tfa.batch_paged_attention.launches
            got = tfa.batch_paged_attention(
                *args, attn_logits_soft_cap=50.0,
                include_current=include_current)
            assert tfa.batch_paged_attention.launches == before + 1
            want = tfa.batch_paged_attention_plain(
                *args, attn_logits_soft_cap=50.0,
                include_current=include_current)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

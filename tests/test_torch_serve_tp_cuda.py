"""Tensor-parallel serving's kernels on a card, at each rank's shapes.

The ranks of one model group run in one process here (a card holds one
rank of NCCL, so the group's reductions are done between the calls, as the
collectives would do them):

- kernel 1 (``batch_paged_attention``) at a rank's heads of ``2b-2b``
  (Hq / Hkv 4 / 2 at tp 2, 2 / 1 at tp 4; hd 256, B = 4, bf16 pages, self
  and cross forms) against its plain version, and its split plan filling
  a wave of the card's SMs;
- kernel 2's parts (``megakernel.TpLayers``, ``t5g_decode_layer_part``) at
  tp 2 and tp 4 over two ``2b-2b``-wide layers (w8 B = 4, w4 B = 1, bf16
  and int8 pages; at tp 4 the 9216-wide F cuts a 512-wide activation tile
  between two ranks): every rank's h, k and v within the card check's
  tolerance for a rank's parts (``chip_smoke.TP_PART_TOL``) of the
  one-process ``decode_stack`` on the card and of the plain
  ``decode_stack_plain`` (not bit for bit: a rank's attention plans its
  splits over its own kv heads, so its f32 partial sums are taken in
  another order than the one-process kernel's; on the CPU, where the
  plain parts walk the pages as the plain layer does, the ranks equal the
  one-process stack bit for bit);
- kernels 3 and 4 at row-split K blocks through ``quant.rows_matmul`` (the
  group's row absmax, the int32 partial products summed, one rescale;
  ``chip_smoke.rows_over_group``): every rank's result bit-equal to the
  plain product on the same inputs, on the GEMV route (the head, M = 4 /
  M = 1) and the tensor cores (prefill, M = 260).

This module imports no JAX; run it on the card with

    python -m pytest -o addopts= --noconftest tests/test_torch_serve_tp_cuda.py

Without a card every test skips.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch.config import VoiceConfig
from t5gemma_tts_tpu_torch.ops import fused_attn as fa
from t5gemma_tts_tpu_torch.ops import megakernel as mk
from t5gemma_tts_tpu_torch.ops import quant
from t5gemma_tts_tpu_torch.parallel.mesh import _take_rows

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = chip_smoke.TP_PART_TOL


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("heads", [(4, 2), (2, 1)])
@pytest.mark.parametrize("form", ["self", "cross"])
def test_kernel1_at_a_ranks_heads(heads, form):
    dev = _card()
    h, hkv = heads
    rng = np.random.default_rng(h)
    cur = form == "self"
    args = chip_smoke.attention_case(
        rng, b=4, h=h, hkv=hkv, hd=256, quant=False,
        a_lens=[1, 128, 165, 256] if cur else [12, 128, 133, 256],
        b_lens=[0, 5, 129, 320] if cur else None, pp_a=2,
        pp_b=3 if cur else 0, layers=2, li=1, include_current=cur,
        device=dev)
    got = fa.batch_paged_attention(**args, attn_logits_soft_cap=50.0,
                                   include_current=cur)
    want = fa.batch_paged_attention_plain(**args, attn_logits_soft_cap=50.0,
                                          include_current=cur)
    chip_smoke.check_close(f"kernel 1 {form} Hq/Hkv {h}/{hkv}", got, want)
    assert chip_smoke.attention_plan(args)[2] >= fa.WAVE


def simulated_ranks(layers, dims, cfg, args, t):
    """Every rank of a tp-``t`` group over its shard of ``layers``, run
    with the group's reductions in this process -> [(h, k_new, v_new,
    first kv head)] a rank."""
    ranks = chip_smoke.tp_layer_ranks(layers, dims, cfg, args, t)
    chip_smoke.run_ranks([r for r, _ in ranks])
    return [(*r.outputs(), lo) for r, lo in ranks]


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_kernel2_parts_equal_the_one_process_stack(t, int4, kv_quant):
    dev = _card()
    cfg = VoiceConfig()
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    layers = chip_smoke.random_quant_layers(dims, 2, dev, seed=4, int4=int4)
    b = 1 if int4 else 4
    args = chip_smoke.decode_layer_inputs(
        dims, b, kv_quant, prompt=37, gen_lens=[129, 5, 0, 300][:b],
        enc_lens=[44, 1, 29, 130][:b], gen_slab=384, device=dev, seed=6)
    whole = mk.decode_stack(layers, dims, **args)
    plain = mk.decode_stack_plain(layers, dims, **args)
    before = mk.decode_layer_part.launches
    ranks = simulated_ranks(layers, dims, cfg, args, t)
    assert mk.decode_layer_part.launches - before == t * mk.PARTS * 2
    for h, k, v, lo in ranks:
        hkv = k.shape[2]
        for ref in (whole, plain):
            assert chip_smoke.rel_fro(h, ref[0]) <= TOL
            assert chip_smoke.rel_fro(k, ref[1][:, :, lo:lo + hkv]) <= TOL
            assert chip_smoke.rel_fro(v, ref[2][:, :, lo:lo + hkv]) <= TOL


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m, k, n", [(4, 2304, 65541), (1, 2304, 65541),
                                     (260, 2048, 2304), (260, 9216, 2304)])
@pytest.mark.parametrize("t", [2, 4])
def test_row_split_products_equal_the_whole_product(int4, m, k, n, t):
    dev = _card()
    if int4 and m == 4:
        pytest.skip("the int4 head runs at batch 1")
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn((m, k), generator=g, device=dev)
    w = (torch.randn((k, n), generator=g, device=dev) * 0.02
         ).to(torch.bfloat16)
    qw = quant.quantize_weight_int4_lanes(w) if int4 else \
        quant.quantize_weight(w)
    x8, sx = quant.quantize_act_plain(x)
    plain = (quant.int_matmul_exact(x8, quant.weight_levels(qw)).float()
             * sx * qw.scale[None, :]).to(x.dtype)
    kr = k // t
    xs = [x[:, r * kr:(r + 1) * kr].contiguous() for r in range(t)]
    ws = [_take_rows(qw, r * kr, kr) for r in range(t)]
    counter = quant.w4a8_matmul if int4 else quant.w8a8_matmul
    before = counter.launches
    got, amax, _ = chip_smoke.rows_over_group(xs, ws)
    assert counter.launches - before == t      # the last call of each rank
    assert torch.equal(amax, quant.row_absmax(x))
    for r in got:
        assert torch.equal(r, plain)

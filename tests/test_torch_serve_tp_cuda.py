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
  ``decode_stack_plain`` (a rank's attention takes the one-process
  call's split plan, so on one H100 its parts read 0 against the
  one-process stack, and the plain stack's distance from it);
- kernels 3 and 4 at row-split K blocks through ``quant.rows_matmul`` (the
  group's row absmax, the int32 partial products summed, one rescale;
  ``chip_smoke.rows_over_group``): every rank's result bit-equal to the
  plain product on the same inputs, on the GEMV route (the head, M = 4 /
  M = 1) and the tensor cores (prefill, M = 260);
- kernel 2's parts at chain 5 (a verify pass at k = 4; w8 and w4, 1 and 2
  cache rows, bf16 and int8 pages) against the one-process chain stack
  within ``TP_PART_TOL``, and against its plain version within
  ``TP_PART_TOL`` beyond the one-process chain stack's own distance from
  it (``chip_smoke.tp_part_limits``);
- kernel 5 (``paged_flash_parts`` at chain 5 and 1) and kernel 7
  (``fused_decode_attention``, bf16 and e4m3 pages) at a rank's heads
  against their plain versions and the whole call's block of heads, their
  plans filling a wave;
- kernel 6 (W8A16) at a rank's row block of ``o`` and ``down``: every
  rank's f32 result summed (``quant.rows_matmul_a16``'s group sum) against
  the whole plain product, within ``chip_smoke.W8A16_REL_FRO``, and its
  column blocks against their plain version.

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


@pytest.mark.parametrize("case", chip_smoke.TP_LAYER_CASES[2:])
@pytest.mark.parametrize("t", [2, 4])
def test_kernel2_chain_parts_equal_the_one_process_chain(case, t):
    dev = _card()
    int4, rows, chain, kv_quant = case
    cfg = VoiceConfig()
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    layers = chip_smoke.random_quant_layers(dims, 2, dev, seed=5, int4=int4)
    args = dict(chip_smoke.chain_layer_inputs(dims, rows, chain, kv_quant,
                                              dev, seed=7), chain=chain)
    whole = mk.decode_stack(layers, dims, **args)
    plain = mk.decode_stack_plain(layers, dims, **args)
    before = mk.decode_layer_part.launches
    ranks = simulated_ranks(layers, dims, cfg, args, t)
    assert mk.decode_layer_part.launches - before == t * mk.PARTS * 2
    assert all(h.shape[0] == rows * chain for h, _, _, _ in ranks)
    errs = chip_smoke.tp_part_errors(
        [((h, k, v), lo) for h, k, v, lo in ranks], whole, plain)
    for got, lim in zip(errs, chip_smoke.tp_part_limits(whole, plain,
                                                        chain)):
        assert all(e <= tol for e, tol in zip(got, lim)), (errs, lim)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("chain, dtype", [(5, torch.bfloat16),
                                          (5, torch.float8_e4m3fn),
                                          (1, torch.bfloat16)])
def test_kernel5_at_a_ranks_heads(t, chain, dtype):
    dev = _card()
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa

    spec = (dict(rows=1, lens=[300], pp=4) if chain > 1
            else dict(rows=4, lens=[44, 9, 29, 130], pp=2))
    args = chip_smoke.parts_case(
        np.random.default_rng(t), s_len=chain, h=8, hkv=4, hd=256,
        dtype=dtype, layers=2, li=1, device=dev, permute=True, **spec)
    whole = pa.paged_flash_parts(**args, attn_logits_soft_cap=50.0)
    h = 8 // t
    for r in range(t):
        a = chip_smoke.head_block(args, t, r)
        got = pa.paged_flash_parts(**a, attn_logits_soft_cap=50.0)
        chip_smoke.check_parts(f"kernel 5 tp {t}", got,
                               pa.paged_flash_parts_plain(
                                   **a, attn_logits_soft_cap=50.0))
        chip_smoke.head_outputs_close(f"kernel 5 tp {t} rank {r}", got,
                                       whole, r * h, h)
        assert chip_smoke.parts_plan(a)[2] >= fa.WAVE


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("f8", [False, True])
def test_kernel7_at_a_ranks_heads(t, f8):
    dev = _card()
    base = chip_smoke.attention_case(
        np.random.default_rng(t + 10), b=4, h=8, hkv=4, hd=256, quant=False,
        f8=f8, a_lens=[0, 1, 128, 1], b_lens=[225, 180, 0, 300], pp_a=1,
        pp_b=4, layers=2, li=1, include_current=True, device=dev)
    args = chip_smoke.fused_args(base)
    whole = fa.fused_decode_attention(**args, attn_logits_soft_cap=50.0)
    h = 8 // t
    for r in range(t):
        a = chip_smoke.head_block(args, t, r)
        got = fa.fused_decode_attention(**a, attn_logits_soft_cap=50.0)
        chip_smoke.check_close(f"kernel 7 tp {t}", got,
                               fa.fused_decode_attention_plain(
                                   **a, attn_logits_soft_cap=50.0))
        chip_smoke.head_outputs_close(f"kernel 7 tp {t} rank {r}", got,
                                       whole, r * h, h)
        assert chip_smoke.attention_plan(
            chip_smoke.head_block(base, t, r))[2] >= fa.WAVE


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("m", [4, 260])
@pytest.mark.parametrize("name, k, n, axis",
                         chip_smoke.W8A16_TP_PRODUCTS)
def test_w8a16_blocks_equal_the_whole_product(t, m, name, k, n, axis):
    dev = _card()
    from t5gemma_tts_tpu_torch.parallel.mesh import _take_columns

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    w = quant.quantize_weight((torch.randn((k, n), generator=g, device=dev)
                               * 0.02).to(torch.bfloat16), act_bits=16)
    x = (torch.randn((m, k), generator=g, device=dev) * 2.0).to(
        torch.bfloat16)
    if axis == "columns":
        nr = n // t
        for r in range(t):
            idx = torch.arange(r * nr, (r + 1) * nr, device=dev)
            chip_smoke.check_w8a16(f"{name} tp {t}", x,
                                   _take_columns(w, idx))
        return
    kr = k // t
    parts = [quant.w8a16_matmul(x[:, r * kr:(r + 1) * kr].contiguous(),
                                _take_rows(w, r * kr, kr), torch.float32)
             for r in range(t)]
    total = sum(parts)
    got = quant.rows_matmul_a16(x[:, :kr].contiguous(), _take_rows(w, 0, kr),
                                lambda _: total)
    want = quant.w8a16_matmul_plain(x, w, torch.float32)
    assert chip_smoke.rel_fro(total, want) <= chip_smoke.W8A16_REL_FRO
    assert torch.equal(got, total.to(torch.bfloat16))

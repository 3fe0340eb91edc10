"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit, and the build of every CUDA
   kernel from the sources under t5gemma_tts_tpu_torch/csrc/ (one nvcc per
   source, all started together);
2. kernel: each kernel against its plain PyTorch version on the card at the
   2b-2b shapes, with its error, time, plain time, bound and library time:
   the two-segment paged attention (bf16, int8 and e4m3 pages, self and
   cross forms, a small odd shape, and the edges of its split plan: empty
   splits, one split a row, the most splits), the one-segment paged kernel
   (bf16 and e4m3 pages, a chain of 5 over one and two cache rows, an empty
   row, lengths inside a chunk and at the capacity, permuted page tables,
   hd 16), the int8 decode layer (B = 4), the int4 decode layer (B = 1 and
   4), each also at the edges of its split plan (a length past the slab,
   36 rows, one row), and the decode layer at chain 5 (int8 and int4, 1
   and 2 cache rows), each with bf16 and int8 pages; the decode layer's
   six GEMVs bit for bit against the GEMV it ran before, both timed; the
   W8A16 product on the bf16 tensor cores from one row to two row tiles
   (M = 1, 2, 4, 5, 16, 17, 260 at K = 2320 / N = 1001, K = 9216 and
   N = 65541; up to 16 rows timed, with their plan) and the v1 fused
   self-attention (hd 256 and
   16, bf16 and e4m3 pages, soft cap 50 and none, empty prompt and
   generation segments, layer offsets, and the edges of its split plan:
   empty splits, one split a page, the most splits, every prompt empty);
   W8A8 and W4A8 at ragged shapes on both sides
   of their route boundary (M = 2 ... 260, N = 1001 and 65541, K = 2304,
   2320 and 9216), each timed on its route and on the GEMV route; the
   W8A8, W4A8 and W8A16 products are held here too, but at each quantized
   main path's own shapes and weights, right after that path's run (4b,
   4c, 4d, 4f), W8A8 and W4A8 timed on both routes (``products`` in the
   kernels' line);
3. reference: a tiny f32 model decoded greedily on the card (kernels) and on
   the CPU (plain versions) must give the same tokens and waveforms, with
   bf16 weights and paged pages, with the dense cache, sampled (top-k 8,
   top-p 0.9, T 0.8: the draws are a hash of (seed, step), the same on
   both devices) over paged pages, with int8 weights and int8 pages, and
   with int4 weights and int8 pages; the card serves through the graphed
   loop (engine.graphed_decoder) and runs the eager loop too, and the two
   must give the same tokens; prefill + run_segment slices (5, 11, the
   buffer's end) through graphed_segment_fns equal one decode, on both
   devices; and the same tokens from the speculative engine (k = 4) with
   int4 weights over bf16 pages (the decode layer's chain) and with f32
   weights over e4m3 pages (the one-segment kernel); then W8A16 weights
   over paged pages (a row may part only at a near-tie, see
   ``near_tie_parting``), and f32 weights with T5G_FUSED_ATTN = 0 and 1
   over paged pages and 1 over e4m3 pages;
4. main path, bf16: TTSPipeline at the full width of the 2b-2b preset
   (seeded random bf16 weights, the full-width XCodec2 decoder) synthesizes
   four requests with the paged cache through the graphed loop (its first
   request captures the bucket's step); the attention kernel's launch count
   must be 2 x 26 x the step bodies launched (the steps, the eager warm-up
   step of a new session and the no-op replays launched before the host
   read the end; each replay adds the launches its capture recorded); it
   prints steps, tokens/s and RTF; then the same decode graphed and eager
   (``engine.decode_tokens``) on the same inputs: tokens equal, each one's
   ms per step, the capture's ms and the session's bytes (``[graph/...]``);
5. profile: device time by kernel (torch.profiler) over a prefill and 32
   decode steps of that batch, graphed and eager, and the device's idle
   share of each; in the graphed window the kernel 1/7 merge kernels that
   the profiler sees are printed beside the wrappers' counts;
6. step timing: one decode step's 52 attention launches at the main
   path's cache shapes, graph-replayed and eager, kernel against plain
   version, beside their bound, with each split plan (a wave of CTAs at
   least);
4b. main path, int8 serving: TTSPipeline(int8=True) at full 2b-2b width and
   depth, int8 pages, the same four requests; decode_stack must run once
   per decode step, the attention kernel of phase 4 never, W8A8 at least
   twice per step (the head); then every W8A8 product of the run against
   its plain version (phase 2: the head's w1 and w2 at M = 4, the six
   layer products of the prefill at M = 4 x 65 and cross K/V at M = 4 x
   text width, the rows taken from the run's plan; int32 part exact), its
   profile (phase 5) and its step timing (phase 6): one decode_stack call
   at the main path's cache shapes (its device time by part: split
   attention, merge + quantize, GEMVs, norms, RoPE, GeGLU) and the step's
   two head products, each against its plain version;
4c. main path, int4 batch-1 latency: TTSPipeline(int4=True) at full 2b-2b
   width and depth, int8 pages, one 4.0 s request at batch 1; decode_stack
   must run once per decode step, the attention kernel never, W4A8 at least
   once per step (the head's w2); the same request through the int8
   pipeline of phase 4b in the same call (and its step timing at these
   batch-1 shapes); then every product of the int4 run against its plain
   version (phase 2: W4A8 at the head's w2, M = 1, and at the six layer
   products of the prefill, M = 65; W8A8 at the head's w1 and cross K/V),
   the int4 profile (phase 5) and step timing (phase 6): one int4
   decode_stack call at the main path's cache shapes and the head's two
   products (w1 W8A8, w2 W4A8);
4d. speculative, the JAX bench's probe: the int4 pipeline, the 4.0 s
   request at batch 1, kv_cache auto (bf16 pages), greedy, k = 4: the
   sequential engine, then the speculative engine drafted from its trace
   (the trace agreement) and drafted from its own trace corrupted to 90 %
   per-token acceptance (numpy seed 0), timed: steps, passes, tokens per
   pass, ms per step and per pass, the verify pass's cost against a step
   and the speedup. decode_stack must run once per pass (chain 5), the
   attention kernel never, W4A8 at least once per pass; then every
   quantized product of the run (the head now also at M = k + 1) and one
   verify pass's decode_stack at its shapes against their plain versions;
4e. bf16 weights over e4m3 pages, the same request: the sequential decode
   (the two-segment kernel, e4m3: 2 x 26 launches per step), then the
   speculative decode drafted as in 4d (the one-segment kernel: 3 x 26
   launches per pass), with 4d's numbers, and both kernels at the run's
   shapes against their plain versions;
4g. the bf16 batch of phase 4 with T5G_FUSED_ATTN=1: the v1 kernel runs
   self-attention (26 launches a step) and the one-segment kernel cross
   attention (26 a step), the two-segment kernel never; RTF, tokens/s and
   ms per step beside phase 4's; its profile, one step's 26 v1
   launches at the run's shapes (bf16 and e4m3 pages, with their split
   plan, which must fill a wave) and its 26 one-segment cross-attention
   launches, each against the plain version;
4f. W8A16 serving: the route quantize_params_for_decode(fuse_for_decode(
   params), act_bits=16) + TTSPipeline(fuse_matmuls=False), the same four
   requests over bf16 pages; W8A16 launches must equal the plan's count
   (w8a16_launches), the two-segment kernel 2 x 26 a step, decode_stack
   never; then every W8A16 product of the run against its plain version
   (with its route and plan), its profile, one row per distinct product
   shape of a step (route, plan, time, bound, bf16 yardstick) and one
   step's 158 products at the run's
   shapes, each with the library call torch._weight_int8pack_mm and a
   bf16 matmul over the weight dequantized beforehand.

4h. voice cloning at full width: seeded encoder weights at the width of
   ``XCodec2Config()`` join phase 4's codec; four reference recordings
   (2.0-4.0 s at 16 kHz, seeded tones plus noise, written to a temporary
   directory), one of them encoded on the card and on the CPU (codes equal
   but where the pre-quantization value lies within 1e-4 of an FSQ
   rounding boundary, counted; the card's encode wall ms); phase 4's four
   requests, each with a reference and its transcript (prompt bucket 256),
   graphed and eager (tokens equal; the attention kernel 2 x 26 x the step
   bodies launched); kernel 1 at the cloned prompt lengths (phase 6, the
   prompt over three pages); the cloned batch through the int8 pipeline
   (decode_stack once a step; its W8A8 products, the prefill at M = 4 x
   257, and one decode_stack call at the cloned prompt lengths against
   their plain versions) and the cloned 4.0 s request through the int4
   pipeline at batch 1 (its W4A8 / W8A8 products, the prefill at M = 257).
   Phase 3 also encodes a recording with the tiny codec (a 2-layer LSTM)
   on both devices, runs the tiny voice-clone pipeline on both (greedy
   tokens equal), and holds two interleaved segment streams of one bucket,
   with a one-shot request between their segments and, with
   MAX_SESSIONS = 1, an eviction, each to its one-shot decode.

Every main path (4, 4b, 4c's int4 run, 4f, 4g) runs its decode graphed and
eager and is profiled both ways; a ``[graph]`` line sums them up as JSON.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12         # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 tensor cores, dense
PEAK_INT8_OPS = 1979e12        # H100 SXM, int8 tensor cores, dense
# The int8 decode layer against its plain version, relative Frobenius
# error: the same arithmetic, sums in another order. An f32 difference
# that moves one int8 activation across a rounding boundary flips its
# level, and the flip grows through the layer's later quantizations, so h
# is held to the JAX suite's bound for its megakernel against the unfused
# path, k/v (one quantization deep) to 5e-3, and a 26-layer stack, where
# flips compound, to 1e-1.
REL_FRO_TOL_H = 5e-2
REL_FRO_TOL_KV = 5e-3
REL_FRO_TOL_STACK = 1e-1
TOL_ABS = 1e-4                 # f32 outputs from the same bf16/int8 pages:
TOL_REL = 1e-4                 # only the order of summation differs
MODEL_LAYERS = 26              # 2b-2b decoder depth
PAGE = 128


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph and replayed, so that the host's launch cost (the Python wrapper,
    ctypes) does not hide the kernels' own time."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 3) / iters


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def attention_case(rng, *, b, h, hkv, hd, quant, a_lens, b_lens, pp_a, pp_b,
                   layers, li, include_current, device, f8=False):
    """Random inputs of one batch_paged_attention call (numpy-seeded); int8
    pages with ``quant``, float8 e4m3 pages with ``f8``, else bf16."""
    from t5gemma_tts_tpu_torch.ops.fused_attn import quantize_kv
    from t5gemma_tts_tpu_torch.ops.paged_attn import identity_page_indices

    def t(x):
        return torch.from_numpy(x).to(device)

    def pages(n):
        x = t(rng.standard_normal((hkv, n, PAGE, hd)).astype(np.float32))
        if quant:
            return quantize_kv(x)
        return x.to(torch.float8_e4m3fn if f8 else torch.bfloat16), None

    a_k, a_ks = pages(layers * b * pp_a)
    a_v, a_vs = pages(layers * b * pp_a)
    args = dict(
        q=t(rng.standard_normal((b, h, hd)).astype(np.float32)),
        k_cur=None, v_cur=None,
        a_k_pages=a_k, a_v_pages=a_v, b_k_pages=None, b_v_pages=None,
        a_lengths=t(np.asarray(a_lens, np.int32)), b_lengths=None,
        a_page_indices=identity_page_indices(b, pp_a, device) + li * b * pp_a,
        b_page_indices=None,
        a_k_scales=a_ks, a_v_scales=a_vs, b_k_scales=None, b_v_scales=None)
    if b_lens is not None:
        b_k, b_ks = pages(layers * b * pp_b)
        b_v, b_vs = pages(layers * b * pp_b)
        args.update(b_k_pages=b_k, b_v_pages=b_v,
                    b_lengths=t(np.asarray(b_lens, np.int32)),
                    b_page_indices=(identity_page_indices(b, pp_b, device)
                                    + li * b * pp_b),
                    b_k_scales=b_ks, b_v_scales=b_vs)
    if include_current:
        args["k_cur"] = t(rng.standard_normal((b, hkv, hd)).astype(np.float32))
        args["v_cur"] = t(rng.standard_normal((b, hkv, hd)).astype(np.float32))
    return args


def attention_bytes_ops(args, include_current, clamp_a=True) -> tuple:
    """Bytes the function must move (each input read once, the output
    written once; only the valid tokens of each segment count, segment A
    at least one with ``clamp_a``, as kernel 1 reads it) and its
    floating-point operations, for this call's data."""
    b, h, hd = args["q"].shape
    hkv = args["a_k_pages"].shape[0]
    elem = args["a_k_pages"].element_size()
    quant = args["a_k_scales"] is not None
    a_lens = args["a_lengths"].clamp_min(1 if clamp_a else 0)
    tokens = int(a_lens.sum())
    pages = int(((a_lens + PAGE - 1) // PAGE).sum())
    if args["b_lengths"] is not None:
        tokens += int(args["b_lengths"].sum())
        pages += int(((args["b_lengths"] + PAGE - 1) // PAGE).sum())
    per_token = 2 * hkv * hd * elem + (2 * hkv * 4 if quant else 0)
    nbytes = (tokens * per_token + pages * 4 + 2 * b * 4
              + 2 * b * h * hd * 4 + (2 * b * hkv * hd * 4 if include_current else 0))
    flops = 4 * h * hd * (tokens + (b if include_current else 0))
    return nbytes, flops


def bound_ms(nbytes, flops, peak_ops=PEAK_F32_FLOPS) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got - want).abs()
    worst = float(err.max())
    if not bool((err <= TOL_ABS + TOL_REL * want.abs()).all()):
        raise AssertionError(f"{name}: max abs err {worst:.3e} exceeds "
                             f"{TOL_ABS:g} abs + {TOL_REL:g} rel")
    return worst


def phase_kernel(card: str, iters: int) -> dict:
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    big = dict(b=4, h=8, hkv=4, hd=256)
    cases = []
    for tag in ("bf16", "i8", "f8"):
        quant, f8 = tag == "i8", tag == "f8"
        cases.append((f"self/{tag}", dict(
            big, quant=quant, f8=f8, a_lens=[1, 128, 165, 256],
            b_lens=[0, 5, 129, 320], pp_a=2, pp_b=3, layers=2, li=1,
            include_current=True)))
        cases.append((f"cross/{tag}", dict(
            big, quant=quant, f8=f8, a_lens=[12, 128, 133, 256], b_lens=None,
            pp_a=2, pp_b=0, layers=2, li=1, include_current=False)))
        cases.append((f"self-hd16-g2/{tag}", dict(
            b=3, h=4, hkv=2, hd=16, quant=quant, f8=f8, a_lens=[0, 100, 200],
            b_lens=[7, 0, 130], pp_a=2, pp_b=2, layers=1, li=0,
            include_current=True)))
    worst = {}
    for name, spec in cases:
        args = attention_case(rng, device=dev, **spec)
        cur = spec["include_current"]
        got = fa.batch_paged_attention(**args, attn_logits_soft_cap=50.0,
                                       include_current=cur)
        want = fa.batch_paged_attention_plain(
            **args, attn_logits_soft_cap=50.0, include_current=cur)
        torch.cuda.synchronize()
        err = check_close(name, got, want)
        page = name.split("/")[1]
        worst[page] = max(worst.get(page, 0.0), err)
        k_ms = cuda_ms(lambda: fa.batch_paged_attention(
            **args, attn_logits_soft_cap=50.0, include_current=cur), iters)
        p_ms = cuda_ms(lambda: fa.batch_paged_attention_plain(
            **args, attn_logits_soft_cap=50.0, include_current=cur), iters)
        b_ms, _ = bound_ms(*attention_bytes_ops(args, cur))
        print(f"[kernel] batch_paged_attention {name}: max_abs_err={err:.3e} "
              f"(tol {TOL_ABS:g} abs + {TOL_REL:g} rel) kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} library_ms=none "
              f"(no PyTorch call computes soft-capped paged GQA) "
              f"{plan_note(attention_plan(args))} [{card}]")
    for page in worst:
        worst[page] = max(worst[page], phase_kernel_splits(card, rng, page))
    return worst


def attention_plan(args) -> tuple:
    """Kernel 1's (chunk, splits, CTAs) for one call's arguments."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    chunk, splits = fa.batch_attention_plan(
        args["a_k_pages"], args["a_page_indices"], args["b_page_indices"])
    b = args["q"].shape[0]
    return chunk, splits, b * args["a_k_pages"].shape[0] * splits


def plan_note(plan) -> str:
    return f"plan chunk={plan[0]} splits={plan[1]} ctas={plan[2]}"


def phase_kernel_splits(card: str, rng, page: str) -> float:
    """Kernel 1 at the edges of its split plan against its plain version
    (bf16, int8 or e4m3 ``page``s, 2b-2b heads): lengths 0, 1, 127, 128,
    129, 255, 256 that leave splits empty or end on a chunk or page edge;
    a batch of 36 cross rows over one page (one split a row); one row over
    one encoder page (chunk 2: the most splits a main path plans) and its
    self-attention over a prompt page and four generation pages."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    dev = torch.device("cuda")
    big = dict(h=8, hkv=4, hd=256, quant=page == "i8", f8=page == "f8",
               layers=1, li=0)
    cases = [
        ("edges", dict(big, b=4, a_lens=[0, 1, 127, 128], b_lens=[129, 0, 255,
                                                                 256],
                       pp_a=2, pp_b=2, include_current=True)),
        ("one-split", dict(big, b=36, a_lens=list(range(1, 128, 4))[:36]
                           + [128] * 4, b_lens=None, pp_a=1, pp_b=0,
                           include_current=False)),
        ("widest-cross", dict(big, b=1, a_lens=[45], b_lens=None, pp_a=1,
                              pp_b=0, include_current=False)),
        ("widest-self", dict(big, b=1, a_lens=[1], b_lens=[225], pp_a=1,
                             pp_b=4, include_current=True))]
    worst = 0.0
    for name, spec in cases:
        spec["a_lens"] = spec["a_lens"][:spec["b"]]
        args = attention_case(rng, device=dev, **spec)
        cur = spec["include_current"]
        got = fa.batch_paged_attention(**args, attn_logits_soft_cap=50.0,
                                       include_current=cur)
        want = fa.batch_paged_attention_plain(
            **args, attn_logits_soft_cap=50.0, include_current=cur)
        torch.cuda.synchronize()
        err = check_close(f"split {name}/{page}", got, want)
        worst = max(worst, err)
        print(f"[kernel] batch_paged_attention split edge {name}/{page}: "
              f"max_abs_err={err:.3e} (tol {TOL_ABS:g} abs + {TOL_REL:g} "
              f"rel) {plan_note(attention_plan(args))} [{card}]")
    return worst


def main_path_step_timing(card: str, prompt_len, gen_len: int,
                          enc_lens, gen_slab: int, iters: int,
                          f8: bool = False, prompt_pages: int = 1) -> dict:
    """One decode step's 52 launches (self + cross for each of 26 layers)
    at the main path's cache shapes (bf16 pages, or e4m3 with ``f8``),
    kernel (graph-replayed, and eager) against plain version, with the
    split plans, which must fill a wave. ``prompt_len`` (BOS included) is
    one length or one a row, over ``prompt_pages`` pages a row (a cloned
    prompt's bucket)."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    b = len(enc_lens)
    tx = -(-max(enc_lens) // PAGE) * PAGE
    common = dict(b=b, h=8, hkv=4, hd=256, quant=False, layers=MODEL_LAYERS,
                  li=0, f8=f8)
    a_lens = (list(prompt_len) if isinstance(prompt_len, (list, tuple))
              else [prompt_len] * b)
    self_args = attention_case(
        rng, device=dev, a_lens=a_lens, b_lens=[gen_len] * b,
        pp_a=prompt_pages, pp_b=gen_slab // PAGE, include_current=True,
        **common)
    cross_args = attention_case(
        rng, device=dev, a_lens=list(enc_lens), b_lens=None,
        pp_a=tx // PAGE, pp_b=0, include_current=False, **common)
    per_layer = []
    for li in range(MODEL_LAYERS):
        s = dict(self_args)
        s["a_page_indices"] = (self_args["a_page_indices"]
                               + li * b * prompt_pages)
        s["b_page_indices"] = (self_args["b_page_indices"]
                               + li * b * (gen_slab // PAGE))
        c = dict(cross_args)
        c["a_page_indices"] = cross_args["a_page_indices"] + li * b * (tx // PAGE)
        per_layer.append((s, c))

    def step(fn):
        def run():
            for s, c in per_layer:
                fn(**s, attn_logits_soft_cap=50.0, include_current=True)
                fn(**c, attn_logits_soft_cap=50.0, include_current=False)
        return run

    worst = 0.0
    for s, c in per_layer[:2]:
        for a, cur in ((s, True), (c, False)):
            got = fa.batch_paged_attention(**a, attn_logits_soft_cap=50.0,
                                           include_current=cur)
            want = fa.batch_paged_attention_plain(
                **a, attn_logits_soft_cap=50.0, include_current=cur)
            worst = max(worst, check_close("main-path shapes", got, want))
    n = 2 * MODEL_LAYERS
    k_ms = graph_ms(step(fa.batch_paged_attention), iters) / n
    eager_ms = cuda_ms(step(fa.batch_paged_attention), iters) / n
    p_ms = cuda_ms(step(fa.batch_paged_attention_plain), iters) / n
    sb, sf = attention_bytes_ops(self_args, True)
    cb, cf = attention_bytes_ops(cross_args, False)
    b_ms, by = bound_ms((sb + cb) / 2, (sf + cf) / 2)
    splits = {"self": attention_plan(self_args),
              "cross": attention_plan(cross_args)}
    print(f"[kernel] main-path step (B={b}, prompt {a_lens}, gen "
          f"{gen_len}, enc {list(enc_lens)}, {'e4m3' if f8 else 'bf16'} "
          f"pages; mean of {n} launches): "
          f"kernel_ms={k_ms:.4f} (graph; eager {eager_ms:.4f}) plain_ms="
          f"{p_ms:.4f} bound_ms={b_ms:.5f} ({by}) max_abs_err={worst:.3e}; "
          f"self {plan_note(splits['self'])}, cross "
          f"{plan_note(splits['cross'])} [{card}]")
    check_wave("batch_paged_attention", splits)
    return {"ms": k_ms, "eager_ms": eager_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": by, "max_abs_err": worst,
            "splits": splits}


def check_wave(name: str, splits: dict) -> None:
    """A split-KV launch at a main path's shapes must fill one wave."""
    from t5gemma_tts_tpu_torch.ops.fused_attn import WAVE

    for form, plan in splits.items():
        if plan[2] < WAVE:
            raise AssertionError(f"{name} {form}: {plan[2]} CTAs, less than "
                                 f"one wave of {WAVE}")


# ---------------------------------------------------------------------------
# phase 2: the quantized products and the decode layers
# ---------------------------------------------------------------------------


def ulp_diff(got, want) -> int:
    """Largest distance in f32 units in the last place."""
    a = got.float().contiguous().view(torch.int32).long()
    b = want.float().contiguous().view(torch.int32).long()
    return int((a - b).abs().max())


def w8a8_cost(m, k, n, x_bytes, out_bytes, w_bytes=1.0) -> tuple:
    """Bytes the product must move (x, the weights -- ``w_bytes`` a level,
    0.5 for int4 -- and their scales, the output) and its integer
    operations."""
    return (m * k * x_bytes + int(n * k * w_bytes) + n * 4 + m * n * out_bytes,
            2 * m * k * n)


def product_fns(w):
    """(kernel wrapper, plain version, bytes a weight level) of a weight."""
    from t5gemma_tts_tpu_torch.ops import quant

    if isinstance(w, quant.Int4Weight):
        return quant.w4a8_matmul, quant.w4a8_matmul_plain, 0.5
    return quant.w8a8_matmul, quant.w8a8_matmul_plain, 1.0


def int_mm_call(x, w):
    """A library yardstick for one quantized product (timing only):
    torch._int_mm on M and N padded to its rules (M > 16, multiples of 8),
    then the rescale, on activations quantized beforehand; int4 weights are
    unpacked to int8 levels beforehand, so it reads twice their bytes."""
    from t5gemma_tts_tpu_torch.ops import quant

    m, k = x.shape
    levels = quant.weight_levels(w)
    n = levels.shape[0]
    mp, np_ = max(32, -(-m // 8) * 8), -(-n // 8) * 8
    x8, sx = quant.quantize_act(x)
    x8p = torch.zeros((mp, k), dtype=torch.int8, device=x.device)
    x8p[:m] = x8
    sxp = torch.ones((mp, 1), device=x.device)
    sxp[:m] = sx
    wp = torch.zeros((np_, k), dtype=torch.int8, device=x.device)
    wp[:n] = levels
    swp = torch.zeros((np_,), device=x.device)
    swp[:n] = w.scale
    wt = wp.t()
    return lambda: (torch._int_mm(x8p, wt).float() * sxp) * swp


def run_products(run: dict) -> list:
    """The quantized products a main-path run sent to the product kernels,
    as (name, M, weight), on the run's own weights (layer 0 of a stack):
    the head's w1 and w2 at M = B (every decode step; a speculative run
    also at M = B x (k + 1), its ``head_rows``), the decoder's six layer
    products in the prefill at M = B x (prompt width + 1) and, with W8A16
    weights (which take the layer loop), at every step at M = B, and cross
    K/V at M = B x text width; M comes from the run's plan."""
    from t5gemma_tts_tpu_torch.models.t5gemma import layer_params

    params = run["pipe"].params
    lay = layer_params(params["decoder"]["layers"], 0)
    rows = run["prefill_rows"]
    out = [(f"head {nm}", b, params["head"][nm])
           for b in run.get("head_rows", [run["batch"]])
           for nm in ("w1", "w2")]
    step_rows = ([run["batch"]]
                 if getattr(lay["mlp"]["down"], "act_bits", 8) == 16 else [])
    for blk, names in (("self_attn", ("qkv", "o")), ("cross_attn", ("q", "o")),
                       ("mlp", ("gate_up", "down"))):
        out += [(f"prefill {blk}.{nm}", rows, lay[blk][nm]) for nm in names]
        out += [(f"step {blk}.{nm}", m, lay[blk][nm])
                for m in step_rows for nm in names]
    out += [(f"cross_attn.{nm} (cross K/V)", run["cross_rows"],
             lay["cross_attn"][nm]) for nm in ("k", "v")]
    return out


def check_product(label, m, w, gen) -> tuple:
    """One W8A8 / W4A8 product on the card against its plain version, on
    seeded inputs: the int32 part equal (integer rows holding 127, scale
    1, against unit channel scales give f32(acc) on both sides), the int8
    activation levels and scales equal, the f32 output within 1 ULP and the
    bf16 output equal. Returns (x, max abs f32 error)."""
    from t5gemma_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    product, plain, _ = product_fns(w)
    k = w.packed.shape[-1] * 2 if isinstance(w, quant.Int4Weight) \
        else w.values.shape[-1]
    xi = torch.randint(-127, 128, (m, k), generator=gen, device=dev)
    xi[:, 0] = 127
    unit = w._replace(scale=torch.ones_like(w.scale))
    got = product(xi.float(), unit)
    want = plain(xi.float(), unit)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label} M={m}: int32 part differs")
    x = torch.randn((m, k), generator=gen, device=dev) * 2.0
    x8, sx = quant.quantize_act(x)
    w8, wsx = quant.quantize_act_plain(x)
    if not (torch.equal(x8, w8) and torch.equal(sx, wsx)):
        raise AssertionError(f"{label}: activation levels differ")
    got = product(x, w, torch.float32)
    want = plain(x, w, torch.float32)
    ulps = ulp_diff(got, want)
    gb = product(x.to(torch.bfloat16), w)
    wb = plain(x.to(torch.bfloat16), w)
    if ulps > 1 or not torch.equal(gb, wb):
        raise AssertionError(f"{label}: {ulps} f32 ULP from the plain "
                             f"version (tol 1), bf16 equal: "
                             f"{torch.equal(gb, wb)}")
    return x, float((got - want).abs().max())


def time_routes(x, w, iters: int) -> tuple:
    """(ms, previous_ms): the product's device time on the route its
    wrapper takes and on the GEMV route of csrc/w8a8.cuh (the only route
    before the tensor-core product), graph-timed in turns (route, GEMV,
    GEMV, route); each the mean of its two turns."""
    from t5gemma_tts_tpu_torch.ops import quant

    product = product_fns(w)[0]
    call = lambda: product(x, w, torch.float32)  # noqa: E731
    gemv = lambda: quant.gemv_route(x, w, torch.float32)  # noqa: E731
    t = [graph_ms(call, iters), graph_ms(gemv, iters), graph_ms(gemv, iters),
         graph_ms(call, iters)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def phase_products(card: str, run: dict, iters: int) -> tuple:
    """Every quantized product of a main-path run (:func:`run_products`)
    against its plain version, on the kernel its weight format takes
    (W8A8 or W4A8; :func:`check_product`), timed on its route and on the
    GEMV route (:func:`time_routes`) beside the library call. Returns the
    largest f32 error by kernel and one record per product."""
    from t5gemma_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst, records = {}, {}
    for name, m, w in run_products(run):
        product, plain, w_bytes = product_fns(w)
        tag = "w4a8" if isinstance(w, quant.Int4Weight) else "w8a8"
        n = w.n
        k = w.packed.shape[-1] * 2 if tag == "w4a8" else w.values.shape[-1]
        x, err = check_product(f"{tag} {run['tag']} {name}", m, w, gen)
        worst[tag] = max(worst.get(tag, 0.0), err)
        k_ms, prev_ms = time_routes(x, w, iters)
        eager_ms = cuda_ms(lambda: product(x, w, torch.float32), iters)
        p_ms = cuda_ms(lambda: plain(x, w, torch.float32), iters)
        lib_ms = graph_ms(int_mm_call(x, w), iters)
        b_ms, by = bound_ms(*w8a8_cost(m, k, n, 4, 4, w_bytes), PEAK_INT8_OPS)
        route = quant.product_plan(m, w)
        records.setdefault(tag, []).append(dict(
            run=run["tag"], name=name, M=m, K=k, N=n, ms=k_ms,
            previous_ms=prev_ms, bound_ms=b_ms, library_ms=lib_ms,
            route=route["route"], splits=route["splits"]))
        lib_note = ("torch._int_mm on the unpacked int8 levels + rescale, "
                    "twice the weight bytes" if tag == "w4a8"
                    else "torch._int_mm + rescale")
        print(f"[kernel] {tag} {run['tag']} {name} [{m}x{k}]x[{k}x{n}]: "
              f"int32 part exact, max_abs_err={err:.3e} (f32 within 1 "
              f"ULP), bf16 equal; kernel_ms={k_ms:.4f} (graph, "
              f"{route['route']}, plan {route}; eager call {eager_ms:.4f}) "
              f"previous_ms={prev_ms:.4f} (the GEMV route, graph, in turns) "
              f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} ({by}) "
              f"library_ms={lib_ms:.4f} ({lib_note}, graph) [{card}]")
    return worst, records


def random_product_weight(int4: bool, n: int, k: int, gen):
    """Seeded W8A8 or W4A8 weights of n channels of K levels on the card."""
    from t5gemma_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
    lo = 7 if int4 else 127
    q = torch.randint(-lo, lo + 1, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    if int4:
        return quant.Int4Weight(quant.pack_int4(q), scale, n)
    return quant.QuantWeight(q, scale, n)


def phase_product_edges(card: str, iters: int) -> float:
    """W8A8 and W4A8 at ragged shapes against their plain versions
    (:func:`check_product`): M = 2, 5, 16, 17, 64, 65, 129, 260 on both
    sides of the route boundary, at an odd N = 1001 with K = 2304 and K =
    2320 (a multiple of 16, not of 32), at the head's N = 65541 and at K =
    9216; each timed on its route and on the GEMV route. The W4A8
    tensor-core route refuses K = 2320 (TMA needs the packed row's 1160
    bytes a multiple of 16): there the wrapper must raise for M >= 2, and
    M = 1 (the GEMV) is checked. Returns the largest f32 error by kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    ms_all = (2, 5, 16, 17, 64, 65, 129, 260)
    cases = [(k, 1001, ms_all) for k in (2304, 2320)]
    cases += [(2304, 65541, (2, 5, 16, 17, 65, 260)),
              (9216, 1001, (5, 17, 65, 260))]
    worst = {}
    it = max(iters // 2, 2)
    for int4 in (False, True):
        tag = "w4a8" if int4 else "w8a8"
        worst[tag] = 0.0
        for k, n, ms in cases:
            w = random_product_weight(int4, n, k, gen)
            if int4 and k % 32:
                x, err = check_product(f"{tag} edge", 1, w, gen)
                worst[tag] = max(worst[tag], err)
                for m in ms:
                    try:
                        product_fns(w)[0](torch.zeros((m, k), device=dev), w)
                    except ValueError:
                        continue
                    raise AssertionError(f"{tag} K={k} M={m}: the tensor-core "
                                         f"route must refuse this K")
                print(f"[kernel] {tag} edge K={k} N={n}: M=1 (GEMV) equal to "
                      f"the plain version, err={err:.3e}; M={list(ms)} refused "
                      f"(ValueError) [{card}]")
                continue
            times = []
            for m in ms:
                x, err = check_product(f"{tag} edge K={k} N={n}", m, w, gen)
                worst[tag] = max(worst[tag], err)
                k_ms, prev_ms = time_routes(x, w, it)
                times.append(f"M={m}: {k_ms:.4f}/{prev_ms:.4f}")
            print(f"[kernel] {tag} edge K={k} N={n}: int32 part exact, f32 "
                  f"within 1 ULP, bf16 equal at M={list(ms)}; ms on the "
                  f"route / the GEMV route (graph, in turns): "
                  f"{'; '.join(times)} [{card}]")
    return worst


def rel_fro(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def decode_layer_inputs(dims, b, quant, prompt, gen_lens, enc_lens, gen_slab,
                        device, seed, layers=None, chain=1,
                        prompt_slab=PAGE):
    """Seeded slabs, lengths, rope tables and hidden rows of one decode-layer
    call (``layers``: the stack depth the slabs hold; ``chain``: b rows are
    b / chain cache rows of the slabs, chain pseudo-rows each; ``prompt``:
    one length or one a row, in a ``prompt_slab``-token slab)."""
    from t5gemma_tts_tpu_torch.ops import rope
    from t5gemma_tts_tpu_torch.ops.fused_attn import quantize_kv

    g = torch.Generator(device=device).manual_seed(seed)
    n_layers = layers or dims.num_layers
    hkv, hd = dims.num_kv_heads, dims.head_dim
    tx = -(-max(enc_lens) // PAGE) * PAGE

    def slab(t):
        x = torch.randn((hkv, n_layers * (b // chain), t, hd), generator=g,
                        device=device) * 0.5
        return quantize_kv(x) if quant else (x.to(torch.bfloat16), None)

    slabs, scales = zip(*(slab(t) for t in (prompt_slab, prompt_slab,
                                            gen_slab, gen_slab, tx, tx)))
    pos = torch.rand((b, 1), generator=g, device=device) * 100
    cos, sin = rope.rope_cos_sin(pos, hd, dims.rope_theta)
    qcos, qsin = rope.rope_cos_sin(pos * 10, hd, dims.rope_theta)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    args = dict(
        h=torch.randn((b, dims.hidden_size), generator=g, device=device),
        cos=cos[:, 0], sin=sin[:, 0], qcos=qcos[:, 0], qsin=qsin[:, 0],
        plens=i32(list(prompt) if isinstance(prompt, (list, tuple))
                  else [prompt] * b), glens=i32(list(gen_lens)),
        elens=i32(list(enc_lens)),
        prompt_k=slabs[0], prompt_v=slabs[1], gen_k=slabs[2],
        gen_v=slabs[3], cross_k=slabs[4], cross_v=slabs[5],
        kv_scales=scales if quant else None)
    return args


def random_quant_layers(dims, n_layers, device, seed, int4=False):
    """Seeded W8A8 (or, with ``int4``, int4) decoder layers at ``dims``'
    widths, quantized on the card from random bf16 weights; norms
    random."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import quant

    g = torch.Generator(device=device).manual_seed(seed)
    d, f = dims.hidden_size, dims.intermediate_size
    ho = dims.num_heads * dims.head_dim
    nkv = dims.num_kv_heads * dims.head_dim
    quantize = (quant.quantize_weight_int4_lanes if int4
                else quant.quantize_weight)
    cls = quant.Int4Weight if int4 else quant.QuantWeight

    def w(k, n):
        parts = [quantize((torch.randn((k, n), generator=g, device=device)
                           * 0.02).to(torch.bfloat16))
                 for _ in range(n_layers)]
        return cls(torch.stack([p[0] for p in parts]),
                   torch.stack([p.scale for p in parts]), n)

    layers = {n: torch.randn((n_layers, d), generator=g, device=device) * 0.1
              for n in mk._NORMS}
    layers["self_attn"] = {"qkv": w(d, ho + 2 * nkv), "o": w(ho, d)}
    layers["cross_attn"] = {"q": w(d, ho), "o": w(ho, d)}
    layers["mlp"] = {"gate_up": w(d, 2 * f), "down": w(f, d)}
    return layers


def decode_layer_bytes(dims, args, w_bytes=1.0, chain=1) -> int:
    """Bytes one layer must move: its weights (``w_bytes`` a level, 0.5 for
    int4) and f32 scales and norms, the valid K/V (and scales) of this
    call's lengths (once per cache row: the ``chain`` pseudo-rows of a row
    share its pages), h in and out, the rope tables and the new k/v."""
    d, f = dims.hidden_size, dims.intermediate_size
    ho = dims.num_heads * dims.head_dim
    nkv = dims.num_kv_heads * dims.head_dim
    nk = ((ho + 2 * nkv, d), (d, ho), (ho, d), (d, ho), (2 * f, d), (d, f))
    weights = sum(int(n * k * w_bytes) + 4 * n for n, k in nk) + 6 * d * 4
    b = args["h"].shape[0]
    elem = args["prompt_k"].element_size()
    quant = args["kv_scales"] is not None
    tokens = int(args["plens"][::chain].sum() + args["glens"][::chain].sum()
                 + args["elens"][::chain].clamp_min(1).sum())
    per_token = 2 * nkv * elem + (2 * dims.num_kv_heads * 4 if quant else 0)
    return (weights + tokens * per_token + 2 * b * d * 4
            + 4 * b * dims.head_dim * 4 + 2 * b * nkv * 4 + 3 * b * 4)


def phase_decode_layer(card: str, cfg, iters: int,
                       int4: bool = False) -> float:
    """The int8 (``int4``: int4) decode layer against its plain version at
    2b-2b width, bf16 and int8 pages (a two-layer stack, layer 1), timed:
    B = 4 (int4: B = 1 and 4). Then, checked only, the edges of the split
    plan: lengths 0, 255, 256 and one past the 256-token generation slab
    (which re-reads its last page), encoder lengths 1, 16, 128, 129; 36
    rows (one cross split a row); one row over a 640-token self capacity
    and one encoder page (the most splits a main path plans)."""
    import dataclasses

    from t5gemma_tts_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda")
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    layers = random_quant_layers(dims, 2, dev, seed=4 + int4, int4=int4)
    weights = "int4" if int4 else "int8"
    cases = [("", 4, [0, 5, 129, 300], [1, 29, 44, 130], 384, True)]
    if int4:
        cases.insert(0, ("", 1, [129], [44], 384, True))
    cases += [("split edges ", 4, [0, 255, 256, 300], [1, 16, 128, 129], 256,
               False),
              ("one cross split ", 36, [(7 * i) % 129 for i in range(36)],
               [1 + (11 * i) % 128 for i in range(36)], 128, False),
              ("widest split ", 1, [225], [45], 512, False)]
    worst = 0.0
    for label, b, gen_lens, enc_lens, gen_slab, timed in cases:
        for quant in (False, True):
            tag = "i8" if quant else "bf16"
            args = decode_layer_inputs(dims, b, quant, prompt=37,
                                       gen_lens=gen_lens, enc_lens=enc_lens,
                                       gen_slab=gen_slab, device=dev,
                                       seed=5 + quant + 10 * (b != 4))
            got = mk.decode_layer(layers, dims, li=1, **args)
            want = mk.decode_layer_plain(layers, dims, li=1, **args)
            torch.cuda.synchronize()
            errs = [rel_fro(g, w) for g, w in zip(got, want)]
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if (errs[0] > REL_FRO_TOL_H or errs[1] > REL_FRO_TOL_KV
                    or errs[2] > REL_FRO_TOL_KV):
                raise AssertionError(
                    f"{weights} decode layer {label}B={b} {tag}: relative "
                    f"error {errs} (h, k, v) exceeds "
                    f"{REL_FRO_TOL_H}/{REL_FRO_TOL_KV}")
            worst = max(worst, err)
            plans = layer_plans(dims, args)
            lens = "/".join(str(n) for n in gen_lens[:4])
            elens = "/".join(str(n) for n in enc_lens[:4])
            head = (f"[kernel] decode_layer {weights} {label}2b-2b B={b} "
                    f"{tag} pages (prompt 37, gen {lens}, enc {elens}, gen "
                    f"slab {gen_slab}): relative error h/k/v {errs[0]:.2e}/"
                    f"{errs[1]:.2e}/{errs[2]:.2e} (tol {REL_FRO_TOL_H:g}/"
                    f"{REL_FRO_TOL_KV:g}/{REL_FRO_TOL_KV:g}), max_abs_err="
                    f"{err:.3e}; self {plan_note(plans['self'])}, cross "
                    f"{plan_note(plans['cross'])}")
            if not timed:
                print(f"{head} [{card}]")
                continue
            k_ms = graph_ms(lambda: mk.decode_layer(layers, dims, li=1,
                                                    **args), iters)
            p_ms = cuda_ms(lambda: mk.decode_layer_plain(layers, dims, li=1,
                                                         **args),
                           max(iters // 4, 2))
            b_ms, by = bound_ms(decode_layer_bytes(
                dims, args, 0.5 if int4 else 1.0), 0)
            print(f"{head}; kernel_ms={k_ms:.4f} (graph) plain_ms={p_ms:.4f}"
                  f" bound_ms={b_ms:.5f} ({by}) library_ms=none (no PyTorch "
                  f"call computes a layer) [{card}]")
    return worst


def layer_plans(dims, args) -> dict:
    """Kernel 2's self and cross (chunk, splits, CTAs) for one call."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk

    plans = mk.attention_plan(dims, args["prompt_k"], args["gen_k"],
                              args["cross_k"])
    pairs = args["prompt_k"].shape[0] * (args["prompt_k"].shape[1]
                                         // dims.num_layers)
    return {k: (c, n, pairs * n) for k, (c, n) in plans.items()}


def product_timing(calls, card: str, label: str, iters: int) -> dict:
    """The quantized products ``calls`` [(x, weight), ...] of one decode
    step, each against its plain version; times are the mean per call."""
    worst = 0.0
    for x, w in calls:
        product, plain, _ = product_fns(w)
        got = product(x, w, torch.float32)
        want = plain(x, w, torch.float32)
        if ulp_diff(got, want) > 1:
            raise AssertionError(f"{label}: above 1 f32 ULP")
        worst = max(worst, float((got - want).abs().max()))

    def run(which):
        return lambda: [product_fns(w)[which](x, w) for x, w in calls]

    lib = [int_mm_call(x.float(), w) for x, w in calls]
    n = len(calls)
    out = {"ms": graph_ms(run(0), iters) / n,
           "eager_ms": cuda_ms(run(0), iters) / n,
           "plain_ms": cuda_ms(run(1), iters) / n,
           "library_ms": graph_ms(lambda: [f() for f in lib], iters) / n,
           "max_abs_err": worst}
    costs = [w8a8_cost(x.shape[0], x.shape[1], w.n, 2, 2, product_fns(w)[2])
             for x, w in calls]
    out["bound_ms"], out["bound_by"] = bound_ms(
        sum(c[0] for c in costs) / n, sum(c[1] for c in costs) / n,
        PEAK_INT8_OPS)
    print(f"[kernel] {label}: kernel_ms={out['ms']:.4f} (graph; eager call "
          f"{out['eager_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
          f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) "
          f"library_ms={out['library_ms']:.4f} max_abs_err={worst:.3e} "
          f"[{card}]")
    return out


def quant_step_timing(pipe, card: str, steps: int, enc_lens, gen_slab: int,
                      iters: int, prompts=1, prompt_slab: int = PAGE,
                      parts: bool = True) -> dict:
    """One decode step's quantized work at the main path's cache shapes, on
    the main path's own weights: the decode_stack call (26 layers, int8
    pages; ``prompts`` one prompt length, BOS included, or one a row, in a
    ``prompt_slab``-token slab; with ``parts`` its device time by part)
    and the step's two head products, each against its plain version. Int8
    weights: the two W8A8 head products as one mean; int4 weights: the
    head's w1 (W8A8) and w2 (W4A8) each on its own."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import quant

    cfg, dev = pipe.cfg, pipe.device
    dims = cfg.backbone.decoder
    layers = pipe.params["decoder"]["layers"]
    int4 = isinstance(layers["mlp"]["down"], quant.Int4Weight)
    weights = "int4" if int4 else "int8"
    b = len(enc_lens)
    args = decode_layer_inputs(dims, b, True, prompt=prompts,
                               gen_lens=[steps // 2] * b, enc_lens=enc_lens,
                               gen_slab=gen_slab, device=dev, seed=6,
                               prompt_slab=prompt_slab)
    got = mk.decode_stack(layers, dims, **args)
    want = mk.decode_stack_plain(layers, dims, **args)
    torch.cuda.synchronize()
    errs = [rel_fro(g, w) for g, w in zip(got, want)]
    if max(errs) > REL_FRO_TOL_STACK:
        raise AssertionError(f"{weights} decode_stack at main-path shapes: "
                             f"relative error {errs} exceeds "
                             f"{REL_FRO_TOL_STACK}")
    stack = {"max_abs_err": max(float((g - w).abs().max())
                                for g, w in zip(got, want)),
             "ms": graph_ms(lambda: mk.decode_stack(layers, dims, **args),
                           iters),
             "eager_ms": cuda_ms(lambda: mk.decode_stack(layers, dims,
                                                         **args), iters),
             "plain_ms": cuda_ms(lambda: mk.decode_stack_plain(
                 layers, dims, **args), 2),
             "library_ms": None}
    stack["bound_ms"], stack["bound_by"] = bound_ms(
        dims.num_layers * decode_layer_bytes(dims, args,
                                             0.5 if int4 else 1.0), 0)
    stack["splits"] = layer_plans(dims, args)
    print(f"[kernel] decode_stack {weights} main-path step (B={b}, prompt "
          f"{prompts}, "
          f"gen {steps // 2}, enc {list(enc_lens)}, int8 pages, 26 layers): "
          f"relative error h/k/v {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
          f"(tol {REL_FRO_TOL_STACK:g}), max_abs_err="
          f"{stack['max_abs_err']:.3e}, "
          f"kernel_ms={stack['ms']:.4f} (graph; eager call "
          f"{stack['eager_ms']:.4f}) plain_ms={stack['plain_ms']:.4f} "
          f"bound_ms={stack['bound_ms']:.5f} ({stack['bound_by']}); self "
          f"{plan_note(stack['splits']['self'])}, cross "
          f"{plan_note(stack['splits']['cross'])} [{card}]")
    check_wave("decode_stack", stack["splits"])
    if parts:
        stack["parts"] = stack_breakdown(
            lambda: mk.decode_stack(layers, dims, **args), card,
            f"decode_stack {weights} B={b}")

    head = pipe.params["head"]
    g = torch.Generator(device=dev).manual_seed(7)
    x1 = torch.randn((b, dims.hidden_size), generator=g, device=dev).to(
        torch.bfloat16)
    x2 = torch.randn((b, head["w1"].n), generator=g, device=dev).to(
        torch.bfloat16)
    if not int4:
        return {"decode_stack": stack, "w8a8": product_timing(
            [(x1, head["w1"]), (x2, head["w2"])], card,
            f"w8a8 main-path step (head w1 and w2, M={b}, bf16; mean of the "
            f"step's 2 launches)", iters)}
    return {"decode_stack": stack,
            "w8a8": product_timing([(x1, head["w1"])], card,
                                   f"w8a8 int4 main-path step (head w1, "
                                   f"M={b}, bf16)", iters),
            "w4a8": product_timing([(x2, head["w2"])], card,
                                   f"w4a8 int4 main-path step (head w2, "
                                   f"M={b}, bf16; int4 weights)", iters)}


STACK_PARTS = (("split attention", "slab_"),
               ("merge + quantize", "merge_quant"),
               ("GEMVs", "gemv"),
               ("norms", "residual_norm_quant"),
               ("RoPE", "rope_kernel"),
               ("GeGLU", "geglu_quant"))


def stack_breakdown(fn, card: str, label: str) -> dict:
    """Device time of one decode_stack call by part: the call captured in a
    CUDA graph and replayed once under torch.profiler (an eager call if
    the profiler sees no kernel of the replay), kernels grouped by name
    (STACK_PARTS)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    source = "graph replay"
    for run in (graph.replay, fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count,
                 e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(ms > 0 for ms, _, _ in rows):
            break
        source = "eager call"
    parts = {name: {"ms": 0.0, "launches": 0} for name, _ in STACK_PARTS}
    parts["other"] = {"ms": 0.0, "launches": 0}
    for ms, count, key in rows:
        name = next((n for n, pat in STACK_PARTS if pat in key), "other")
        parts[name]["ms"] += ms
        parts[name]["launches"] += count
    total = sum(p["ms"] for p in parts.values())
    print(f"[kernel] {label} by part ({source}, torch.profiler, one call): "
          + "; ".join(f"{n} {p['ms']:.4f} ms x{p['launches']} "
                      f"({100 * p['ms'] / max(total, 1e-9):.1f}%)"
                      for n, p in parts.items())
          + f"; total {total:.4f} ms [{card}]")
    return {"source": source, "total_ms": total, **parts}


# ---------------------------------------------------------------------------
# phase 2: the speculative slice's kernels
# ---------------------------------------------------------------------------

SPEC_K = 4                     # drafted tokens per verify pass (k)


def parts_case(rng, *, rows, s_len, h, hkv, hd, lens, pp, dtype, layers, li,
               device, permute=False):
    """Random inputs of one paged_flash_parts call in its chain form:
    ``rows`` cache rows (lengths, page tables: layer ``li``'s pages of the
    slab, or with ``permute`` a random choice of the slab's pages), q of
    ``s_len`` pseudo-rows each as in a verify pass."""
    from t5gemma_tts_tpu_torch.ops.paged_attn import identity_page_indices

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    if permute:
        idx = torch.from_numpy(rng.permutation(layers * rows * pp)[
            :rows * pp].reshape(rows, pp).astype(np.int32)).to(device)
    else:
        idx = identity_page_indices(rows, pp, device) + li * rows * pp
    return dict(
        q=t((rows * s_len, h, hd)),
        k_pages=t((hkv, layers * rows * pp, PAGE, hd)).to(dtype),
        v_pages=t((hkv, layers * rows * pp, PAGE, hd)).to(dtype),
        lengths=torch.tensor(lens, dtype=torch.int32, device=device),
        page_indices=idx, chain=s_len)


def parts_bytes_ops(args) -> tuple:
    """Bytes a paged_flash_parts call must move (the valid K/V of each
    cache row once, its page ids and lengths, q in, out/m/l out) and its
    floating-point operations (every pseudo-row's dots)."""
    b, h, hd = args["q"].shape
    hkv = args["k_pages"].shape[0]
    elem = args["k_pages"].element_size()
    lens = args["lengths"]
    tokens = int(lens.sum())
    pages = int(((lens + PAGE - 1) // PAGE).sum())
    nbytes = (tokens * 2 * hkv * hd * elem + pages * 4 + len(lens) * 4
              + 2 * b * h * hd * 4 + 2 * b * h * 4)
    return nbytes, 4 * h * hd * tokens * args["chain"]


def parts_plan(args) -> tuple:
    """Kernel 5's (chunk, splits, CTAs) for one call's arguments: cache
    rows x Hkv x splits CTAs, with no factor of the chain."""
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa

    chunk, splits = pa.parts_plan(args["k_pages"], args["page_indices"])
    rows = args["page_indices"].shape[0]
    return chunk, splits, rows * args["k_pages"].shape[0] * splits


def check_parts(name, got, want) -> float:
    """(out, m, l) against the plain version: the same rows empty (m = -inf
    exactly, l = 0), the rest within TOL_ABS + TOL_REL."""
    worst = 0.0
    for g, w, part in zip(got, want, ("out", "m", "l")):
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            raise AssertionError(f"{name} {part}: empty rows differ")
        live = torch.isfinite(w)
        worst = max(worst, check_close(f"{name} {part}", g[live], w[live]))
    empty = ~torch.isfinite(want[1])
    if not (bool((got[2][empty] == 0).all())
            and bool((got[0][empty.any(-1)] == 0).all())):
        raise AssertionError(f"{name}: an empty row is not (0, -inf, 0)")
    return worst


def phase_paged_parts(card: str, iters: int) -> float:
    """The one-segment paged kernel against its plain version at the 2b-2b
    head shapes (8 query heads, 4 kv heads, hd 256), bf16 and e4m3 pages,
    permuted page tables: a chain of 5 over 1 cache row (a verify pass at
    k = 4; 300 ends inside a chunk of 8), over 2 cache rows of which one is
    empty and one at its capacity, 4 rows at chain 1, and a small odd
    shape (hd 16, G 2)."""
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    big = dict(h=8, hkv=4, hd=256, pp=3, layers=2, li=1, permute=True)
    worst = 0.0
    for dtype, tag in ((torch.bfloat16, "bf16"),
                       (torch.float8_e4m3fn, "e4m3")):
        for name, spec in (
                (f"chain5/{tag}", dict(big, rows=1, s_len=5, lens=[300])),
                (f"chain5-empty/{tag}", dict(big, rows=2, s_len=5,
                                             lens=[0, 384])),
                (f"chain1-4rows/{tag}", dict(big, rows=4, s_len=1,
                                             lens=[1, 129, 0, 383])),
                (f"hd16-g2/{tag}", dict(rows=3, s_len=1, h=4, hkv=2, hd=16,
                                        pp=2, layers=1, li=0, permute=True,
                                        lens=[0, 100, 200]))):
            args = parts_case(rng, dtype=dtype, device=dev, **spec)
            got = pa.paged_flash_parts(**args, attn_logits_soft_cap=50.0)
            want = pa.paged_flash_parts_plain(**args,
                                              attn_logits_soft_cap=50.0)
            torch.cuda.synchronize()
            err = check_parts(name, got, want)
            worst = max(worst, err)
            k_ms = cuda_ms(lambda: pa.paged_flash_parts(
                **args, attn_logits_soft_cap=50.0), iters)
            p_ms = cuda_ms(lambda: pa.paged_flash_parts_plain(
                **args, attn_logits_soft_cap=50.0), iters)
            b_ms, by = bound_ms(*parts_bytes_ops(args))
            print(f"[kernel] paged_flash_parts {name}: max_abs_err={err:.3e} "
                  f"(tol {TOL_ABS:g} abs + {TOL_REL:g} rel; empty rows exact)"
                  f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({by}) library_ms=none (no PyTorch "
                  f"call computes soft-capped paged GQA with its flash "
                  f"statistics) {plan_note(parts_plan(args))} [{card}]")
    return worst


def parts_step_timing(card: str, prompt_len: int, gen_len: int, enc_len: int,
                      gen_slab: int, iters: int, s_len: int = SPEC_K + 1
                      ) -> dict:
    """One verify pass's 78 one-segment launches (prompt, generation and
    cross for each of 26 layers) at a batch-1 main path's shapes, e4m3
    pages, a chain of s_len over the cache row, kernel against plain
    version, with each segment's split plan (a wave of CTAs at least)."""
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa

    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    tx = -(-enc_len // PAGE) * PAGE
    common = dict(rows=1, s_len=s_len, h=8, hkv=4, hd=256,
                  dtype=torch.float8_e4m3fn, layers=MODEL_LAYERS, li=0,
                  device=dev)
    segs = [parts_case(rng, lens=[n], pp=t // PAGE, **common)
            for n, t in ((prompt_len, PAGE), (gen_len, gen_slab),
                         (enc_len, tx))]
    calls = []
    for li in range(MODEL_LAYERS):
        for a in segs:
            pp = a["page_indices"].shape[1]
            calls.append(dict(a, page_indices=a["page_indices"] + li * pp))
    worst = max(check_parts("verify-pass shapes", pa.paged_flash_parts(
        **a, attn_logits_soft_cap=50.0), pa.paged_flash_parts_plain(
        **a, attn_logits_soft_cap=50.0)) for a in calls[:3])

    def run(fn):
        return lambda: [fn(**a, attn_logits_soft_cap=50.0) for a in calls]

    n = len(calls)
    out = {"ms": graph_ms(run(pa.paged_flash_parts), iters) / n,
           "eager_ms": cuda_ms(run(pa.paged_flash_parts), iters) / n,
           "plain_ms": cuda_ms(run(pa.paged_flash_parts_plain), iters) / n,
           "max_abs_err": worst, "library_ms": None}
    costs = [parts_bytes_ops(a) for a in segs]
    out["bound_ms"], out["bound_by"] = bound_ms(
        sum(c[0] for c in costs) / 3, sum(c[1] for c in costs) / 3)
    out["splits"] = {name: parts_plan(a)
                     for name, a in zip(("prompt", "gen", "cross"), segs)}
    print(f"[kernel] paged_flash_parts verify-pass shapes (1 row, chain "
          f"{s_len}, prompt {prompt_len}, gen {gen_len}, enc {enc_len}, "
          f"e4m3 pages; mean of {n} launches): kernel_ms={out['ms']:.4f} "
          f"(graph; eager {out['eager_ms']:.4f}) "
          f"plain_ms={out['plain_ms']:.4f} bound_ms={out['bound_ms']:.5f} "
          f"({out['bound_by']}) max_abs_err={worst:.3e}; "
          + "; ".join(f"{k} {plan_note(v)}" for k, v in out["splits"].items())
          + f" [{card}]")
    check_wave("paged_flash_parts", out["splits"])
    return out


def cross_parts_timing(card: str, enc_lens, iters: int) -> dict:
    """One decode step's 26 one-segment launches of mode 1's cross
    attention (phase 4g: paged_gqa_attention over the encoder pages, bf16)
    at the batch's shapes, kernel (graph-replayed) against plain
    version."""
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    pp = -(-max(enc_lens) // PAGE)
    base = parts_case(rng, rows=len(enc_lens), s_len=1, h=8, hkv=4, hd=256,
                      lens=list(enc_lens), pp=pp, dtype=torch.bfloat16,
                      layers=MODEL_LAYERS, li=0, device=dev)
    calls = [dict(base, page_indices=base["page_indices"]
                  + li * len(enc_lens) * pp) for li in range(MODEL_LAYERS)]
    worst = max(check_parts("4g cross shapes", pa.paged_flash_parts(
        **a, attn_logits_soft_cap=50.0), pa.paged_flash_parts_plain(
        **a, attn_logits_soft_cap=50.0)) for a in calls[:2])

    def run(fn):
        return lambda: [fn(**a, attn_logits_soft_cap=50.0) for a in calls]

    n = len(calls)
    out = {"ms": graph_ms(run(pa.paged_flash_parts), iters) / n,
           "eager_ms": cuda_ms(run(pa.paged_flash_parts), iters) / n,
           "plain_ms": cuda_ms(run(pa.paged_flash_parts_plain), iters) / n,
           "max_abs_err": worst, "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound_ms(*parts_bytes_ops(base))
    out["splits"] = {"cross": parts_plan(base)}
    print(f"[kernel] paged_flash_parts 4g cross-attention shapes (B="
          f"{len(enc_lens)}, enc {list(enc_lens)}, bf16 pages; mean of {n} "
          f"launches): kernel_ms={out['ms']:.4f} (graph; eager "
          f"{out['eager_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
          f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) "
          f"max_abs_err={worst:.3e} {plan_note(out['splits']['cross'])} "
          f"[{card}]")
    check_wave("paged_flash_parts", out["splits"])
    return out


def chain_layer_inputs(dims, rows, s_len, quant, device, seed, layers=None,
                       gen=(129, 5), enc=(44, 9), gen_slab=384):
    """Inputs of one decode-layer call at chain ``s_len`` over ``rows``
    cache rows (prompt 37; generated and encoder lengths by cache row)."""
    n = rows * s_len
    return decode_layer_inputs(
        dims, n, quant, prompt=37,
        gen_lens=np.repeat(np.asarray(gen[:rows]), s_len).tolist(),
        enc_lens=np.repeat(np.asarray(enc[:rows]), s_len).tolist(),
        gen_slab=gen_slab, device=device, seed=seed, layers=layers,
        chain=s_len)


def phase_chain_layer(card: str, cfg, iters: int) -> dict:
    """The decode layer at chain 5 (a verify pass at k = 4) against its
    plain version at 2b-2b width, layer 1 of two: int8 and int4 weights,
    bf16 and int8 pages, 1 and 2 cache rows. Returns the largest error by
    weight format."""
    import dataclasses

    from t5gemma_tts_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda")
    s_len = SPEC_K + 1
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    worst = {}
    for int4 in (False, True):
        weights = "int4" if int4 else "int8"
        layers = random_quant_layers(dims, 2, dev, seed=8 + int4, int4=int4)
        for rows in (1, 2):
            for quant in (False, True):
                tag = "i8" if quant else "bf16"
                args = chain_layer_inputs(dims, rows, s_len, quant, dev,
                                          seed=9 + quant + 2 * rows)
                got = mk.decode_layer(layers, dims, li=1, chain=s_len, **args)
                want = mk.decode_layer_plain(layers, dims, li=1, chain=s_len,
                                             **args)
                torch.cuda.synchronize()
                errs = [rel_fro(g, w) for g, w in zip(got, want)]
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                if (errs[0] > REL_FRO_TOL_H or errs[1] > REL_FRO_TOL_KV
                        or errs[2] > REL_FRO_TOL_KV):
                    raise AssertionError(
                        f"{weights} chain-{s_len} layer, {rows} rows, {tag}: "
                        f"relative error {errs} (h, k, v)")
                worst[weights] = max(worst.get(weights, 0.0), err)
                k_ms = graph_ms(lambda: mk.decode_layer(
                    layers, dims, li=1, chain=s_len, **args), iters)
                p_ms = cuda_ms(lambda: mk.decode_layer_plain(
                    layers, dims, li=1, chain=s_len, **args),
                    max(iters // 4, 2))
                b_ms, by = bound_ms(decode_layer_bytes(
                    dims, args, 0.5 if int4 else 1.0, chain=s_len), 0)
                print(f"[kernel] decode_layer {weights} chain {s_len} 2b-2b "
                      f"{rows} cache row(s) = {rows * s_len} pseudo-rows, "
                      f"{tag} pages: relative error h/k/v {errs[0]:.2e}/"
                      f"{errs[1]:.2e}/{errs[2]:.2e} (tol {REL_FRO_TOL_H:g}/"
                      f"{REL_FRO_TOL_KV:g}/{REL_FRO_TOL_KV:g}), max_abs_err="
                      f"{err:.3e}; kernel_ms={k_ms:.4f} (graph) plain_ms="
                      f"{p_ms:.4f} bound_ms={b_ms:.5f} ({by}) library_ms=none"
                      f" (no PyTorch call computes a layer) [{card}]")
    return worst


def chain_step_timing(pipe, card: str, steps: int, enc_len: int,
                      gen_slab: int, iters: int) -> dict:
    """One verify pass's decode_stack call (26 layers, chain k + 1 over one
    cache row, bf16 pages) at a batch-1 main path's shapes, on its own
    weights, against the plain version."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import quant

    cfg, dev = pipe.cfg, pipe.device
    dims = cfg.backbone.decoder
    layers = pipe.params["decoder"]["layers"]
    int4 = isinstance(layers["mlp"]["down"], quant.Int4Weight)
    s_len = SPEC_K + 1
    args = chain_layer_inputs(dims, 1, s_len, False, dev, seed=10,
                              gen=(steps // 2,), enc=(enc_len,),
                              gen_slab=gen_slab)
    args["plens"].fill_(1)
    got = mk.decode_stack(layers, dims, chain=s_len, **args)
    want = mk.decode_stack_plain(layers, dims, chain=s_len, **args)
    torch.cuda.synchronize()
    errs = [rel_fro(g, w) for g, w in zip(got, want)]
    if max(errs) > REL_FRO_TOL_STACK:
        raise AssertionError(f"chain decode_stack at main-path shapes: "
                             f"relative error {errs}")
    out = {"max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "ms": graph_ms(lambda: mk.decode_stack(layers, dims, chain=s_len,
                                                  **args), iters),
           "plain_ms": cuda_ms(lambda: mk.decode_stack_plain(
               layers, dims, chain=s_len, **args), 2),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound_ms(
        dims.num_layers * decode_layer_bytes(dims, args, 0.5 if int4 else 1.0,
                                             chain=s_len), 0)
    out["splits"] = layer_plans(dims, args)
    print(f"[kernel] decode_stack {'int4' if int4 else 'int8'} chain {s_len}"
          f" verify pass at main-path shapes (1 row x {s_len}, prompt 1, gen "
          f"{steps // 2}, enc {enc_len}, bf16 pages, 26 layers): relative "
          f"error h/k/v {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol "
          f"{REL_FRO_TOL_STACK:g}), kernel_ms={out['ms']:.4f} (graph) "
          f"plain_ms={out['plain_ms']:.4f} bound_ms={out['bound_ms']:.5f} "
          f"({out['bound_by']}); self {plan_note(out['splits']['self'])}, "
          f"cross {plan_note(out['splits']['cross'])} [{card}]")
    check_wave("decode_stack chain", out["splits"])
    return out


# ---------------------------------------------------------------------------
# phase 2: slice 5's kernels, the W8A16 product and the v1 fused attention
# ---------------------------------------------------------------------------

W8A16_REL_FRO = 1e-5   # f32 output: exact products, f32 sums in another order


def bf16_ulp(x):
    """One bf16 unit in the last place at each element's magnitude."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(tiny))) - 7)


def check_w8a16(name, x, w) -> float:
    """Kernel 6 against its plain version on ``x`` and ``w``: f32 output
    within W8A16_REL_FRO (relative Frobenius); bf16 output equal to the
    kernel's own f32 output rounded to bf16, and within one bf16 ulp (at
    the larger of the two magnitudes) of the plain version's, beyond the
    two f32 sums' own difference (an output near 0 sums to other f32
    values in another order, and that difference is many ulp of its own
    magnitude).
    Returns the f32 output's max abs error."""
    from t5gemma_tts_tpu_torch.ops import quant

    got = quant.w8a16_matmul(x, w, torch.float32)
    want = quant.w8a16_matmul_plain(x, w, torch.float32)
    gb = quant.w8a16_matmul(x, w, torch.bfloat16).float()
    wb = quant.w8a16_matmul_plain(x, w, torch.bfloat16).float()
    torch.cuda.synchronize()
    rel = rel_fro(got, want)
    own = torch.equal(gb, got.to(torch.bfloat16).float())
    ulps = float(((gb - wb).abs() - (got - want).abs()).div(
        bf16_ulp(torch.maximum(gb.abs(), wb.abs()))).max())
    if not (rel <= W8A16_REL_FRO and own and ulps <= 1.0):
        raise AssertionError(f"w8a16 {name}: f32 relative error {rel:.2e} "
                             f"(tol {W8A16_REL_FRO:g}); bf16 = its f32 "
                             f"rounded: {own}; bf16 {ulps:g} ulp beyond the "
                             f"f32 difference (tol 1)")
    return float((got - want).abs().max())


def w8a16_cost(m, k, n, x_bytes=2, out_bytes=2) -> tuple:
    """Bytes the W8A16 product must move (x, the int8 weights and their
    f32 scales, the output) and its operations."""
    return m * k * x_bytes + n * k + n * 4 + m * n * out_bytes, 2 * m * k * n


def int8pack_call(x, w):
    """The library yardstick for one W8A16 product (timing only):
    ``torch._weight_int8pack_mm`` over bf16 x and bf16 scales, or None
    with the reason where this build has no CUDA kernel for it."""
    xb, sb = x.to(torch.bfloat16), w.scale.to(torch.bfloat16)
    try:
        torch._weight_int8pack_mm(xb, w.values, sb)
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        return None, str(e).strip().splitlines()[0][:120]
    return lambda: torch._weight_int8pack_mm(xb, w.values, sb), None


def bf16_matmul_call(x, w):
    """The bf16 yardstick (timing only): x @ the weight dequantized to
    bf16 beforehand, twice the int8 bytes."""
    xb = x.to(torch.bfloat16)
    wd = (w.values.float() * w.scale[:, None]).to(torch.bfloat16).t()
    return lambda: xb @ wd


def w8a16_launches(layers: int, steps: int) -> int:
    """Kernel 6's launches on the W8A16 main path: cross K/V (two a layer)
    and the prefill's six layer products, then at every decode step the
    six layer products and the head's w1 and w2."""
    return 8 * layers + steps * (6 * layers + 2)


def time_w8a16(calls, card: str, label: str, iters: int) -> dict:
    """The W8A16 products ``calls`` [(x, weight), ...] timed as one graph
    each way: the kernel, the plain version, the library call and the bf16
    yardstick; times are means per call."""
    from t5gemma_tts_tpu_torch.ops import quant

    n = len(calls)

    def run(fns):
        return lambda: [f() for f in fns]

    kern = [lambda x=x, w=w: quant.w8a16_matmul(x, w) for x, w in calls]
    plain = [lambda x=x, w=w: quant.w8a16_matmul_plain(x, w)
             for x, w in calls]
    lib = [int8pack_call(x, w) for x, w in calls]
    out = {"ms": graph_ms(run(kern), iters) / n,
           "eager_ms": cuda_ms(run(kern), iters) / n,
           "plain_ms": cuda_ms(run(plain), iters) / n,
           "library_ms": (graph_ms(run([f for f, _ in lib]), iters) / n
                          if lib[0][0] is not None else None),
           "bf16_ms": graph_ms(run([bf16_matmul_call(x, w)
                                    for x, w in calls]), iters) / n}
    costs = [w8a16_cost(x.shape[0], x.shape[1], w.n) for x, w in calls]
    out["bound_ms"], out["bound_by"] = bound_ms(
        sum(c[0] for c in costs) / n, sum(c[1] for c in costs) / n,
        PEAK_BF16_FLOPS)
    lib_note = (f"{out['library_ms']:.4f} (torch._weight_int8pack_mm, bf16 "
                f"scales, graph)" if out["library_ms"] is not None
                else f"none (torch._weight_int8pack_mm: {lib[0][1]})")
    print(f"[kernel] w8a16 {label}: kernel_ms={out['ms']:.4f} (graph; eager "
          f"call {out['eager_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
          f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) library_ms="
          f"{lib_note} bf16_matmul_ms={out['bf16_ms']:.4f} (x @ the weight "
          f"dequantized to bf16 beforehand, graph) [{card}]")
    return out


def w8a16_plan_note(m, w) -> str:
    """A W8A16 product's route and tiling (``quant.product_plan``)."""
    from t5gemma_tts_tpu_torch.ops import quant

    p = quant.product_plan(m, w)
    return (f"route {p['route']} ni={p['ni']} rowtiles={p['rowtiles']} "
            f"ntiles={p['ntiles']} ktiles={p['ktiles']} splits={p['splits']}"
            f" per_sm={p['per_sm']}")


def phase_w8a16_shapes(card: str, iters: int) -> float:
    """Kernel 6 against its plain version from one row to two row tiles
    (M = 1, 2, 4, 5, 16, 17, 260): at an odd width (N = 1001) and a depth
    that is no multiple of the 128-level K tile (K = 2320), at the main
    path's K = 9216 (down) and at N = 65541 (the head's w2), f32 and bf16
    activations and outputs; the bf16 products up to 16 rows timed, with
    their plan."""
    from t5gemma_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    ms_all = (1, 2, 4, 5, 16, 17, 260)
    for k, n in ((2320, 1001), (9216, 2304), (2304, 65541)):
        w = quant.quantize_weight(
            torch.randn((k, n), generator=g, device=dev) * 0.05, act_bits=16)
        times = []
        for m in ms_all:
            x = torch.randn((m, k), generator=g, device=dev) * 2.0
            for xd in (x, x.to(torch.bfloat16)):
                worst = max(worst, check_w8a16(f"K={k} N={n} M={m}", xd, w))
            if m <= 16:
                xb = x.to(torch.bfloat16)
                k_ms = graph_ms(lambda: quant.w8a16_matmul(xb, w),
                                max(iters // 2, 2))
                times.append(f"M={m}: {k_ms:.4f} ({w8a16_plan_note(m, w)})")
        print(f"[kernel] w8a16 K={k} N={n} (M = {list(ms_all)}; f32 and "
              f"bf16 x and out): f32 within {W8A16_REL_FRO:g} relative, "
              f"bf16 its f32 rounded and within 1 ulp; ms (graph): "
              f"{'; '.join(times)} [{card}]")
    print(f"[kernel] w8a16 shape edges: max_abs_err={worst:.3e} [{card}]")
    return worst


def phase_w8a16_products(card: str, run: dict, iters: int) -> tuple:
    """Every W8A16 product of a main-path run (:func:`run_products`: the
    head's w1 and w2 at M = B, the six layer products of the prefill at
    M = B x (prompt width + 1) and of a step at M = B, cross K/V at M = B x
    text width) against its plain version on the run's weights, each timed
    with its route and plan. Returns the largest f32 error and one record
    per product."""
    from t5gemma_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    worst, records = 0.0, []
    for name, m, w in run_products(run):
        k = w.values.shape[-1]
        x = (torch.randn((m, k), generator=gen, device=dev) * 2.0).to(
            torch.bfloat16)
        err = check_w8a16(name, x, w)
        worst = max(worst, err)
        out = time_w8a16([(x, w)], card, f"{run['tag']} {name} [{m}x{k}]x[{k}x"
                         f"{w.n}] ({w8a16_plan_note(m, w)}): max_abs_err="
                         f"{err:.3e} (f32 within {W8A16_REL_FRO:g} relative, "
                         f"bf16 its f32 rounded and within 1 ulp)", iters)
        plan = quant.product_plan(m, w)
        records.append(dict(run=run["tag"], name=name, M=m, K=k, N=w.n,
                            route=plan["route"], splits=plan["splits"],
                            **{key: out[key] for key in
                               ("ms", "bound_ms", "library_ms", "bf16_ms")}))
    return worst, records


def w8a16_step_timing(pipe, card: str, batch: int, iters: int) -> dict:
    """One decode step's W8A16 products at the main path's shapes, on its
    own weights: the six products of each of the 26 layers and the head's
    w1 and w2, all at M = B, bf16 activations. One row per distinct shape
    (the six layer products of layer 0, then the head's w1 and w2): its
    route and plan, ms (graph), bound and bf16 yardstick; then the step's
    158 products in one graph, mean per launch."""
    from t5gemma_tts_tpu_torch.models.t5gemma import layer_params
    from t5gemma_tts_tpu_torch.ops import quant

    dev = pipe.device
    params = pipe.params
    g = torch.Generator(device=dev).manual_seed(13)
    xs = {}

    def x_for(w):
        k = w.values.shape[-1]
        if k not in xs:
            xs[k] = torch.randn((batch, k), generator=g, device=dev).to(
                torch.bfloat16)
        return xs[k], w

    calls, names = [], []
    layers = params["decoder"]["layers"]
    for li in range(pipe.cfg.backbone.decoder.num_layers):
        lay = layer_params(layers, li)
        for blk, nm in (("self_attn", "qkv"), ("self_attn", "o"),
                        ("cross_attn", "q"), ("cross_attn", "o"),
                        ("mlp", "gate_up"), ("mlp", "down")):
            calls.append(x_for(lay[blk][nm]))
            names.append(f"{blk}.{nm}")
    calls += [x_for(params["head"][nm]) for nm in ("w1", "w2")]
    names += ["head w1", "head w2"]
    rows = calls[:6] + calls[-2:]
    worst = max(check_w8a16("main-path step", x, w) for x, w in rows)
    products = []
    for name, (x, w) in zip(names[:6] + names[-2:], rows):
        m, k = x.shape
        k_ms = graph_ms(lambda: quant.w8a16_matmul(x, w), iters)
        b_ms, by = bound_ms(*w8a16_cost(m, k, w.n), PEAK_BF16_FLOPS)
        bf_ms = graph_ms(bf16_matmul_call(x, w), iters)
        products.append(dict(name=name, M=m, K=k, N=w.n, ms=k_ms,
                             bound_ms=b_ms, bf16_ms=bf_ms,
                             plan=w8a16_plan_note(m, w)))
        print(f"[kernel] w8a16 main-path step {name} [{m}x{k}]x[{k}x{w.n}]: "
              f"kernel_ms={k_ms:.4f} (graph) "
              f"bound_ms={b_ms:.5f} ({by}) bf16_matmul_ms={bf_ms:.4f} "
              f"({w8a16_plan_note(m, w)}) [{card}]")
    out = time_w8a16(calls, card, f"main-path step (B={batch}, the 158 "
                     f"products of one step: 6 x 26 layers + the head's "
                     f"two; mean per launch)", iters)
    out["max_abs_err"] = worst
    out["products"] = products
    return out


def fused_args(args: dict) -> dict:
    """An :func:`attention_case` (two segments, the in-flight token) as the
    v1 kernel's arguments."""
    return dict(q=args["q"], k_cur=args["k_cur"], v_cur=args["v_cur"],
                prompt_k_pages=args["a_k_pages"],
                prompt_v_pages=args["a_v_pages"],
                gen_k_pages=args["b_k_pages"], gen_v_pages=args["b_v_pages"],
                prompt_lengths=args["a_lengths"],
                gen_lengths=args["b_lengths"],
                prompt_page_indices=args["a_page_indices"],
                gen_page_indices=args["b_page_indices"])


def phase_fused_attention(card: str, iters: int) -> dict:
    """The v1 fused self-attention (kernel 7) against its plain version at
    the 2b-2b head shapes (hd 256, 8 query heads, 4 kv heads) and at hd 16
    (G 2), bf16 and e4m3 pages, soft cap 50 and none, with a row of prompt
    length 0 and a row of generation length 0, page tables at layer 1 of a
    two-layer buffer. Tolerance as kernel 1."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(14)
    dev = torch.device("cuda")
    worst = {}
    for tag in ("bf16", "e4m3"):
        for name, spec in (
                (f"hd256/{tag}", dict(b=4, h=8, hkv=4, hd=256,
                                      a_lens=[0, 128, 165, 256],
                                      b_lens=[7, 0, 129, 320], pp_a=2,
                                      pp_b=3)),
                (f"hd16-g2/{tag}", dict(b=3, h=4, hkv=2, hd=16,
                                        a_lens=[0, 100, 0],
                                        b_lens=[7, 0, 0], pp_a=2, pp_b=2))):
            base = attention_case(rng, device=dev, quant=False,
                                  f8=tag == "e4m3", layers=2, li=1,
                                  include_current=True, **spec)
            args = fused_args(base)
            for cap in (50.0, None):
                got = fa.fused_decode_attention(**args,
                                                attn_logits_soft_cap=cap)
                want = fa.fused_decode_attention_plain(
                    **args, attn_logits_soft_cap=cap)
                torch.cuda.synchronize()
                err = check_close(f"fused_decode_attention {name} cap {cap}",
                                  got, want)
                worst[tag] = max(worst.get(tag, 0.0), err)
            k_ms = cuda_ms(lambda: fa.fused_decode_attention(
                **args, attn_logits_soft_cap=50.0), iters)
            p_ms = cuda_ms(lambda: fa.fused_decode_attention_plain(
                **args, attn_logits_soft_cap=50.0), iters)
            b_ms, by = bound_ms(*attention_bytes_ops(base, True, False))
            print(f"[kernel] fused_decode_attention {name} (caps 50 and "
                  f"none): max_abs_err={worst[tag]:.3e} (tol {TOL_ABS:g} abs"
                  f" + {TOL_REL:g} rel) kernel_ms={k_ms:.4f} plain_ms="
                  f"{p_ms:.4f} bound_ms={b_ms:.5f} ({by}) library_ms=none "
                  f"(no PyTorch call computes soft-capped paged GQA) "
                  f"{plan_note(attention_plan(base))} [{card}]")
        worst[tag] = max(worst[tag], phase_fused_split_edges(card, rng, tag))
    return worst


# Kernel 7 at the edges of its split plan (prompt = segment A, generation =
# segment B): lengths that leave splits empty, prompts of length 0 (no
# clamp) and a row whose only key is the in-flight token; 36 rows over a
# prompt and a generation page (one split a page); one row over two pages
# (chunk 4, the most splits); every prompt empty.
FUSED_SPLIT_EDGES = [
    ("edges", dict(b=4, a_lens=[0, 1, 127, 128], b_lens=[129, 0, 255, 256],
                   pp_a=2, pp_b=2)),
    ("one-split", dict(b=36, a_lens=[(5 * i) % 129 for i in range(36)],
                       b_lens=[(11 * i) % 129 for i in range(36)], pp_a=1,
                       pp_b=1)),
    ("widest", dict(b=1, a_lens=[0], b_lens=[45], pp_a=1, pp_b=1)),
    ("empty-prompt", dict(b=4, a_lens=[0, 0, 0, 0], b_lens=[0, 1, 128, 200],
                          pp_a=1, pp_b=2)),
]


def phase_fused_split_edges(card: str, rng, tag: str) -> float:
    """Kernel 7 at :data:`FUSED_SPLIT_EDGES` against its plain version
    (bf16 or e4m3 pages, 2b-2b heads, soft cap 50 and none)."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    worst = 0.0
    for name, spec in FUSED_SPLIT_EDGES:
        base = attention_case(rng, device=torch.device("cuda"), h=8, hkv=4,
                              hd=256, quant=False, f8=tag == "e4m3",
                              layers=1, li=0, include_current=True, **spec)
        args = fused_args(base)
        for cap in (50.0, None):
            got = fa.fused_decode_attention(**args, attn_logits_soft_cap=cap)
            want = fa.fused_decode_attention_plain(
                **args, attn_logits_soft_cap=cap)
            torch.cuda.synchronize()
            worst = max(worst, check_close(
                f"fused_decode_attention split {name}/{tag} cap {cap}", got,
                want))
        print(f"[kernel] fused_decode_attention split edge {name}/{tag} "
              f"(caps 50 and none): max_abs_err={worst:.3e} (tol "
              f"{TOL_ABS:g} abs + {TOL_REL:g} rel) "
              f"{plan_note(attention_plan(base))} [{card}]")
    return worst


def fused_step_timing(card: str, prompt_len: int, gen_len: int, batch: int,
                      gen_slab: int, iters: int, f8: bool = False) -> dict:
    """One decode step's 26 v1-kernel launches (self-attention of each
    layer) at the main path's cache shapes, kernel against plain version."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(15)
    pp_b = gen_slab // PAGE
    base = attention_case(
        rng, device=torch.device("cuda"), b=batch, h=8, hkv=4, hd=256,
        quant=False, f8=f8, a_lens=[prompt_len] * batch,
        b_lens=[gen_len] * batch, pp_a=1, pp_b=pp_b, layers=MODEL_LAYERS,
        li=0, include_current=True)
    args = fused_args(base)
    calls = [dict(args, prompt_page_indices=args["prompt_page_indices"]
                  + li * batch,
                  gen_page_indices=args["gen_page_indices"]
                  + li * batch * pp_b) for li in range(MODEL_LAYERS)]
    worst = max(check_close("v1 main-path shapes", fa.fused_decode_attention(
        **a, attn_logits_soft_cap=50.0), fa.fused_decode_attention_plain(
        **a, attn_logits_soft_cap=50.0)) for a in calls[:2])

    def run(fn):
        return lambda: [fn(**a, attn_logits_soft_cap=50.0) for a in calls]

    n = len(calls)
    out = {"ms": graph_ms(run(fa.fused_decode_attention), iters) / n,
           "eager_ms": cuda_ms(run(fa.fused_decode_attention), iters) / n,
           "plain_ms": cuda_ms(run(fa.fused_decode_attention_plain),
                               iters) / n,
           "max_abs_err": worst, "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound_ms(
        *attention_bytes_ops(base, True, False))
    out["splits"] = {"self": attention_plan(base)}
    print(f"[kernel] fused_decode_attention main-path step (B={batch}, "
          f"prompt {prompt_len}, gen {gen_len}, {'e4m3' if f8 else 'bf16'} "
          f"pages; mean of {n} launches): kernel_ms={out['ms']:.4f} (graph; "
          f"eager {out['eager_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
          f"bound_ms={out['bound_ms']:.5f} ({out['bound_by']}) "
          f"max_abs_err={worst:.3e} {plan_note(out['splits']['self'])} "
          f"[{card}]")
    check_wave("fused_decode_attention", out["splits"])
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the port's main path
# ---------------------------------------------------------------------------


def char_tokenizer(vocab: int):
    def encode(text):
        return [3 + (ord(c) % (vocab - 10)) for c in text]
    return encode


def build_pipeline(cfg, ccfg, device, seed, init_device=None, int8=False,
                   int4=False, w8a16=False, encoder=False):
    """A pipeline on ``device`` with seeded random weights, made on
    ``init_device`` (default: ``device``); ``int8`` / ``int4`` quantize its
    decode weights on ``device``, and so does ``w8a16`` by the W8A16 route
    (``quantize_params_for_decode(fuse_for_decode(params), act_bits=16)``,
    then ``TTSPipeline(params, fuse_matmuls=False)``); ``encoder`` adds the
    codec's encoder weights (voice cloning). The CPU's and the card's
    generators draw different numbers from one seed, so two pipelines that
    must hold the same weights make them on one device."""
    from t5gemma_tts_tpu_torch.codec.audio_tokenizer import AudioTokenizer
    from t5gemma_tts_tpu_torch.codec.model import (init_decoder_params,
                                                   init_encoder_params_for)
    from t5gemma_tts_tpu_torch.device import tree_to
    from t5gemma_tts_tpu_torch.inference.pipeline import TTSPipeline
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.models.t5gemma import fuse_for_decode
    from t5gemma_tts_tpu_torch.ops.quant import quantize_params_for_decode

    init_device = init_device or device
    params = voice.init_params(seed, cfg, device=init_device)
    cparams = init_decoder_params(seed + 1, ccfg, device=init_device)
    if encoder:
        cparams.update(init_encoder_params_for(seed + 2, ccfg,
                                               device=init_device))
    if w8a16:
        params = quantize_params_for_decode(fuse_for_decode(
            tree_to(params, torch.device(device))), act_bits=16)
    return TTSPipeline(params, cfg, char_tokenizer(cfg.text_vocab_size),
                       AudioTokenizer(cparams, ccfg, device=device),
                       fuse_matmuls=not w8a16, device=device, int8=int8,
                       int4=int4)


@contextlib.contextmanager
def attn_mode(mode):
    """``T5G_FUSED_ATTN`` set to ``mode`` (None: left as it is) for the
    block, then restored; an error inside propagates."""
    old = os.environ.get("T5G_FUSED_ATTN")
    if mode is not None:
        os.environ["T5G_FUSED_ATTN"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("T5G_FUSED_ATTN", None)
        else:
            os.environ["T5G_FUSED_ATTN"] = old


def tiny_setup():
    """The tiny reference model's config (the paged cache inside the
    sliding window) and its two requests."""
    import dataclasses

    from t5gemma_tts_tpu_torch.config import backbone_preset, tiny_voice_config
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    bb = backbone_preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    # a short duration tail keeps the paged cache inside the window
    cfg = tiny_voice_config(backbone=dataclasses.replace(
        bb, encoder=dims, decoder=dims), extra_cutoff=0.5)
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in (("hello world", 0.4), ("a test of the port", 0.6))]
    return cfg, reqs


@contextlib.contextmanager
def eager_engine():
    """TTSPipeline decodes through the eager loop (``engine.decode_tokens``)
    for the block instead of the graphed one, so that one process compares
    the two on the same pipeline."""
    from t5gemma_tts_tpu_torch.decode import engine

    graphed = engine.graphed_decoder

    def eager(cfg, dcfg):
        return lambda params, *args: engine.decode_tokens(params, cfg, dcfg,
                                                          *args)

    engine.graphed_decoder = eager
    try:
        yield
    finally:
        engine.graphed_decoder = graphed


SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)


def phase_reference(devices=("cpu", "cuda"), weights="f32",
                    kv_cache="paged", mode=None, sampled=False) -> dict:
    """Tiny f32 model: paged (or dense) decode on the card == on the CPU,
    greedy or ``sampled`` (top-k 8, top-p 0.9, T 0.8: the draws are a hash
    of (seed, step), the same on both devices), with ``T5G_FUSED_ATTN`` =
    ``mode`` where given. The card serves through the graphed loop, and its
    eager loop runs too: the two must give the same tokens; the CPU runs
    the eager loop. Returns the card's graphed run's kernel launches."""
    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config
    from t5gemma_tts_tpu_torch.config import DecodeConfig

    cfg, reqs = tiny_setup()
    dcfg = DecodeConfig(kv_cache=kv_cache,
                        **(SAMPLED if sampled else dict(top_k=1)))
    out, logits, tokens, launches = {}, {}, {}, {}
    for device in devices:
        pipe = build_pipeline(cfg, tiny_codec_config(), device, seed=0,
                              init_device="cpu", int8=weights == "int8",
                              int4=weights == "int4",
                              w8a16=weights == "w8a16")
        logits[device], tokens[device] = {}, {}
        with attn_mode(mode):
            def run():
                return pipe.synthesize_batch(reqs, dcfg, seed=0, quiet=True)

            if device == "cuda":
                graphed, _, launches = _counted(run)
                with eager_engine():
                    out[device] = _recorded(run, logits[device],
                                            tokens[device])
                for r, (rg, re) in enumerate(zip(graphed, out[device])):
                    if not np.array_equal(rg.gen_frames, re.gen_frames):
                        raise AssertionError(
                            f"row {r}: graphed {rg.gen_frames} != eager "
                            f"{re.gen_frames} on the card")
            else:
                out[device] = _recorded(run, logits[device], tokens[device])
    worst, partings = 0.0, []
    for r, (rc, rg) in enumerate(zip(out[devices[0]], out[devices[-1]])):
        if np.array_equal(rc.gen_frames, rg.gen_frames):
            worst = max(worst, float(np.abs(rc.wav - rg.wav).max()))
        elif weights == "w8a16" or sampled:
            partings.append(near_tie_parting(
                r, *(logits[d] for d in devices), *(tokens[d]
                                                    for d in devices)))
        else:
            raise AssertionError(f"greedy tokens differ: cpu {rc.gen_frames} "
                                 f"cuda {rg.gen_frames}")
    if worst > 1e-4:
        raise AssertionError(f"tiny wav differs from the CPU by {worst:.3e}")
    mode_note = f" T5G_FUSED_ATTN={mode}" if mode is not None else ""
    equal = len(out[devices[-1]]) - len(partings)
    print(f"[reference] tiny {weights}-weight "
          f"{'sampled' if sampled else 'greedy'} {kv_cache}{mode_note} "
          f"decode: the card's graphed and eager loops give the same tokens; "
          f"tokens equal on card and CPU for {equal} of "
          f"{len(out[devices[-1]])} rows "
          f"({[len(r.gen_frames) for r in out[devices[-1]]]} frames), "
          f"wav max abs diff {worst:.3e} over those (tol 1e-4)"
          f"{''.join('; ' + p for p in partings)}; card launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_segments(devices=("cpu", "cuda")) -> None:
    """Tiny f32 model, sampled, paged: prefill + run_segment slices (5, 11,
    the buffer's end) through graphed_segment_fns on the card == one
    graphed decode == the CPU's eager segments."""
    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine

    cfg, reqs = tiny_setup()
    got = {}
    for device in devices:
        pipe = build_pipeline(cfg, tiny_codec_config(), device, seed=0,
                              init_device="cpu")
        inputs, max_frames = planned_inputs(pipe, reqs)
        x, x_lens, prompt, plens, targets = inputs
        dcfg = DecodeConfig(kv_cache="paged", max_frames=max_frames,
                            **SAMPLED)
        prefill_fn, segment_fn = engine.graphed_segment_fns(cfg, dcfg)
        state = prefill_fn(pipe.params, x, x_lens, prompt, plens, targets)
        for until in (5, 11, max_frames):
            state = segment_fn(pipe.params, state, x_lens, plens, targets, 3,
                               until)
        whole = engine.graphed_decoder(cfg, dcfg)(pipe.params, *inputs, 3)
        if not (torch.equal(state.tokens, whole.tokens)
                and int(state.step) == whole.steps):
            raise AssertionError(f"{device}: segments {state.tokens} != one "
                                 f"decode {whole.tokens}")
        got[device] = (whole.tokens.cpu(), whole.steps)
    first, last = got[devices[0]], got[devices[-1]]
    if not torch.equal(first[0], last[0]):
        raise AssertionError(f"sampled segments: {devices[0]} {first[0]} "
                             f"{devices[-1]} {last[0]}")
    print(f"[reference] tiny f32 sampled paged: run_segment slices (5, 11, "
          f"{max_frames}) == one decode, graphed on the card and eager on "
          f"the CPU, and the two devices agree ({last[1]} steps)")


def phase_streams() -> None:
    """Segment streams on the card keep their own state: two prefill +
    run_segment streams of one bucket, interleaved (5, 11, the buffer's
    end), with a one-shot graphed_decoder request between their segments,
    each token-equal to its own one-shot decode (engine.decode_tokens);
    then again with engine.MAX_SESSIONS lowered to 1 and the one-shot
    request in another bucket, so that it evicts the streams' session and
    each next segment captures it anew."""
    import dataclasses

    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    cfg, reqs = tiny_setup()
    pipe = build_pipeline(cfg, tiny_codec_config(), "cuda", seed=0,
                          init_device="cpu")
    other_reqs = [Request(target_text=t, target_duration=r.target_duration,
                          lang="en")
                  for t, r in zip(("a second stream", "of the same bucket"),
                                  reqs)]
    (ia, frames_a), (ib, frames_b) = (planned_inputs(pipe, rs)
                                      for rs in (reqs, other_reqs))
    if [t.shape for t in ia] != [t.shape for t in ib] or frames_a != frames_b:
        raise AssertionError("the two streams' requests are not one bucket")
    dcfg = DecodeConfig(kv_cache="paged", max_frames=frames_a, **SAMPLED)
    streams = [(ia, 3), (ib, 8)]
    wants = [engine.decode_tokens(pipe.params, cfg, dcfg, *i, sd)
             for i, sd in streams]
    limit = engine.MAX_SESSIONS
    left = []
    try:
        for max_sessions in (limit, 1):
            engine.MAX_SESSIONS = max_sessions
            engine.release_sessions()
            other = dcfg if max_sessions > 1 else dataclasses.replace(
                dcfg, top_k=4)
            one_shot_want = engine.decode_tokens(pipe.params, cfg, other,
                                                 *ib, 5)
            prefill_fn, segment_fn = engine.graphed_segment_fns(cfg, dcfg)
            states = [prefill_fn(pipe.params, *i) for i, _ in streams]
            for until in (5, 11, frames_a):
                for k, ((x, x_lens, _, plens, targets), sd) in enumerate(
                        streams):
                    states[k] = segment_fn(pipe.params, states[k], x_lens,
                                           plens, targets, sd, until)
                one_shot = engine.graphed_decoder(cfg, other)(
                    pipe.params, *ib, 5)
                if not torch.equal(one_shot.tokens, one_shot_want.tokens):
                    raise AssertionError("a one-shot request between the "
                                         "streams' segments differs")
            for k, (state, want) in enumerate(zip(states, wants)):
                if not (torch.equal(state.tokens, want.tokens)
                        and int(state.step) == want.steps):
                    raise AssertionError(
                        f"MAX_SESSIONS={max_sessions}: stream {k} differs "
                        f"from its one-shot decode")
            left.append(f"MAX_SESSIONS={max_sessions}: "
                        f"{len(engine.sessions())} session(s) left")
    finally:
        engine.MAX_SESSIONS = limit
        engine.release_sessions()
    print(f"[reference] tiny f32 sampled paged on the card: two run_segment "
          f"streams of one bucket, interleaved (5, 11, {frames_a}) with a "
          f"one-shot graphed_decoder request between segments, each "
          f"token-equal to its one-shot decode ({wants[0].steps} / "
          f"{wants[1].steps} steps); {'; '.join(left)}")


def reference_wavs(directory: str, rate: int, durations, seed: int) -> list:
    """Seeded recordings (a tone and its overtone plus noise, 16-bit PCM)
    of ``durations`` seconds at ``rate``, written under ``directory``."""
    from t5gemma_tts_tpu_torch.inference.audio_io import write_wav

    rng = np.random.default_rng(seed)
    paths = []
    for i, secs in enumerate(durations):
        t = np.arange(int(rate * secs)) / rate
        f0 = rng.uniform(0.02, 0.1) * rate
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 2.5 * f0 * t)
               + 0.05 * rng.standard_normal(t.size))
        path = os.path.join(directory, f"reference_{i}.wav")
        write_wav(path, wav.astype(np.float32), rate)
        paths.append(path)
    return paths


FLIP_MARGIN = 1e-4   # an FSQ code may round apart only this near a boundary


def encode_both(params_cpu, params_card, ccfg, path: str, card: str,
                tag: str) -> dict:
    """One recording encoded on the CPU and on the card (the same weights,
    bucket-padded with wav_lens, as AudioTokenizer.encode pads it): the
    codes must be equal but at frames whose pre-quantization value lies
    within FLIP_MARGIN of an FSQ rounding boundary on either device; those
    are counted. The card's encode wall ms (synchronized, the mean of 3
    after one warm-up) is printed."""
    from t5gemma_tts_tpu_torch.codec import audio_tokenizer as at
    from t5gemma_tts_tpu_torch.codec import fsq
    from t5gemma_tts_tpu_torch.codec import model as cm
    from t5gemma_tts_tpu_torch.inference.audio_io import load_for_encode

    wav = load_for_encode(path, ccfg.encode_sample_rate)
    s = wav.shape[0]
    padded = np.pad(wav, (0, at._bucket(s) - s))[None]
    codes, margins = {}, {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_card)):
        w = torch.from_numpy(padded).to(dev)
        lens = torch.tensor([s], device=dev)
        with torch.inference_mode():
            z = cm.encode_prior(params, ccfg, w, lens) \
                @ params["fsq"]["project_in"]["w"] \
                + params["fsq"]["project_in"]["b"]
            codes[dev] = fsq.codes_to_indices(
                ccfg.fsq, fsq.quantize(ccfg.fsq, z)).cpu()
            margins[dev] = fsq.rounding_margin(ccfg.fsq, z).cpu()
    near = torch.minimum(margins["cpu"], margins["cuda"]) < FLIP_MARGIN
    differ = codes["cpu"] != codes["cuda"]
    if bool((differ & ~near).any()):
        raise AssertionError(f"{tag} encode: codes differ on the CPU and the "
                             f"card away from a rounding boundary at frames "
                             f"{(differ & ~near).nonzero()[:8].tolist()}")
    tok = at.AudioTokenizer(params_card, ccfg, device="cuda")
    tok.encode(wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        tok.encode(wav)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 3
    print(f"[encode] {tag}: {s / ccfg.encode_sample_rate:.2f} s at "
          f"{ccfg.encode_sample_rate} Hz -> {codes['cpu'].shape[1]} codes, "
          f"equal on the CPU and the card but at {int(differ.sum())} "
          f"frame(s); {int(near.sum())} frame(s) within {FLIP_MARGIN:g} of "
          f"a rounding boundary; card encode wall {ms:.1f} ms "
          f"(AudioTokenizer.encode, synchronized) [{card}]")
    return {"codes": codes["cpu"].shape[1], "flips": int(differ.sum()),
            "near_boundary": int(near.sum()), "encode_ms": ms}


def tiny_clone_codec():
    """The tiny codec config with a 2-layer LSTM in its acoustic encoder."""
    import dataclasses

    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config

    ccfg = tiny_codec_config()
    return dataclasses.replace(ccfg, acoustic_cfg=dataclasses.replace(
        ccfg.acoustic_cfg, rnn_layers=2))


def phase_clone_reference(card: str, directory: str) -> None:
    """The tiny codec encoder (an LSTM of 2 layers) on the CPU and the card
    (:func:`encode_both`), then the tiny voice-clone pipeline (a reference
    and its transcript a request; repeat_prompt 0 and 1) greedy on both
    devices: the same prompts, generated and concat frames."""
    from t5gemma_tts_tpu_torch.codec import model as cm
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.device import tree_to
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    ccfg = tiny_clone_codec()
    refs = reference_wavs(directory, ccfg.encode_sample_rate, (30.0, 24.0),
                          seed=5)
    params = cm.init_decoder_params(1, ccfg, device="cpu")
    params.update(cm.init_encoder_params_for(2, ccfg, device="cpu"))
    enc = encode_both(params, tree_to(params, torch.device("cuda")), ccfg,
                      refs[0], card, "tiny codec (rnn_layers=2)")
    cfg, reqs = tiny_setup()
    clones = [Request(target_text=r.target_text, lang="en",
                      target_duration=r.target_duration, audio_path=ref,
                      prompt_transcript="the reference words",
                      repeat_prompt=i)
              for i, (r, ref) in enumerate(zip(reqs, refs))]
    dcfg = DecodeConfig(kv_cache="paged", top_k=1)
    out = {}
    for device in ("cpu", "cuda"):
        pipe = build_pipeline(cfg, ccfg, device, seed=0, init_device="cpu",
                              encoder=True)
        out[device] = ([pipe.plan_request(r).prompt for r in clones],
                       pipe.synthesize_batch(clones, dcfg, seed=0,
                                             quiet=True))
    (pc, rc), (pg, rg) = out["cpu"], out["cuda"]
    if pc != pg:
        raise AssertionError(f"tiny clone: prompts differ on the CPU and the "
                             f"card ({enc['flips']} code flip(s) at a "
                             f"rounding boundary in one encode)")
    for r, (a, b) in enumerate(zip(rc, rg)):
        if not (np.array_equal(a.gen_frames, b.gen_frames)
                and np.array_equal(a.concat_frames, b.concat_frames)):
            raise AssertionError(f"tiny clone row {r}: greedy tokens differ: "
                                 f"cpu {a.gen_frames} cuda {b.gen_frames}")
    print(f"[reference] tiny voice clone (greedy, paged): prompts "
          f"{[len(p) for p in pg]} tokens (repeat_prompt 0 and 1, y_sep), "
          f"generated {[len(r.gen_frames) for r in rg]} frames: prompts, "
          f"generated and concat frames equal on the CPU and the card")


def near_tie_parting(row, cpu_logits, card_logits, cpu_tokens,
                     card_tokens) -> str:
    """Where a row's card stream parts from its CPU stream, held to the
    parting protocol: W8A16 rounds f32 activations to bf16, so an
    activation that the two devices compute one f32 rounding apart next to
    a bf16 rounding midpoint rounds to neighbouring values, and the flip
    grows through the later layers; a sampled stream draws the same
    uniforms on both devices, but their logits differ in the last f32
    bits. Before the parting step the two devices' logits agree within a
    flip cascade's bound (REL_FRO_TOL_STACK); at it the CPU's margin
    between its token and the card's is within the gap between the
    devices' logits there (a near-tie). The card's logits come from its
    eager loop, which gives the graphed loop's tokens. Returns the
    report."""
    steps = sorted(set(cpu_tokens) & set(card_tokens))
    parted = [s for s in steps
              if int(cpu_tokens[s][row]) != int(card_tokens[s][row])]
    if not parted:
        raise AssertionError(f"row {row}: the frames differ but no sampled "
                             f"token does")
    t = parted[0]

    def rel(s):
        c = cpu_logits[s][row]
        return float((card_logits[s][row].cpu() - c).norm() / c.norm())

    before = max((rel(s) for s in steps if s < t), default=0.0)
    a, b = int(cpu_tokens[t][row]), int(card_tokens[t][row])
    ls, lp = cpu_logits[t][row], card_logits[t][row].cpu()
    margin, gap = float(ls[a] - ls[b]), float((lp - ls).abs().max())
    if before > REL_FRO_TOL_STACK or margin > gap:
        raise AssertionError(f"row {row} parts at step {t}: logits "
                             f"{before:.2e} apart before it (tol "
                             f"{REL_FRO_TOL_STACK:g}); CPU margin {margin:.3e}"
                             f" against a logit gap of {gap:.3e}")
    return (f"row {row} parts at step {t} at a near-tie: the devices' logits "
            f"apart by at most {before:.2e} (relative) before it; there the "
            f"CPU puts its token {a} {margin:.3e} above the card's {b}, "
            f"and their logits lie up to {gap:.3e} apart")


def planned_inputs(pipe, reqs):
    """The decode inputs TTSPipeline.synthesize_planned makes for
    ``reqs`` (int32 tensors on the pipeline's device) and the frame bucket
    it decodes them in."""
    planned = [pipe.plan_request(r) for r in reqs]
    tx, p_max, max_frames = pipe.widths(planned)
    b = len(planned)
    x = np.zeros((b, tx), np.int32)
    x_lens = np.zeros((b,), np.int32)
    prm = np.full((b, p_max), pipe.cfg.special.pad, np.int32)
    prm_lens = np.zeros((b,), np.int32)
    for i, p in enumerate(planned):
        t, pr = p.text[:tx], p.prompt[:p_max]
        x[i, :len(t)], x_lens[i] = t, len(t)
        prm[i, :len(pr)], prm_lens[i] = pr, len(pr)
    targets = np.asarray([p.target for p in planned], np.int32)
    return (tuple(torch.from_numpy(a).to(pipe.device)
                  for a in (x, x_lens, prm, prm_lens, targets)), max_frames)


def phase_spec_reference(weights: str, kv_cache: str) -> None:
    """Tiny f32 model: greedy speculative decode (k = 4, drafted from the
    CPU's sequential trace) on the card == on the CPU, and == the
    sequential trace."""
    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine, speculative

    cfg, reqs = tiny_setup()
    out, trace = {}, None
    for device in ("cpu", "cuda"):
        pipe = build_pipeline(cfg, tiny_codec_config(), device, seed=0,
                              init_device="cpu", int8=weights == "int8",
                              int4=weights == "int4")
        inputs, max_frames = planned_inputs(pipe, reqs)
        dcfg = DecodeConfig(top_k=1, kv_cache=kv_cache, max_frames=max_frames)
        if trace is None:
            trace = engine.decode_tokens(pipe.params, cfg, dcfg, *inputs, 0)
        out[device] = speculative.decode_tokens_speculative(
            pipe.params, cfg, dcfg, *inputs, 0,
            speculative.trace_draft_fn(trace.tokens.to(pipe.device), SPEC_K),
            SPEC_K)
    cpu, gpu = out["cpu"], out["cuda"]
    if not (torch.equal(cpu.tokens, gpu.tokens.cpu())
            and torch.equal(cpu.gen_lens, gpu.gen_lens.cpu())):
        raise AssertionError(f"speculative greedy tokens differ: cpu "
                             f"{cpu.tokens} cuda {gpu.tokens}")
    agree = float((cpu.tokens == trace.tokens).float().mean())
    print(f"[reference] tiny {weights}-weight greedy speculative {kv_cache} "
          f"decode (k={SPEC_K}): tokens equal on card and CPU "
          f"({gpu.gen_lens.tolist()} frames, {gpu.steps} steps in "
          f"{gpu.passes} passes), agreement with the sequential trace "
          f"{agree:.4f}")


def _counters():
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa
    from t5gemma_tts_tpu_torch.ops import quant

    return {"batch_paged_attention": fa.batch_paged_attention,
            "paged_flash_parts": pa.paged_flash_parts,
            "decode_stack": mk.decode_stack,
            "decode_layer": mk.decode_layer,
            "w8a8_matmul": quant.w8a8_matmul,
            "w4a8_matmul": quant.w4a8_matmul,
            "w8a16_matmul": quant.w8a16_matmul,
            "fused_decode_attention": fa.fused_decode_attention}


def _counted(fn):
    """(result, wall s, launches by kernel) of ``fn()``, counts set to 0
    just before and read just after."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return out, wall, {k: c.launches for k, c in counters.items()}


def _recorded(fn, store, tokens=None):
    """``fn()`` with the logits of every sampled step kept in ``store``
    (step -> [B, V] f32 on the device; a step sampled twice keeps its last
    logits, those of the emitted token) and, with ``tokens``, the sampled
    tokens there (step -> [B])."""
    from t5gemma_tts_tpu_torch.decode import engine

    sample = engine._candidate_sample

    def recording(cfg, dcfg, logits, step, *a, **k):
        store[int(step)] = logits.float().clone()
        out = sample(cfg, dcfg, logits, step, *a, **k)
        if tokens is not None:
            tokens[int(step)] = out[0].clone()
        return out

    engine._candidate_sample = recording
    try:
        return fn()
    finally:
        engine._candidate_sample = sample


def parting(seq_tokens, spec_tokens, seq_logits, spec_logits) -> tuple:
    """Where the speculative stream first parts from the sequential one
    (row 0), and whether it parts at a near-tie: the two engines' logits
    before it (largest relative difference, returned with the report), and
    at it the sequential engine's margin between its token and the
    speculative engine's token against how far the two engines' logits lie
    apart there."""
    differ = (seq_tokens[0] != spec_tokens[0]).nonzero()
    if not len(differ):
        return "never parts", 0.0
    t = int(differ[0])

    def rel(s):
        return float((spec_logits[s] - seq_logits[s]).norm()
                     / seq_logits[s].norm())

    before = max((rel(s) for s in range(t)), default=0.0)
    a, b = int(seq_tokens[0, t]), int(spec_tokens[0, t])
    ls, lp = seq_logits[t][0], spec_logits[t][0]
    return (f"parts at step {t}: logits apart by at most {before:.2e} "
            f"(relative) before it, {rel(t):.2e} at it; there the sequential "
            f"engine puts its token {a} {float(ls[a] - ls[b]):.3e} above the "
            f"speculative engine's {b}, which puts its token "
            f"{float(lp[b] - lp[a]):.3e} above; the largest logit gap "
            f"between the engines there is "
            f"{float((lp - ls).abs().max()):.3e}"), before


def phase_speculative(card: str, pipe, tag: str, kv_cache: str, seed: int,
                      accept: float = 0.9) -> dict:
    """The JAX bench's speculative probe on the port: the 4.0 s request at
    batch 1, greedy, k = 4. The sequential engine first; then the
    speculative engine drafted from the sequential trace (its own trace
    and the agreement), then drafted from its own trace corrupted to
    ``accept`` per-token acceptance (numpy seed 0), timed."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine, speculative
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    cfg = pipe.cfg
    layers = cfg.backbone.decoder.num_layers
    reqs = [Request(target_text=TEXTS[-1], target_duration=DURATIONS[-1],
                    lang="en")]
    inputs, max_frames = planned_inputs(pipe, reqs)
    dcfg = DecodeConfig(kv_cache=kv_cache, top_k=1, top_p=1.0,
                        temperature=1.0, max_frames=max_frames, seed=seed)

    # the sequential run keeps each step's logits (one device copy of the
    # [1, V] row per step) to show where the streams part
    seq_logits, boot_logits = {}, {}
    seq, seq_s, seq_n = _counted(lambda: _recorded(
        lambda: engine.decode_tokens(pipe.params, cfg, dcfg, *inputs, seed),
        seq_logits))

    def spec(trace):
        draft = speculative.trace_draft_fn(trace, SPEC_K)
        return speculative.decode_tokens_speculative(
            pipe.params, cfg, dcfg, *inputs, seed, draft, SPEC_K)

    boot = _recorded(lambda: spec(seq.tokens), boot_logits)
    agree = float((boot.tokens == seq.tokens).float().mean())
    parted, apart = parting(seq.tokens, boot.tokens, seq_logits, boot_logits)
    del seq_logits, boot_logits
    # until they part, both engines compute the same logits but for sums in
    # another order, whose rounding flips cascade through 26 layers
    if apart > REL_FRO_TOL_STACK:
        raise AssertionError(f"{tag}: the speculative logits are {apart:.2e} "
                             f"from the sequential ones before the streams "
                             f"part (tol {REL_FRO_TOL_STACK:g})")
    own = boot.tokens.cpu().numpy()
    corrupt = np.random.default_rng(0).random(own.shape) > accept
    bad = (own + 1) % cfg.audio_vocab_size
    drafted = torch.from_numpy(np.where(corrupt, bad, own)).to(pipe.device)
    out, spec_s, spec_n = _counted(lambda: spec(drafted))
    # the verify pass sums a token's logits in another order at another
    # chain position, so a near-tie may resolve otherwise with another draft
    draft_agree = float((out.tokens == boot.tokens).float().mean())

    steps, passes = out.steps, out.passes
    if kv_cache == "paged_f8":
        ok = (seq_n["batch_paged_attention"] == 2 * layers * seq.steps
              and spec_n["paged_flash_parts"] == 3 * layers * passes
              and spec_n["batch_paged_attention"] == 0
              and spec_n["decode_stack"] == 0)
    else:
        ok = (seq_n["decode_stack"] == seq.steps
              and spec_n["decode_stack"] == passes
              and spec_n["batch_paged_attention"] == 0
              and spec_n["paged_flash_parts"] == 0
              and spec_n["w4a8_matmul"] >= passes)
    if not ok:
        raise AssertionError(f"{tag}: launches sequential {seq_n} over "
                             f"{seq.steps} steps, speculative {spec_n} over "
                             f"{passes} passes")
    if not steps / passes > 1:
        raise AssertionError(f"{tag}: {steps / passes} tokens per pass")
    step_ms = 1e3 * seq_s / seq.steps
    pass_ms = 1e3 * spec_s / passes
    ideal = sum(accept ** i for i in range(SPEC_K + 1))
    print(f"[spec/{tag}] 2b-2b batch 1, {kv_cache} cache, greedy, k={SPEC_K}"
          f": sequential {seq.steps} steps in {seq_s:.3f}s ({step_ms:.2f} ms "
          f"per step); speculative {steps} steps in {passes} passes = "
          f"{steps / passes:.3f} tokens per pass at {accept:g} draft "
          f"acceptance, {spec_s:.3f}s ({pass_ms:.2f} ms per pass); "
          f"verify_pass_cost_vs_step {pass_ms / step_ms:.3f}, speedup "
          f"{seq_s / spec_s:.3f}x (at the formula's {ideal:.3f} tokens per "
          f"pass for {accept:g} acceptance it would be "
          f"{ideal * step_ms / pass_ms:.3f}x); trace agreement with "
          f"sequential {agree:.4f}, with the bootstrap run "
          f"{draft_agree:.4f}; launches sequential {seq_n}, speculative "
          f"{spec_n} [{card}]")
    print(f"[spec/{tag}] the speculative stream (drafted from the sequential "
          f"trace) {parted} [{card}]")
    planned = [pipe.plan_request(r) for r in reqs]
    tx, p_max, _ = pipe.widths(planned)
    return {"pipe": pipe, "tag": tag, "batch": 1,
            "head_rows": [1, SPEC_K + 1], "steps": steps, "passes": passes,
            "seq_steps": seq.steps, "launches": spec_n, "seq_launches": seq_n,
            "enc_lens": [len(p.text) for p in planned],
            "gen_slab": -(-(max_frames + SPEC_K) // PAGE) * PAGE,
            "prefill_rows": p_max + 1, "cross_rows": tx}


TEXTS = ("Hello world, this is a test of the port.",
         "The quick brown fox jumps over the lazy dog.",
         "Speech synthesis on one card.",
         "Four requests decode in one batch.")
DURATIONS = (2.0, 2.5, 3.0, 4.0)
TRANSCRIPTS = ("This is how my voice sounds.",
               "A reference recording for the port.",
               "Cloned speech from a short prompt.",
               "The fourth speaker reads this line.")


def phase_main_path(card: str, seed: int, weights: str = "bf16",
                    batch: int = 4, pipe=None, mode=None,
                    ab: bool = True, refs=None) -> dict:
    """Requests through TTSPipeline at 2b-2b (the graphed decode loop): the
    four requests, or with ``batch=1`` the 4.0 s one alone; bf16 or W8A16
    (``weights="w8a16"``) weights and bf16 pages, or W8A8 (``"int8"``) or
    int4 (``"int4"``) weights and int8 pages; ``mode`` sets
    ``T5G_FUSED_ATTN`` for the run (bf16 weights, mode 1: the v1
    attention). ``pipe`` reuses a pipeline built for the same weights. The
    launch counts are set to 0 just before the run and read just after;
    each replay of the captured step adds the launches its capture
    recorded. With ``ab`` the same decode then runs graphed and eager
    (``graphed_vs_eager``). With ``refs`` (reference recordings, one a
    request) each request clones its recording's voice: the codec encodes
    it (``pipe``'s codec must hold encoder weights) and its transcript
    leads the text."""
    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    cfg = VoiceConfig()                      # 2b-2b preset, bf16
    ccfg = XCodec2Config()                   # full-width decoder
    kv_cache = "paged" if weights in ("bf16", "w8a16") else "paged_i8"
    tag = weights if batch == 4 else f"{weights} b{batch}"
    if mode is not None:
        tag += f" mode {mode}"
    if refs is not None:
        tag += " clone"
    if pipe is None:
        t0 = time.time()
        pipe = build_pipeline(cfg, ccfg, "cuda", seed,
                              int8=weights == "int8", int4=weights == "int4",
                              w8a16=weights == "w8a16")
        torch.cuda.synchronize()
        print(f"[main/{tag}] 2b-2b pipeline built on the card in "
              f"{time.time() - t0:.3f}s ({n_params(pipe.params) / 1e9:.2f} B "
              f"parameters, {torch.cuda.memory_allocated() / 1e9:.1f} GB "
              f"allocated)")
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(TEXTS, DURATIONS)][-batch:]
    if refs is not None:
        reqs = [Request(target_text=r.target_text,
                        target_duration=r.target_duration, lang="en",
                        audio_path=ref, prompt_transcript=tr)
                for r, ref, tr in zip(reqs, refs[-batch:],
                                      TRANSCRIPTS[-batch:])]
    dcfg = DecodeConfig(kv_cache=kv_cache, seed=seed)

    torch.cuda.reset_peak_memory_stats()
    with attn_mode(mode):
        results, wall, launches = _counted(
            lambda: pipe.synthesize_batch(reqs, dcfg, seed=seed))

    steps = results[0].steps
    # step bodies the card ran: the steps, a new session's eager warm-up
    # step and the no-op replays launched before the host read the end
    launched = results[0].launched_steps
    layers = cfg.backbone.decoder.num_layers
    n = launches
    unquantized = (n["decode_stack"] == n["w8a8_matmul"] == 0
                   and n["w4a8_matmul"] == 0)
    if mode == "1":                  # v1 self-attention, one-segment cross
        ok = (unquantized and n["w8a16_matmul"] == 0
              and n["fused_decode_attention"] == layers * launched
              and n["paged_flash_parts"] == layers * launched
              and n["batch_paged_attention"] == 0)
    elif weights in ("bf16", "w8a16"):
        w16 = w8a16_launches(layers, launched) if weights == "w8a16" else 0
        ok = (unquantized and n["w8a16_matmul"] == w16
              and n["batch_paged_attention"] == 2 * layers * launched
              and n["paged_flash_parts"] == n["fused_decode_attention"] == 0)
    else:
        ok = (n["decode_stack"] == launched and n["batch_paged_attention"] == 0
              and n["decode_layer"] == n["paged_flash_parts"] == 0
              and n["w8a16_matmul"] == n["fused_decode_attention"] == 0)
        if weights == "int8":        # the head's w1 and w2
            ok = (ok and n["w8a8_matmul"] >= 2 * launched
                  and n["w4a8_matmul"] == 0)
        else:                        # the head's w1 (int8) and w2 (int4)
            ok = (ok and n["w8a8_matmul"] >= launched
                  and n["w4a8_matmul"] >= launched)
    ok = ok and steps <= launched <= steps + 1 + engine.LOOKAHEAD
    if not ok:
        raise AssertionError(f"{tag} main path over {steps} steps "
                             f"({launched} launched): launches {launches}")
    hop = ccfg.hop_length
    frames = 0
    for r in results:
        if r.wav is None or not np.isfinite(r.wav).all():
            raise AssertionError("a waveform is missing or not finite")
        if len(r.wav) != len(r.gen_frames) * hop:
            raise AssertionError(f"wav length {len(r.wav)} != "
                                 f"{len(r.gen_frames)} frames x {hop}")
        frames += len(r.gen_frames)
    audio_s = frames / cfg.encodec_sr
    peak = torch.cuda.max_memory_allocated() / 1e9
    planned = [pipe.plan_request(r) for r in reqs]
    tx, p_max, _ = pipe.widths(planned)
    prompts = [len(p.prompt) for p in planned]
    print(f"[main/{tag}] {batch} request(s) ({kv_cache} cache, graphed; "
          f"prompts {prompts} tokens, bucket {p_max}): "
          f"{steps} decode steps ({launched} step bodies launched), "
          f"{frames} frames, {frames / wall:.2f} tokens/s, RTF "
          f"{audio_s / wall:.3f}x (audio s per wall s, decode+vocode "
          f"{wall:.2f}s), {1e3 * wall / steps:.2f} ms per step, launches "
          f"{launches}, peak {peak:.2f} GB allocated [{card}]")
    out = {"pipe": pipe, "tag": tag, "batch": batch, "launches": launches,
           "steps": steps, "tokens_per_s": frames / wall,
           "rtf": audio_s / wall, "step_ms": 1e3 * wall / steps,
           "enc_lens": [len(p.text) for p in planned],
           "gen_slab": max(pipe.frame_bucket(p) for p in planned),
           "prompts": prompts, "p_max": p_max,
           "prefill_rows": batch * (p_max + 1), "cross_rows": batch * tx}
    if ab:
        with attn_mode(mode):
            out["ab"] = graphed_vs_eager(pipe, reqs, dcfg, seed, tag, card)
    return out


def clone_setup(card: str, pipe, directory: str, seed: int) -> tuple:
    """Phase 4h's codec: seeded encoder weights at the full width of
    ``XCodec2Config()`` made on the card and added to ``pipe``'s codec,
    four reference recordings (``DURATIONS`` seconds at 16 kHz), and one of
    them encoded on the CPU and on the card (:func:`encode_both`). Returns
    (the recordings, the encoder weights, the encode report)."""
    from t5gemma_tts_tpu_torch.codec.model import init_encoder_params_for
    from t5gemma_tts_tpu_torch.device import tree_to

    tok = pipe.audio_tokenizer
    t0 = time.time()
    enc = init_encoder_params_for(seed + 2, tok.cfg, device="cuda")
    tok.params.update(enc)
    torch.cuda.synchronize()
    print(f"[main/clone] full-width XCodec2 encoder weights made on the card "
          f"in {time.time() - t0:.3f}s ({n_params(enc) / 1e6:.1f} M "
          f"parameters, f32) [{card}]")
    refs = reference_wavs(directory, tok.cfg.encode_sample_rate, DURATIONS,
                          seed=seed + 7)
    report = encode_both(tree_to(tok.params, torch.device("cpu")),
                         tok.params, tok.cfg, refs[2], card,
                         "full-width XCodec2Config()")
    return refs, enc, report


def graphed_vs_eager(pipe, reqs, dcfg, seed: int, tag: str,
                     card: str) -> dict:
    """The main path's decode (prefill + steps, no vocoder) on the same
    inputs, graphed (the bucket's session, captured by the main run) and
    eager (``engine.decode_tokens``): the tokens must be equal; each one's
    ms per step (wall less the prefill's, over the steps), the session's
    capture ms and bytes."""
    import dataclasses

    from t5gemma_tts_tpu_torch.decode import engine

    cfg = pipe.cfg
    inputs, max_frames = planned_inputs(pipe, reqs)
    dcfg = dataclasses.replace(dcfg, max_frames=max_frames)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        _, prefill_s = timed(lambda: engine.prefill(pipe.params, cfg, dcfg,
                                                    *inputs))
    graphed, graphed_s = timed(lambda: engine.graphed_decoder(cfg, dcfg)(
        pipe.params, *inputs, seed))
    session = engine.sessions()[-1]
    eager, eager_s = timed(lambda: engine.decode_tokens(
        pipe.params, cfg, dcfg, *inputs, seed))
    if not (torch.equal(graphed.tokens, eager.tokens)
            and torch.equal(graphed.gen_lens, eager.gen_lens)
            and graphed.steps == eager.steps):
        differ = (graphed.tokens != eager.tokens).nonzero()
        raise AssertionError(f"{tag}: graphed tokens differ from eager at "
                             f"(row, step) {differ[:8].tolist()}")
    steps = eager.steps
    res = dict(steps=steps, launched=graphed.launched_steps,
               prefill_ms=1e3 * prefill_s,
               eager_step_ms=1e3 * (eager_s - prefill_s) / steps,
               graphed_step_ms=1e3 * (graphed_s - prefill_s) / steps,
               capture_ms=session.capture_ms,
               session_bytes=session.state_bytes,
               pool_bytes=session.pool_bytes)
    print(f"[graph/{tag}] {steps} steps, tokens equal graphed and eager; "
          f"eager {res['eager_step_ms']:.3f} ms per step, graphed "
          f"{res['graphed_step_ms']:.3f} ms per step "
          f"({res['eager_step_ms'] / res['graphed_step_ms']:.2f}x; "
          f"{graphed.launched_steps} bodies launched, prefill "
          f"{res['prefill_ms']:.1f} ms taken off both), capture "
          f"{session.capture_ms:.1f} ms, session {session.state_bytes / 1e9:.3f}"
          f" GB of buffers + {session.pool_bytes / 1e9:.3f} GB graph pool "
          f"[{card}]")
    return res


def phase_profile(pipe, card: str, enc_lens, steps: int = 32,
                  kv_cache: str = "paged", weights: str = "bf16") -> dict:
    """Device time by kernel over a prefill and ``steps`` decode steps of
    the main path's batch (torch.profiler), graphed and eager, and the
    device's idle share of each one's wall time. In the graphed window the
    two-segment and v1 attention kernels' merge kernels seen by the
    profiler must not exceed their wrappers' counts (a replay adds what its
    capture recorded), nor be none where they count some; both are
    printed. Returns each form's wall, busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine

    cfg, dev = pipe.cfg, pipe.device
    b = len(enc_lens)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(
        3, cfg.text_vocab_size, (b, 64)).astype(np.int32)).to(dev)
    x_lens = torch.tensor(enc_lens, dtype=torch.int32, device=dev)
    prompt = torch.full((b, 64), cfg.special.pad, dtype=torch.int32,
                        device=dev)
    prompt_lens = torch.zeros((b,), dtype=torch.int32, device=dev)
    targets = torch.full((b,), 200, dtype=torch.int32, device=dev)
    dcfg = DecodeConfig(kv_cache=kv_cache, max_frames=steps)
    args = (x, x_lens, prompt, prompt_lens, targets, 0)
    forms = {"graphed": lambda: engine.graphed_decoder(cfg, dcfg)(
                 pipe.params, *args),
             "eager": lambda: engine.decode_tokens(pipe.params, cfg, dcfg,
                                                   *args)}
    res = {}
    for form, decode in forms.items():
        def run():
            out = decode()
            torch.cuda.synchronize()
            return out

        if form == "graphed":
            run()                    # the bucket's capture
        t0 = time.time()
        run()
        wall_ms = (time.time() - t0) * 1e3   # without the profiler's cost
        # device activity only: the rows read are kernels, and recording
        # every host op of a layer loop would add tens of seconds to the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, launches = _counted(run)
        rows = []
        for e in prof.key_averages():
            # kernels only: a CPU op's row repeats the time of its kernels
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                rows.append((dev_us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        # the union of the kernels' intervals: a kernel launched as a
        # programmatic dependent starts before its primary ends, and the
        # sum counts that overlap twice
        union_us, end = 0.0, float("-inf")
        for lo, hi in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
            if hi > end:
                union_us += hi - max(lo, end)
                end = hi
        merges = sum("t5g_split" in e.name and "merge_kernel" in e.name
                     for e in kernels)
        counted = (launches["batch_paged_attention"]
                   + launches["fused_decode_attention"])
        # the profiler may drop a few events at the window's edges, but
        # never adds any
        if form == "graphed" and kernels and (
                merges > counted or (counted and not merges)):
            raise AssertionError(
                f"profile {weights}: {merges} kernel 1/7 merge kernels ran in "
                f"the graphed window, the wrappers counted {counted}")
        idle = 1 - union_us / 1e3 / wall_ms
        res[form] = dict(wall_ms=wall_ms, busy_ms=union_us / 1e3, idle=idle)
        print(f"[profile] {form}: prefill + {steps} decode steps of the "
              f"2b-2b batch of {b} ({kv_cache} cache, {weights} weights): "
              f"wall {wall_ms:.1f} ms (unprofiled), device busy "
              f"{union_us / 1e3:.1f} ms (the union of the kernels' "
              f"intervals; their sum {busy_ms:.1f} ms), idle share "
              f"{idle:.3f}; kernel 1/7 merges in the window {merges}, "
              f"wrapper counts {counted} [{card}]")
        if not rows:
            print("[profile] torch.profiler recorded no device time")
        for ms, count, key in rows[:12 if form == "graphed" else 6]:
            print(f"[profile] {form} {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% "
                  f"x{count:<6d} {key[:90]}")
    print(f"[profile] {weights}: graphed wall {res['graphed']['wall_ms']:.1f}"
          f" ms vs eager {res['eager']['wall_ms']:.1f} ms "
          f"({res['eager']['wall_ms'] / res['graphed']['wall_ms']:.2f}x), "
          f"idle share {res['graphed']['idle']:.3f} vs "
          f"{res['eager']['idle']:.3f} [{card}]")
    return res


def n_params(tree) -> int:
    """Weights in a parameter tree, quantized ones counted by their
    levels."""
    from t5gemma_tts_tpu_torch.ops import quant

    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    if isinstance(tree, quant.Int4Weight):
        return 2 * tree.packed.numel()
    if isinstance(tree, quant.QuantWeight):
        return tree.values.numel()
    return tree.numel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as refdir:
        return run_all(args, refdir)


def run_all(args, refdir: str) -> int:
    """Every phase, in order (``refdir``: a directory for the reference
    recordings); raises on the first failure."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.ops import cuda_build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    start = t0 = time.time()

    def stamp(label):
        print(f"[time] {label} done at {time.time() - start:.1f}s")

    logs = cuda_build.build(verbose=True)
    print(f"[device] built {sorted(cuda_build.SOURCES)} in "
          f"{time.time() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[device] {name}: {line.strip()}")

    cfg = VoiceConfig()
    stamp("1 (build)")
    worst_attn = phase_kernel(card, args.iters)
    worst_parts = phase_paged_parts(card, args.iters)
    worst_layer = phase_decode_layer(card, cfg, args.iters)
    worst_layer4 = phase_decode_layer(card, cfg, args.iters, int4=True)
    worst_chain = phase_chain_layer(card, cfg, args.iters)
    worst16 = phase_w8a16_shapes(card, args.iters)
    worst_edges = phase_product_edges(card, args.iters)
    worst_fused = phase_fused_attention(card, args.iters)
    stamp("2 (kernels)")
    phase_reference()
    phase_reference(kv_cache="dense")
    phase_reference(sampled=True)
    phase_segments()
    phase_reference(weights="int8", kv_cache="paged_i8")
    phase_reference(weights="int4", kv_cache="paged_i8")
    phase_spec_reference("int4", "paged")
    phase_spec_reference("f32", "paged_f8")
    phase_reference(weights="w8a16")
    phase_reference(mode="0")
    phase_reference(mode="1")
    ref_f8 = phase_reference(kv_cache="paged_f8", mode="1")
    phase_streams()
    phase_clone_reference(card, refdir)
    step_iters = max(args.iters // 4, 2)
    stamp("3 (references)")

    main = phase_main_path(card, args.seed)
    prof = {"bf16": phase_profile(main["pipe"], card, main["enc_lens"])}
    timing = main_path_step_timing(
        card, prompt_len=1, gen_len=main["steps"] // 2,
        enc_lens=main["enc_lens"], gen_slab=main["gen_slab"],
        iters=step_iters)
    pipe16 = main.pop("pipe")          # phases 4g and 4e run it again

    # 4g: the same batch with the v1 self-attention (T5G_FUSED_ATTN=1)
    main1 = phase_main_path(card, args.seed, pipe=pipe16, mode="1")
    main1.pop("pipe")
    print(f"[main/bf16 mode 1 vs mode 2] RTF {main1['rtf']:.3f}x vs "
          f"{main['rtf']:.3f}x; tokens/s {main1['tokens_per_s']:.2f} vs "
          f"{main['tokens_per_s']:.2f}; ms per step {main1['step_ms']:.2f} "
          f"vs {main['step_ms']:.2f} [{card}]")
    with attn_mode("1"):
        prof["bf16 mode 1"] = phase_profile(pipe16, card, main1["enc_lens"],
                                            weights="bf16 mode 1")
    fused_timing = fused_step_timing(
        card, prompt_len=1, gen_len=main1["steps"] // 2, batch=4,
        gen_slab=main1["gen_slab"], iters=step_iters)
    fused_timing_f8 = fused_step_timing(
        card, prompt_len=1, gen_len=main1["steps"] // 2, batch=4,
        gen_slab=main1["gen_slab"], iters=step_iters, f8=True)
    cross_timing = cross_parts_timing(card, main1["enc_lens"], step_iters)
    stamp("4 and 4g (bf16)")

    # 4h: voice cloning at full width: the bf16 batch with a reference
    # recording and its transcript a request (prompt bucket 256), graphed
    # and eager; kernel 1 at the cloned prompt lengths
    refs, enc, encode_report = clone_setup(card, pipe16, refdir, args.seed)
    clone = phase_main_path(card, args.seed, pipe=pipe16, refs=refs)
    clone.pop("pipe")
    clone_pages = -(-(clone["p_max"] + 1) // PAGE)
    clone_timing = main_path_step_timing(
        card, prompt_len=[p + 1 for p in clone["prompts"]],
        gen_len=clone["steps"] // 2, enc_lens=clone["enc_lens"],
        gen_slab=clone["gen_slab"], iters=step_iters,
        prompt_pages=clone_pages)
    stamp("4h (bf16 clone)")
    main8 = phase_main_path(card, args.seed, "int8")
    worst8, prod8 = phase_products(card, main8, args.iters)
    prof["int8"] = phase_profile(main8["pipe"], card, main8["enc_lens"],
                                 kv_cache="paged_i8", weights="int8")
    timing8 = quant_step_timing(main8["pipe"], card, main8["steps"],
                                main8["enc_lens"], main8["gen_slab"],
                                iters=step_iters)
    # 4h, int8: the cloned batch at B = 4, its products (the prefill at
    # M = 4 x 257) and one decode_stack call at the cloned prompt lengths
    main8["pipe"].audio_tokenizer.params.update(enc)
    clone8 = phase_main_path(card, args.seed, "int8", pipe=main8["pipe"],
                             refs=refs, ab=False)
    worst8c, prod8c = phase_products(card, clone8, args.iters)
    timing8c = quant_step_timing(
        main8["pipe"], card, clone8["steps"], clone8["enc_lens"],
        clone8["gen_slab"], iters=step_iters,
        prompts=[p + 1 for p in clone8["prompts"]],
        prompt_slab=clone_pages * PAGE, parts=False)
    clone8.pop("pipe")

    stamp("4b (int8)")
    # 4c: int4 at batch 1, against int8 at batch 1 on the same request, in
    # turns (int8, int4, int4, int8)
    pipe8 = main8.pop("pipe")
    runs8 = [phase_main_path(card, args.seed, "int8", 1, pipe=pipe8,
                             ab=False)]
    main4 = phase_main_path(card, args.seed, "int4", 1)
    pipe4 = main4.pop("pipe")
    runs4 = [main4, phase_main_path(card, args.seed, "int4", 1, pipe=pipe4,
                                    ab=False)]
    runs8.append(phase_main_path(card, args.seed, "int8", 1, pipe=pipe8,
                                 ab=False))
    # the int8 decode_stack and head at the int4 run's batch-1 shapes, so
    # that the two weight formats' layer times compare
    quant_step_timing(pipe8, card, main4["steps"], main4["enc_lens"],
                      main4["gen_slab"], iters=step_iters)
    for r in runs8 + runs4:
        r.pop("pipe", None)
    del pipe8
    engine.release_sessions()
    torch.cuda.empty_cache()

    def pair(key, fmt):
        return " vs int8 ".join("/".join(fmt.format(r[key]) for r in rs)
                                for rs in (runs4, runs8))

    print(f"[main/int4 vs int8 b1] per-step ms int4 "
          f"{pair('step_ms', '{:.2f}')}; tokens/s int4 "
          f"{pair('tokens_per_s', '{:.2f}')}; RTF int4 "
          f"{pair('rtf', '{:.3f}x')} [{card}]")
    worst4, prod4 = phase_products(card, dict(main4, pipe=pipe4),
                                   args.iters)
    # 4h, int4: the cloned 4.0 s request at B = 1 and its products (the
    # prefill at M = 257)
    pipe4.audio_tokenizer.params.update(enc)
    clone4 = phase_main_path(card, args.seed, "int4", 1, pipe=pipe4,
                             refs=refs, ab=False)
    worst4c, prod4c = phase_products(card, clone4, args.iters)
    clone4.pop("pipe")
    prof["int4 b1"] = phase_profile(pipe4, card, main4["enc_lens"],
                                    kv_cache="paged_i8", weights="int4")
    timing4 = quant_step_timing(pipe4, card, main4["steps"],
                                main4["enc_lens"], main4["gen_slab"],
                                iters=step_iters)

    stamp("4c (int4 b1)")
    # 4d: speculative int4 at batch 1 (the JAX bench's probe), then every
    # quantized product of that run and one verify pass's decode_stack
    spec4 = phase_speculative(card, pipe4, "int4 b1", "auto", args.seed)
    worst_spec4, prod_spec4 = phase_products(card, spec4, args.iters)
    chain_timing = chain_step_timing(pipe4, card, spec4["steps"],
                                     spec4["enc_lens"][0], spec4["gen_slab"],
                                     iters=step_iters)
    spec4.pop("pipe")
    del pipe4
    engine.release_sessions()
    torch.cuda.empty_cache()

    stamp("4d (speculative int4)")
    # 4e: bf16 weights over float8 pages at batch 1: sequential (kernel 1,
    # e4m3) and speculative (the one-segment kernel)
    spec8 = phase_speculative(card, pipe16, "bf16 b1", "paged_f8", args.seed)
    spec8.pop("pipe")
    timing_f8 = main_path_step_timing(
        card, prompt_len=1, gen_len=spec8["seq_steps"] // 2,
        enc_lens=spec8["enc_lens"], gen_slab=spec8["gen_slab"],
        iters=step_iters, f8=True)
    parts_timing = parts_step_timing(
        card, prompt_len=1, gen_len=spec8["steps"] // 2,
        enc_len=spec8["enc_lens"][0], gen_slab=spec8["gen_slab"],
        iters=step_iters)
    del pipe16
    engine.release_sessions()
    torch.cuda.empty_cache()

    stamp("4e (bf16 over e4m3)")
    # 4f: W8A16 serving, the four requests at batch 4 over bf16 pages; then
    # every W8A16 product of the run and one decode step's products
    main16 = phase_main_path(card, args.seed, "w8a16")
    worst_run16, prod16 = phase_w8a16_products(card, main16, args.iters)
    worst16 = max(worst16, worst_run16)
    prof["w8a16"] = phase_profile(main16["pipe"], card, main16["enc_lens"],
                                  weights="w8a16")
    timing16 = w8a16_step_timing(main16.pop("pipe"), card, 4, step_iters)
    engine.release_sessions()
    torch.cuda.empty_cache()

    stamp("4f (w8a16)")
    # the graphed loop against the eager one, path by path
    graph = {run["tag"]: dict(run["ab"], **{
                 f"profile_{form}_{k}": v
                 for form, r in prof[name].items() for k, v in r.items()})
             for name, run in (("bf16", main), ("bf16 mode 1", main1),
                               ("int8", main8), ("int4 b1", main4),
                               ("w8a16", main16))}
    graph[clone["tag"]] = clone["ab"]
    print(f"[graph] {json.dumps(graph)}")
    clone_keys = ("prompts", "p_max", "steps", "tokens_per_s", "rtf",
                  "step_ms", "prefill_rows")
    print(f"[clone] {json.dumps(dict(encode=encode_report, **{
        r['tag']: {k: r[k] for k in clone_keys}
        for r in (clone, clone8, clone4)}))}")
    src = "t5gemma_tts_tpu_torch/csrc/"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="batch_paged_attention", route="cuda",
             source=src + "batch_paged_attention.cu",
             replaces="t5gemma_tts_tpu/ops/fused_attn.py:220",
             launches=main["launches"]["batch_paged_attention"],
             max_abs_err=max(*worst_attn.values(), timing["max_abs_err"],
                             timing_f8["max_abs_err"],
                             clone_timing["max_abs_err"]),
             ms=timing["ms"], plain_ms=timing["plain_ms"],
             bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
             library_ms=None, eager_ms=timing["eager_ms"],
             splits=timing["splits"],
             e4m3=dict(launches=spec8["seq_launches"]["batch_paged_attention"],
                       max_abs_err=max(worst_attn["f8"],
                                       timing_f8["max_abs_err"]),
                       splits=timing_f8["splits"],
                       **{k: timing_f8[k] for k in keys[:4]}),
             clone=dict(launches=clone["launches"]["batch_paged_attention"],
                        max_abs_err=clone_timing["max_abs_err"],
                        splits=clone_timing["splits"],
                        **{k: clone_timing[k] for k in keys[:4]})),
        dict(name="w8a8_matmul", route="cuda",
             source=src + "w8a8_matmul.cu",
             replaces="t5gemma_tts_tpu/ops/quant.py:140",
             launches=main8["launches"]["w8a8_matmul"],
             max_abs_err=max(worst8["w8a8"], worst4["w8a8"],
                             worst_spec4["w8a8"], worst_edges["w8a8"],
                             worst8c["w8a8"], worst4c["w8a8"],
                             timing8["w8a8"]["max_abs_err"]),
             **{k: timing8["w8a8"][k] for k in keys},
             products=[dict(p, run=f"{ph} {p['run']}")
                       for ph, r in (("4b", prod8), ("4c", prod4),
                                     ("4d", prod_spec4), ("4h", prod8c),
                                     ("4h", prod4c))
                       for p in r.get("w8a8", [])]),
        dict(name="decode_stack", route="cuda",
             source=src + "decode_layer.cu",
             replaces="t5gemma_tts_tpu/ops/megakernel.py:115",
             launches=main8["launches"]["decode_stack"],
             max_abs_err=max(worst_layer,
                             timing8["decode_stack"]["max_abs_err"]),
             **{k: timing8["decode_stack"][k] for k in keys},
             splits=timing8["decode_stack"]["splits"],
             parts=timing8["decode_stack"]["parts"],
             clone=dict(launches=clone8["launches"]["decode_stack"],
                        max_abs_err=timing8c["decode_stack"]["max_abs_err"],
                        splits=timing8c["decode_stack"]["splits"],
                        **{k: timing8c["decode_stack"][k]
                           for k in keys[:4]})),
        dict(name="w4a8_matmul", route="cuda",
             source=src + "w4a8_matmul.cu",
             replaces="t5gemma_tts_tpu/ops/quant.py:656",
             launches=main4["launches"]["w4a8_matmul"],
             max_abs_err=max(worst4["w4a8"], worst_spec4["w4a8"],
                             worst_edges["w4a8"], worst4c["w4a8"],
                             timing4["w4a8"]["max_abs_err"]),
             **{k: timing4["w4a8"][k] for k in keys},
             products=[dict(p, run=f"{ph} {p['run']}")
                       for ph, r in (("4c", prod4), ("4d", prod_spec4),
                                     ("4h", prod4c))
                       for p in r.get("w4a8", [])]),
        dict(name="decode_stack_int4", route="cuda",
             source=src + "decode_layer.cu",
             replaces="t5gemma_tts_tpu/ops/megakernel.py:115",
             launches=main4["launches"]["decode_stack"],
             max_abs_err=max(worst_layer4,
                             timing4["decode_stack"]["max_abs_err"]),
             **{k: timing4["decode_stack"][k] for k in keys},
             splits=timing4["decode_stack"]["splits"],
             parts=timing4["decode_stack"]["parts"],
             clone=dict(launches=clone4["launches"]["decode_stack"]),
             chain5=dict(launches=spec4["launches"]["decode_stack"],
                         max_abs_err=max(*worst_chain.values(),
                                         chain_timing["max_abs_err"]),
                         splits=chain_timing["splits"],
                         **{k: chain_timing[k] for k in keys[:4]})),
        dict(name="paged_flash_parts", route="cuda",
             source=src + "paged_flash_parts.cu",
             replaces="t5gemma_tts_tpu/ops/paged_attn.py:122",
             launches=spec8["launches"]["paged_flash_parts"],
             max_abs_err=max(worst_parts, parts_timing["max_abs_err"],
                             cross_timing["max_abs_err"]),
             **{k: parts_timing[k] for k in keys},
             splits=parts_timing["splits"],
             cross_4g=dict(launches=main1["launches"]["paged_flash_parts"],
                           splits=cross_timing["splits"],
                           **{k: cross_timing[k] for k in keys})),
        dict(name="w8a16_matmul", route="cuda",
             source=src + "w8a16_matmul.cu",
             replaces="t5gemma_tts_tpu/ops/quant.py:78",
             launches=main16["launches"]["w8a16_matmul"],
             max_abs_err=max(worst16, timing16["max_abs_err"]),
             **{k: timing16[k] for k in keys},
             bf16_matmul_ms=timing16["bf16_ms"],
             step_products=timing16["products"],
             products=[dict(p, run=f"4f {p['run']}") for p in prod16]),
        dict(name="fused_decode_attention", route="cuda",
             source=src + "fused_decode_attention.cu",
             replaces="t5gemma_tts_tpu/ops/fused_attn.py:97",
             launches=main1["launches"]["fused_decode_attention"],
             max_abs_err=max(worst_fused["bf16"],
                             fused_timing["max_abs_err"]),
             **{k: fused_timing[k] for k in keys},
             eager_ms=fused_timing["eager_ms"], splits=fused_timing["splits"],
             e4m3=dict(launches=ref_f8["fused_decode_attention"],
                       max_abs_err=max(worst_fused["e4m3"],
                                       fused_timing_f8["max_abs_err"]),
                       splits=fused_timing_f8["splits"],
                       **{k: fused_timing_f8[k] for k in keys[:4]})),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
4e. bf16 weights over e4m3 pages, the same request, on a 13 + 13 layer
   pipeline of its own (full width; its depth cut for the run's time): the sequential decode (the two-segment kernel, e4m3: 2 x
   13 launches per step), then the speculative decode drafted as in 4d
   (the one-segment kernel: 3 x 13 launches per pass), with 4d's numbers,
   and both kernels at the full model's step shapes against their plain
   versions;
4g. the bf16 batch of phase 4 with T5G_FUSED_ATTN=1, on a 13 + 13 layer
   pipeline of its own (full width; its depth cut for the run's time, PR
   17): the v1 kernel runs self-attention (13 launches a step) and the
   one-segment kernel cross attention (13 a step), the two-segment kernel
   never; RTF, tokens/s and ms per step beside phase 4's (26 + 26
   layers); its profile, one step's 26 v1
   launches at the run's shapes (bf16 and e4m3 pages, with their split
   plan, which must fill a wave) and its 26 one-segment cross-attention
   launches, each against the plain version;
4f. W8A16 serving: the route quantize_params_for_decode(fuse_for_decode(
   params), act_bits=16) + TTSPipeline(fuse_matmuls=False), on a pipeline
   of its own at full width and 13 + 13 layers (W8A16_LAYERS, for the
   run's time), the same four requests over bf16 pages; W8A16 launches
   must equal the plan's count (w8a16_launches), the two-segment kernel
   2 x 13 a step, decode_stack never; then every W8A16 product of the run
   against its plain version (with its route and plan), its profile, one
   row per distinct product shape of a step (route, plan, time, bound,
   bf16 yardstick) and one step's 80 products (6 x 13 layers and the
   head's two) at the run's shapes, each with the library call
   torch._weight_int8pack_mm and a bf16 matmul over the weight dequantized
   beforehand.

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
   MAX_SESSIONS = 1, an eviction, each to its one-shot decode. Then,
   on 4h's full-width codec, preprocessing: 16 seeded recordings of 2-6 s
   at 16 kHz with transcripts, in ``data/preprocess``'s wav-folder layout,
   through ``preprocess.prepare`` (encode batch 4) into a directory 4k and
   4l train on; each utterance's codes equal ``AudioTokenizer.encode`` of
   the same zero-padded batch cut to ``len(wav) // hop``, the manifest,
   text, code and neighbor files in the layout ``VoiceDataset`` reads;
   seconds of audio encoded a wall second, first pass and warm.

4i. serving, on bf16 and int8 pipelines of its own at 13 + 13 layers
   (``SERVE_LAYERS``, since ``[serve_tp]`` took its part-D paths):
   ``TTSPipeline.warmup`` on the int8 pipeline as a server starts (every
   session dropped first; the kernels' builds, a captured session for
   batch 1 and 4 at the serving buckets, the vocoder's length buckets,
   each timed); streaming on the bf16 pipeline, the 4.0 s request
   at batch 1 (time to first audio and stream wall against the one-shot
   wall; tokens equal the one-shot decode's, alone and with a one-shot
   request between two segments; the waveform's max abs error); then on
   the bf16 and the int8 pipelines, continuous batching in 4 slots of
   eight requests 0.1 s apart (ragged texts): through ContinuousServer,
   sampled (launches: kernel 1 2 x 13 a step body, or decode_stack one a
   body and W8A8 at least two; aggregate RTF), each request alone in the
   same resident state at the seed the server gave it (tokens equal,
   exact; the continuous step and the admission timed, synchronized,
   against the synchronized graphed step of the four main requests on the
   same pipeline), the same requests through BatchingServer (max batch
   4), and greedy in a state of its own, each
   stream against the request at batch 1, parting only under the stream
   contract's near-tie rule (``cross_batch_parting``); kernel 1 (bf16),
   decode_stack (int8) at the continuous path's ragged lengths (generation
   50 / 0 / 343 / 350, encoder 48 / 52 / 37 / 42; 26 layers of slabs) and
   the W8A8 products of the int8 continuous path (the head at M = 4, the
   batch-1 admission prefill at M = 65, cross K/V at M = 64), each against
   its plain version; a ``[serve]`` JSON line.

4j. front end and ASR: the HTTP server on 127.0.0.1:0 in front of the
   int8 ContinuousServer (4 slots): eight concurrent POSTs
   /synthesize, each response's PCM against the same request alone in the
   same resident state at the seed the server gave it (``X-Seed``), the
   HTTP wall against the backend's; in front of a bf16 BatchingServer:
   /synthesize_streaming of the 4.0 s request, alone and with a one-shot
   request of the same bucket on the server's thread (the stream's tokens
   equal its one-shot decode, the one-shot's its own alone: the engine's
   session lock), time to the first audio byte; ``--fast_start``: seconds
   from construction to the first answered request with ``TieredBackend``
   and with the int8 server built and warmed first, and to the tier swap
   (kernels already built); Whisper at the large-v3-turbo widths (seeded
   random f32 weights): log_mel, encode and decoder-step ms, the
   transcriber's wall over its six rungs, the greedy ids against the card's
   own teacher-forced argmax, a 2-layer truncation of the encoder on the
   card against the CPU; a ``[front]`` JSON line. The HTTP phases and the
   tiered start run on bf16 and int8 pipelines of their own at 13 + 13
   layers (``FRONT_LAYERS``, since ``[serve_tp]`` was added).

4k. training (after 4f, on a card the earlier phases have released):
   (a) LoRA at 2b-2b full width, 13 + 13 layers (the run's time; seeded
   random bf16 base, r 16,
   alpha 32, rematerialized layers, chunked CE at 8192 columns, ScaledAdam
   on the adapters, two micro-batches of four utterances a step) through
   ``Trainer`` over the 16 utterances of 2-6 s that the preprocessing
   after 4h encoded (byte-level text tokens): four steps
   (synchronized ms a step, counted training tokens/s, peak memory); every
   loss finite and no step skipped, the base bit-unchanged, every adapter
   ``b`` moved from zero; a run saved at step 2 and resumed in a fresh
   ``Trainer`` against the uninterrupted one; then ``lora.merge`` into the
   bf16 ``TTSPipeline`` (``fuse_for_decode``): one 1.0 s request graphed
   (kernel 1 2 x 26 launches a step body), tokens equal to the eager
   decode's. (b) A full-model ScaledAdam step at 2b-2b width and 1 + 1
   layers (2 + 2 took 45 s on the CPU side) in f32 (TF32 off), two
   micro-batches of one row, on the card and on the CPU from the same
   state: loss, every gradient leaf, every updated leaf (beyond what the
   gradients' differences carry through the update's normalization).
   (c) ``ops/chunked_ce.head_nll_top10`` at the 2b-2b head and the full
   audio vocab (65541), bf16, 4 x 301 positions, forward and backward
   against the dense head + ``token_loss`` under autograd, each timed with
   its peak memory. (d) ``decode/speculative.mtp_loss`` at 2b-2b width
   (4 heads, D 2304, V 65541, hidden 2 x 64, f32, TF32 off): value and
   autograd gradients on the card against the CPU. (e) ``[parallel]``,
   after (b): NCCL at world size 1 (127.0.0.1, a free port) and
   ``parallel.make_mesh(dp=1, tp=1)`` with ZeRO-1 on; (b)'s step through
   the mesh's step and the plain step in turns, bit-equal (loss, every
   gradient and updated leaf), ms both ways, the collectives a step and
   their bytes; both updated models served graphed in bf16 (one 1.0 s
   greedy request, B = 1; kernel 1 2 x 1 x the step bodies), tokens
   equal; the per-rank GB of the 2b-2b full fine-tune at (dp, tp) = (1, 1),
   (2, 1) and (2, 2) with ZeRO-1 and (1, 2), reckoned from ``meta``
   shapes. A ``[train]`` JSON line. No kernel of ours is on the training
   path; the merged and the mesh-trained models' serves run kernel 1.

4l. the fine-tuning lifecycle through files, at 2b-2b width and 1 + 1
   layers (bf16, seeded): the base written as the trainer writes an
   experiment directory (``save_bundle`` + ``save_config``) and read back
   by ``load_voice_model`` bit-equal; a LoRA ``Trainer`` (r 16, alpha 32)
   for two steps on it over the preprocessed utterances; the export's
   ``main --bundle --lora_bundle --save_adapter_dir`` (bf16 HF directory
   and PEFT adapter); ``load_voice_model`` of the export bit-equal to
   ``lora.merge`` of the base and the adapters; one 1.0 s request served
   from the loaded model, graphed (kernel 1 2 x 1 x the step bodies), its
   tokens equal to a pipeline's over the in-memory merge; each write and
   read in s and GB/s; a ``[lifecycle]`` JSON line.

serve_tp. serving over the mesh (after 4l): (a) the kernels of a
   tensor-parallel rank at its 2b-2b shapes against their plain versions,
   timed, with their bounds and launches: kernel 1 at Hq / Hkv 4 / 2 (tp
   2) and 2 / 1 (tp 4), B = 4, bf16, self and cross, its split plan
   filling a wave; kernel 2's seven parts a layer at tp 2 and tp 4 (w8
   B = 4, w4 B = 1, two layers, int8 pages; at tp 4 an activation tile
   spans two ranks), every rank of the group in this process
   (:func:`run_ranks`), against the one-process stack and the plain one
   (TP_PART_TOL), and the same at chain 5 (a verify pass: w8 and w4, 1
   and 2 cache rows, bf16 and int8 pages; :data:`TP_LAYER_CASES`);
   kernels 3 and 4 at the row-split K blocks of the
   prefill and the head, every rank's ``quant.rows_matmul`` (the group's
   reductions done between its calls, :func:`rows_over_group`) bit-equal
   to the plain product; kernel 5 (the verify pass at chain 5, bf16 and
   e4m3 pages; cross attention at B = 4) and kernel 7 (B = 4, bf16 and
   e4m3 pages) at a rank's heads, every rank against its plain version
   and the whole call's block of heads, their plans filling a wave;
   kernel 6 at a rank's column and row blocks of the layer products at
   M = 4 and 260 (a row block's ranks summed against the whole product),
   with ``torch._weight_int8pack_mm`` as the library's time. (b) Two
   ranks on cuda:0 (gloo over CUDA tensors: NCCL refuses two ranks on one
   device; the kernels built by this process before they start) decode
   :data:`SERVE_TP_CASES` at tp 2: bf16 B = 4 at 26 + 26 layers; at 13 +
   13, int8 B = 4 and int4 B = 1 through ``engine.decode_tokens``,
   speculative int4 over bf16 pages B = 1 (k = 4, drafted at 90 %
   acceptance from rank 0's world-1 run as 4d drafts: kernel 2's parts
   at chain 5),
   ``T5G_FUSED_ATTN=1`` and ``=0`` B = 4 (kernels 7 and 5), W8A16 B = 4
   (kernel 6, row blocks summed over the group), bf16 over e4m3 pages B =
   1 sequential (kernel 1's e4m3 variant) and speculative (kernel 5 at
   chain 5); SERVE_TP_FRAMES frames, each after rank 0's world-1 decode
   of the same weights (the same draft); the ranks' tokens and passes
   equal, and the tokens equal to world 1's but at a near-tie, their
   logits within SERVE_TP_LOGITS_TOL of world 1's before it; launches a
   rank by the main path's formulas (:func:`serve_tp_launches`; kernels
   3 / 4 as many as world 1's), collectives and their bytes, eager ms a
   step against world 1's. (c) NCCL at world 1, ``make_mesh(dp=1,
   tp=1)``: the mesh's shard served graphed inside ``model_parallel``,
   frames equal to the plain path's. A ``[serve_tp]`` JSON line.

Every main path (4, 4b, 4c's int4 run, 4f, 4g) runs its decode graphed and
eager and is profiled both ways; a ``[graph]`` line sums them up as JSON.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
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
# A tensor-parallel rank's decode-layer parts against the one-process stack
# and the plain one (relative Frobenius error of h, k and v): the same
# levels and integer sums. On one H100 the sound parts read 1.3e-7 at most
# and 9.4e-4 where the attention's split plan, when it was made for the
# rank's kv heads, ordered its f32 sums otherwise and flipped an int8
# level (the card test, bf16 pages, tp 4); planted faults read 1.6e-2 and
# up (the GeGLU absmax of half of each piece of a tile that spans ranks,
# at tp 4) and 7.2e-2 and up (a tile's scale read without the rank's
# first column k0). With the one-process plan a rank's parts read 0
# against the one-process stack (chain 1 and 5).
TP_PART_TOL = 4e-3
# The two-rank tp-2 decode's logits against world 1's, relative, at every
# step before a row parts from world 1's tokens: 1.5 x the largest reading
# of the runs on one H100 (bf16 2.58e-2, int8 4.95e-2, int4 4.55e-2; in
# three runs each, spec_int4 4.55e-2, mode1 / mode0 / w8a16 1.86e-2,
# f8 / spec_f8 2.29e-2).
SERVE_TP_LOGITS_TOL = {"bf16": 4e-2, "int8": 7.5e-2, "int4": 7.5e-2,
                       "spec_int4": 7e-2, "mode1": 2.8e-2, "mode0": 2.8e-2,
                       "w8a16": 2.8e-2, "f8": 3.5e-2, "spec_f8": 3.5e-2}
TOL_ABS = 1e-4                 # f32 outputs from the same bf16/int8 pages:
TOL_REL = 1e-4                 # only the order of summation differs
MODEL_LAYERS = 26              # 2b-2b decoder depth
# 4e's depth: at 26 + 26 layers its eager batch-1 decodes (sequential and
# speculative) took 176.6 s of a 1187.6 s run on one H100 machine
E4M3_LAYERS = 13
W8A16_LAYERS = 13              # 4f's own pipeline (for the run's time)
MODE1_LAYERS = 13              # 4g's own pipeline (for the run's time)
FRONT_LAYERS = 13              # 4j's own pipelines (for the run's time,
                               # since [serve_tp] was added)
SERVE_LAYERS = 13              # 4i's own pipelines (for the run's time,
                               # since [serve_tp] took its part-D paths)
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


def main_path_step_timing(card: str, prompt_len, gen_len,
                          enc_lens, gen_slab: int, iters: int,
                          f8: bool = False, prompt_pages: int = 1) -> dict:
    """One decode step's 52 launches (self + cross for each of 26 layers)
    at the main path's cache shapes (bf16 pages, or e4m3 with ``f8``),
    kernel (graph-replayed, and eager) against plain version, with the
    split plans, which must fill a wave. ``prompt_len`` (BOS included) is
    one length or one a row, over ``prompt_pages`` pages a row (a cloned
    prompt's bucket); ``gen_len`` one length or one a row (the continuous
    path's per-row clocks)."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    b = len(enc_lens)
    tx = -(-max(enc_lens) // PAGE) * PAGE
    common = dict(b=b, h=8, hkv=4, hd=256, quant=False, layers=MODEL_LAYERS,
                  li=0, f8=f8)
    a_lens = (list(prompt_len) if isinstance(prompt_len, (list, tuple))
              else [prompt_len] * b)
    b_lens = (list(gen_len) if isinstance(gen_len, (list, tuple))
              else [gen_len] * b)
    self_args = attention_case(
        rng, device=dev, a_lens=a_lens, b_lens=b_lens,
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
          f"{b_lens}, enc {list(enc_lens)}, {'e4m3' if f8 else 'bf16'} "
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


def layer_plans(dims, args, plan_hkv=None) -> dict:
    """Kernel 2's self and cross (chunk, splits, CTAs) for one call
    (``plan_hkv``: as ``megakernel.attention_plan``'s)."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk

    plans = mk.attention_plan(dims, args["prompt_k"], args["gen_k"],
                              args["cross_k"], plan_hkv)
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
                      parts: bool = True, gen_lens=None) -> dict:
    """One decode step's quantized work at the main path's cache shapes, on
    the main path's own weights: the decode_stack call (26 layers, int8
    pages; ``prompts`` one prompt length, BOS included, or one a row, in a
    ``prompt_slab``-token slab; every row at ``steps // 2`` generated
    tokens, or at its own ``gen_lens``; with ``parts`` its device time by
    part) and the step's two head products, each against its plain
    version. Int8
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
    gen_lens = list(gen_lens) if gen_lens is not None else [steps // 2] * b
    args = decode_layer_inputs(dims, b, True, prompt=prompts,
                               gen_lens=gen_lens, enc_lens=enc_lens,
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
          f"gen {gen_lens}, enc {list(enc_lens)}, int8 pages, 26 layers): "
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
    own weights: the six products of each of the pipeline's layers and the
    head's w1 and w2, all at M = B, bf16 activations. One row per distinct
    shape (the six layer products of layer 0, then the head's w1 and w2):
    its route and plan, ms (graph), bound and bf16 yardstick; then the
    step's products in one graph, mean per launch."""
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
    n_layers = pipe.cfg.backbone.decoder.num_layers
    out = time_w8a16(calls, card, f"main-path step (B={batch}, the "
                     f"{len(calls)} products of one step: 6 x {n_layers} "
                     f"layers + the head's two; mean per launch)", iters)
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


def depth_cut(cfg, layers: int):
    """``cfg`` with ``layers`` encoder and decoder layers (widths kept)."""
    bb = cfg.backbone
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        bb, encoder=dataclasses.replace(bb.encoder, num_layers=layers,
                                        layer_types=()),
        decoder=dataclasses.replace(bb.decoder, num_layers=layers,
                                    layer_types=())))


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
                     card_tokens, tol: float = REL_FRO_TOL_STACK) -> str:
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
    eager loop, which gives the graphed loop's tokens. ``tol``: the bound
    before the parting step. Returns the report."""
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
    if before > tol or margin > gap:
        raise AssertionError(f"row {row} parts at step {t}: logits "
                             f"{before:.2e} apart before it (tol "
                             f"{tol:g}); CPU margin {margin:.3e}"
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
            "fused_decode_attention": fa.fused_decode_attention,
            "decode_layer_part": mk.decode_layer_part}


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

    # 2b-2b preset, bf16; a pipeline given keeps its own (its depth)
    cfg = VoiceConfig() if pipe is None else pipe.cfg
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


def kernel_rows(prof) -> tuple:
    """A CUDA-only profile's (rows of (device ms, count, kernel name) by
    time, their sum in ms, the union of the kernels' intervals in us, the
    kernel events). The union, not the sum, is the device's busy time: a
    kernel launched as a programmatic dependent starts before its primary
    ends, and the sum counts that overlap twice."""
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    union_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in kernels):
        if hi > end:
            union_us += hi - max(lo, end)
            end = hi
    return rows, sum(r[0] for r in rows), union_us, kernels


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
        rows, busy_ms, union_us, kernels = kernel_rows(prof)
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


# ---------------------------------------------------------------------------
# phase 4i: serving (streaming, continuous batching, the servers, warm-up)
# ---------------------------------------------------------------------------

SERVE_TEXTS = ("Good morning.",
               "The weather is fine today, isn't it?",
               "One more request joins the batch.",
               "Continuous batching keeps the slots full.",
               "Short.",
               "Streaming speech arrives while it is made.",
               "A request that arrives late does not wait.",
               "Every slot draws from its own seed.")
SERVE_DURATIONS = (1.0, 0.6, 1.4, 0.8, 1.2, 0.5, 1.5, 0.9)
SERVE_SLOTS = 4
# the continuous path's ragged per-row lengths for the kernels' check:
# generated tokens (slot 1 just admitted or idle) and encoder lengths
CONTINUOUS_GEN = (50, 0, 343, 350)
CONTINUOUS_ENC = (48, 52, 37, 42)
SERVE_BUCKETS = (64, 64, 512)         # text, prompt, frames of the state
SERVE_SEGMENT = 50                    # frames a segment
ARRIVAL_S = 0.1                       # between two requests' arrivals
NEAR_TIE_REL = 0.1                    # logits before a cross-batch parting
BF16_STEP = 0.03125                   # the top two logits at a parting


def serve_requests():
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    return [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(SERVE_TEXTS, SERVE_DURATIONS)]


def slot_inputs(pipe, req) -> tuple:
    """(x, x_len, prompt, prompt_len, target) of a request at the resident
    state's text and prompt buckets."""
    planned = pipe.plan_request(req)
    tx, pm, _ = SERVE_BUCKETS
    x = np.zeros((tx,), np.int32)
    x[:len(planned.text)] = planned.text
    p = np.full((pm,), pipe.cfg.special.pad, np.int32)
    p[:len(planned.prompt)] = planned.prompt
    return x, len(planned.text), p, len(planned.prompt), planned.target


def synced(fn):
    """(fn(), seconds) with the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def submit_spaced(server, reqs) -> tuple:
    """Submit ``reqs`` ARRIVAL_S apart; (results, wall s from the first
    arrival to the last result)."""
    t0 = time.perf_counter()
    futs = []
    for i, r in enumerate(reqs):
        if i:
            time.sleep(ARRIVAL_S)
        futs.append(server.submit(r))
    results = [f.result(timeout=600) for f in futs]
    return results, time.perf_counter() - t0


def stripped(pipe, tokens):
    strip = [pipe.cfg.special.y_sep, pipe.cfg.eog_inference]
    tokens = np.asarray(tokens)
    return tokens[~np.isin(tokens, strip)]


def run_alone(pipe, fns, state, inputs, seed) -> tuple:
    """One request alone in slot 0 of a resident state, segment by segment
    until it is harvested: (raw tokens, bodies, segment seconds, admission
    seconds), each timed with the card synchronized."""
    from t5gemma_tts_tpu_torch.decode import continuous

    _, admit_s = synced(lambda: fns.admit(pipe.params, state, 0, *inputs,
                                          seed))
    bodies, seg_s = 0, 0.0
    for _ in range(SERVE_BUCKETS[2] // SERVE_SEGMENT + 2):
        _, s = synced(lambda: fns.segment(pipe.params, state, SERVE_SEGMENT))
        bodies, seg_s = bodies + SERVE_SEGMENT, seg_s + s
        outs = continuous.harvest(state)[1]
        if outs:
            return outs[0][1], bodies, seg_s, admit_s
    raise AssertionError("a request alone did not finish")


def cross_batch_parting(pipe, dcfg, inputs, slot, cont, alone) -> str:
    """Where a greedy continuous stream (``cont``, raw tokens from ``slot``)
    parts from the same request at batch 1 (``alone``), held to the stream
    contract's cross-batch rule: greedy, the logits of the two (teacher
    forced: the streams are equal before the parting) within NEAR_TIE_REL
    relative before it, and the batch-1 top two logits within one bf16 step
    (BF16_STEP) at it. Both logit streams come from eager runs (the batch-1
    loop, and the request alone in an eager resident state, whose tokens
    must be the graphed stream's)."""
    from t5gemma_tts_tpu_torch.decode import continuous, engine

    n = min(len(cont), len(alone))
    differ = np.nonzero(cont[:n] != alone[:n])[0]
    t = int(differ[0]) if len(differ) else n
    cfg, dev = pipe.cfg, pipe.device
    x, xl, p, pl, tgt = inputs
    one = [torch.tensor(v, dtype=torch.int32, device=dev)
           for v in (x[None], [xl], p[None], [pl], [tgt])]
    b1 = {}

    def run_b1():
        st = engine.prefill(pipe.params, cfg, dcfg, *one)
        body = engine._make_body(pipe.params, cfg, dcfg, engine.step_inputs(
            cfg, one[1], one[3], one[4], 0))
        for _ in range(t + 1):
            st = body(st)

    with torch.inference_mode():
        _recorded(run_b1, b1)
    rows = engine.sample_step_token_rows
    cont_logits = {}

    def recording(cfg_, dcfg_, logits, steps, *a, **k):
        cont_logits[int(steps[slot])] = logits[slot].float().clone()
        return rows(cfg_, dcfg_, logits, steps, *a, **k)

    engine.sample_step_token_rows = recording
    try:
        fns = continuous.make_fns(cfg, dcfg, graphed=False)
        state = continuous.init_slots(cfg, dcfg, SERVE_SLOTS,
                                      *SERVE_BUCKETS[:2], dev)
        fns.admit(pipe.params, state, slot, *inputs, 0)
        fns.segment(pipe.params, state, t + 1)
    finally:
        engine.sample_step_token_rows = rows
    eager = state.tokens[slot, :t + 1].cpu().numpy()
    if not np.array_equal(eager, cont[:t + 1]):
        raise AssertionError(f"slot {slot}: the eager resident state's "
                             f"tokens {eager} are not the graphed stream's "
                             f"{cont[:t + 1]}")

    def rel(s):
        a, c = b1[s][0], cont_logits[s]
        return float((c - a).norm() / a.norm())

    before = max((rel(s) for s in range(t)), default=0.0)
    top2 = torch.topk(b1[t][0], 2).values
    gap = float(top2[0] - top2[1])
    if before > NEAR_TIE_REL or gap > BF16_STEP:
        raise AssertionError(f"slot {slot}: greedy stream parts from batch "
                             f"1 at step {t}: logits {before:.2e} apart "
                             f"before it (tol {NEAR_TIE_REL}), batch-1 top "
                             f"two {gap:.3e} apart (tol {BF16_STEP})")
    return (f"parts at step {t}: logits apart by at most {before:.2e} "
            f"(relative) before it; there the batch-1 top two logits lie "
            f"{gap:.3e} apart")


def phase_serve_stream(card: str, pipe, seed: int) -> dict:
    """Streaming synthesis, bf16 at batch 1: the 4.0 s request (about 450
    frames), one-shot (``synthesize``, after one run that captures the
    bucket), then streamed alone and with a one-shot request of the same
    bucket between its first two pieces: tokens equal the one-shot
    decode's, the waveform within its max abs error; time to first audio
    and stream wall against the one-shot wall."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    req = Request(target_text=TEXTS[-1], target_duration=DURATIONS[-1],
                  lang="en")
    other = Request(target_text=TEXTS[0], target_duration=DURATIONS[-1],
                    lang="en")
    dcfg = DecodeConfig(kv_cache="paged", seed=seed)
    pipe.synthesize(req, dcfg, seed=seed, quiet=True)
    one, one_s = synced(lambda: pipe.synthesize(req, dcfg, seed=seed,
                                                quiet=True))
    out = {"frames": len(one.gen_frames), "one_shot_wall_s": one_s}
    for tag, interleave in (("", False), ("interleaved_", True)):
        fed, pieces = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttfa = None
        for piece in pipe.synthesize_streaming(
                req, dcfg, seed=seed, segment_frames=SERVE_SEGMENT,
                vocode_chunk=SERVE_SEGMENT, on_tokens=fed.append):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
                if interleave:
                    pipe.synthesize(other, dcfg, seed=seed + 1, quiet=True)
            pieces.append(piece)
        wall = time.perf_counter() - t0
        toks = np.concatenate(fed)
        if not np.array_equal(toks, one.gen_frames):
            raise AssertionError(f"stream{' (interleaved)' * interleave}: "
                                 f"tokens differ from the one-shot decode "
                                 f"at {np.nonzero(toks != one.gen_frames)}")
        wav = np.concatenate(pieces)
        if wav.shape != one.wav.shape or not np.isfinite(wav).all():
            raise AssertionError(f"streamed wav {wav.shape} against "
                                 f"{one.wav.shape}")
        out.update({f"{tag}ttfa_s": ttfa, f"{tag}stream_wall_s": wall,
                    f"{tag}pieces": len(pieces),
                    f"{tag}wav_max_abs_err": float(
                        np.abs(wav - one.wav).max())})
    print(f"[serve/stream] bf16 B=1, {out['frames']} frames: first audio "
          f"after {out['ttfa_s']:.3f}s against a one-shot wall of "
          f"{one_s:.3f}s (stream wall {out['stream_wall_s']:.3f}s, "
          f"{out['pieces']} pieces); tokens equal the one-shot decode's, "
          f"alone and with a one-shot request between two segments (first "
          f"audio {out['interleaved_ttfa_s']:.3f}s, wall "
          f"{out['interleaved_stream_wall_s']:.3f}s); waveform max abs err "
          f"{out['wav_max_abs_err']:.2e} [{card}]")
    return out


def phase_serve_continuous(card: str, pipe, weights: str, seed: int,
                           sync_step_ms: float) -> dict:
    """Continuous batching at 2b-2b, SERVE_SLOTS slots, the eight
    SERVE_TEXTS requests ARRIVAL_S apart (ragged text lengths):

    - sampled (the default DecodeConfig) through ContinuousServer: the
      launch counts of the run (0 just before the first arrival, read
      after the last result), aggregate RTF; then each request alone in
      slot 0 of the same resident state at the seed the server gave it:
      its tokens must equal the server's (exact), which also times the
      continuous step (segments synchronized) and the admission;
    - the same requests through BatchingServer (max batch SERVE_SLOTS);
    - greedy in a resident state of its own (admitted as slots free up),
      each stream against the request at batch 1 (engine.graphed_decoder
      at the state's buckets): equal, or parting only under the stream
      contract's cross-batch rule (:func:`cross_batch_parting`)."""
    import dataclasses

    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import continuous, engine
    from t5gemma_tts_tpu_torch.inference.server import (BatchingServer,
                                                        ContinuousServer)

    cfg = pipe.cfg
    layers = cfg.backbone.decoder.num_layers
    kv = "paged" if weights == "bf16" else "paged_i8"
    tx, pm, frames = SERVE_BUCKETS
    dcfg = DecodeConfig(kv_cache=kv, seed=seed, max_frames=frames)
    reqs = serve_requests()
    inputs = [slot_inputs(pipe, r) for r in reqs]

    srv = ContinuousServer(pipe, dcfg, slots=SERVE_SLOTS, text_bucket=tx,
                           prompt_bucket=pm, segment_frames=SERVE_SEGMENT)
    if srv.capture_ms is None:
        raise AssertionError("the continuous server did not capture its "
                             "segment before serving")
    rec = continuous.stats(srv.state)
    bodies0, segments0 = rec.bodies, rec.segments
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    try:
        results, wall = submit_spaced(srv, reqs)
    finally:
        srv.close()
    launches = {k: c.launches for k, c in counters.items()}
    bodies, segments = rec.bodies - bodies0, rec.segments - segments0
    n = launches
    if weights == "bf16":
        ok = (n["batch_paged_attention"] == 2 * layers * bodies
              and n["decode_stack"] == n["w8a8_matmul"] == 0)
    else:
        ok = (n["decode_stack"] == bodies and n["batch_paged_attention"] == 0
              and n["w8a8_matmul"] >= 2 * bodies)
    if not ok or bodies == 0:
        raise AssertionError(f"continuous {weights}: launches {launches} "
                             f"over {bodies} step bodies")
    hop = pipe.audio_tokenizer.cfg.hop_length
    for r in results:
        if (r.wav is None or len(r.wav) != len(r.gen_frames) * hop
                or not np.isfinite(r.wav).all()):
            raise AssertionError("a continuous result's waveform is missing, "
                                 "cut or not finite")
    frames_out = sum(len(r.gen_frames) for r in results)
    rtf = frames_out / cfg.encodec_sr / wall

    fns = continuous.make_fns(cfg, dcfg)
    step_s = admit_s = 0.0
    n_bodies = 0
    for req_inputs, res in zip(inputs, results):
        toks, b, s, a = run_alone(pipe, fns, srv.state, req_inputs, res.seed)
        if not np.array_equal(stripped(pipe, toks), res.gen_frames):
            raise AssertionError(f"continuous {weights} sampled: the "
                                 f"request with seed {res.seed} alone in "
                                 f"the same resident state gives other "
                                 f"tokens than in the batch")
        n_bodies, step_s, admit_s = n_bodies + b, step_s + s, admit_s + a
    step_ms = 1e3 * step_s / n_bodies
    admit_ms = 1e3 * admit_s / len(reqs)

    bsrv = BatchingServer(pipe, dcfg, max_batch=SERVE_SLOTS)
    try:
        bresults, bwall = submit_spaced(bsrv, reqs)
    finally:
        bsrv.close()
    brtf = sum(len(r.gen_frames) for r in bresults) / cfg.encodec_sr / bwall

    gcfg = dataclasses.replace(dcfg, top_k=1)
    gfns = continuous.make_fns(cfg, gcfg)
    gstate = continuous.init_slots(cfg, gcfg, SERVE_SLOTS, tx, pm,
                                   pipe.device)
    queue, held, got = list(range(len(reqs))), {}, {}
    while len(got) < len(reqs):
        for slot in range(SERVE_SLOTS):
            if slot not in held and queue:
                held[slot] = queue.pop(0)
                gfns.admit(pipe.params, gstate, slot, *inputs[held[slot]], 0)
        gfns.segment(pipe.params, gstate, SERVE_SEGMENT)
        for slot, toks in continuous.harvest(gstate)[1]:
            got[held.pop(slot)] = (slot, toks)
    decode1 = engine.graphed_decoder(cfg, gcfg)
    equal, partings = 0, []
    for i, (slot, toks) in sorted(got.items()):
        one = [torch.tensor(v, dtype=torch.int32, device=pipe.device)
               for v in (inputs[i][0][None], [inputs[i][1]],
                         inputs[i][2][None], [inputs[i][3]],
                         [inputs[i][4]])]
        out = decode1(pipe.params, *one, 0)
        alone = out.tokens[0, :int(out.gen_lens[0])].cpu().numpy()
        if np.array_equal(toks, alone):
            equal += 1
        else:
            partings.append(f"request {i} (slot {slot}) " + (
                cross_batch_parting(pipe, gcfg, inputs[i], slot, toks,
                                    alone)))
    for p in partings:
        print(f"[serve/{weights}] greedy against batch 1: {p}")
    res = {"requests": len(reqs), "frames": frames_out, "bodies": bodies,
           "segments": segments, "capture_ms": srv.capture_ms,
           "launches": launches, "wall_s": wall, "rtf": rtf,
           "admit_ms": admit_ms,
           "admit_host_ms_mean": float(np.mean(srv.stats.admit_ms)),
           "step_ms": step_ms, "sync_graphed_step_ms": sync_step_ms,
           "state_bytes": continuous.state_bytes(srv.state),
           "batching_wall_s": bwall, "batching_rtf": brtf,
           "batching_batches": bsrv.stats.batch_sizes,
           "sampled_equal_alone": len(reqs), "greedy_equal_batch1": equal,
           "greedy_near_tie_partings": len(partings)}
    print(f"[serve/{weights}] continuous, {SERVE_SLOTS} slots ({kv} pages, "
          f"buckets {SERVE_BUCKETS}), {len(reqs)} requests {ARRIVAL_S}s "
          f"apart: {frames_out} frames in {wall:.3f}s, aggregate RTF "
          f"{rtf:.3f}x (batching server, max batch {SERVE_SLOTS}: "
          f"{brtf:.3f}x in {bwall:.3f}s, batches "
          f"{bsrv.stats.batch_sizes}); admission {admit_ms:.1f} ms "
          f"(synchronized; host {res['admit_host_ms_mean']:.1f} ms in the "
          f"server); continuous step {step_ms:.3f} ms against the "
          f"synchronized graphed step's {sync_step_ms:.3f} ms ({bodies} "
          f"bodies in {segments} segments, capture "
          f"{srv.capture_ms:.1f} ms, state {res['state_bytes'] / 1e9:.3f} "
          f"GB); every sampled request token-equal to itself alone in the "
          f"same resident state; greedy: {equal} of {len(reqs)} equal to "
          f"batch 1, {len(partings)} parted under the near-tie rule; "
          f"launches {launches} [{card}]")
    return res


def graphed_step_ms(pipe, kv_cache: str, seed: int) -> float:
    """The synchronized graphed step of the main path's four requests on
    ``pipe`` (its own depth): the prefill timed, a first graphed decode
    (which captures the bucket's session), then a second one timed; its
    wall less the prefill's, over its steps."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(TEXTS, DURATIONS)]
    inputs, max_frames = planned_inputs(pipe, reqs)
    dcfg = DecodeConfig(kv_cache=kv_cache, seed=seed, max_frames=max_frames)
    with torch.inference_mode():
        _, prefill_s = synced(lambda: engine.prefill(
            pipe.params, pipe.cfg, dcfg, *inputs))
    run = engine.graphed_decoder(pipe.cfg, dcfg)
    run(pipe.params, *inputs, seed)
    out, wall = synced(lambda: run(pipe.params, *inputs, seed))
    return 1e3 * (wall - prefill_s) / out.steps


def phase_serve_warmup(card: str, pipe, seed: int) -> dict:
    """TTSPipeline.warmup as a server starts: every graph session dropped
    first, then the kernels' builds, one captured session for batch 1 and
    SERVE_SLOTS at the serving buckets, and the vocoder's length buckets,
    each with its time."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine

    engine.release_sessions()
    torch.cuda.empty_cache()
    tx, pm, frames = SERVE_BUCKETS
    report, wall = synced(lambda: pipe.warmup(
        batch_sizes=(1, SERVE_SLOTS), text_buckets=(tx,),
        prompt_buckets=(pm,), frame_buckets=(frames,),
        dcfg=DecodeConfig(kv_cache="paged_i8", seed=seed), vocoder=True))
    sessions = [r for r in report if r["kind"] == "session"]
    if (len(sessions) != 2 or any(r["capture_ms"] is None for r in sessions)
            or not any(r["kind"] == "vocoder" for r in report)):
        raise AssertionError(f"warm-up report {report}")
    print(f"[serve/warmup] int8: {len(sessions)} sessions (B = 1 and "
          f"{SERVE_SLOTS}) and "
          f"{sum(r['kind'] == 'vocoder' for r in report)} vocoder buckets "
          f"in {wall:.3f}s: {json.dumps(report)} [{card}]")
    return {"wall_s": wall, "report": report}


# ---------------------------------------------------------------------------
# phase 4j: the HTTP front end, the tiered start and Whisper
# ---------------------------------------------------------------------------

HTTP_WAIT = 600.0                     # seconds: every HTTP wait's bound
PCM_TOL = 1                           # int16 steps: the same waveform
WHISPER_TOL = 1e-4                    # f32 encoder states, card vs CPU
WHISPER_NEAR_TIE = 1e-4               # greedy vs teacher-forced argmax
WHISPER_SECONDS = 3.0


def http_request(port, method, path, body=None, headers=None):
    """(status, headers, body) of one request to 127.0.0.1:``port``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_WAIT)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body), headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def http_stream(port, body, on_first_audio=None) -> tuple:
    """POST /synthesize_streaming on a raw socket: (seconds to the first
    audio chunk, [chunk payloads, the RIFF header first], terminated),
    ``on_first_audio()`` called as the first audio chunk arrives."""
    import socket

    data = json.dumps(body).encode()
    req = (f"POST /synthesize_streaming HTTP/1.1\r\nHost: x\r\n"
           f"Connection: close\r\nContent-Length: {len(data)}\r\n\r\n"
           ).encode()
    t0 = time.perf_counter()
    ttfa, buf, chunks, terminated = None, b"", [], False
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=HTTP_WAIT) as s:
        s.sendall(req + data)
        head = None
        while True:
            got = s.recv(1 << 16)
            if not got:
                break
            buf += got
            if head is None:
                if b"\r\n\r\n" not in buf:
                    continue
                head, buf = buf.split(b"\r\n\r\n", 1)
                if not head.startswith(b"HTTP/1.1 200"):
                    raise AssertionError(f"stream refused: {head[:200]}")
            while b"\r\n" in buf:
                size, rest = buf.split(b"\r\n", 1)
                n = int(size, 16)
                if n == 0:
                    terminated = rest.startswith(b"\r\n")
                    buf = b""
                    break
                if len(rest) < n + 2:
                    break
                chunks.append(rest[:n])
                buf = rest[n + 2:]
                if len(chunks) == 2 and ttfa is None:
                    ttfa = time.perf_counter() - t0
                    if on_first_audio is not None:
                        on_first_audio()
    return ttfa, chunks, terminated


def wav_pcm(body: bytes) -> np.ndarray:
    import io
    import wave

    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def phase_http_continuous(card: str, pipe, seed: int) -> dict:
    """The HTTP server on 127.0.0.1:0 in front of the int8
    ContinuousServer (4 slots, 4i's buckets): the eight SERVE_TEXTS
    requests sent to the backend directly, all at once, then as eight
    concurrent POSTs /synthesize; each response's PCM against the same
    request alone in the same resident state at the seed the server gave
    it (``X-Seed``), vocoded (within PCM_TOL int16 steps); the HTTP wall
    against the backend's."""
    from concurrent.futures import ThreadPoolExecutor

    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import continuous
    from t5gemma_tts_tpu_torch.inference import http_server as hs
    from t5gemma_tts_tpu_torch.inference.server import ContinuousServer

    tx, pm, frames = SERVE_BUCKETS
    dcfg = DecodeConfig(kv_cache="paged_i8", seed=seed, max_frames=frames)
    reqs = serve_requests()
    srv = ContinuousServer(pipe, dcfg, slots=SERVE_SLOTS, text_bucket=tx,
                           prompt_bucket=pm, segment_frames=SERVE_SEGMENT)
    sr = pipe.audio_tokenizer.sample_rate
    httpd = hs.serve(srv, "127.0.0.1", 0, sample_rate=sr, block=False)
    port = httpd.server_address[1]
    counters = _counters()
    try:
        t0 = time.perf_counter()
        direct = [f.result(HTTP_WAIT) for f in [srv.submit(r) for r in reqs]]
        backend_s = time.perf_counter() - t0
        bodies = [{"target_text": r.target_text,
                   "target_duration": r.target_duration, "lang": r.lang}
                  for r in reqs]
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            answers = list(pool.map(
                lambda b: http_request(port, "POST", "/synthesize", b,
                                       {"Content-Type": "application/json"}),
                bodies))
        http_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    if any(status != 200 for status, _, _ in answers):
        raise AssertionError(f"HTTP statuses {[a[0] for a in answers]}")
    if launches["decode_stack"] == 0:
        raise AssertionError(f"HTTP int8: no decode_stack launch {launches}")
    fns = continuous.make_fns(pipe.cfg, dcfg)
    worst, exact = 0, 0
    for req, (_, headers, body) in zip(reqs, answers):
        seed_r = int(headers["X-Seed"])
        toks = run_alone(pipe, fns, srv.state, slot_inputs(pipe, req),
                         seed_r)[0]
        gen = stripped(pipe, toks)
        want = np.frombuffer(hs.pcm16(pipe.audio_tokenizer.decode(
            gen[None, None, :])[0, 0]), "<i2")
        got = wav_pcm(body)
        if got.shape != want.shape:
            raise AssertionError(f"HTTP int8, seed {seed_r}: {got.shape} "
                                 f"samples against {want.shape} alone")
        diff = int(np.abs(got.astype(np.int32) - want).max())
        worst, exact = max(worst, diff), exact + (diff == 0)
    if worst > PCM_TOL:
        raise AssertionError(f"HTTP int8: PCM {worst} steps from the "
                             f"requests alone (tol {PCM_TOL})")
    audio_s = sum(len(r.gen_frames) for r in direct) / pipe.cfg.encodec_sr
    res = {"requests": len(reqs), "http_wall_s": http_s,
           "backend_wall_s": backend_s, "audio_s": audio_s,
           "pcm_max_steps": worst, "pcm_exact": exact, "launches": launches}
    print(f"[serve/http int8] HTTP in front of ContinuousServer "
          f"({SERVE_SLOTS} slots, paged_i8): {len(reqs)} concurrent POSTs "
          f"in {http_s:.3f}s against {backend_s:.3f}s submitted to the "
          f"backend directly; every response's PCM within {worst} int16 "
          f"steps of its request alone at its X-Seed ({exact} of "
          f"{len(reqs)} exact); launches {launches} [{card}]")
    return res


def phase_http_stream(card: str, pipe, seed: int) -> dict:
    """The HTTP server in front of a bf16 BatchingServer (paged, tokens as
    JSON): /synthesize_streaming of the 4.0 s request while a one-shot
    request of the same bucket runs on the server's thread (sent as the
    stream's first audio arrives): the stream's tokens equal its one-shot
    decode, the one-shot's tokens equal those it gets alone (the session
    lock); time to the first audio byte, alone and shared."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.inference import http_server as hs
    from t5gemma_tts_tpu_torch.inference.pipeline import Request
    from t5gemma_tts_tpu_torch.inference.server import BatchingServer

    dcfg = DecodeConfig(kv_cache="paged", seed=seed)
    req = Request(target_text=TEXTS[-1], target_duration=DURATIONS[-1],
                  lang="en")
    other = {"target_text": TEXTS[0], "target_duration": DURATIONS[-1],
             "lang": "en"}
    body = {"target_text": req.target_text,
            "target_duration": req.target_duration, "lang": "en"}
    want = pipe.synthesize(req, dcfg, seed=seed, quiet=True,
                           decode_audio=False).gen_frames
    srv = BatchingServer(pipe, dcfg, max_batch=SERVE_SLOTS,
                         decode_audio=False)
    httpd = hs.serve(srv, "127.0.0.1", 0,
                     sample_rate=pipe.audio_tokenizer.sample_rate,
                     block=False)
    port = httpd.server_address[1]
    fed: list = []
    original = pipe.synthesize_streaming

    def recorded(r, d=None, **kw):          # the stream's final tokens
        return original(r, d, on_tokens=fed.append, **kw)

    pipe.synthesize_streaming = recorded
    out = {}
    try:
        def one_shot():
            status, _, raw = http_request(
                port, "POST", "/synthesize", other,
                {"Content-Type": "application/json"})
            if status != 200:
                raise AssertionError(f"one-shot status {status}")
            return np.asarray(json.loads(raw)["frames"])

        alone = one_shot()
        for tag in ("alone", "shared"):
            fed.clear()
            shot: dict = {}

            def start_one_shot():
                t = threading.Thread(target=lambda: shot.update(
                    frames=one_shot()))
                t.start()
                shot["thread"] = t

            ttfa, chunks, terminated = http_stream(
                port, body, start_one_shot if tag == "shared" else None)
            if tag == "shared":
                shot["thread"].join(HTTP_WAIT)
                if not np.array_equal(shot.get("frames"), alone):
                    raise AssertionError("the one-shot request beside the "
                                         "stream got other tokens than "
                                         "alone")
            toks = np.concatenate(fed)
            if not terminated or not np.array_equal(toks, want):
                raise AssertionError(f"HTTP stream ({tag}): terminated "
                                     f"{terminated}, tokens equal "
                                     f"{np.array_equal(toks, want)}")
            pcm = sum(len(c) for c in chunks[1:]) // 2
            out[tag] = {"ttfa_s": ttfa, "chunks": len(chunks) - 1,
                        "samples": pcm}
    finally:
        pipe.synthesize_streaming = original
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    out["frames"] = len(want)
    print(f"[serve/http stream] bf16 BatchingServer, the 4.0 s request "
          f"({len(want)} frames) over /synthesize_streaming: first audio "
          f"byte after {out['alone']['ttfa_s']:.3f}s alone, "
          f"{out['shared']['ttfa_s']:.3f}s with a one-shot request of the "
          f"same bucket on the server's thread; the stream's tokens equal "
          f"its one-shot decode and the one-shot's equal its own alone, "
          f"both times [{card}]")
    return out


def phase_fast_start(card: str, pipe, seed: int) -> dict:
    """``--fast_start`` against a plain start, the kernels already built
    and every graph session dropped first: seconds from construction to
    the first answered request with the int8 full tier built and warmed
    up front (``make_backend(quantized_pipeline(...))``), and with
    ``tiered_backend`` (the bf16 fast tier answers; kernel 1 must run),
    then to its swap to the full tier (decode_stack must run there)."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference import http_server as hs

    dcfg = DecodeConfig(kv_cache="paged_i8", seed=seed)
    req = serve_requests()[0]
    counters = _counters()
    out = {}

    def cold():
        engine.release_sessions()
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0

    cold()
    t0 = time.perf_counter()
    backend = hs.make_backend(hs.quantized_pipeline(pipe, "int8"), dcfg,
                              max_batch=SERVE_SLOTS)
    built = time.perf_counter() - t0
    try:
        backend.synthesize(req, HTTP_WAIT)
        out["plain_first_s"] = time.perf_counter() - t0
        out["plain_build_s"] = built
    finally:
        backend.close()
    del backend
    cold()
    t0 = time.perf_counter()
    backend = hs.tiered_backend(pipe, dcfg, "int8", max_batch=SERVE_SLOTS,
                                drain_sec=1.0, build_delay_sec=HTTP_WAIT)
    try:
        backend.synthesize(req, HTTP_WAIT)
        out["tiered_first_s"] = time.perf_counter() - t0
        fast_launches = {k: c.launches for k, c in counters.items()}
        while backend.tier != "full":
            if time.perf_counter() - t0 > HTTP_WAIT:
                raise AssertionError("the full tier did not swap in")
            time.sleep(0.01)
        out["tiered_swap_s"] = time.perf_counter() - t0
        out["tiered_build_s"] = backend.build_s
        for c in counters.values():
            c.launches = 0
        backend.synthesize(req, HTTP_WAIT)
        full_launches = {k: c.launches for k, c in counters.items()}
    finally:
        backend.close()
    if (fast_launches["batch_paged_attention"] == 0
            or full_launches["decode_stack"] == 0):
        raise AssertionError(f"fast tier launches {fast_launches}, full "
                             f"tier {full_launches}")
    engine.release_sessions()
    torch.cuda.empty_cache()
    print(f"[serve/fast_start] kernels already built, sessions dropped: "
          f"first answered request {out['tiered_first_s']:.3f}s after "
          f"construction with TieredBackend (bf16 fast tier, kernel 1 "
          f"{fast_launches['batch_paged_attention']} launches) against "
          f"{out['plain_first_s']:.3f}s for the int8 server built and "
          f"warmed first ({out['plain_build_s']:.3f}s of it the build); "
          f"the int8 tier swapped in at {out['tiered_swap_s']:.3f}s "
          f"(build {out['tiered_build_s']:.3f}s; decode_stack "
          f"{full_launches['decode_stack']} launches on its first "
          f"request) [{card}]")
    return out


class WhisperStubTokenizer:
    """The special-token ids of the large-v3 vocabulary; ``decode`` spells
    the ids (no tokenizer files on the card's machine)."""

    IDS = {"<|en|>": 50259, "<|ja|>": 50266, "<|transcribe|>": 50360,
           "<|notimestamps|>": 50364, "<|nospeech|>": 50363}
    unk_token_id = None

    def convert_tokens_to_ids(self, t):
        return self.IDS.get(t)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids if int(i) < 50257)


def phase_whisper(card: str, seed: int) -> dict:
    """Whisper at the large-v3-turbo widths, seeded random f32 weights, on
    the card: log_mel, encode and a decoder step (ms, synchronized), the
    transcriber's wall over every rung of its ladder (random weights never
    emit eos: 440 tokens a rung), the greedy rung's ids against the argmax
    of the card's own teacher-forced ``decoder_logits`` over them (equal,
    or at a near tie: the teacher-forced top two within
    WHISPER_NEAR_TIE), and a 2-layer truncation of the full-width encoder
    on the card against the CPU (WHISPER_TOL)."""
    from t5gemma_tts_tpu_torch.asr import mel as asr_mel
    from t5gemma_tts_tpu_torch.asr import model as asr_model
    from t5gemma_tts_tpu_torch.device import tree_to
    from t5gemma_tts_tpu_torch.inference import audio_io, transcribe

    cfg = asr_model.WhisperConfig()
    params = asr_model.init_params(seed, cfg, device="cuda")
    rng = np.random.default_rng(seed)
    n = np.arange(int(WHISPER_SECONDS * 16000))
    wav = (0.3 * np.sin(2 * np.pi * 220 * n / 16000)
           + 0.05 * rng.normal(size=n.size)).astype(np.float32)
    wav_dev = torch.from_numpy(wav).cuda()
    out = {"params": n_params(params)}
    with torch.inference_mode():
        mel = asr_mel.log_mel(wav_dev, cfg.num_mel_bins)
        out["log_mel_ms"] = 1e3 * synced(
            lambda: asr_mel.log_mel(wav_dev, cfg.num_mel_bins))[1]
        asr_model.encode(params, cfg, mel)
        enc, s = synced(lambda: asr_model.encode(params, cfg, mel))
        out["encode_ms"] = 1e3 * s
        forced = [cfg.decoder_start_token_id, 50259, 50360, 50364]
        (ids, n_ids), s = synced(lambda: asr_model.greedy_decode(
            params, cfg, enc, forced, 440))
        out["greedy_tokens"] = n_ids - len(forced)
        out["decode_step_ms"] = 1e3 * s / (n_ids - 1)
        lf = asr_model.decoder_logits(params, cfg, ids[:n_ids], enc)
        pred = lf.argmax(-1)[len(forced) - 1:n_ids - 1]
        chosen = ids[len(forced):n_ids]
        part = torch.nonzero(pred != chosen).flatten().tolist()
        gaps = [float(lf[len(forced) - 1 + i].max()
                      - lf[len(forced) - 1 + i, chosen[i]]) for i in part]
        if any(g > WHISPER_NEAR_TIE for g in gaps):
            raise AssertionError(f"whisper greedy ids part from the "
                                 f"teacher-forced argmax at {part}, top "
                                 f"gaps {gaps} (tol {WHISPER_NEAR_TIE})")
        out["greedy_vs_teacher_forced_near_ties"] = len(part)
    rungs = []
    decode = asr_model.decode_with_stats

    def counted(*a, **k):
        res = decode(*a, **k)
        rungs.append(res[1] - len(forced))
        return res

    path = os.path.join(tempfile.mkdtemp(prefix="whisper_"), "ref.wav")
    audio_io.write_wav(path, wav, 16000)
    fn = transcribe.transcriber(params, cfg, WhisperStubTokenizer())
    asr_model.decode_with_stats = counted
    try:
        text, s = synced(lambda: fn(path))
    finally:
        asr_model.decode_with_stats = decode
        os.remove(path)
        os.rmdir(os.path.dirname(path))
    out.update(transcriber_wall_s=s, rung_tokens=rungs,
               transcript_words=len(text.split()))
    cfg2 = dataclasses.replace(cfg, encoder_layers=2)
    two = {"encoder": dict(params["encoder"], layers={
        k: {kk: vv[:2] for kk, vv in v.items()}
        for k, v in params["encoder"]["layers"].items()}),
           "decoder": params["decoder"]}
    with torch.inference_mode():
        card_enc = asr_model.encode(two, cfg2, mel).cpu()
        cpu_enc = asr_model.encode(tree_to(two, torch.device("cpu")),
                                   cfg2, mel.cpu())
    err = float((card_enc - cpu_enc).abs().max())
    if err > WHISPER_TOL or not torch.isfinite(card_enc).all():
        raise AssertionError(f"whisper 2-layer encoder: card vs CPU "
                             f"{err:.2e} (tol {WHISPER_TOL})")
    out["encoder_2layer_max_abs_err"] = err
    del params, two, enc
    torch.cuda.empty_cache()
    print(f"[asr] whisper large-v3-turbo widths ({out['params']} f32 "
          f"parameters, seeded random): log_mel {out['log_mel_ms']:.2f} ms, "
          f"encode {out['encode_ms']:.1f} ms, decoder step "
          f"{out['decode_step_ms']:.3f} ms ({out['greedy_tokens']} greedy "
          f"tokens; {out['greedy_vs_teacher_forced_near_ties']} near-tie "
          f"partings from the teacher-forced argmax); transcriber "
          f"{s:.3f}s over {len(rungs)} rungs of {rungs} tokens; 2-layer "
          f"encoder card vs CPU {err:.2e} (tol {WHISPER_TOL}) [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 4k: training
# ---------------------------------------------------------------------------

TRAIN_UTTS = 16                 # utterances of the synthetic dataset
TRAIN_WORDS = ("the", "voice", "of", "a", "port", "speaks", "softly", "and",
               "clearly", "today", "morning", "river", "light", "station",
               "garden", "slowly")
TRAIN_TEXT_LEN = 128            # text positions a row (byte tokens)
TRAIN_MICRO_TOKENS = 1280       # four utterances of <= 300 codes (pad 320)
TRAIN_STEPS = 4
TRAIN_RESUME_SPLIT = 2          # the split run saves here and resumes
# a resumed step against the uninterrupted one on the same card: the same
# kernels on the same inputs, so equal unless a kernel's reduction order
# depends on the run; allowed: a bf16 rounding's worth of the loss
TRAIN_RESUME_RTOL = 1e-3
LORA_LAYERS = 13                # (a): encoder and decoder depth (26 + 26
                                # until the whole run neared its 900 s aim)
FULL_LAYERS = 1                 # (b): encoder and decoder depth (2 + 2
                                # took 45 s on the CPU side)
FULL_LOSS_RTOL = 1e-4           # (b): f32, TF32 off, card against the CPU
FULL_GRAD_TOL = 1e-3            # of each leaf's largest CPU gradient
FULL_PARAM_TOL = 1e-5           # of each updated leaf's largest, beyond
                                # what the gradients' differences explain
CE_ROWS, CE_POSITIONS = 4, 301  # (c): bf16, the 2b-2b head, 65541 columns
CE_LOSS_RTOL = 1e-3
CE_NLL_ATOL = 2e-2              # a few bf16 ulps of a logit near 1
CE_GRAD_TOL = 2e-2              # nine bf16-rounded block partials summed


def byte_tokenizer(text: str) -> list:
    """A byte-level stand-in for the T5Gemma tokenizer (the card's machine
    has no ``transformers``): ids 3-258."""
    return [3 + b for b in text.encode("utf-8")]


PRE_BATCH = 4                   # encode_batch of the preprocess run


def write_wav_folder(folder: str, rate: int, seed: int,
                     n: int = TRAIN_UTTS) -> None:
    """``n`` seeded recordings of 2-6 s at ``rate`` (a tone plus noise,
    16-bit PCM), each with a transcript of TRAIN_WORDS, in
    ``preprocess.iter_wav_folder``'s layout: ``spk<k>_<i>.wav`` + ``.txt``,
    four speakers."""
    from t5gemma_tts_tpu_torch.inference.audio_io import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        utt = f"spk{i % 4}_{i:02d}"
        t = np.arange(int(rate * rng.uniform(2.05, 5.95))) / rate
        f0 = rng.uniform(0.01, 0.05) * rate
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.05 * rng.standard_normal(t.size))
        write_wav(os.path.join(folder, utt + ".wav"), wav.astype(np.float32),
                  rate)
        words = rng.choice(TRAIN_WORDS, size=int(rng.integers(6, 16)))
        with open(os.path.join(folder, utt + ".txt"), "w") as f:
            f.write(" ".join(words).capitalize() + ".")


def phase_preprocess(card: str, tok, directory: str, seed: int) -> dict:
    """After 4h, on 4h's full-width codec (``tok`` holds the encoder
    weights): TRAIN_UTTS seeded recordings of 2-6 s at 16 kHz through
    ``data/preprocess.prepare`` (encode batch PRE_BATCH, everything to the
    train split) into ``<directory>/prepared``, which 4k and 4l train on.
    Each utterance's codes must equal ``tok.encode`` of the same
    zero-padded batch cut to ``len(wav) // hop`` (that second pass is
    timed too, warm); the manifest, text, code and neighbor files must have
    the layout ``VoiceDataset`` reads, and it must read all of them."""
    from t5gemma_tts_tpu_torch.data import preprocess
    from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
    from t5gemma_tts_tpu_torch.data.manifest import DataConfig

    sr = tok.encode_sample_rate
    raw = os.path.join(directory, "raw")
    out = os.path.join(directory, "prepared")
    write_wav_folder(raw, sr, seed)
    samples = list(preprocess.iter_wav_folder(raw, sr))
    audio_s = sum(len(x.wav) for x in samples) / sr
    pcfg = preprocess.PreprocessConfig(out_dir=out, valid_fraction=0.0,
                                       encode_batch=PRE_BATCH, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = preprocess.prepare(iter(samples), tok, pcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(records) != TRAIN_UTTS:
        raise AssertionError(f"preprocess kept {len(records)} of "
                             f"{TRAIN_UTTS}")
    rel = {r.utt_id.split("/")[1]: r.utt_id for r in records}
    hop = int(np.prod(tok.cfg.acoustic_cfg.ratios))
    manifest = {}
    with open(os.path.join(out, "manifest_final", "train.txt")) as f:
        for line in f:
            key, n = line.rstrip("\n").split("\t")
            manifest[key] = int(n)
    t0 = time.perf_counter()
    for i in range(0, len(samples), PRE_BATCH):
        batch = samples[i:i + PRE_BATCH]
        wavs = np.zeros((len(batch), max(len(x.wav) for x in batch)),
                        np.float32)
        for row, x in enumerate(batch):
            wavs[row, :len(x.wav)] = x.wav
        codes = tok.encode(wavs)
        for row, x in enumerate(batch):
            key = rel[x.utt_id]
            with open(os.path.join(out, "xcodec2_1cb", key + ".txt")) as f:
                got = np.asarray(f.read().split(), np.int64)
            want = codes[row, :max(len(x.wav) // hop, 1), 0]
            if not np.array_equal(got, want) or manifest[key] != len(got):
                raise AssertionError(f"{key}: codes {got[:8]} ({len(got)}, "
                                     f"manifest {manifest[key]}) against "
                                     f"{want[:8]} ({len(want)})")
            with open(os.path.join(out, "text", key + ".txt")) as f:
                text = f.read().strip()
            if text != preprocess.normalize_text(x.text):
                raise AssertionError(f"{key}: text {text!r}")
            with open(os.path.join(out, "neighbors", key + ".txt")) as f:
                nbs = [ln.split("\t")[0] for ln in f.read().splitlines()]
            spk = x.speaker + "_"
            if len(nbs) != TRAIN_UTTS // 4 - 1 or not all(
                    n.split("/")[1].startswith(spk) for n in nbs):
                raise AssertionError(f"{key}: neighbors {nbs}")
    warm = time.perf_counter() - t0
    ds = VoiceDataset(DataConfig(dataset_dir=out, audio_min_length=2.0,
                                 audio_max_length=6.0, encodec_sr=50.0),
                      "train", byte_tokenizer, None, None, seed=seed)
    if len(ds) != TRAIN_UTTS or ds[0] is None:
        raise AssertionError(f"VoiceDataset reads {len(ds)} utterances")
    res = dict(dir=out, utts=TRAIN_UTTS, audio_s=audio_s, wall_s=wall,
               audio_s_per_s=audio_s / wall, warm_encode_s=warm,
               warm_audio_s_per_s=audio_s / warm,
               codes=int(sum(manifest.values())))
    print(f"[preprocess] {TRAIN_UTTS} utterances, {audio_s:.2f} s of 16 kHz "
          f"audio: prepare (encode batch {PRE_BATCH}, files written) "
          f"{wall:.3f} s, {res['audio_s_per_s']:.1f} s of audio a wall "
          f"second; the same batches encoded again (warm) in {warm:.3f} s, "
          f"{res['warm_audio_s_per_s']:.1f} s a second; {res['codes']} codes, "
          f"equal to AudioTokenizer.encode; layout read by VoiceDataset "
          f"[{card}]")
    return res


def train_step_profile(trainer, card: str) -> dict:
    """One step of ``trainer`` (its own step function on its state, the
    result dropped; the trainer has run) on the first accumulation group of
    epoch 0: the wall unprofiled, then a CUDA-only profile: device busy (the union of the
    kernels' intervals), the idle share of the wall, the kernels launched
    and the largest by device time."""
    from torch.profiler import ProfilerActivity, profile

    trainer.sampler.set_epoch(0)
    groups: dict = {}
    for bucket, rows in trainer.sampler:
        group = groups.setdefault(bucket, [])
        group.append(trainer._to_batch(
            [trainer.train_ds[i] if i >= 0 else None for i in rows], bucket,
            trainer.plan))
        if len(group) == trainer.tcfg.gradient_accumulation_steps:
            batch = trainer._device_batch(group)
            break
    lr = trainer._lr(trainer.progress["step"])

    def run():
        float(trainer._step_fn(trainer.state, batch, lr)[1].loss)

    t0 = time.perf_counter()            # the trainer's steps warmed it
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    rows, sum_ms, union_us, kernels = kernel_rows(prof)
    busy_ms = union_us / 1e3
    res = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
               kernels=len(kernels),
               top=[dict(ms=ms, count=c, name=k[:80]) for ms, c, k in rows[:6]])
    print(f"[train/profile] one LoRA step: wall {wall_ms:.1f} ms "
          f"(unprofiled), device busy {busy_ms:.1f} ms (the union of the "
          f"kernels' intervals; their sum {sum_ms:.1f} ms), idle share "
          f"{res['idle']:.3f}, {len(kernels)} kernels "
          f"({1e3 * wall_ms / max(len(kernels), 1):.1f} us of wall each) "
          f"[{card}]")
    for ms, count, key in rows[:6]:
        print(f"[train/profile] {ms:9.3f} ms {100 * ms / sum_ms:5.1f}% "
              f"x{count:<6d} {key[:90]}")
    return res


def phase_train_lora(card: str, seed: int, directory: str,
                     dataset: str) -> dict:
    """(a) LoRA at 2b-2b, full width and LORA_LAYERS + LORA_LAYERS layers
    (a cut of depth for the run's time; seeded random bf16 base,
    r 16, alpha 32, layers rematerialized, chunked CE at 8192 columns,
    ScaledAdam on the adapters, two micro-batches a step) through
    ``Trainer`` over ``dataset``, the utterances the port's preprocessing
    encoded after 4h: TRAIN_STEPS steps timed
    (synchronized), peak memory; every loss finite and no step skipped, the
    base bit-unchanged, every adapter ``b`` moved from zero; a run saved at
    TRAIN_RESUME_SPLIT and resumed in a fresh ``Trainer`` against the
    uninterrupted run; then ``lora.merge`` into the bf16 ``TTSPipeline``
    (``fuse_for_decode``), one 1.0 s request graphed, kernel 1 launched
    2 x LORA_LAYERS a step body, tokens equal to the eager decode's."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
    from t5gemma_tts_tpu_torch.data.manifest import DataConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request, TTSPipeline
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.train import lora
    from t5gemma_tts_tpu_torch.train.trainer import Trainer, TrainerConfig
    from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

    cfg = depth_cut(VoiceConfig(gradient_checkpointing=True,
                                ce_vocab_chunk=8192), LORA_LAYERS)
    dcfg = DataConfig(dataset_dir=dataset, audio_min_length=2.0,
                      audio_max_length=6.0, encodec_sr=50.0)
    t0 = time.time()
    base = voice.init_params(seed, cfg, "cuda")
    frozen = [t.clone() for _, t in leaves_with_path(base)]
    torch.cuda.synchronize()
    print(f"[train/lora] 2b-2b base at {LORA_LAYERS} + {LORA_LAYERS} "
          f"layers built in {time.time() - t0:.1f}s "
          f"({n_params(base) / 1e9:.2f} B bf16 parameters)")

    def trainer(exp: str, steps: int) -> Trainer:
        tcfg = TrainerConfig(
            exp_dir=os.path.join(directory, exp), optimizer_name="ScaledAdam",
            num_steps=steps, gradient_accumulation_steps=2,
            max_num_tokens=TRAIN_MICRO_TOKENS, num_buckets=1,
            text_max_length=TRAIN_TEXT_LEN, print_every_n_steps=10 ** 6,
            val_every_n_steps=10 ** 6, early_stop_step=0, num_epochs=100,
            seed=seed, use_lora=True, lora_r=16, lora_alpha=32)
        ds = VoiceDataset(dcfg, "train", byte_tokenizer, cfg.x_sep_token,
                          cfg.special.y_sep, seed=seed)
        return Trainer(cfg, tcfg, ds, params=base, device="cuda")

    base_bytes = sum(t.numel() * t.element_size()
                     for _, t in leaves_with_path(base))
    before = torch.cuda.memory_allocated()     # the base and its copy
    torch.cuda.reset_peak_memory_stats()
    whole = trainer("whole", TRAIN_STEPS)
    rows = whole.plan.batch_sizes[0]
    whole.train()
    # the training run's peak: the base, and what training added above
    # everything allocated before it (the check's copy not counted)
    train_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    peak_gb = base_bytes / 1e9 + train_gb
    hist = whole.history
    losses = [h["loss"] for h in hist]
    if not (len(hist) == TRAIN_STEPS and np.isfinite(losses).all()
            and int(whole.state.nan_skips) == 0):
        raise AssertionError(f"LoRA steps {hist}, nan_skips "
                             f"{int(whole.state.nan_skips)}")
    for before, (path, after) in zip(frozen, leaves_with_path(base)):
        if not torch.equal(before, after):
            raise AssertionError(f"the frozen base moved at {path}")
    del frozen
    b_leaves = [(p, t) for p, t in leaves_with_path(whole.state.params)
                if p[-1] == "b"]
    still = [p for p, t in b_leaves if not bool(t.abs().max() > 0)]
    if len(b_leaves) != 18 or still:
        raise AssertionError(f"{len(b_leaves)} adapters, still zero: {still}")
    adapter_params = sum(t.numel() for _, t in
                         leaves_with_path(whole.state.params))
    profiled = train_step_profile(whole, card)

    first = trainer("split", TRAIN_RESUME_SPLIT)
    first.train()
    resumed = trainer("split", TRAIN_STEPS)
    if resumed.progress["step"] != TRAIN_RESUME_SPLIT:
        raise AssertionError(f"resumed at {resumed.progress}")
    resumed.train()
    split = [h["loss"] for h in first.history + resumed.history]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(split, losses))
    ad_err = max(float((a.float() - b.float()).abs().max())
                 for (_, a), (_, b) in zip(
                     leaves_with_path(resumed.state.params),
                     leaves_with_path(whole.state.params)))
    if len(split) != TRAIN_STEPS or loss_rel > TRAIN_RESUME_RTOL:
        raise AssertionError(f"resumed losses {split} against {losses}")
    seconds = [h["seconds"] for h in hist]
    ntok = sum(h["ntokens"] for h in hist)
    res = dict(layers=LORA_LAYERS, steps=TRAIN_STEPS, micro_rows=rows,
               losses=losses,
               step_ms=[1e3 * s for s in seconds],
               mean_step_ms=1e3 * float(np.mean(seconds[1:])),
               tokens_per_s=ntok / sum(seconds),
               steady_tokens_per_s=sum(h["ntokens"] for h in hist[1:])
               / sum(seconds[1:]),
               peak_gb=peak_gb, above_base_gb=train_gb,
               adapter_params=adapter_params,
               resume_loss_rel=loss_rel, resume_adapter_max_abs=ad_err,
               profile=profiled)
    print(f"[train/lora] {TRAIN_STEPS} steps of 2 x {rows} utterances: "
          f"losses {['%.4f' % x for x in losses]}, ms a step "
          f"{['%.1f' % x for x in res['step_ms']]} (mean after the first "
          f"{res['mean_step_ms']:.1f}), {res['tokens_per_s']:.1f} training "
          f"tokens/s ({res['steady_tokens_per_s']:.1f} after the first), "
          f"peak {peak_gb:.2f} GB allocated ({train_gb:.2f} GB above the "
          f"base), {adapter_params / 1e6:.1f} M "
          f"adapter parameters; resumed at step {TRAIN_RESUME_SPLIT}: "
          f"losses within {loss_rel:.2e} relative, adapters within "
          f"{ad_err:.2e} [{card}]")
    adapters = whole.state.params
    del whole, first, resumed

    merged = lora.merge(base, adapters, lora.LoraConfig(r=16, alpha=32))
    del base
    pipe = TTSPipeline(merged, cfg, byte_tokenizer, None, device="cuda")
    del merged
    req = Request(target_text="The voice of the port speaks clearly.",
                  target_duration=1.0, lang="en")
    dcfg_dec = DecodeConfig(kv_cache="paged", seed=seed)
    results, wall, launches = _counted(lambda: pipe.synthesize_batch(
        [req], dcfg_dec, seed=seed, decode_audio=False))
    launched = results[0].launched_steps
    layers = cfg.backbone.decoder.num_layers
    if launches["batch_paged_attention"] != 2 * layers * launched:
        raise AssertionError(f"merged LoRA serve: {launched} bodies, "
                             f"launches {launches}")
    res["serve"] = graphed_vs_eager(pipe, [req], dcfg_dec, seed,
                                    "lora merged b1", card)
    res["serve"]["kernel1_launches"] = launches["batch_paged_attention"]
    del pipe
    engine.release_sessions()
    torch.cuda.empty_cache()
    return res


def full_step_setup(seed: int) -> tuple:
    """(cfg, numpy batch, ScaledAdam config, lr) of 4k(b)'s full-model
    step: 2b-2b width, FULL_LAYERS + FULL_LAYERS layers, f32, chunked CE,
    two micro-batches of one row."""
    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.train import optim

    cfg = depth_cut(VoiceConfig(dtype="float32", ce_vocab_chunk=8192),
                    FULL_LAYERS)
    rng = np.random.default_rng(seed)
    n_micro, rows, tx, ty = 2, 1, 32, 160     # the CPU side bounds it
    batch = dict(
        x=rng.integers(3, 259, (n_micro, rows, tx)).astype(np.int32),
        x_lens=rng.integers(tx // 2, tx + 1, (n_micro, rows)).astype(np.int32),
        y=rng.integers(0, cfg.audio_vocab_size,
                       (n_micro, rows, ty)).astype(np.int32),
        y_lens=rng.integers(ty // 2, ty + 1, (n_micro, rows)).astype(np.int32),
        y_sep_position=np.zeros((n_micro, rows), np.int32))
    return cfg, batch, optim.ScaledAdamConfig(), 0.035


def phase_train_full(card: str, seed: int) -> dict:
    """(b) Full-model ScaledAdam at 2b-2b width, FULL_LAYERS + FULL_LAYERS
    layers, f32 (TF32 off): one step of two micro-batches through the
    port's step (``accumulate_grads`` then ``apply_grads``) on the card and
    on the CPU from the same state; loss, every gradient leaf and every
    updated leaf compared."""
    from t5gemma_tts_tpu_torch.device import tree_to
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.train import optim, train_step
    from t5gemma_tts_tpu_torch.utils.tree import keystr, leaves_with_path

    cfg, batch, ocfg, lr = full_step_setup(seed)
    n_micro, rows = batch["x"].shape[:2]

    def forward(p, mb):
        return voice.forward(p, cfg, mb)

    def step(params, device):
        dev = torch.device(device)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        opt = optim.init(params, ocfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, sums = train_step.accumulate_grads(params, b, forward)
        float(sums["loss"])
        t1 = time.perf_counter()
        new, _, metrics = train_step.apply_grads(
            params, opt, grads, sums, torch.tensor(lr, device=dev), ocfg)
        float(metrics.loss)
        return grads, new, metrics, (t1 - t0, time.perf_counter() - t1)

    params = voice.init_params(seed, cfg, "cuda")
    cpu_params = tree_to(params, torch.device("cpu"))
    n = n_params(params)
    g_card, p_card, m_card, card_s = step(params, "cuda")
    del params
    g_cpu, p_cpu, m_cpu, cpu_s = step(cpu_params, "cpu")
    loss_rel = abs(float(m_card.loss) - float(m_cpu.loss)) / abs(
        float(m_cpu.loss))
    grad_worst = param_worst = fro_worst = 0.0
    worst_leaf = ""
    beta1 = ocfg.betas[0]
    for (path, gc), (_, gx), (_, pc), (_, px), (_, p0) in zip(
            *(leaves_with_path(t) for t in (g_card, g_cpu, p_card, p_cpu,
                                            cpu_params))):
        gc, pc = gc.cpu(), pc.cpu()
        err = float((gc - gx).abs().max()) / max(float(gx.abs().max()), 1e-30)
        if err > grad_worst:
            grad_worst, worst_leaf = err, keystr(path)
        # ScaledAdam's first step moves each element by lr (1 - beta1)
        # max(rms, min_rms) g / (|g| + eps): an element's update differs
        # between the devices as far as its gradients' difference carries
        # through that normalization (far, where |g| is near f32 noise)
        rms = optim._rms(p0, optim._is_stacked(path)).clamp(
            min=ocfg.param_min_rms)

        def unit(g):
            return g / (g.abs() + ocfg.eps)

        carried = lr * (1 - beta1) * rms * (unit(gc) - unit(gx)).abs()
        excess = ((pc - px).abs() - carried).clamp(min=0)
        param_worst = max(param_worst, float(excess.max()) / max(
            float(px.abs().max()), 1e-30))
        fro_worst = max(fro_worst, float(
            torch.linalg.vector_norm((pc - px).double())
            / max(float(torch.linalg.vector_norm(px.double())), 1e-30)))
    res = dict(layers=FULL_LAYERS, params=n, loss=float(m_cpu.loss),
               loss_rel=loss_rel, grad_worst=grad_worst,
               grad_worst_leaf=worst_leaf, param_excess_worst=param_worst,
               param_fro_worst=fro_worst, card_grads_s=card_s[0],
               card_update_s=card_s[1], cpu_grads_s=cpu_s[0],
               cpu_update_s=cpu_s[1], ntokens=float(m_cpu.ntokens))
    print(f"[train/full] 2b-2b width, {FULL_LAYERS} + {FULL_LAYERS} layers "
          f"({n / 1e9:.2f} B f32 parameters), one ScaledAdam step of "
          f"{n_micro} x {rows} rows ({float(m_cpu.ntokens):.0f} tokens): "
          f"loss {float(m_card.loss):.6f} card vs {float(m_cpu.loss):.6f} "
          f"CPU ({loss_rel:.2e} relative, tol {FULL_LOSS_RTOL}); worst "
          f"gradient leaf {worst_leaf} {grad_worst:.2e} of its largest "
          f"(tol {FULL_GRAD_TOL}); updated leaves within {param_worst:.2e} "
          f"of their largest beyond what the gradients' differences carry "
          f"through the update (tol {FULL_PARAM_TOL}; {fro_worst:.2e} "
          f"relative Frobenius); gradients + update {card_s[0]:.2f} + "
          f"{card_s[1]:.2f} s on the card, {cpu_s[0]:.2f} + {cpu_s[1]:.2f} s "
          f"on the CPU [{card}]")
    if (loss_rel > FULL_LOSS_RTOL or grad_worst > FULL_GRAD_TOL
            or param_worst > FULL_PARAM_TOL):
        raise AssertionError(f"full-model step, card against CPU: {res}")
    return res


def phase_chunked_ce(card: str, seed: int, iters: int = 5) -> dict:
    """(c) ``head_nll_top10`` at 2b-2b width and the full audio vocab,
    bf16, CE_ROWS x CE_POSITIONS positions on the card: forward and
    backward against the dense head + ``token_loss`` under autograd (nll,
    hits but at a near tie, the loss and the gradients of w1 / b1 / w2 /
    b2 / hidden), each path's time and peak memory."""
    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.ops import chunked_ce

    cfg = VoiceConfig()
    d, va = cfg.backbone.hidden_size, cfg.audio_embedding_vocab
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    head = {"w1": randn(d, d, std=0.02), "b1": randn(d, std=0.02),
            "w2": randn(d, va, std=0.02), "b2": randn(va, std=0.02)}
    hidden = randn(CE_ROWS, CE_POSITIONS, d)
    targets = torch.randint(0, va, (CE_ROWS, CE_POSITIONS), generator=gen,
                            device="cuda", dtype=torch.int32)
    lens = torch.tensor([CE_POSITIONS, 280, 250, 200][:CE_ROWS],
                        dtype=torch.int32, device="cuda")

    def run(chunked):
        h = {k: v.detach().requires_grad_(True) for k, v in head.items()}
        x = hidden.detach().requires_grad_(True)
        if chunked:
            nll, hit = chunked_ce.head_nll_top10(cfg.ce_vocab_chunk, h, x,
                                                 targets)
            out = voice.loss_from_nll(cfg, nll, hit, targets, lens, None)
        else:
            logits = voice.predict_head(h, x)
            lf = logits.float()
            nll = -torch.gather(torch.log_softmax(lf, -1), -1,
                                targets.long()[..., None])[..., 0]
            hit = None
            out = voice.token_loss(cfg, logits, targets, lens, None)
        grads = torch.autograd.grad(out.loss, [h[k] for k in sorted(h)] + [x])
        return out, nll.detach(), hit, dict(zip(sorted(h) + ["hidden"],
                                                grads))

    stats = {}
    for name, chunked in (("chunked", True), ("dense", False)):
        run(chunked)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: run(chunked), iters)
        stats[name] = dict(ms=ms, peak_gb=(torch.cuda.max_memory_allocated()
                                           - base_mem) / 1e9)
    out_c, nll_c, hit_c, g_c = run(True)
    out_d, nll_d, _, g_d = run(False)
    # the dense top-10 by value, and which targets sit at its 10th value
    with torch.no_grad():
        lf = voice.predict_head(head, hidden).float()
        kth = torch.topk(lf, 10, dim=-1).values[..., 9]
        tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
        hit_d = tgt >= kth
        ulp = torch.finfo(torch.bfloat16).eps * kth.abs().clamp(min=1e-3)
        near = (tgt - kth).abs() <= 2 * ulp
    parted = hit_c != hit_d
    loss_c, loss_d = float(out_c.loss.detach()), float(out_d.loss.detach())
    loss_rel = abs(loss_c - loss_d) / abs(loss_d)
    nll_err = float((nll_c - nll_d).abs().max())
    grad_err = {k: float((g_c[k].float() - g_d[k].float()).abs().max())
                / max(float(g_d[k].float().abs().max()), 1e-30) for k in g_c}
    res = dict(rows=CE_ROWS, positions=CE_POSITIONS, vocab=va,
               chunk=cfg.ce_vocab_chunk, loss_rel=loss_rel,
               nll_max_abs=nll_err, hits=int(hit_d.sum()),
               hits_parted=int(parted.sum()),
               hits_parted_at_near_tie=int((parted & near).sum()),
               grad_rel=grad_err, **{f"{k}_ms": v["ms"]
                                     for k, v in stats.items()},
               **{f"{k}_peak_gb": v["peak_gb"] for k, v in stats.items()})
    print(f"[train/chunked_ce] {CE_ROWS} x {CE_POSITIONS} positions, vocab "
          f"{va}, chunk {cfg.ce_vocab_chunk}, bf16: loss {loss_rel:.2e} "
          f"relative of the dense head's (tol {CE_LOSS_RTOL}), nll within "
          f"{nll_err:.2e} (tol {CE_NLL_ATOL}), hits {int(hit_d.sum())}, "
          f"{int(parted.sum())} parted ({int((parted & near).sum())} at a "
          f"near tie), gradients within "
          f"{', '.join(f'{k} {v:.2e}' for k, v in grad_err.items())} of "
          f"their largest (tol {CE_GRAD_TOL}); forward + backward "
          f"{stats['chunked']['ms']:.2f} ms chunked vs "
          f"{stats['dense']['ms']:.2f} ms dense, peak "
          f"{stats['chunked']['peak_gb']:.2f} vs "
          f"{stats['dense']['peak_gb']:.2f} GB above the inputs [{card}]")
    if (loss_rel > CE_LOSS_RTOL or nll_err > CE_NLL_ATOL
            or bool((parted & ~near).any())
            or max(grad_err.values()) > CE_GRAD_TOL):
        raise AssertionError(f"chunked CE against the dense head: {res}")
    return res


MTP_K, MTP_ROWS, MTP_T = 4, 2, 64    # (d): 2b-2b width, the full vocab
MTP_LOSS_RTOL = 1e-5                 # f32, TF32 off, card against the CPU
MTP_GRAD_TOL = 1e-4                  # of each leaf's largest CPU gradient


def phase_mtp_loss(card: str, seed: int) -> dict:
    """(d) ``decode/speculative.mtp_loss`` at 2b-2b width: MTP_K seeded f32
    heads (D = 2304, V = 65541), hidden [MTP_ROWS, MTP_T, D] with masked
    positions, value and gradients (autograd) on the card and on the CPU
    from the same inputs; the card's forward + backward timed."""
    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.decode import speculative

    cfg = VoiceConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    heads = speculative.init_mtp_heads(gen, cfg, MTP_K, dtype=torch.float32)
    rng = np.random.default_rng(seed + 11)
    d = cfg.backbone.decoder.hidden_size
    hidden = torch.from_numpy(
        rng.standard_normal((MTP_ROWS, MTP_T, d)).astype(np.float32))
    targets = torch.from_numpy(
        rng.integers(0, cfg.audio_embedding_vocab, (MTP_ROWS, MTP_T)))
    mask = torch.ones((MTP_ROWS, MTP_T), dtype=torch.bool)
    mask[1, MTP_T - 14:] = False

    def leaves(dev):
        return [{n: h[n].detach().to(dev).requires_grad_() for n in h}
                for h in heads]

    def run(hs, dev):
        for h in hs:
            for t in h.values():
                t.grad = None
        loss = speculative.mtp_loss(hs, hidden.to(dev), targets.to(dev),
                                    mask.to(dev))
        loss.backward()
        return loss.detach()

    t0 = time.time()
    cpu_heads = leaves("cpu")
    want = run(cpu_heads, "cpu")
    cpu_s = time.time() - t0
    card_heads = leaves("cuda")
    got = run(card_heads, "cuda")
    loss_rel = abs(float(got) - float(want)) / abs(float(want))
    grad_err = max(
        float((c[n].grad.cpu() - h[n].grad).abs().max()
              / h[n].grad.abs().max())
        for c, h in zip(card_heads, cpu_heads) for n in ("w1", "w2"))
    del cpu_heads
    ms = cuda_ms(lambda: run(card_heads, "cuda"), 3)
    del card_heads, heads
    if not (loss_rel <= MTP_LOSS_RTOL and grad_err <= MTP_GRAD_TOL):
        raise AssertionError(f"mtp_loss card {float(got)} vs CPU "
                             f"{float(want)} ({loss_rel:.2e}); gradients "
                             f"{grad_err:.2e} of each leaf's largest")
    res = dict(k=MTP_K, loss=float(got), loss_rel=loss_rel,
               grad_rel_max=grad_err, card_fwd_bwd_ms=ms, cpu_s=cpu_s)
    print(f"[train/mtp] mtp_loss, {MTP_K} heads at D {d} x V "
          f"{cfg.audio_embedding_vocab}, hidden {MTP_ROWS} x {MTP_T} (f32): "
          f"{float(got):.6f}, card vs CPU {loss_rel:.2e} relative, "
          f"gradients within {grad_err:.2e} of each leaf's largest; forward "
          f"+ backward {ms:.2f} ms on the card (CPU {cpu_s:.1f} s) [{card}]")
    return res


def rank_state_gb(cfg, dp: int, tp: int, zero: bool) -> float:
    """GB a rank holds of a full fine-tune's state under the port's specs
    at (dp, tp): bf16 parameters, f32 gradients and two f32 moments
    (ScaledAdam's delta and exp_avg_sq, AdamW's mu and nu), ZeRO-1 on the
    moments when ``zero``. Reckoned from ``meta`` shapes; nothing is
    allocated."""
    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

    meta = voice.init_params(0, cfg, "meta")
    specs = parallel.param_specs(meta, cfg, tp)
    total = 0
    for (_, p), (_, spec) in zip(leaves_with_path(meta),
                                 leaves_with_path(specs)):
        n = p.numel() // (tp if spec.dim(parallel.MODEL_AXIS) is not None
                          else 1)
        moments = parallel.zero_spec(spec, p.shape, dp) if zero else spec
        m = n // (dp if moments.dim(parallel.DATA_AXIS) is not None else 1)
        total += 2 * n + 4 * n + 2 * 4 * m
    return total / 1e9


PARALLEL_GRID = ((1, 1, True), (2, 1, True), (1, 2, False), (2, 2, True))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_parallel(card: str, seed: int) -> dict:
    """4k(e) ``[parallel]``: NCCL at world size 1 (127.0.0.1, a free port),
    ``make_mesh(dp=1, tp=1)`` with ZeRO-1 on; 4k(b)'s full-model ScaledAdam
    step (2b-2b width, FULL_LAYERS + FULL_LAYERS layers, f32, TF32 off)
    through the mesh's step and the plain step from the same state, in
    turns (plain, mesh, mesh, plain): the loss and metrics, every gradient
    leaf and every updated leaf bit-equal; the collectives of a mesh step
    and their bytes; then both updated models served graphed in bf16, one
    1.0 s greedy request at B = 1 (kernel 1 2 x FULL_LAYERS launches a
    step body), tokens equal; and the per-rank GB of the 2b-2b full
    fine-tune state at PARALLEL_GRID, reckoned from shapes."""
    import torch.distributed as dist

    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request, TTSPipeline
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.parallel import mesh as mesh_mod
    from t5gemma_tts_tpu_torch.train import optim, train_step
    from t5gemma_tts_tpu_torch.utils.tree import tree_map

    t_start = time.time()
    cfg, np_batch, ocfg, lr = full_step_setup(seed)
    parallel.init_distributed(
        "cuda", init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        world = dist.get_world_size()
        mesh = parallel.make_mesh(dp=1, tp=1)
        # the communicator's start, outside the timed steps
        mesh_mod.all_reduce(torch.ones(1, device="cuda"), mesh.data_group)
        batch = {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}
        lr_t = torch.tensor(lr, device="cuda")
        params = voice.init_params(seed, cfg, "cuda")
        specs = parallel.param_specs(params, cfg, mesh.tp)
        local = parallel.shard_params(params, mesh, specs)
        layout = parallel.Layout(mesh, specs, local, zero=True)

        def forward(p, mb):
            return voice.forward(p, cfg, mb)

        def plain():
            grads, sums = train_step.accumulate_grads(params, batch, forward)
            new, _, metrics = train_step.apply_grads(
                params, optim.init(params, ocfg), grads, sums, lr_t, ocfg)
            return grads, new, metrics

        def meshed():
            grads, sums = train_step.accumulate_grads(local, batch, forward,
                                                      mesh)
            new, _, metrics = train_step.apply_grads(
                local, optim.init(local, ocfg, layout), grads, sums, lr_t,
                ocfg, layout)
            return grads, new, metrics

        want, plain_s = synced(plain)
        mesh_mod.reset_counts()
        got, mesh_s = synced(meshed)
        counts = dict(mesh_mod.COUNTS)
        _bit_equal(got[0], want[0], "the mesh step's gradients")
        _bit_equal(got[1], want[1], "the mesh step's updated parameters")
        for f in want[2]._fields:
            if not torch.equal(getattr(got[2], f), getattr(want[2], f)):
                raise AssertionError(f"the mesh step's {f}: "
                                     f"{getattr(got[2], f)} against "
                                     f"{getattr(want[2], f)}")
        new_mesh, new_plain, metrics = got[1], want[1], want[2]
        del got, want
        mesh_times = [mesh_s, synced(meshed)[1]]
        plain_times = [plain_s, synced(plain)[1]]
        del params, local
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    req = Request(target_text="The voice of the port speaks clearly.",
                  target_duration=1.0, lang="en")
    dcfg = DecodeConfig(kv_cache="paged", top_k=1, seed=seed)
    served = {}
    for name in ("mesh", "plain"):
        tree = new_mesh if name == "mesh" else new_plain
        pipe = TTSPipeline(tree_map(lambda t: t.to(torch.bfloat16), tree),
                           cfg16, byte_tokenizer, None, device="cuda")
        results, wall, launches = _counted(lambda: pipe.synthesize_batch(
            [req], dcfg, seed=seed, decode_audio=False))
        bodies = results[0].launched_steps
        if launches["batch_paged_attention"] != 2 * FULL_LAYERS * bodies:
            raise AssertionError(f"served {name} step: {bodies} bodies, "
                                 f"launches {launches}")
        served[name] = dict(frames=results[0].gen_frames, bodies=bodies,
                            launches=launches["batch_paged_attention"],
                            wall=wall)
        del pipe
        engine.release_sessions()
    del new_mesh, new_plain
    torch.cuda.empty_cache()
    if not np.array_equal(served["mesh"]["frames"],
                          served["plain"]["frames"]):
        raise AssertionError(
            f"served from the mesh's step {served['mesh']['frames'][:16]} "
            f"against the plain step's {served['plain']['frames'][:16]}")
    full = VoiceConfig()
    gb = {f"dp{dp}_tp{tp}{'_zero' if zero else ''}":
          rank_state_gb(full, dp, tp, zero) for dp, tp, zero in PARALLEL_GRID}
    res = dict(nccl=nccl, world=world, layers=FULL_LAYERS,
               loss=float(metrics.loss), mesh_ms=[t * 1e3 for t in mesh_times],
               plain_ms=[t * 1e3 for t in plain_times],
               collectives=counts["calls"], collective_bytes=counts["bytes"],
               serve_bodies=served["mesh"]["bodies"],
               kernel1_launches=served["mesh"]["launches"],
               serve_wall_s=served["mesh"]["wall"],
               frames=int(len(served["mesh"]["frames"])), rank_gb=gb,
               seconds=time.time() - t_start)
    print(f"[parallel] NCCL {nccl}, world {world}, mesh dp 1 x tp 1 with "
          f"ZeRO-1: 4k(b)'s step ({FULL_LAYERS} + {FULL_LAYERS} layers, f32) "
          f"bit-equal to the plain step (loss {res['loss']:.6f}, every "
          f"gradient and updated leaf); mesh step "
          f"{'/'.join('%.1f' % t for t in res['mesh_ms'])} ms against plain "
          f"{'/'.join('%.1f' % t for t in res['plain_ms'])} ms; "
          f"{counts['calls']} collectives a step moving "
          f"{counts['bytes'] / 1e9:.3f} GB; served bf16 graphed: "
          f"{res['serve_bodies']} step bodies, kernel 1 "
          f"{res['kernel1_launches']} launches, {res['frames']} frames equal "
          f"to the plain step's; per-rank GB of the 2b-2b full fine-tune "
          f"(bf16 params, f32 grads and moments, reckoned) "
          f"{json.dumps({k: round(v, 2) for k, v in gb.items()})}; "
          f"{res['seconds']:.1f} s [{card}]")
    return res


def phase_train(card: str, seed: int, dataset: str) -> dict:
    """Phase 4k: (a) LoRA at full width (LORA_LAYERS deep) through
    ``Trainer`` over
    the port-encoded ``dataset`` and the merged model served, (b) the
    full-model step card against CPU, (c) chunked CE against the dense head
    at the full vocab, (d) ``mtp_loss`` card against CPU."""
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        res = {"lora": phase_train_lora(card, seed, d, dataset)}
    torch.cuda.empty_cache()
    res["full"] = phase_train_full(card, seed)
    torch.cuda.empty_cache()
    res["parallel"] = phase_parallel(card, seed)
    torch.cuda.empty_cache()
    res["chunked_ce"] = phase_chunked_ce(card, seed)
    torch.cuda.empty_cache()
    res["mtp"] = phase_mtp_loss(card, seed)
    torch.cuda.empty_cache()
    res["seconds"] = time.time() - t0
    return res


# ---------------------------------------------------------------------------
# phase 4l: the fine-tuning lifecycle through files
# ---------------------------------------------------------------------------

LIFE_LAYERS = 1                 # encoder and decoder depth, full width
LIFE_STEPS = 2


def _bit_equal(got, want, what: str) -> None:
    from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

    got, want = list(leaves_with_path(got)), list(leaves_with_path(want))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"{what}: the trees differ")
    for (path, a), (_, b) in zip(got, want):
        if a.dtype != b.dtype or not torch.equal(a, b.to(a.device)):
            raise AssertionError(f"{what}: {path} differs")


def phase_lifecycle(card: str, seed: int, dataset: str) -> dict:
    """Phase 4l: a base at 2b-2b width and LIFE_LAYERS + LIFE_LAYERS layers
    (bf16, seeded) written as the trainer writes an experiment directory
    (``save_bundle`` of a TrainState whose params are the base, and
    ``save_config``); ``load_voice_model`` of it bit-equal to the base; a
    LoRA ``Trainer`` (r 16, alpha 32, ScaledAdam) for LIFE_STEPS steps on
    that base over ``dataset`` (the port-encoded utterances); the export's
    ``main --bundle <base> --lora_bundle <lora>/bundle --save_adapter_dir``
    (bf16); ``load_voice_model`` of the export bit-equal to ``lora.merge``
    of the base and the trained adapters; one 1.0 s request served from
    the loaded model through ``TTSPipeline``, graphed (kernel 1 2 x
    LIFE_LAYERS launches a step body), its tokens equal to those of a
    pipeline over the in-memory merge. Each write and read timed (s,
    GB/s; the file cache warm)."""
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
    from t5gemma_tts_tpu_torch.data.manifest import DataConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.export import hf_export
    from t5gemma_tts_tpu_torch.inference.loading import load_voice_model
    from t5gemma_tts_tpu_torch.inference.pipeline import Request, TTSPipeline
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.train import checkpoint as ckpt
    from t5gemma_tts_tpu_torch.train import lora
    from t5gemma_tts_tpu_torch.train.train_step import TrainState
    from t5gemma_tts_tpu_torch.train.trainer import Trainer, TrainerConfig
    from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

    t_start = time.time()
    cfg = depth_cut(VoiceConfig(), LIFE_LAYERS)
    base = voice.init_params(seed + 5, cfg, "cuda")
    gb = sum(t.numel() * t.element_size()
             for _, t in leaves_with_path(base)) / 1e9
    io = {}

    def note(name, secs, nbytes_gb):
        io[name] = dict(s=secs, gb=nbytes_gb, gb_per_s=nbytes_gb / secs)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_life_") as d:
        base_exp = os.path.join(d, "base")
        zero = torch.zeros((), dtype=torch.int32)
        _, secs = synced(lambda: (
            ckpt.save_bundle(base_exp, TrainState(base, None, zero, zero),
                             {"step": 0}),
            ckpt.save_config(base_exp, cfg)))
        note("write bundle", secs, os.path.getsize(os.path.join(
            base_exp, ckpt.BUNDLE, ckpt.STATE_FILE)) / 1e9)
        (loaded, lcfg, _), secs = synced(
            lambda: load_voice_model(base_exp, "cuda"))
        note("read bundle", secs, gb)
        _bit_equal(loaded, base, "the loaded bundle")
        if dataclasses.asdict(lcfg) != dataclasses.asdict(cfg):
            raise AssertionError(f"config.json read back as {lcfg}")
        del loaded

        tcfg = TrainerConfig(
            exp_dir=os.path.join(d, "lora"), optimizer_name="ScaledAdam",
            num_steps=LIFE_STEPS, max_num_tokens=TRAIN_MICRO_TOKENS,
            num_buckets=1, text_max_length=TRAIN_TEXT_LEN,
            print_every_n_steps=10 ** 6, val_every_n_steps=10 ** 6,
            early_stop_step=0, num_epochs=100, seed=seed, use_lora=True,
            lora_r=16, lora_alpha=32)
        ds = VoiceDataset(DataConfig(dataset_dir=dataset, audio_min_length=2.0,
                                     audio_max_length=6.0, encodec_sr=50.0),
                          "train", byte_tokenizer, cfg.x_sep_token,
                          cfg.special.y_sep, seed=seed)
        trainer = Trainer(cfg, tcfg, ds, params=base, device="cuda")
        _, train_s = synced(trainer.train)
        losses = [h["loss"] for h in trainer.history]
        if len(losses) != LIFE_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"LoRA steps {trainer.history}")
        adapters = trainer.state.params
        del trainer

        hf = os.path.join(d, "hf")
        _, secs = synced(lambda: hf_export.main([
            "--bundle", base_exp, "--lora_bundle",
            os.path.join(tcfg.exp_dir, ckpt.BUNDLE), "--save_adapter_dir",
            os.path.join(d, "adapter"), "--out", hf]))
        note("export (read base, merge, write)", secs, os.path.getsize(
            os.path.join(hf, "model.safetensors")) / 1e9)
        (exported, ecfg, _), secs = synced(
            lambda: load_voice_model(hf, "cuda"))
        note("read export", secs, gb)
    merged = lora.merge(base, adapters, lora.LoraConfig(r=16, alpha=32))
    del base, adapters
    _bit_equal(exported, merged, "the loaded export")

    req = Request(target_text="The voice of the port speaks clearly.",
                  target_duration=1.0, lang="en")
    dcfg = DecodeConfig(kv_cache="paged", seed=seed)
    pipe = TTSPipeline(exported, ecfg, byte_tokenizer, None, device="cuda")
    del exported
    results, wall, launches = _counted(lambda: pipe.synthesize_batch(
        [req], dcfg, seed=seed, decode_audio=False))
    launched = results[0].launched_steps
    if launches["batch_paged_attention"] != 2 * LIFE_LAYERS * launched:
        raise AssertionError(f"served export: {launched} bodies, launches "
                             f"{launches}")
    del pipe
    engine.release_sessions()
    mem = TTSPipeline(merged, cfg, byte_tokenizer, None, device="cuda")
    del merged
    want = mem.synthesize_batch([req], dcfg, seed=seed, decode_audio=False)
    del mem
    engine.release_sessions()
    torch.cuda.empty_cache()
    got_frames, want_frames = results[0].gen_frames, want[0].gen_frames
    if not np.array_equal(got_frames, want_frames):
        raise AssertionError(f"served export tokens {got_frames[:16]} "
                             f"against the in-memory merge "
                             f"{want_frames[:16]}")
    res = dict(layers=LIFE_LAYERS, gb=gb, io=io, lora_losses=losses,
               train_s=train_s, steps=results[0].steps,
               bodies=launched, kernel1_launches=launches[
                   "batch_paged_attention"], serve_wall_s=wall,
               frames=int(len(got_frames)), seconds=time.time() - t_start)
    for name, r in io.items():
        print(f"[lifecycle] {name}: {r['gb']:.3f} GB in {r['s']:.3f} s, "
              f"{r['gb_per_s']:.2f} GB/s [{card}]")
    print(f"[lifecycle] {LIFE_LAYERS} + {LIFE_LAYERS} layers at 2b-2b width "
          f"({gb:.2f} GB bf16): bundle written and read back bit-equal; "
          f"LoRA {LIFE_STEPS} steps in {train_s:.2f} s, losses "
          f"{['%.4f' % x for x in losses]}; export merged and read back "
          f"bit-equal to lora.merge; served 1.0 s graphed: {launched} step "
          f"bodies, kernel 1 {res['kernel1_launches']} launches, "
          f"{len(got_frames)} frames equal to the in-memory merge's; "
          f"{res['seconds']:.1f} s in all [{card}]")
    return res


# ---------------------------------------------------------------------------
# [serve_tp]: tensor-parallel serving at each rank's shapes, and two ranks
# on the one card
# ---------------------------------------------------------------------------

SERVE_TP_QUANT_LAYERS = 13      # the int8 / int4 two-rank decodes' depth
SERVE_TP_FRAMES = 48            # the two-rank decodes' frame buffer: every
                                # collective is a gloo exchange through the
                                # host, 2.5-4.4 ms each on one H100 machine
SERVE_TP_TIMEOUT = 900          # seconds: the two ranks' launch, at most


def serve_tp_inputs(cfg, b: int) -> tuple:
    """The main path's requests as decode inputs (numpy): text bytes
    through the character tokenizer, no prompt, targets of 50 frames a
    second; ``b`` = 1 takes the 4.0 s request."""
    texts = TEXTS if b > 1 else TEXTS[-1:]
    durations = DURATIONS if b > 1 else DURATIONS[-1:]
    enc = char_tokenizer(cfg.text_vocab_size)
    ids = [enc(t) for t in texts]
    tx = max(len(i) for i in ids)
    x = np.zeros((b, tx), np.int32)
    for r, i in enumerate(ids):
        x[r, :len(i)] = i
    x_lens = np.asarray([len(i) for i in ids], np.int32)
    prompt = np.zeros((b, 1), np.int32)
    targets = np.asarray([int(round(d * cfg.encodec_sr)) for d in durations],
                         np.int32)
    return x, x_lens, prompt, np.zeros((b,), np.int32), targets


# kernel 2's parts at a rank's shapes: (int4 weights, cache rows, chain,
# int8 pages); chain 5 is a verify pass at k = 4
TP_LAYER_CASES = ((False, 4, 1, True), (True, 1, 1, True),
                  (False, 2, 5, True), (False, 1, 5, False),
                  (True, 1, 5, False), (True, 2, 5, True))
# the two-rank decodes: (name, weights, depth, batch rows, kv cache,
# T5G_FUSED_ATTN, speculative: k = SPEC_K, drafted at 90 % acceptance as
# phase 4d drafts (world 1's speculative stream drafted from its
# sequential one, corrupted); else the sequential eager decode)
SERVE_TP_CASES = (
    ("bf16", "bf16", MODEL_LAYERS, 4, "paged", "3", False),
    ("int8", "int8", SERVE_TP_QUANT_LAYERS, 4, "paged_i8", "3", False),
    ("int4", "int4", SERVE_TP_QUANT_LAYERS, 1, "paged_i8", "3", False),
    ("spec_int4", "int4", SERVE_TP_QUANT_LAYERS, 1, "paged", "3", True),
    ("mode1", "bf16", SERVE_TP_QUANT_LAYERS, 4, "paged", "1", False),
    ("mode0", "bf16", SERVE_TP_QUANT_LAYERS, 4, "paged", "0", False),
    ("w8a16", "w8a16", SERVE_TP_QUANT_LAYERS, 4, "paged", "3", False),
    ("f8", "bf16", SERVE_TP_QUANT_LAYERS, 1, "paged_f8", "3", False),
    ("spec_f8", "bf16", SERVE_TP_QUANT_LAYERS, 1, "paged_f8", "3", True))


def drafted_trace(tokens: torch.Tensor, vocab: int,
                  accept: float = 0.9) -> torch.Tensor:
    """A decode's tokens as a speculative draft at ``accept`` per-token
    acceptance: each token replaced by its successor (mod ``vocab``) where
    a uniform of numpy seed 0 exceeds ``accept`` (phase 4d's recipe)."""
    own = tokens.cpu().numpy()
    corrupt = np.random.default_rng(0).random(own.shape) > accept
    return torch.from_numpy(np.where(corrupt, (own + 1) % vocab, own))


def serve_tp_rank(outdir: str) -> int:
    """One rank of ``[serve_tp]``'s tp-2 launch on the card (``python3
    chip_smoke.py --serve-tp-rank OUTDIR`` with torchrun's RANK and
    WORLD_SIZE): gloo over CUDA tensors on cuda:0, since NCCL refuses two
    ranks on one device. For each case (:data:`SERVE_TP_CASES`) it takes
    the seeded 2b-2b weights at the case's depth (made once a depth), rank
    0 first decodes them in one process (the world-1 run, eager, greedy,
    logits kept), then every rank cuts its shard
    (``parallel.serving_shard``) and decodes eagerly inside
    ``model_parallel``, its kernel counts set to 0 just before and read
    just after; a speculative case (k = SPEC_K) is drafted, in both runs,
    as phase 4d drafts: rank 0's world-1 speculative stream, itself drafted
    from its sequential decode, corrupted to 90 % acceptance
    (:func:`drafted_trace`) and broadcast to the other rank.
    Rank 0 holds its tokens to the world-1 run under the near-tie clause
    and records what fails. The cases come from OUTDIR/spec.json. Writes
    OUTDIR/rank<r>.pt."""
    import torch.distributed as dist

    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine, speculative
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.parallel import mesh as mesh_mod
    from t5gemma_tts_tpu_torch.parallel import tensor as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    from datetime import timedelta

    parallel.init_distributed(
        "cuda", init_method=f"tcp://127.0.0.1:{spec['port']}",
        timeout=timedelta(seconds=SERVE_TP_TIMEOUT), gloo_on_cuda=True)
    mesh = parallel.make_mesh(dp=1, tp=2)
    results, wholes = {}, {}
    for name, weights, layers, b, kv, mode, spec_case in spec["cases"]:
        cfg = VoiceConfig()
        if layers != MODEL_LAYERS:
            cfg = depth_cut(cfg, layers)
        quant = dict(quantize=weights != "bf16",
                     weight_bits=4 if weights == "int4" else 8,
                     act_bits=16 if weights == "w8a16" else 8)
        dcfg = DecodeConfig(kv_cache=kv, top_k=1, max_frames=SERVE_TP_FRAMES)
        ins = [torch.from_numpy(a).cuda() for a in serve_tp_inputs(cfg, b)]
        if layers not in wholes:
            wholes.clear()
            torch.cuda.empty_cache()
            wholes[layers] = voice.init_params(spec["seed"], cfg, "cuda")
        whole = wholes[layers]
        ref_logits, ref_tokens, ref, one = {}, {}, None, None
        with attn_mode(mode):
            if rank == 0:
                one = parallel.serving_shard(
                    whole, cfg, parallel.Mesh(dp=1, tp=1), **quant)
            if not spec_case:
                def run(params):
                    return engine.decode_tokens(params, cfg, dcfg, *ins,
                                                seed=spec["seed"])
            else:
                trace = torch.zeros((b, SERVE_TP_FRAMES), dtype=torch.int32,
                                    device="cuda")
                if rank == 0:
                    seq = engine.decode_tokens(one, cfg, dcfg, *ins,
                                               seed=spec["seed"])
                    boot = speculative.decode_tokens_speculative(
                        one, cfg, dcfg, *ins, spec["seed"],
                        speculative.trace_draft_fn(seq.tokens, SPEC_K),
                        SPEC_K)
                    trace.copy_(drafted_trace(boot.tokens,
                                              cfg.audio_vocab_size))
                dist.broadcast(trace, src=0)
                draft = speculative.trace_draft_fn(trace, SPEC_K)

                def run(params):
                    return speculative.decode_tokens_speculative(
                        params, cfg, dcfg, *ins, spec["seed"], draft, SPEC_K)
            if rank == 0:
                ref, ref_wall, ref_launches = _counted(lambda: _recorded(
                    lambda: run(one), ref_logits, ref_tokens))
                ref_logits = {s: v.cpu() for s, v in ref_logits.items()}
                del one
            local = parallel.serving_shard(whole, cfg, mesh, **quant)
            torch.cuda.empty_cache()
            dist.barrier()
            logits, tokens = {}, {}
            mesh_mod.reset_counts()
            with tp.model_parallel(mesh):
                out, wall, launches = _counted(lambda: _recorded(
                    lambda: run(local), logits, tokens))
        res = dict(tokens=out.tokens.cpu(), gen_lens=out.gen_lens.cpu(),
                   steps=out.steps, passes=getattr(out, "passes", None),
                   wall=wall, launches=launches,
                   collectives=dict(mesh_mod.COUNTS), layers=layers, b=b,
                   gb=torch.cuda.max_memory_allocated() / 1e9)
        if rank == 0:
            tol = SERVE_TP_LOGITS_TOL[name]
            steps = sorted(set(ref_tokens) & set(tokens))
            partings, apart, failures = [], [], []
            for r in range(b):
                parted = [s for s in steps
                          if int(ref_tokens[s][r]) != int(tokens[s][r])]
                apart.append(max(
                    (float((logits[s][r].cpu() - ref_logits[s][r]).norm()
                           / ref_logits[s][r].norm())
                     for s in steps if not parted or s < parted[0]),
                    default=0.0))
                if apart[-1] > tol:
                    failures.append(
                        f"{name} row {r}: logits {apart[-1]:.2e} apart from "
                        f"world 1's before it parts (tol {tol:g})")
                ln = int(out.gen_lens[r])
                if int(ref.gen_lens[r]) != ln or not torch.equal(
                        ref.tokens[r, :ln], out.tokens[r, :ln]):
                    try:
                        partings.append(near_tie_parting(
                            r, ref_logits, logits, ref_tokens, tokens, tol))
                    except AssertionError as e:
                        failures.append(f"{name}: {e}")
            res.update(ref_wall=ref_wall, ref_steps=ref.steps,
                       ref_passes=getattr(ref, "passes", None),
                       ref_launches=ref_launches, partings=partings,
                       logits_apart=apart, failures=failures)
        results[name] = res
        del local, logits, tokens, ref_logits
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    wholes.clear()
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def rank_layer_args(args, dims, mesh) -> tuple:
    """(a rank's decode-layer inputs: its kv heads of ``args``' slabs and
    scale planes, its first kv head)."""
    from t5gemma_tts_tpu_torch import parallel

    hkv = parallel.serving_dims(dims, mesh).num_kv_heads
    lo = mesh.tp_rank * hkv if hkv != dims.num_kv_heads else 0
    out = dict(args)
    for name in ("prompt_k", "prompt_v", "gen_k", "gen_v", "cross_k",
                 "cross_v"):
        out[name] = args[name][lo:lo + hkv]
    if args["kv_scales"] is not None:
        out["kv_scales"] = tuple(x[lo:lo + hkv] for x in args["kv_scales"])
    return out, lo


def head_block(args: dict, t: int, r: int) -> dict:
    """Rank ``r`` of a tp-``t`` group's arguments of one attention call:
    its block of the query heads of ``q`` and of the kv heads of the
    in-flight ``k_cur`` / ``v_cur`` (dim 1), of every page buffer and scale
    plane (dim 0); lengths and page tables as they are."""
    out = dict(args)
    for name, v in args.items():
        if not isinstance(v, torch.Tensor):
            continue
        if name in ("q", "k_cur", "v_cur"):
            dim = 1
        elif "pages" in name or "scales" in name:
            dim = 0
        else:
            continue
        n = v.shape[dim] // t
        out[name] = v.narrow(dim, r * n, n).contiguous()
    return out


def tp_layer_ranks(layers, dims, cfg, args, t):
    """The TpLayers of every rank of a tp-``t`` group over its shard of
    ``layers`` and its kv heads of ``args``' slabs, made inside
    ``model_parallel`` (the group's reductions are :func:`run_ranks`'):
    [(TpLayers, first kv head)]."""
    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.parallel import tensor as tp

    out = []
    for r in range(t):
        mesh = parallel.Mesh(dp=1, tp=t, rank=r)
        shard = parallel.serving_shard({"decoder": {"layers": layers}}, cfg,
                                       mesh)["decoder"]["layers"]
        a, lo = rank_layer_args(args, dims, mesh)
        with tp.model_parallel(mesh):
            ldims = tp.local_dims(shard, dims)[0]
        f = ldims.intermediate_size
        k0 = r * f if f != dims.intermediate_size else 0
        out.append((mk.TpLayers(shard, dims, ldims, k0=k0, **a), lo))
    return out


def run_ranks(ranks) -> None:
    """Every layer of the ``megakernel.TpLayers`` of all ranks of one model
    group held in one process, the group's reductions done here between
    the parts (what the collectives compute): a tensor-parallel layer at
    each rank's shapes on one card."""
    from t5gemma_tts_tpu_torch.ops import megakernel as mk

    for li in range(ranks[0].dims.num_layers):
        for part in range(mk.PARTS):
            for r in ranks:
                r.run(li, part)
            views = [r.reduce_view(part) for r in ranks]
            if views[0] is None:
                continue
            bufs = torch.stack([v[0] for v in views])
            whole = (bufs.amax(dim=0) if views[0][1] == "max"
                     else bufs.sum(dim=0).to(bufs.dtype))
            for v in views:
                v[0].copy_(whole)


def tp_part_errors(ranks, whole, plain) -> tuple:
    """(the largest relative Frobenius error of every rank's h, k and v
    against the one-process stack ``whole``, the same against the plain
    stack ``plain``): ``ranks`` [((h, k_new, v_new), first kv head)]."""
    out = []
    for ref in (whole, plain):
        errs = [(rel_fro(h, ref[0]),
                 rel_fro(k, ref[1][:, :, lo:lo + k.shape[2]]),
                 rel_fro(v, ref[2][:, :, lo:lo + v.shape[2]]))
                for (h, k, v), lo in ranks]
        out.append(tuple(max(e[i] for e in errs) for i in range(3)))
    return tuple(out)


def tp_part_limits(whole, plain, chain: int) -> tuple:
    """The limits of :func:`tp_part_errors`' readings (h, k, v): TP_PART_TOL
    against the one-process stack; against the plain one TP_PART_TOL at
    chain 1, and at chain > 1 TP_PART_TOL beyond the one-process chain
    stack's own distance from it (the chain kernel rounds p per split of
    its own plan, which flips an int8 level against the plain version;
    6.8e-3 on one H100; the one-process path is held to REL_FRO_TOL_H
    there)."""
    if chain == 1:
        return (TP_PART_TOL,) * 3, (TP_PART_TOL,) * 3
    own = tuple(rel_fro(w, p) for w, p in zip(whole, plain))
    return (TP_PART_TOL,) * 3, tuple(TP_PART_TOL + e for e in own)


class _Stop(Exception):
    pass


def rows_over_group(xs, ws, out_dtype=None) -> list:
    """``quant.rows_matmul`` of every rank of a group held in one process
    (``xs[r]``, ``ws[r]``: rank r's columns of the activations and rows of
    the weight) -> ([each rank's result], the group's row absmax, the
    group's int32 sums). Each rank's call is made three
    times: to read its row absmax, to read its int32 sums at the group's
    absmax, and with the group's absmax and sums (what the collectives
    return)."""
    from t5gemma_tts_tpu_torch.ops import quant

    def stop(store):
        def f(t):
            store.append(t.clone())
            raise _Stop
        return f

    def call(x, w, group_max, group_sum):
        try:
            return quant.rows_matmul(x, w, group_max, group_sum, out_dtype)
        except _Stop:
            return None

    amax, sums = [], []
    for x, w in zip(xs, ws):
        call(x, w, stop(amax), None)
    gmax = torch.stack(amax).amax(dim=0)
    for x, w in zip(xs, ws):
        call(x, w, lambda _: gmax, stop(sums))
    gsum = torch.stack(sums).sum(dim=0).to(torch.int32)
    return ([call(x, w, lambda _: gmax, lambda _: gsum)
             for x, w in zip(xs, ws)], gmax, gsum)


def serve_tp_kernels(card: str, iters: int) -> dict:
    """``[serve_tp]`` (a): the kernels of a tensor-parallel rank at its
    shapes of 2b-2b, each against its plain version, timed, with its
    bound and its launches: kernel 1 at Hq / Hkv 4 / 2 (tp 2) and 2 / 1
    (tp 4), B = 4, bf16, self and cross; kernel 2's parts at tp 2 and tp 4
    (w8 B = 4, w4 B = 1, int8 pages, two layers; at tp 4 a 512-wide
    activation tile spans ranks 0 and 1), every rank of the group in this
    process, the reductions done between the parts (TP_PART_TOL); kernels 3
    and 4 at the row-split K blocks of the prefill (M = 260, w4 M = 65) and
    the head (M = 4, w4 M = 1), every rank's ``quant.rows_matmul``
    bit-equal to the plain product. Every reading is printed before a
    limit fails."""
    import dataclasses

    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import quant
    from t5gemma_tts_tpu_torch.parallel import tensor as tp
    from t5gemma_tts_tpu_torch.parallel.mesh import _take_rows

    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    out = {"kernel1": [], "kernel2": [], "rows": []}
    for t, (h, hkv) in ((2, (4, 2)), (4, (2, 1))):
        for form in ("self", "cross", "self e4m3"):
            cur = form != "cross"
            f8 = form == "self e4m3"
            args = attention_case(
                np.random.default_rng(18 + t) if f8 else rng, b=4, h=h,
                hkv=hkv, hd=256, quant=False, f8=f8,
                a_lens=[1, 128, 165, 256] if cur else [12, 128, 133, 256],
                b_lens=[0, 5, 129, 320] if cur else None, pp_a=2,
                pp_b=3 if cur else 0, layers=2, li=1, include_current=cur,
                device=dev)

            def call(a=args, c=cur):
                return fa.batch_paged_attention(
                    **a, attn_logits_soft_cap=50.0, include_current=c)

            before = fa.batch_paged_attention.launches
            got = call()
            launches = fa.batch_paged_attention.launches - before
            want = fa.batch_paged_attention_plain(
                **args, attn_logits_soft_cap=50.0, include_current=cur)
            err = check_close(f"kernel 1 tp {t} {form}", got, want)
            plan = attention_plan(args)
            if plan[2] < fa.WAVE:
                raise AssertionError(f"kernel 1 at Hkv {hkv}: {plan[2]} CTAs "
                                     f"do not fill a wave")
            k_ms = graph_ms(call, iters)
            p_ms = cuda_ms(lambda a=args, c=cur:
                           fa.batch_paged_attention_plain(
                               **a, attn_logits_soft_cap=50.0,
                               include_current=c), iters)
            b_ms, by = bound_ms(*attention_bytes_ops(args, cur))
            row = dict(tp=t, form=form, heads=f"{h}/{hkv}", max_abs_err=err,
                       ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       launches=launches, ctas=plan[2],
                       pages="e4m3" if f8 else "bf16")
            out["kernel1"].append(row)
            print(f"[serve_tp] kernel 1 {form} at tp {t} (Hq/Hkv {h}/{hkv}, "
                  f"hd 256, B = 4, {row['pages']} pages): max_abs_err="
                  f"{err:.3e} kernel_ms="
                  f"{k_ms:.4f} (graph) plain_ms={p_ms:.4f} bound_ms="
                  f"{b_ms:.5f} ({by}) "
                  f"launches={launches} {plan_note(plan)} [{card}]")

    cfg = VoiceConfig()
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    failed = []         # every reading is printed before the check fails
    quant_layers = {int4: random_quant_layers(dims, 2, dev, seed=18 + int4,
                                              int4=int4)
                    for int4 in (False, True)}
    for int4, b, chain, int8_pages in TP_LAYER_CASES:
        layers = quant_layers[int4]
        if chain == 1:
            args = decode_layer_inputs(
                dims, b, True, prompt=37, gen_lens=[129, 5, 0, 300][:b],
                enc_lens=[44, 1, 29, 130][:b], gen_slab=384, device=dev,
                seed=19)
        else:
            args = dict(chain_layer_inputs(dims, b, chain, int8_pages, dev,
                                           seed=19 + b), chain=chain)
        pages = "int8" if int8_pages else "bf16"
        whole = mk.decode_stack(layers, dims, **args)
        plain = mk.decode_stack_plain(layers, dims, **args)
        for t in (2, 4):
            ranks = tp_layer_ranks(layers, dims, cfg, args, t)
            before = mk.decode_layer_part.launches
            run_ranks([r for r, _ in ranks])
            torch.cuda.synchronize()
            launches = mk.decode_layer_part.launches - before
            errs = tp_part_errors([(r.outputs(), lo) for r, lo in ranks],
                                  whole, plain)
            limits = tp_part_limits(whole, plain, chain)
            worst = tuple(max(e) for e in zip(*errs))
            if any(e > tol for got, lim in zip(errs, limits)
                   for e, tol in zip(got, lim)):
                failed.append(f"kernel 2 parts {'int4' if int4 else 'int8'}"
                              f" chain {chain} {pages} pages at tp {t}: "
                              f"relative error h/k/v {errs[0]} against the "
                              f"one-process stack, {errs[1]} against the "
                              f"plain one (limits {limits})")
            rank0 = ranks[0][0]

            def one_rank(layer=rank0):
                for li in range(dims.num_layers):
                    for part in range(mk.PARTS):
                        layer.run(li, part)

            k_ms = graph_ms(one_rank, max(iters // 4, 2)) / dims.num_layers
            p_ms = cuda_ms(lambda: mk.decode_layer_plain(
                layers, dims, li=1, **args), 2)
            b_ms, by = bound_ms(decode_layer_bytes(
                rank0.ldims, dict(rank0.args, h=args["h"]),
                0.5 if int4 else 1.0, chain=chain), 0)
            plans = layer_plans(rank0.ldims, rank0.args,
                                rank0.dims.num_kv_heads)
            row = dict(tp=t, weights="int4" if int4 else "int8", b=b,
                       chain=chain, pages=pages, splits=plans,
                       rel_err=worst, rel_err_whole=errs[0],
                       rel_err_plain=errs[1], ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms,
                       bound_by=by, launches=launches,
                       max_abs_err=float((ranks[0][0].outputs()[0]
                                          - plain[0]).abs().max()))
            out["kernel2"].append(row)
            print(f"[serve_tp] kernel 2 parts {row['weights']} B = {b} "
                  f"cache rows x chain {chain}, {pages} pages, at tp "
                  f"{t} (a rank: {rank0.ldims.num_heads}/"
                  f"{rank0.ldims.num_kv_heads} heads, F "
                  f"{rank0.ldims.intermediate_size} from column "
                  f"{rank0.k0}, tile {rank0.tile}): relative error h/k/v "
                  f"{'/'.join(f'{e:.2e}' for e in errs[0])} against the "
                  f"one-process stack (tol {TP_PART_TOL:g}), "
                  f"{'/'.join(f'{e:.2e}' for e in errs[1])} against the "
                  f"plain one (tol "
                  f"{'/'.join(f'{e:.2e}' for e in limits[1])}); a rank's "
                  f"layer "
                  f"kernel_ms={k_ms:.4f} (graph, its 7 parts) plain_ms="
                  f"{p_ms:.4f} (the whole layer) bound_ms={b_ms:.5f} ({by}, "
                  f"its weights and KV) launches={launches} ({t} ranks x 7 "
                  f"parts x 2 layers); self {plan_note(plans['self'])}, "
                  f"cross {plan_note(plans['cross'])} [{card}]")

    g = torch.Generator(device=dev).manual_seed(18)
    out["bf16_rows"] = []
    for label, k in (("o", 2048), ("down", 9216)):
        for t in (2, 4):
            x = torch.randn((4, k // t), generator=g, device=dev
                            ).to(torch.bfloat16)
            w = (torch.randn((k // t, 2304), generator=g, device=dev) * 0.02
                 ).to(torch.bfloat16)
            got, want = tp._f32_product(x, w), x.float() @ w.float()
            err = rel_fro(got, want)
            if err > 1e-5:
                failed.append(f"bf16 {label} rows at tp {t}: the f32-output "
                              f"GEMM {err:.2e} from the f32 product")
            k_ms = cuda_ms(lambda a=x, b=w: tp._f32_product(a, b), iters)
            c_ms = cuda_ms(lambda a=x, b=w: a.float() @ b.float(), iters)
            out["bf16_rows"].append(dict(product=label, tp=t, k=k // t,
                                         ms=k_ms, f32_copy_ms=c_ms,
                                         rel_err=err))
            print(f"[serve_tp] bf16 row-split {label} at tp {t} (M=4, a "
                  f"rank's K={k // t}, N=2304): one bf16 GEMM with an f32 "
                  f"output {k_ms:.4f} ms against f32 copies and an f32 GEMM "
                  f"{c_ms:.4f} ms, {err:.2e} apart [{card}]")

    for int4 in (False, True):
        shapes = ([("head w2", 1, 2304, 65541), ("prefill o", 65, 2048, 2304),
                   ("prefill down", 65, 9216, 2304)] if int4 else
                  [("head w2", 4, 2304, 65541), ("prefill o", 260, 2048, 2304),
                   ("prefill down", 260, 9216, 2304)])
        for label, m, k, n in shapes:
            x = torch.randn((m, k), generator=g, device=dev)
            w = (torch.randn((k, n), generator=g, device=dev) * 0.02
                 ).to(torch.bfloat16)
            qw = (quant.quantize_weight_int4_lanes(w) if int4
                  else quant.quantize_weight(w))
            x8, sx = quant.quantize_act_plain(x)
            plain = (quant.int_matmul_exact(x8, quant.weight_levels(qw))
                     .float() * sx * qw.scale[None, :]).to(x.dtype)
            for t in (2, 4):
                kr = k // t
                xs = [x[:, r * kr:(r + 1) * kr].contiguous() for r in range(t)]
                ws = [_take_rows(qw, r * kr, kr) for r in range(t)]
                got, gmax, gsum = rows_over_group(xs, ws)
                apart = max(float((g_r - plain).abs().max()) for g_r in got)
                if apart:
                    failed.append(f"{label} at tp {t}: the ranks' rows_matmul "
                                  f"differs from the plain product by up to "
                                  f"{apart:.3e}")

                def rank_call(a=xs[0], wr=ws[0]):
                    return quant.rows_matmul(a, wr, lambda _: gmax,
                                             lambda _: gsum)

                def rank_plain(a=xs[0], wr=ws[0]):
                    x8, sx = quant.quantize_act_plain(a)
                    return (quant.int_matmul_exact(
                        x8, quant.weight_levels(wr)).float() * sx
                        * wr.scale[None, :]).to(a.dtype)

                k_ms = graph_ms(rank_call, iters)
                p_ms = cuda_ms(rank_plain, iters)
                lib = int_mm_call(xs[0], ws[0])
                lib_ms = cuda_ms(lib, iters)
                nb, ops = w8a8_cost(m, kr, n, 4, 4, 0.5 if int4 else 1.0)
                b_ms, by = bound_ms(nb, ops, PEAK_INT8_OPS)
                row = dict(tp=t, product=label, m=m, k=kr, n=n,
                           weights="int4" if int4 else "int8",
                           max_abs_err=apart, ms=k_ms,
                           plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=by, route=quant.product_plan(m, ws[0])
                           ["route"])
                out["rows"].append(row)
                print(f"[serve_tp] {'W4A8' if int4 else 'W8A8'} row-split "
                      f"{label} at tp {t} (M={m}, a rank's K={kr}, N={n}, "
                      f"{row['route']}): every rank's rows_matmul against "
                      f"the plain product max_abs_err={apart:.3e} (tol 0); "
                      f"a rank's kernel_ms={k_ms:.4f} (graph: its absmax, "
                      f"quantize, int32 product and rescale) plain_ms="
                      f"{p_ms:.4f} (its block, plain) "
                      f"library_ms={lib_ms:.4f} (torch._int_mm + rescale) "
                      f"bound_ms={b_ms:.5f} ({by}) [{card}]")
    out["kernel5"] = tp_kernel5_rows(card, iters, failed)
    out["kernel7"] = tp_kernel7_rows(card, iters, failed)
    out["kernel6"] = tp_kernel6_rows(card, iters, failed)
    if failed:
        raise AssertionError("[serve_tp] " + "; ".join(failed))
    return out


TP_HEADS = ((2, 4, 2), (4, 2, 1))     # (tp, a rank's Hq, its Hkv) of 2b-2b


def head_outputs_close(name, got, whole, lo, n) -> float:
    """A rank's attention output(s) against the whole call's block of heads
    ``lo .. lo + n`` (dim 1), within TOL_ABS + TOL_REL (its split plan,
    made for its own kv heads, sums in another order)."""
    got = got if isinstance(got, tuple) else (got,)
    whole = whole if isinstance(whole, tuple) else (whole,)
    worst = 0.0
    for g, w in zip(got, whole):
        w = w[:, lo:lo + n]
        live = torch.isfinite(w)
        if not torch.equal(torch.isfinite(g), live):
            raise AssertionError(f"{name}: empty rows differ")
        worst = max(worst, check_close(name, g[live], w[live]))
    return worst


def tp_kernel5_rows(card: str, iters: int, failed: list) -> list:
    """Kernel 5 (``paged_flash_parts``) at a tp-2 / tp-4 rank's heads of
    2b-2b (hd 256): the verify pass's generation segment at chain 5 over one
    cache row (300 tokens of a 512-token slab), bf16 and e4m3 pages, and
    mode 0/1's cross attention at B = 4 (bf16 pages, 44 / 9 / 29 / 130
    encoder tokens). Every rank's call against its plain version and
    against the whole call's block of heads; rank 0 timed, with its bound
    and plan (a wave of CTAs at least)."""
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa
    from t5gemma_tts_tpu_torch.ops.fused_attn import WAVE

    rng = np.random.default_rng(19)
    dev = torch.device("cuda")
    rows = []
    cases = (("verify gen", torch.bfloat16,
              dict(rows=1, s_len=SPEC_K + 1, lens=[300], pp=4)),
             ("verify gen", torch.float8_e4m3fn,
              dict(rows=1, s_len=SPEC_K + 1, lens=[300], pp=4)),
             ("cross", torch.bfloat16,
              dict(rows=4, s_len=1, lens=[44, 9, 29, 130], pp=2)))
    for form, dtype, spec in cases:
        tag = "e4m3" if dtype == torch.float8_e4m3fn else "bf16"
        args = parts_case(rng, h=8, hkv=4, hd=256, dtype=dtype, layers=2,
                          li=1, device=dev, permute=True, **spec)
        whole = pa.paged_flash_parts(**args, attn_logits_soft_cap=50.0)
        for t, h, hkv in TP_HEADS:
            errs = []
            before = pa.paged_flash_parts.launches
            for r in range(t):
                a = head_block(args, t, r)
                got = pa.paged_flash_parts(**a, attn_logits_soft_cap=50.0)
                errs.append(check_parts(f"kernel 5 {form} {tag} tp {t}", got,
                                        pa.paged_flash_parts_plain(
                                            **a, attn_logits_soft_cap=50.0)))
                errs.append(head_outputs_close(
                    f"kernel 5 {form} {tag} tp {t} rank {r} vs whole", got,
                    whole, r * h, h))
            launches = pa.paged_flash_parts.launches - before
            a = head_block(args, t, 0)
            plan = parts_plan(a)
            if plan[2] < WAVE:
                failed.append(f"kernel 5 {form} at Hkv {hkv}: {plan[2]} CTAs "
                              f"do not fill a wave")
            k_ms = graph_ms(lambda: pa.paged_flash_parts(
                **a, attn_logits_soft_cap=50.0), iters)
            p_ms = cuda_ms(lambda: pa.paged_flash_parts_plain(
                **a, attn_logits_soft_cap=50.0), iters)
            b_ms, by = bound_ms(*parts_bytes_ops(a))
            row = dict(tp=t, form=form, pages=tag, heads=f"{h}/{hkv}",
                       chain=spec["s_len"], max_abs_err=max(errs), ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       library_ms=None, launches=launches, ctas=plan[2])
            rows.append(row)
            print(f"[serve_tp] kernel 5 {form} at tp {t} (Hq/Hkv {h}/{hkv}, "
                  f"hd 256, {spec['rows']} cache row(s) x chain "
                  f"{spec['s_len']}, {tag} pages): every rank against its "
                  f"plain version and the whole call's heads max_abs_err="
                  f"{max(errs):.3e} (tol {TOL_ABS:g} abs + {TOL_REL:g} rel) "
                  f"kernel_ms={k_ms:.4f} (graph) plain_ms={p_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({by}) library_ms=none (no PyTorch "
                  f"call computes soft-capped paged GQA with its flash "
                  f"statistics) launches={launches} {plan_note(plan)} "
                  f"[{card}]")
    return rows


def tp_kernel7_rows(card: str, iters: int, failed: list) -> list:
    """Kernel 7 (``fused_decode_attention``, mode 1) at a tp-2 / tp-4 rank's
    heads of 2b-2b, B = 4 at a main-path step's shapes (prompt 1, 180-300
    generated tokens of a 512-token slab, the in-flight token), bf16 and
    e4m3 pages: every rank against its plain version and the whole call's
    block of heads; rank 0 timed, with its bound and plan."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(20)
    rows = []
    for f8 in (False, True):
        tag = "e4m3" if f8 else "bf16"
        base = attention_case(
            rng, b=4, h=8, hkv=4, hd=256, quant=False, f8=f8,
            a_lens=[1] * 4, b_lens=[225, 180, 225, 300], pp_a=1, pp_b=4,
            layers=2, li=1, include_current=True, device=torch.device("cuda"))
        args = fused_args(base)
        whole = fa.fused_decode_attention(**args, attn_logits_soft_cap=50.0)
        for t, h, hkv in TP_HEADS:
            errs = []
            before = fa.fused_decode_attention.launches
            for r in range(t):
                a = head_block(args, t, r)
                got = fa.fused_decode_attention(**a, attn_logits_soft_cap=50.0)
                errs.append(check_close(
                    f"kernel 7 {tag} tp {t}", got,
                    fa.fused_decode_attention_plain(
                        **a, attn_logits_soft_cap=50.0)))
                errs.append(head_outputs_close(
                    f"kernel 7 {tag} tp {t} rank {r} vs whole", got, whole,
                    r * h, h))
            launches = fa.fused_decode_attention.launches - before
            a = head_block(args, t, 0)
            rank_base = head_block(base, t, 0)
            plan = attention_plan(rank_base)
            if plan[2] < fa.WAVE:
                failed.append(f"kernel 7 at Hkv {hkv}: {plan[2]} CTAs do not "
                              f"fill a wave")
            k_ms = graph_ms(lambda: fa.fused_decode_attention(
                **a, attn_logits_soft_cap=50.0), iters)
            p_ms = cuda_ms(lambda: fa.fused_decode_attention_plain(
                **a, attn_logits_soft_cap=50.0), iters)
            b_ms, by = bound_ms(*attention_bytes_ops(rank_base, True, False))
            row = dict(tp=t, pages=tag, heads=f"{h}/{hkv}",
                       max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=by, library_ms=None,
                       launches=launches, ctas=plan[2])
            rows.append(row)
            print(f"[serve_tp] kernel 7 at tp {t} (Hq/Hkv {h}/{hkv}, hd 256, "
                  f"B = 4, {tag} pages): every rank against its plain "
                  f"version and the whole call's heads max_abs_err="
                  f"{max(errs):.3e} (tol {TOL_ABS:g} abs + {TOL_REL:g} rel) "
                  f"kernel_ms={k_ms:.4f} (graph) plain_ms={p_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({by}) library_ms=none (no PyTorch "
                  f"call computes soft-capped paged GQA) launches={launches} "
                  f"{plan_note(plan)} [{card}]")
    return rows


def w8a16_with_splits(x, w, splits: int) -> torch.Tensor:
    """Kernel 6's tensor-core route with ``splits`` K splits in place of
    its plan's count (bf16 x and output; a measurement's comparison, no
    caller on the main path)."""
    from t5gemma_tts_tpu_torch.ops import quant

    m, k = x.shape
    out = torch.empty((m, w.n), dtype=torch.bfloat16, device=x.device)
    part = (torch.empty((splits, m, w.n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn = quant._bind("w8a16_matmul", "t5g_w8a16_matmul")
    err = fn(x.data_ptr(), 1, m, k, w.values.data_ptr(), w.scale.data_ptr(),
             w.n, out.data_ptr(), 1, splits, None,
             None if part is None else part.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16 splits={splits}: CUDA error {err}")
    return out


# kernel 6's products of a 2b-2b decoder layer: (name, K, N, split axis)
W8A16_TP_PRODUCTS = (("qkv", 2304, 4096, "columns"),
                     ("cross q", 2304, 2048, "columns"),
                     ("gate_up", 2304, 18432, "columns"),
                     ("o", 2048, 2304, "rows"), ("down", 9216, 2304, "rows"))


def tp_kernel6_rows(card: str, iters: int, failed: list) -> list:
    """Kernel 6 (W8A16) at a tp-2 / tp-4 rank's blocks of the 2b-2b layer
    products (:data:`W8A16_TP_PRODUCTS`) at M = 4 (a decode step) and
    M = 260 (the prefill), bf16 activations: a column block against its
    plain version (``check_w8a16``); a row block's f32 results of every
    rank summed (what ``quant.rows_matmul_a16``'s group sum adds) against
    the whole plain product within W8A16_REL_FRO. Rank 0's block timed
    with its plan (CTAs against a wave), bound, plain and library
    (``torch._weight_int8pack_mm``) times; where the plan's grid is under a
    wave (each split keeps two K tiles), the count that fills the wave at
    one K tile a split is timed beside it."""
    from t5gemma_tts_tpu_torch.ops import quant
    from t5gemma_tts_tpu_torch.ops.fused_attn import WAVE
    from t5gemma_tts_tpu_torch.parallel.mesh import _take_columns, _take_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for name, k, n, axis in W8A16_TP_PRODUCTS:
        w = quant.quantize_weight(
            (torch.randn((k, n), generator=g, device=dev) * 0.02).to(
                torch.bfloat16), act_bits=16)
        for m in (4, 260):
            x = (torch.randn((m, k), generator=g, device=dev) * 2.0).to(
                torch.bfloat16)
            for t in (2, 4):
                if axis == "columns":
                    nr = n // t
                    half = n // 2 if name == "gate_up" else 0
                    step = nr // 2 if half else nr
                    blocks = [torch.arange(r * step, (r + 1) * step,
                                           device=dev) for r in range(t)]
                    if half:                    # [gate_r | up_r]
                        blocks = [torch.cat([b, b + half]) for b in blocks]
                    ws = [_take_columns(w, idx) for idx in blocks]
                    xs = [x] * t
                    err = max(check_w8a16(f"{name} tp {t} M={m}", x, wr)
                              for wr in ws)
                else:
                    kr = k // t
                    ws = [_take_rows(w, r * kr, kr) for r in range(t)]
                    xs = [x[:, r * kr:(r + 1) * kr].contiguous()
                          for r in range(t)]
                    total = sum(quant.w8a16_matmul(xr, wr, torch.float32)
                                for xr, wr in zip(xs, ws))
                    want = quant.w8a16_matmul_plain(x, w, torch.float32)
                    rel = rel_fro(total, want)
                    if rel > W8A16_REL_FRO:
                        failed.append(f"w8a16 {name} rows at tp {t} M={m}: "
                                      f"the ranks' f32 sum {rel:.2e} from "
                                      f"the whole product (tol "
                                      f"{W8A16_REL_FRO:g})")
                    err = float((total - want).abs().max())
                x0, w0 = xs[0], ws[0]
                plan = quant.product_plan(m, w0)
                ctas = plan["rowtiles"] * plan["ntiles"] * plan["splits"]
                k_ms = graph_ms(lambda: quant.w8a16_matmul(x0, w0), iters)
                p_ms = cuda_ms(lambda: quant.w8a16_matmul_plain(x0, w0),
                               iters)
                lib, why = int8pack_call(x0, w0)
                lib_ms = graph_ms(lib, iters) if lib is not None else None
                b_ms, by = bound_ms(*w8a16_cost(m, x0.shape[1], w0.n),
                                    PEAK_BF16_FLOPS)
                tiles = plan["rowtiles"] * plan["ntiles"]
                fill = (min(plan["ktiles"], max(1, WAVE // tiles))
                        if ctas < WAVE else plan["splits"])
                fill_ms = (graph_ms(lambda: w8a16_with_splits(x0, w0, fill),
                                    iters)
                           if fill != plan["splits"] else None)
                row = dict(tp=t, product=name, split=axis, m=m,
                           k=x0.shape[1], n=w0.n, max_abs_err=err, ms=k_ms,
                           plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=by, splits=plan["splits"], ctas=ctas,
                           fill_splits=fill, fill_ms=fill_ms)
                rows.append(row)
                note = (f"; filling the wave at one K tile a split ({fill} "
                        f"splits, {tiles * fill} CTAs) {fill_ms:.4f} ms"
                        if fill_ms is not None else "")
                lib_note = (f"{lib_ms:.4f} (torch._weight_int8pack_mm, bf16 "
                            f"scales)" if lib_ms is not None
                            else f"none ({why})")
                print(f"[serve_tp] w8a16 {axis}-split {name} at tp {t} "
                      f"(M={m}, a rank's K={x0.shape[1]}, N={w0.n}): "
                      f"max_abs_err={err:.3e} (f32 within "
                      f"{W8A16_REL_FRO:g} relative) kernel_ms={k_ms:.4f} "
                      f"(graph) plain_ms={p_ms:.4f} library_ms={lib_note} "
                      f"bound_ms={b_ms:.5f} ({by}) "
                      f"({w8a16_plan_note(m, w0)}, {ctas} CTAs against a "
                      f"wave of {WAVE}{note}) [{card}]")
    return rows


def serve_tp_world1(card: str, seed: int) -> dict:
    """``[serve_tp]`` (c): NCCL at world 1, ``make_mesh(dp=1, tp=1)``: the
    mesh's serving shard (the whole tree at tp 1) served graphed inside
    ``model_parallel`` against the plain path's graphed serve, one 1.0 s
    greedy request at B = 1 on 2b-2b at FULL_LAYERS + FULL_LAYERS layers:
    frames equal."""
    import torch.distributed as dist

    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.models import voice
    from t5gemma_tts_tpu_torch.parallel import tensor as tp

    cfg = dataclasses.replace(depth_cut(VoiceConfig(), FULL_LAYERS),
                              dtype="bfloat16")
    dcfg = DecodeConfig(kv_cache="paged", top_k=1, max_frames=512)
    ins = [torch.from_numpy(a[-1:]).cuda() for a in serve_tp_inputs(cfg, 4)]
    whole = voice.init_params(seed, cfg, "cuda")
    parallel.init_distributed(
        "cuda", init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = parallel.make_mesh(dp=1, tp=1)
        served = {}
        for name in ("plain", "mesh"):
            params = parallel.serving_shard(whole, cfg, mesh)
            with tp.model_parallel(mesh if name == "mesh" else None):
                out, wall, launches = _counted(lambda: engine.graphed_decoder(
                    cfg, dcfg)(params, *ins, seed))
            served[name] = (out, launches)
            engine.release_sessions()
    finally:
        dist.destroy_process_group()
    (a, la), (b, lb) = served["plain"], served["mesh"]
    n = int(a.gen_lens[0])
    if int(b.gen_lens[0]) != n or not torch.equal(a.tokens[0, :n],
                                                  b.tokens[0, :n]):
        raise AssertionError("the world-1 mesh's graphed serve differs from "
                             "the plain path's")
    if lb["batch_paged_attention"] != 2 * FULL_LAYERS * b.launched_steps:
        raise AssertionError(f"world-1 mesh serve launches {lb}")
    return dict(frames=n, bodies=b.launched_steps,
                kernel1_launches=lb["batch_paged_attention"])


def serve_tp_launches(name: str, weights: str, layers: int, steps: int,
                      passes) -> dict:
    """A two-rank case's launches a rank, by kernel: the main path's own
    formulas at a rank's heads (steps or verify passes x layers x the
    kernel's calls a layer)."""
    if name.startswith("spec_"):
        if weights == "int4":            # kernel 2's seven parts at chain 5
            return {"decode_layer_part": 7 * layers * passes,
                    "decode_stack": 0, "batch_paged_attention": 0,
                    "paged_flash_parts": 0}
        return {"paged_flash_parts": 3 * layers * passes,   # prompt, gen,
                "batch_paged_attention": 0}                  # cross
    if weights in ("int8", "int4"):
        return {"decode_layer_part": 7 * layers * steps,
                "batch_paged_attention": 0}
    if name == "mode1":
        return {"fused_decode_attention": layers * steps,
                "paged_flash_parts": layers * steps,
                "batch_paged_attention": 0}
    if name == "mode0":
        return {"paged_flash_parts": 3 * layers * steps,
                "fused_decode_attention": 0, "batch_paged_attention": 0}
    want = {"batch_paged_attention": 2 * layers * steps}
    if weights == "w8a16":
        want["w8a16_matmul"] = w8a16_launches(layers, steps)
    return want


def serve_tp_entry(stp: dict, run: str, counter: str, table: str,
                   **select) -> dict:
    """A kernel's ``tp`` entry of the kernels' line: its launches in the
    two-rank tp-2 decode ``run`` (rank 0's count), that run's depth, steps
    and passes, and its rows of :func:`serve_tp_kernels` (each with ms,
    plain_ms, bound_ms and bound_by at a rank's shapes; those whose keys
    hold ``select``'s values)."""
    out = stp["runs"][run]
    rows = [r for r in stp["kernels"][table]
            if all(r[k] == v for k, v in select.items())]
    return dict(launches=out["launches"].get(counter, 0),
                layers=out["layers"], steps=out["steps"],
                passes=out["passes"], shapes=rows)


def phase_serve_tp(card: str, seed: int, iters: int, workdir: str,
                   cases=SERVE_TP_CASES, full: bool = True) -> dict:
    """``[serve_tp]``: (a) :func:`serve_tp_kernels`; (b) two ranks on
    cuda:0 (gloo over CUDA tensors; the kernels are built already, by this
    process) decode ``cases`` (:data:`SERVE_TP_CASES`) at tp 2
    (:func:`serve_tp_rank`), each rank's tokens and passes equal to the
    other's, the tokens to the world-1 run's but at a near-tie, their
    logits within SERVE_TP_LOGITS_TOL of world 1's before it, each
    kernel's launches a rank by :func:`serve_tp_launches`; every reading is
    printed before a check fails; (c) :func:`serve_tp_world1`.
    ``full=False``: (b) alone."""
    t_start = time.time()
    kernels = serve_tp_kernels(card, iters) if full else None
    torch.cuda.empty_cache()
    outdir = os.path.join(workdir, "serve_tp")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump(dict(port=free_port(), seed=seed, cases=cases), f)
    procs = []
    logs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0")
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-tp-rank",
             outdir], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=SERVE_TP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                raise AssertionError(f"[serve_tp] rank {r} exited "
                                     f"{p.returncode}:\n{f.read()[-6000:]}")
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    runs, failures = {}, []
    for name, weights, layers, b, kv, mode, spec_case in cases:
        r0, r1 = ranks[0][name], ranks[1][name]
        if not (torch.equal(r0["tokens"], r1["tokens"])
                and torch.equal(r0["gen_lens"], r1["gen_lens"])
                and r0["passes"] == r1["passes"]):
            raise AssertionError(f"[serve_tp] {name}: the two ranks' "
                                 f"tokens or passes differ")
        lc = r0["launches"]
        steps, passes = r0["steps"], r0["passes"]
        bodies = passes if spec_case else steps
        run = runs[name] = dict(
            layers=layers, b=b, kv=kv, mode=mode, steps=steps, passes=passes,
            frames=r0["gen_lens"].tolist(), wall_s=r0["wall"],
            ms_per_step=1e3 * r0["wall"] / max(steps, 1),
            ms_per_body=1e3 * r0["wall"] / max(bodies, 1),
            world1_wall_s=r0["ref_wall"], world1_passes=r0["ref_passes"],
            world1_ms_per_step=1e3 * r0["ref_wall"] / max(r0["ref_steps"], 1),
            launches={k: v for k, v in lc.items() if v},
            world1_launches={k: v for k, v in r0["ref_launches"].items()
                             if v},
            collectives=r0["collectives"]["calls"],
            collective_bytes=r0["collectives"]["bytes"],
            rank_peak_gb=[ranks[0][name]["gb"], ranks[1][name]["gb"]],
            partings=r0["partings"], logits_apart=r0["logits_apart"])
        spec_note = (f", speculative k = {SPEC_K} drafted from world 1's "
                     f"sequential decode" if spec_case else "")
        pass_note = (f" in {passes} passes (world 1: {r0['ref_passes']}), "
                     f"{run['ms_per_body']:.2f} ms a pass"
                     if spec_case else "")
        print(f"[serve_tp] two ranks on cuda:0 (gloo over CUDA tensors), "
              f"tp 2, {name} ({weights} weights, {kv} pages, "
              f"T5G_FUSED_ATTN={mode}{spec_note}) B = {b} at {layers} + "
              f"{layers} layers: "
              f"{steps} steps{pass_note}, the ranks' tokens agree; "
              f"{b - len(r0['partings'])} of {b} rows token-equal to the "
              f"world-1 run's; logits apart from world 1's before a row "
              f"parts (relative, by row) "
              f"{'/'.join(f'{a:.2e}' for a in r0['logits_apart'])} (tol "
              f"{SERVE_TP_LOGITS_TOL[name]:g})"
              f"{''.join('; ' + p for p in r0['partings'])}; eager ms a step "
              f"{run['ms_per_step']:.2f} (world 1: "
              f"{run['world1_ms_per_step']:.2f}); "
              f"{run['collectives']} collectives moving "
              f"{run['collective_bytes'] / 1e6:.1f} MB; launches "
              f"{run['launches']} (world 1: "
              f"{run['world1_launches']}); rank peak GB "
              f"{run['rank_peak_gb'][0]:.2f}/{run['rank_peak_gb'][1]:.2f} "
              f"[{card}]")
        failures += r0["failures"]
        for k, v in serve_tp_launches(name, weights, layers, steps,
                                      passes).items():
            if lc[k] != v:
                failures.append(f"{name}: {k} launched {lc[k]} times, not "
                                f"{v}: {lc}")
        # kernels 3 and 4: every product of world 1's run, the row-split
        # ones through rows_matmul (the head's w2 a step at least)
        for k in ("w8a8_matmul", "w4a8_matmul"):
            if weights in ("int8", "int4") and not spec_case and \
                    r0["ref_steps"] == steps and \
                    lc[k] != r0["ref_launches"][k]:
                failures.append(f"{name}: {k} launched {lc[k]} times, world "
                                f"1 {r0['ref_launches'][k]}")
        prod = "w4a8_matmul" if weights == "int4" else "w8a8_matmul"
        if weights in ("int8", "int4") and lc[prod] < bodies:
            failures.append(f"{name}: {prod} launched {lc[prod]} times in "
                            f"{bodies} steps or passes")
    if failures:
        raise AssertionError("[serve_tp] " + "; ".join(failures))
    world1 = serve_tp_world1(card, seed) if full else None
    if full:
        print(f"[serve_tp] NCCL world 1, mesh dp 1 x tp 1: served graphed, "
              f"{world1['frames']} frames equal to the plain path's, kernel "
              f"1 {world1['kernel1_launches']} launches over "
              f"{world1['bodies']} step bodies [{card}]")
    res = dict(kernels=kernels, runs=runs, world1=world1,
               seconds=time.time() - t_start)
    print(f"[serve_tp] {json.dumps(res)}")
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
    ap.add_argument("--serve-tp-rank", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=("serve_tp", "serve_tp_kernels",
                                       "serve_tp_bf16"),
                    help="build the kernels and run this part of [serve_tp] "
                         "alone (no result line)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.serve_tp_rank:
        return serve_tp_rank(args.serve_tp_rank)
    if args.only:
        return run_only(args)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as refdir:
        return run_all(args, refdir)


def run_only(args) -> int:
    """``--only``: the kernels built, then one part of ``[serve_tp]``:
    all of it, its kernels (a), or the two ranks' bf16 decode (b)."""
    from t5gemma_tts_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__}")
    cuda_build.build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.only == "serve_tp_kernels":
            serve_tp_kernels(card, args.iters)
        else:
            phase_serve_tp(card, args.seed, args.iters, workdir,
                           cases=SERVE_TP_CASES[:1]
                           if args.only == "serve_tp_bf16" else
                           SERVE_TP_CASES,
                           full=args.only == "serve_tp")
    return 0


def run_all(args, refdir: str) -> int:
    """Every phase, in order (``refdir``: a directory for the reference
    recordings); raises on the first failure."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
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
    pipe16 = main.pop("pipe")          # phases 4h and 4i run it again

    # 4g: the same batch with the v1 self-attention (T5G_FUSED_ATTN=1), on
    # a pipeline of its own at MODE1_LAYERS + MODE1_LAYERS layers
    pipe_g = build_pipeline(depth_cut(cfg, MODE1_LAYERS), XCodec2Config(),
                            "cuda", args.seed)
    main1 = phase_main_path(card, args.seed, pipe=pipe_g, mode="1")
    main1.pop("pipe")
    # its own depth: not set beside mode 2's figures at MODEL_LAYERS
    print(f"[main/bf16 mode 1 at {MODE1_LAYERS} + {MODE1_LAYERS} layers] RTF "
          f"{main1['rtf']:.3f}x; tokens/s {main1['tokens_per_s']:.2f}; ms "
          f"per step {main1['step_ms']:.2f} [{card}]")
    with attn_mode("1"):
        prof["bf16 mode 1"] = phase_profile(pipe_g, card, main1["enc_lens"],
                                            weights="bf16 mode 1")
    del pipe_g
    engine.release_sessions()
    torch.cuda.empty_cache()
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
    # after 4h: preprocessing on 4h's full-width codec; 4k and 4l train on
    # what it writes
    pre = phase_preprocess(card, pipe16.audio_tokenizer, refdir, args.seed)
    stamp("4h (preprocess)")
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
    # 4i: serving -- warm-up, streaming (bf16), continuous batching and the
    # two servers (bf16 and int8), on pipelines of their own at
    # SERVE_LAYERS + SERVE_LAYERS layers; then kernels 1, 2 and 3 at the
    # continuous path's ragged per-row lengths (an idle slot at generation
    # length 0) at full depth
    engine.release_sessions()
    cfg_i = depth_cut(cfg, SERVE_LAYERS)
    pipe_i = build_pipeline(cfg_i, XCodec2Config(), "cuda", args.seed)
    pipe_i8 = build_pipeline(cfg_i, XCodec2Config(), "cuda", args.seed,
                             int8=True)
    serve = {"layers": SERVE_LAYERS,
             "warmup": phase_serve_warmup(card, pipe_i8, args.seed),
             "stream": phase_serve_stream(card, pipe_i, args.seed)}
    serve["bf16"] = phase_serve_continuous(
        card, pipe_i, "bf16", args.seed,
        graphed_step_ms(pipe_i, "paged", args.seed))
    serve["int8"] = phase_serve_continuous(
        card, pipe_i8, "int8", args.seed,
        graphed_step_ms(pipe_i8, "paged_i8", args.seed))
    del pipe_i, pipe_i8
    engine.release_sessions()
    torch.cuda.empty_cache()
    ragged = dict(prompt_len=1, gen_len=list(CONTINUOUS_GEN),
                  enc_lens=list(CONTINUOUS_ENC), gen_slab=SERVE_BUCKETS[2],
                  iters=step_iters)
    serve_timing = main_path_step_timing(card, **ragged)
    serve_timing8 = quant_step_timing(
        main8["pipe"], card, 0, ragged["enc_lens"], ragged["gen_slab"],
        step_iters, gen_lens=ragged["gen_len"], parts=False)
    worst8s, prod8s = phase_products(card, {
        "pipe": main8["pipe"], "tag": "int8 continuous",
        "batch": SERVE_SLOTS, "prefill_rows": SERVE_BUCKETS[1] + 1,
        "cross_rows": SERVE_BUCKETS[0]}, args.iters)
    print(f"[serve] {json.dumps(serve)}")
    engine.release_sessions()
    torch.cuda.empty_cache()
    stamp("4i (serving)")
    # 4j: the HTTP front end (int8 continuous, a bf16 stream beside a
    # one-shot request of its bucket), the tiered start, and Whisper at the
    # large-v3-turbo widths; on pipelines of their own at FRONT_LAYERS +
    # FRONT_LAYERS layers
    cfg_j = depth_cut(cfg, FRONT_LAYERS)
    pipe_j = build_pipeline(cfg_j, XCodec2Config(), "cuda", args.seed)
    pipe_j8 = build_pipeline(cfg_j, XCodec2Config(), "cuda", args.seed,
                             int8=True)
    front = {"layers": FRONT_LAYERS,
             "http_int8": phase_http_continuous(card, pipe_j8, args.seed),
             "http_stream": phase_http_stream(card, pipe_j, args.seed),
             "fast_start": phase_fast_start(card, pipe_j, args.seed),
             "whisper": phase_whisper(card, args.seed)}
    print(f"[front] {json.dumps(front)}")
    del pipe_j, pipe_j8
    engine.release_sessions()
    torch.cuda.empty_cache()
    stamp("4j (front end, ASR)")
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
    # e4m3) and speculative (the one-segment kernel), on a pipeline of its
    # own at half depth (E4M3_LAYERS)
    del pipe16
    engine.release_sessions()
    torch.cuda.empty_cache()
    pipe_e = build_pipeline(depth_cut(cfg, E4M3_LAYERS),
                            XCodec2Config(), "cuda", args.seed)
    spec8 = phase_speculative(card, pipe_e, f"bf16 b1 {E4M3_LAYERS} layers",
                              "paged_f8", args.seed)
    spec8.pop("pipe")
    timing_f8 = main_path_step_timing(
        card, prompt_len=1, gen_len=spec8["seq_steps"] // 2,
        enc_lens=spec8["enc_lens"], gen_slab=spec8["gen_slab"],
        iters=step_iters, f8=True)
    parts_timing = parts_step_timing(
        card, prompt_len=1, gen_len=spec8["steps"] // 2,
        enc_len=spec8["enc_lens"][0], gen_slab=spec8["gen_slab"],
        iters=step_iters)
    del pipe_e
    engine.release_sessions()
    torch.cuda.empty_cache()

    stamp("4e (bf16 over e4m3)")
    # 4f: W8A16 serving, the four requests at batch 4 over bf16 pages, on a
    # pipeline of its own at W8A16_LAYERS; then every W8A16 product of the
    # run and one decode step's products
    pipe_w = build_pipeline(depth_cut(cfg, W8A16_LAYERS), XCodec2Config(),
                            "cuda", args.seed, w8a16=True)
    main16 = phase_main_path(card, args.seed, "w8a16", pipe=pipe_w)
    del pipe_w
    worst_run16, prod16 = phase_w8a16_products(card, main16, args.iters)
    worst16 = max(worst16, worst_run16)
    prof["w8a16"] = phase_profile(main16["pipe"], card, main16["enc_lens"],
                                  weights="w8a16")
    timing16 = w8a16_step_timing(main16.pop("pipe"), card, 4, step_iters)
    engine.release_sessions()
    torch.cuda.empty_cache()

    stamp("4f (w8a16)")
    # 4k: training -- LoRA at full width (LORA_LAYERS deep) through Trainer,
    # the merged model served; the full-model step card against CPU; chunked CE
    train = phase_train(card, args.seed, pre["dir"])
    print(f"[train] {json.dumps(train)}")
    stamp("4k (training)")
    # 4l: the lifecycle through files: bundle -> load -> LoRA -> export ->
    # load -> serve
    life = phase_lifecycle(card, args.seed, pre["dir"])
    print(f"[lifecycle] {json.dumps(dict(life, preprocess=pre))}")
    stamp("4l (lifecycle)")
    # [serve_tp]: tensor-parallel serving at each rank's shapes, two ranks
    # on this card, the NCCL world-1 mesh served graphed
    engine.release_sessions()
    torch.cuda.empty_cache()
    stp = phase_serve_tp(card, args.seed, args.iters, refdir)
    stamp("serve_tp")
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
                             clone_timing["max_abs_err"],
                             serve_timing["max_abs_err"]),
             ms=timing["ms"], plain_ms=timing["plain_ms"],
             bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
             library_ms=None, eager_ms=timing["eager_ms"],
             splits=timing["splits"],
             e4m3=dict(launches=spec8["seq_launches"]["batch_paged_attention"],
                       max_abs_err=max(worst_attn["f8"],
                                       timing_f8["max_abs_err"]),
                       splits=timing_f8["splits"],
                       **{k: timing_f8[k] for k in keys[:4]},
                       tp=serve_tp_entry(stp, "f8", "batch_paged_attention",
                                         "kernel1", pages="e4m3")),
             clone=dict(launches=clone["launches"]["batch_paged_attention"],
                        max_abs_err=clone_timing["max_abs_err"],
                        splits=clone_timing["splits"],
                        **{k: clone_timing[k] for k in keys[:4]}),
             continuous=dict(
                 launches=serve["bf16"]["launches"]["batch_paged_attention"],
                 max_abs_err=serve_timing["max_abs_err"],
                 splits=serve_timing["splits"],
                 **{k: serve_timing[k] for k in keys[:4]}),
             lifecycle=dict(launches=life["kernel1_launches"],
                            bodies=life["bodies"], layers=LIFE_LAYERS),
             parallel=dict(launches=train["parallel"]["kernel1_launches"],
                           bodies=train["parallel"]["serve_bodies"],
                           layers=FULL_LAYERS),
             tp=serve_tp_entry(stp, "bf16", "batch_paged_attention",
                               "kernel1", pages="bf16")),
        dict(name="w8a8_matmul", route="cuda",
             source=src + "w8a8_matmul.cu",
             replaces="t5gemma_tts_tpu/ops/quant.py:140",
             launches=main8["launches"]["w8a8_matmul"],
             max_abs_err=max(worst8["w8a8"], worst4["w8a8"],
                             worst_spec4["w8a8"], worst_edges["w8a8"],
                             worst8c["w8a8"], worst4c["w8a8"],
                             worst8s["w8a8"], timing8["w8a8"]["max_abs_err"],
                             serve_timing8["w8a8"]["max_abs_err"]),
             **{k: timing8["w8a8"][k] for k in keys},
             continuous=dict(
                 launches=serve["int8"]["launches"]["w8a8_matmul"],
                 **{k: serve_timing8["w8a8"][k] for k in keys}),
             products=[dict(p, run=f"{ph} {p['run']}")
                       for ph, r in (("4b", prod8), ("4c", prod4),
                                     ("4d", prod_spec4), ("4h", prod8c),
                                     ("4h", prod4c), ("4i", prod8s))
                       for p in r.get("w8a8", [])],
             tp=serve_tp_entry(stp, "int8", "w8a8_matmul", "rows",
                               weights="int8")),
        dict(name="decode_stack", route="cuda",
             source=src + "decode_layer.cu",
             replaces="t5gemma_tts_tpu/ops/megakernel.py:115",
             launches=main8["launches"]["decode_stack"],
             max_abs_err=max(worst_layer,
                             timing8["decode_stack"]["max_abs_err"],
                             serve_timing8["decode_stack"]["max_abs_err"]),
             **{k: timing8["decode_stack"][k] for k in keys},
             splits=timing8["decode_stack"]["splits"],
             parts=timing8["decode_stack"]["parts"],
             clone=dict(launches=clone8["launches"]["decode_stack"],
                        max_abs_err=timing8c["decode_stack"]["max_abs_err"],
                        splits=timing8c["decode_stack"]["splits"],
                        **{k: timing8c["decode_stack"][k]
                           for k in keys[:4]}),
             continuous=dict(
                 launches=serve["int8"]["launches"]["decode_stack"],
                 max_abs_err=serve_timing8["decode_stack"]["max_abs_err"],
                 splits=serve_timing8["decode_stack"]["splits"],
                 **{k: serve_timing8["decode_stack"][k] for k in keys[:4]}),
             tp=serve_tp_entry(stp, "int8", "decode_layer_part", "kernel2",
                               weights="int8", chain=1),
             tp_chain5_shapes=[r for r in stp["kernels"]["kernel2"]
                               if r["weights"] == "int8"
                               and r["chain"] > 1]),
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
                       for p in r.get("w4a8", [])],
             tp=serve_tp_entry(stp, "int4", "w4a8_matmul", "rows",
                               weights="int4")),
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
                         **{k: chain_timing[k] for k in keys[:4]}),
             tp=serve_tp_entry(stp, "int4", "decode_layer_part", "kernel2",
                               weights="int4", chain=1),
             tp_chain5=serve_tp_entry(stp, "spec_int4", "decode_layer_part",
                                      "kernel2", weights="int4", chain=5)),
        dict(name="paged_flash_parts", route="cuda",
             source=src + "paged_flash_parts.cu",
             replaces="t5gemma_tts_tpu/ops/paged_attn.py:122",
             launches=spec8["launches"]["paged_flash_parts"],
             max_abs_err=max(worst_parts, parts_timing["max_abs_err"],
                             cross_timing["max_abs_err"]),
             **{k: parts_timing[k] for k in keys},
             splits=parts_timing["splits"],
             cross_4g=dict(launches=main1["launches"]["paged_flash_parts"],
                           layers=MODE1_LAYERS,
                           splits=cross_timing["splits"],
                           **{k: cross_timing[k] for k in keys}),
             tp=serve_tp_entry(stp, "spec_f8", "paged_flash_parts",
                               "kernel5", form="verify gen"),
             tp_mode0=serve_tp_entry(stp, "mode0", "paged_flash_parts",
                                     "kernel5", form="cross"),
             tp_mode1=serve_tp_entry(stp, "mode1", "paged_flash_parts",
                                     "kernel5", form="cross")),
        dict(name="w8a16_matmul", route="cuda",
             source=src + "w8a16_matmul.cu",
             replaces="t5gemma_tts_tpu/ops/quant.py:78",
             launches=main16["launches"]["w8a16_matmul"],
             layers=W8A16_LAYERS,
             max_abs_err=max(worst16, timing16["max_abs_err"]),
             **{k: timing16[k] for k in keys},
             bf16_matmul_ms=timing16["bf16_ms"],
             step_products=timing16["products"],
             products=[dict(p, run=f"4f {p['run']}") for p in prod16],
             tp=serve_tp_entry(stp, "w8a16", "w8a16_matmul", "kernel6")),
        dict(name="fused_decode_attention", route="cuda",
             source=src + "fused_decode_attention.cu",
             replaces="t5gemma_tts_tpu/ops/fused_attn.py:97",
             launches=main1["launches"]["fused_decode_attention"],
             layers=MODE1_LAYERS,
             max_abs_err=max(worst_fused["bf16"],
                             fused_timing["max_abs_err"]),
             **{k: fused_timing[k] for k in keys},
             eager_ms=fused_timing["eager_ms"], splits=fused_timing["splits"],
             e4m3=dict(launches=ref_f8["fused_decode_attention"],
                       max_abs_err=max(worst_fused["e4m3"],
                                       fused_timing_f8["max_abs_err"]),
                       splits=fused_timing_f8["splits"],
                       **{k: fused_timing_f8[k] for k in keys[:4]}),
             tp=serve_tp_entry(stp, "mode1", "fused_decode_attention",
                               "kernel7")),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit, and the build of every CUDA
   kernel from the sources under t5gemma_tts_tpu_torch/csrc/;
2. kernel: each kernel against its plain PyTorch version on the card at the
   2b-2b shapes (bf16 and int8 pages, self and cross forms, and a small odd
   shape), with its error, time, plain time and bound;
3. reference: a tiny f32 model decoded greedily on the card (kernels) and on
   the CPU (plain versions) must give the same tokens and waveforms;
4. main path: TTSPipeline at the full width of the 2b-2b preset (seeded
   random bf16 weights, the full-width XCodec2 decoder) synthesizes four
   requests with the paged cache, and the kernel's launch count must be
   2 x 26 x decode steps; it prints steps, tokens/s and RTF;
5. profile: device time by kernel (torch.profiler) over a prefill and 32
   decode steps of that batch, and the device's idle share;
6. step timing: one decode step's 52 kernel launches replayed at the main
   path's cache shapes, kernel against plain version, beside their bound.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12         # H100 SXM, f32 outside the tensor cores
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


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def attention_case(rng, *, b, h, hkv, hd, quant, a_lens, b_lens, pp_a, pp_b,
                   layers, li, include_current, device):
    """Random inputs of one batch_paged_attention call (numpy-seeded)."""
    from t5gemma_tts_tpu_torch.ops.fused_attn import quantize_kv
    from t5gemma_tts_tpu_torch.ops.paged_attn import identity_page_indices

    def t(x):
        return torch.from_numpy(x).to(device)

    def pages(n):
        x = t(rng.standard_normal((hkv, n, PAGE, hd)).astype(np.float32))
        if quant:
            return quantize_kv(x)
        return x.to(torch.bfloat16), None

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


def attention_bytes_ops(args, include_current) -> tuple:
    """Bytes the function must move (each input read once, the output
    written once; only the valid tokens of each segment count) and its
    floating-point operations, for this call's data."""
    b, h, hd = args["q"].shape
    hkv = args["a_k_pages"].shape[0]
    elem = args["a_k_pages"].element_size()
    quant = args["a_k_scales"] is not None
    tokens = int(args["a_lengths"].clamp_min(1).sum())
    pages = int(((args["a_lengths"].clamp_min(1) + PAGE - 1) // PAGE).sum())
    if args["b_lengths"] is not None:
        tokens += int(args["b_lengths"].sum())
        pages += int(((args["b_lengths"] + PAGE - 1) // PAGE).sum())
    per_token = 2 * hkv * hd * elem + (2 * hkv * 4 if quant else 0)
    nbytes = (tokens * per_token + pages * 4 + 2 * b * 4
              + 2 * b * h * hd * 4 + (2 * b * hkv * hd * 4 if include_current else 0))
    flops = 4 * h * hd * (tokens + (b if include_current else 0))
    return nbytes, flops


def bound_ms(nbytes, flops) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
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
    for quant in (False, True):
        tag = "i8" if quant else "bf16"
        cases.append((f"self/{tag}", dict(
            big, quant=quant, a_lens=[1, 128, 165, 256],
            b_lens=[0, 5, 129, 320], pp_a=2, pp_b=3, layers=2, li=1,
            include_current=True)))
        cases.append((f"cross/{tag}", dict(
            big, quant=quant, a_lens=[12, 128, 133, 256], b_lens=None,
            pp_a=2, pp_b=0, layers=2, li=1, include_current=False)))
        cases.append((f"self-hd16-g2/{tag}", dict(
            b=3, h=4, hkv=2, hd=16, quant=quant, a_lens=[0, 100, 200],
            b_lens=[7, 0, 130], pp_a=2, pp_b=2, layers=1, li=0,
            include_current=True)))
    worst = 0.0
    for name, spec in cases:
        args = attention_case(rng, device=dev, **spec)
        cur = spec["include_current"]
        got = fa.batch_paged_attention(**args, attn_logits_soft_cap=50.0,
                                       include_current=cur)
        want = fa.batch_paged_attention_plain(
            **args, attn_logits_soft_cap=50.0, include_current=cur)
        torch.cuda.synchronize()
        err = check_close(name, got, want)
        worst = max(worst, err)
        k_ms = cuda_ms(lambda: fa.batch_paged_attention(
            **args, attn_logits_soft_cap=50.0, include_current=cur), iters)
        p_ms = cuda_ms(lambda: fa.batch_paged_attention_plain(
            **args, attn_logits_soft_cap=50.0, include_current=cur), iters)
        b_ms, _ = bound_ms(*attention_bytes_ops(args, cur))
        print(f"[kernel] batch_paged_attention {name}: max_abs_err={err:.3e} "
              f"(tol {TOL_ABS:g} abs + {TOL_REL:g} rel) kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} library_ms=none "
              f"(no PyTorch call computes soft-capped paged GQA) [{card}]")
    return {"max_abs_err": worst}


def main_path_step_timing(card: str, prompt_len: int, gen_len: int,
                          enc_lens, gen_slab: int, iters: int) -> dict:
    """One decode step's 52 launches (self + cross for each of 26 layers)
    at the main path's cache shapes, kernel against plain version."""
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    b = len(enc_lens)
    tx = -(-max(enc_lens) // PAGE) * PAGE
    common = dict(b=b, h=8, hkv=4, hd=256, quant=False, layers=MODEL_LAYERS,
                  li=0)
    self_args = attention_case(
        rng, device=dev, a_lens=[prompt_len] * b, b_lens=[gen_len] * b,
        pp_a=1, pp_b=gen_slab // PAGE, include_current=True, **common)
    cross_args = attention_case(
        rng, device=dev, a_lens=list(enc_lens), b_lens=None,
        pp_a=tx // PAGE, pp_b=0, include_current=False, **common)
    per_layer = []
    for li in range(MODEL_LAYERS):
        s = dict(self_args)
        s["a_page_indices"] = self_args["a_page_indices"] + li * b
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
    k_ms = cuda_ms(step(fa.batch_paged_attention), iters) / n
    p_ms = cuda_ms(step(fa.batch_paged_attention_plain), iters) / n
    sb, sf = attention_bytes_ops(self_args, True)
    cb, cf = attention_bytes_ops(cross_args, False)
    b_ms, by = bound_ms((sb + cb) / 2, (sf + cf) / 2)
    print(f"[kernel] main-path step (B={b}, prompt {prompt_len}, gen "
          f"{gen_len}, enc {list(enc_lens)}; mean of {n} launches): "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} "
          f"({by}) max_abs_err={worst:.3e} [{card}]")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": worst}


# ---------------------------------------------------------------------------
# phases 3 and 4: the port's main path
# ---------------------------------------------------------------------------


def char_tokenizer(vocab: int):
    def encode(text):
        return [3 + (ord(c) % (vocab - 10)) for c in text]
    return encode


def build_pipeline(cfg, ccfg, device, seed, init_device=None):
    """A pipeline on ``device`` with seeded random weights, made on
    ``init_device`` (default: ``device``). The CPU's and the card's
    generators draw different numbers from one seed, so two pipelines that
    must hold the same weights make them on one device."""
    from t5gemma_tts_tpu_torch.codec.audio_tokenizer import AudioTokenizer
    from t5gemma_tts_tpu_torch.codec.model import init_decoder_params
    from t5gemma_tts_tpu_torch.inference.pipeline import TTSPipeline
    from t5gemma_tts_tpu_torch.models import voice

    init_device = init_device or device
    params = voice.init_params(seed, cfg, device=init_device)
    cparams = init_decoder_params(seed + 1, ccfg, device=init_device)
    return TTSPipeline(params, cfg, char_tokenizer(cfg.text_vocab_size),
                       AudioTokenizer(cparams, ccfg, device=device),
                       device=device)


def phase_reference(devices=("cpu", "cuda")) -> None:
    """Tiny f32 model: greedy paged decode on the card == on the CPU."""
    from t5gemma_tts_tpu_torch.codec.model import tiny_codec_config
    from t5gemma_tts_tpu_torch.config import (
        DecodeConfig, backbone_preset, tiny_voice_config)
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    import dataclasses

    bb = backbone_preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    # a short duration tail keeps the paged cache inside the window
    cfg = tiny_voice_config(backbone=dataclasses.replace(
        bb, encoder=dims, decoder=dims), extra_cutoff=0.5)
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in (("hello world", 0.4), ("a test of the port", 0.6))]
    dcfg = DecodeConfig(top_k=1, kv_cache="paged")
    out = {}
    for device in devices:
        pipe = build_pipeline(cfg, tiny_codec_config(), device, seed=0,
                              init_device="cpu")
        out[device] = pipe.synthesize_batch(reqs, dcfg, seed=0, quiet=True)
    worst = 0.0
    for rc, rg in zip(out[devices[0]], out[devices[-1]]):
        if not np.array_equal(rc.gen_frames, rg.gen_frames):
            raise AssertionError(f"greedy tokens differ: cpu {rc.gen_frames} "
                                 f"cuda {rg.gen_frames}")
        worst = max(worst, float(np.abs(rc.wav - rg.wav).max()))
    if worst > 1e-4:
        raise AssertionError(f"tiny wav differs from the CPU by {worst:.3e}")
    print(f"[reference] tiny f32 greedy paged decode: tokens equal on card "
          f"and CPU ({[len(r.gen_frames) for r in out[devices[-1]]]} frames), "
          f"wav max abs diff {worst:.3e} (tol 1e-4)")


def phase_main_path(card: str, seed: int) -> dict:
    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.inference.pipeline import Request
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa

    cfg = VoiceConfig()                      # 2b-2b preset, bf16
    ccfg = XCodec2Config()                   # full-width decoder
    t0 = time.time()
    pipe = build_pipeline(cfg, ccfg, "cuda", seed)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(pipe.params))
    print(f"[main] 2b-2b pipeline built on the card in {time.time() - t0:.3f}s "
          f"({n_params / 1e9:.2f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated)")
    texts = ["Hello world, this is a test of the port.",
             "The quick brown fox jumps over the lazy dog.",
             "Speech synthesis on one card.",
             "Four requests decode in one batch."]
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(texts, (2.0, 2.5, 3.0, 4.0))]
    dcfg = DecodeConfig(kv_cache="paged", seed=seed)

    torch.cuda.reset_peak_memory_stats()
    fa.batch_paged_attention.launches = 0
    t0 = time.time()
    results = pipe.synthesize_batch(reqs, dcfg, seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.batch_paged_attention.launches

    steps = results[0].steps
    want = 2 * cfg.backbone.decoder.num_layers * steps
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != 2 x 26 x {steps}")
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
    print(f"[main] 4 requests: {steps} decode steps, {frames} frames, "
          f"{frames / wall:.2f} tokens/s, RTF {audio_s / wall:.3f}x "
          f"(audio s per wall s, decode+vocode {wall:.2f}s), "
          f"batch_paged_attention launches {launches} = 2 x 26 x {steps}, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
          f"[{card}]")
    planned = [pipe.plan_request(r) for r in reqs]
    return {"pipe": pipe, "launches": launches, "steps": steps,
            "enc_lens": [len(p.text) for p in planned],
            "gen_slab": max(pipe.frame_bucket(p) for p in planned)}


def phase_profile(pipe, card: str, enc_lens, steps: int = 32) -> None:
    """Device time by kernel over a prefill and ``steps`` decode steps of
    the main path's batch (torch.profiler), and the device's idle share of
    that wall time."""
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
    dcfg = DecodeConfig(kv_cache="paged", max_frames=steps)

    def run():
        gen = torch.Generator(device=dev).manual_seed(0)
        out = engine.decode_tokens(pipe.params, cfg, dcfg, x, x_lens, prompt,
                                   prompt_lens, targets, gen)
        torch.cuda.synchronize()
        return out

    run()
    t0 = time.time()
    run()
    wall_ms = (time.time() - t0) * 1e3       # without the profiler's cost
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
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
    print(f"[profile] prefill + {steps} decode steps of the 2b-2b batch of "
          f"{b}: wall {wall_ms:.1f} ms (unprofiled), device busy "
          f"{busy_ms:.1f} ms (kernels), idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{card}]")
    if not rows:
        print("[profile] torch.profiler recorded no device time")
    for ms, count, key in rows[:12]:
        print(f"[profile] {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{count:<6d} {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from t5gemma_tts_tpu_torch.ops import cuda_build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    t0 = time.time()
    logs = cuda_build.build(verbose=True)
    print(f"[device] built {sorted(cuda_build.SOURCES)} in "
          f"{time.time() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[device] {name}: {line.strip()}")

    entry = {"name": "batch_paged_attention", "route": "cuda",
             "source": "t5gemma_tts_tpu_torch/csrc/batch_paged_attention.cu",
             "replaces": "t5gemma_tts_tpu/ops/fused_attn.py:220",
             "library_ms": None}
    worst = phase_kernel(card, args.iters)["max_abs_err"]
    phase_reference()
    main = phase_main_path(card, args.seed)
    phase_profile(main["pipe"], card, main["enc_lens"])
    timing = main_path_step_timing(
        card, prompt_len=1, gen_len=main["steps"] // 2,
        enc_lens=main["enc_lens"], gen_slab=main["gen_slab"],
        iters=max(args.iters // 4, 2))
    entry.update(launches=main["launches"], ms=timing["ms"],
                 plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                 bound_by=timing["bound_by"],
                 max_abs_err=max(worst, timing["max_abs_err"]))
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts of the PyTorch/CUDA port, compared on one card.

    python3 tools/torch_prefill_ab.py PARENT CHANGE [--decode | --host]

PARENT and CHANGE are the roots of the two checkouts. For each checkout,
in turns (parent, change, change, parent), one process builds that
checkout's kernels and measures (host mode: one process for both).
Prints one ``AB {...}`` JSON line per process and the card's name and
power limit. Needs a card; imports nothing of JAX.

Prefill mode (the default): the wall and device time of the quantized
paths' prefill. The process builds the 2b-2b pipeline with seeded random
weights (int8 at batch 4, then int4 at batch 1, int8 pages) and runs
``engine.decode_tokens`` over a prefill and 1 decode step, then a prefill
and 32 decode steps: five timed runs each (host clock around work that ends
in ``torch.cuda.synchronize``; the median is reported) and one under
``torch.profiler`` for the device's busy time.

Decode mode (``--decode``): the device time of the decode kernels at the
main paths' shapes (generated length 225, the mean of a 451-step run),
each a CUDA graph of the calls replayed (``chip_smoke.graph_ms``) and, for
the attention, also the eager calls (``chip_smoke.cuda_ms``): kernel 2's
``decode_stack`` (26 layers of seeded random weights) for int8 weights at
batch 4 over int8 pages, int4 at batch 1 over int8 pages, and int4 at
chain 5 over bf16 pages (a verify pass); kernel 1's 52 launches of one
decode step (self + cross attention of 26 layers), bf16 pages at batch 4
and e4m3 pages at batch 1, also as host time (the median over 21 steps of
the time to enqueue one step's calls on an idle card); and the head's
products (W8A8 w1 and w2 at M = 1, 4 and 5; W4A8 w2 at M = 1 and 5).
Every device time is the mean of three replays of ``iters`` calls. Last,
the bf16 decode step as the main path serves it (eager, kernel 1 for both
attentions of every layer): the four requests of ``chip_smoke.py``'s main
path through ``engine.decode_tokens`` over paged bf16 pages, one step and
the whole 451-step bucket in turns, five times each; the step's wall ms is
(median of the bucket's walls - median of one step's) / (the bucket run's
steps - 1).

Host mode (``--host``): kernel 1's host time a call (the 52 calls of a
bf16 B = 4 and of an e4m3 B = 1 step as in decode mode), both checkouts'
wrappers in one process and in turns, 41 rounds; quartiles in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def measure(root: str) -> dict:
    """One checkout's walls and device busy times (run inside its root)."""
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    dev = torch.device("cuda")
    out = {"tree": root}
    for weights, b in (("int8", 4), ("int4", 1)):
        cfg = VoiceConfig()
        pipe = cs.build_pipeline(cfg, XCodec2Config(), "cuda", 0,
                                 int8=weights == "int8",
                                 int4=weights == "int4")
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.integers(
            3, cfg.text_vocab_size, (b, 64)).astype(np.int32)).to(dev)
        x_lens = torch.tensor([24, 40, 31, 56][-b:], dtype=torch.int32,
                              device=dev)
        prompt = torch.full((b, 64), cfg.special.pad, dtype=torch.int32,
                            device=dev)
        prompt_lens = torch.zeros((b,), dtype=torch.int32, device=dev)
        targets = torch.full((b,), 200, dtype=torch.int32, device=dev)
        res = {}
        for steps in (1, 32):
            dcfg = DecodeConfig(kv_cache="paged_i8", max_frames=steps)

            def run():
                engine.decode_tokens(pipe.params, cfg, dcfg, x, x_lens,
                                     prompt, prompt_lens, targets, 0)
                torch.cuda.synchronize()

            run()
            walls = []
            for _ in range(5):
                t0 = time.time()
                run()
                walls.append((time.time() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
            busy = sum(getattr(e, "self_device_time_total", 0)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            res[f"prefill+{steps}"] = dict(
                wall_ms_median=float(np.median(walls)), wall_ms=walls,
                busy_ms=busy / 1e3)
        out[f"{weights} b{b}"] = res
        del pipe
        torch.cuda.empty_cache()
    return out


ENC4 = [42, 46, 31, 36]       # about the four requests' text widths
GEN = 225                     # generated length: the mean of a 451-step run


def measure_decode(root: str, iters: int = 5) -> dict:
    """One checkout's decode-kernel device times (run inside its root)."""
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from t5gemma_tts_tpu_torch.config import VoiceConfig
    from t5gemma_tts_tpu_torch.ops import cuda_build
    from t5gemma_tts_tpu_torch.ops import fused_attn as fa
    from t5gemma_tts_tpu_torch.ops import megakernel as mk
    from t5gemma_tts_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build()
    dev = torch.device("cuda")
    dims = VoiceConfig().backbone.decoder
    out = {"tree": root}

    def stack_ms(layers, args, chain=1):
        return cs.graph_ms(lambda: mk.decode_stack(layers, dims, chain=chain,
                                                   **args), iters)

    w8 = cs.random_quant_layers(dims, dims.num_layers, dev, seed=1)
    args = cs.decode_layer_inputs(dims, 4, True, prompt=1, gen_lens=[GEN] * 4,
                                  enc_lens=ENC4, gen_slab=512, device=dev,
                                  seed=6)
    out["k2 w8 B=4 i8 pages"] = stack_ms(w8, args)
    del w8
    w4 = cs.random_quant_layers(dims, dims.num_layers, dev, seed=2, int4=True)
    args = cs.decode_layer_inputs(dims, 1, True, prompt=1, gen_lens=[GEN],
                                  enc_lens=ENC4[-1:], gen_slab=512,
                                  device=dev, seed=6)
    out["k2 w4 B=1 i8 pages"] = stack_ms(w4, args)
    args = cs.chain_layer_inputs(dims, 1, 5, False, dev, seed=10, gen=(GEN,),
                                 enc=(ENC4[-1],), gen_slab=512)
    args["plens"].fill_(1)
    out["k2 w4 chain 5 bf16 pages"] = stack_ms(w4, args, chain=5)
    del w4, args
    torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    for b, f8 in ((4, False), (1, True)):
        calls = kernel1_step(cs, dims, rng, b, f8, dev)

        def step():
            run_kernel1(fa, calls)

        tag = f"k1 {'e4m3' if f8 else 'bf16'} B={b}"
        out[f"{tag} graph"] = cs.graph_ms(step, iters) / len(calls)
        out[f"{tag} eager"] = cs.cuda_ms(step, iters) / len(calls)
        out[f"{tag} host"] = host_ms(step) / len(calls)

    gen = torch.Generator(device=dev).manual_seed(7)
    d = dims.hidden_size
    for int4, n, ms in ((False, 2304, (1, 4, 5)), (False, 65541, (1, 4, 5)),
                        (True, 65541, (1, 5))):
        w = cs.random_product_weight(int4, n, d, gen)
        product = quant.w4a8_matmul if int4 else quant.w8a8_matmul
        for m in ms:
            x = torch.randn((m, d), generator=gen, device=dev).to(
                torch.bfloat16)
            out[f"head {'w4a8' if int4 else 'w8a8'} N={n} M={m}"] = (
                cs.graph_ms(lambda: product(x, w), iters * 4))
    del w
    torch.cuda.empty_cache()
    out.update(bf16_step_ms(cs, dims))
    return out


def kernel1_step(cs, dims, rng, b: int, f8: bool, dev) -> list:
    """The inputs of kernel 1's 52 calls in one decode step of the main
    path: self attention (prompt 1 + generated ``GEN`` + the in-flight
    token) and cross attention of every layer; bf16 or e4m3 pages."""
    common = dict(b=b, h=dims.num_heads, hkv=dims.num_kv_heads,
                  hd=dims.head_dim, quant=False, layers=dims.num_layers,
                  li=0, f8=f8, device=dev)
    s_args = cs.attention_case(rng, a_lens=[1] * b, b_lens=[GEN] * b,
                               pp_a=1, pp_b=4, include_current=True, **common)
    c_args = cs.attention_case(rng, a_lens=ENC4[-b:], b_lens=None, pp_a=1,
                               pp_b=0, include_current=False, **common)
    calls = []
    for li in range(dims.num_layers):
        s = dict(s_args, a_page_indices=s_args["a_page_indices"] + li * b,
                 b_page_indices=s_args["b_page_indices"] + li * b * 4)
        c = dict(c_args, a_page_indices=c_args["a_page_indices"] + li * b)
        calls += [(s, True), (c, False)]
    return calls


def run_kernel1(fa, calls) -> None:
    for a, cur in calls:
        fa.batch_paged_attention(**a, attn_logits_soft_cap=50.0,
                                 include_current=cur)


def measure_host(parent: str, change: str, reps: int = 41) -> dict:
    """Kernel 1's host time a call, both checkouts' wrappers in one process
    and in turns (parent, change, change, parent; ``reps`` rounds), so that
    the host's speed, which differs between processes, is the same for
    both. Each checkout's package is imported under a name of its own and
    builds its own kernel; the inputs are those of ``kernel1_step``."""
    import importlib
    import importlib.util

    import numpy as np
    import torch

    os.chdir(change)
    sys.path.insert(0, change)
    import chip_smoke as cs
    from t5gemma_tts_tpu_torch.config import VoiceConfig

    fas = {}
    for tag, root in (("parent", parent), ("change", change)):
        name = f"_ab_{tag}"
        pkg = os.path.join(root, "t5gemma_tts_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
        importlib.import_module(f"{name}.ops.cuda_build").build(
            ["batch_paged_attention"])
        fas[tag] = importlib.import_module(f"{name}.ops.fused_attn")
    dev = torch.device("cuda")
    dims = VoiceConfig().backbone.decoder
    rng = np.random.default_rng(1)
    out = {}
    for b, f8 in ((4, False), (1, True)):
        calls = kernel1_step(cs, dims, rng, b, f8, dev)
        walls = {tag: [] for tag in fas}
        for fa in fas.values():
            run_kernel1(fa, calls)
        for _ in range(reps):
            for tag in ("parent", "change", "change", "parent"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_kernel1(fas[tag], calls)
                walls[tag].append((time.perf_counter() - t0) * 1e3
                                  / len(calls))
        torch.cuda.synchronize()
        for tag, w in walls.items():
            out[f"k1 {'e4m3' if f8 else 'bf16'} B={b} host {tag}"] = [
                float(np.percentile(w, q)) for q in (25, 50, 75)]
    return out


def host_ms(fn, reps: int = 21) -> float:
    """Median host time of one ``fn()`` that starts on an idle device: the
    time to check its arguments and enqueue its launches."""
    import numpy as np
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(walls))


def bf16_step_ms(cs, dims) -> dict:
    """The eager bf16 decode step of the main path's four requests."""
    import numpy as np
    import torch

    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    cfg = VoiceConfig()
    pipe = cs.build_pipeline(cfg, XCodec2Config(), "cuda", 0)
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(cs.TEXTS, cs.DURATIONS)]
    inputs, bucket = cs.planned_inputs(pipe, reqs)

    def run(steps):
        dcfg = DecodeConfig(kv_cache="paged", seed=0, max_frames=steps)
        torch.cuda.synchronize()
        t0 = time.time()
        out = engine.decode_tokens(pipe.params, cfg, dcfg, *inputs, 0)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, out.steps

    run(2)
    walls = {1: [], bucket: []}
    for _ in range(5):
        for steps in walls:
            wall, ran = run(steps)
            walls[steps].append(wall)
    one, full = (float(np.median(walls[s])) for s in (1, bucket))
    return {"bf16 B=4 step eager": (full - one) / (ran - 1),
            "bf16 B=4 steps": ran, "bf16 B=4 walls ms": walls}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--one", action="store_true",
                    help="measure the first root only (one process)")
    ap.add_argument("--decode", action="store_true",
                    help="the decode kernels instead of the prefill")
    ap.add_argument("--host", action="store_true",
                    help="kernel 1's host time a call, both in one process")
    args = ap.parse_args(argv)
    if args.host:
        print(card_line(), flush=True)
        print("AB " + json.dumps(measure_host(os.path.abspath(args.parent),
                                              os.path.abspath(args.change))),
              flush=True)
        return 0
    if args.one:
        fn = measure_decode if args.decode else measure
        print("AB " + json.dumps(fn(os.path.abspath(args.parent))),
              flush=True)
        return 0
    print(card_line(), flush=True)
    for root in (args.parent, args.change, args.change, args.parent):
        subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        root, "--one"] + (["--decode"] if args.decode else []),
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

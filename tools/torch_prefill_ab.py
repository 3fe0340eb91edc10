"""Two checkouts of the PyTorch/CUDA port, compared on one card.

    python3 tools/torch_prefill_ab.py PARENT CHANGE [--decode [--attention]
                                                    | --host]

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
decode step (self + cross attention of 26 layers; the 26 self
attentions also alone, kernel 7's work), bf16 pages at batch 4 and e4m3
pages at batch 1, also as host time (the median over 21 steps of
the time to enqueue one step's calls on an idle card); kernel 7's 26
launches of one 4g step (the v1 self-attention of 26 layers, bf16 and
e4m3 pages at batch 4), graph and eager; kernel 5's 78 launches of one 4e
verify pass (prompt 1, generated ``GEN`` and encoder pages of one cache row
for each of 26 layers, e4m3 pages, a chain of 5) and its 26 launches of a
4g step's cross attention (bf16 pages, batch 4), graph and eager (a
checkout whose wrapper takes no ``chain`` gets the lengths and page tables
repeated over the pseudo-rows, built outside the timed calls); with
``--attention`` the process stops here. Then the head's products (W8A8 w1
and w2 at M = 1, 4 and 5; W4A8 w2 at M = 1 and 5); and kernel 6 (W8A16)
over 26 layers of seeded random int8 weights at 2b-2b widths: the 158
products of one decode step at M = 4 (6 x 26 layer products and the
head's w1 and w2) in one graph, their mean per launch, and each of the
eight shapes' calls of a step alone (mean per launch), then the six layer
products of the prefill at M = 260 (layer 0).
Every device time is the mean of three replays of ``iters`` calls. Last,
the decode step as the main path serves it, eager: the four requests of
``chip_smoke.py``'s main path through ``engine.decode_tokens`` over paged
bf16 pages with bf16 weights (kernel 1 for both attentions of every
layer), with bf16 weights and ``T5G_FUSED_ATTN=1`` (4g: kernels 7 and 5)
and with W8A16 weights (4f: kernels 6 and 1); one step and 65 steps in
turns, five times each; the step's wall ms is (median of the 65-step
walls - median of one step's) / 64.

Host mode (``--host``): whether kernels 1 and 7 give the parent's output
bits (kernel 1's bf16 B = 4 and e4m3 B = 1 step, kernel 7's bf16 and e4m3
4g step); kernel 1's host time a call (the 52 calls of a
bf16 B = 4 and of an e4m3 B = 1 step as in decode mode), kernel 7's (the
26 calls of a bf16 B = 4 4g step), kernel 5's (the 26 cross calls of a 4g
step; the 78 calls of a 4e verify pass, the parent's wrapper once on
pseudo-row inputs repeated beforehand and once with the
``repeat_interleave`` of the page tables that its caller ran each call and
of the lengths once a pass) and kernel 6's (the 158 products of a 4f step
at M = 4), both checkouts' wrappers in one process and in turns, 41
rounds; quartiles in ms.
"""

from __future__ import annotations

import argparse
import inspect
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
PAGE = 128                    # tokens a KV page
GEN = 225                     # generated length: the mean of a 451-step run


def measure_decode(root: str, iters: int = 5,
                   attention_only: bool = False) -> dict:
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
    from t5gemma_tts_tpu_torch.ops import paged_attn as pa
    from t5gemma_tts_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build()
    dev = torch.device("cuda")
    dims = VoiceConfig().backbone.decoder
    out = {"tree": root}
    if attention_only:
        return attention_kernels(out, cs, fa, pa, dims, dev, iters)

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

    attention_kernels(out, cs, fa, pa, dims, dev, iters)
    torch.cuda.empty_cache()

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
    out.update(w8a16_step(cs, quant, dims, dev, iters))
    torch.cuda.empty_cache()
    out.update(eager_steps_ms(cs))
    return out


def attention_kernels(out, cs, fa, pa, dims, dev, iters: int) -> dict:
    """Kernels 1, 7 and 5 at the main paths' shapes, graph-replayed and
    eager (ms a launch), into ``out``."""
    import numpy as np

    rng = np.random.default_rng(1)
    for b, f8 in ((4, False), (1, True)):
        calls = kernel1_step(cs, dims, rng, b, f8, dev)

        def step():
            run_kernel1(fa, calls)

        tag = f"k1 {'e4m3' if f8 else 'bf16'} B={b}"
        out[f"{tag} graph"] = cs.graph_ms(step, iters) / len(calls)
        selves = calls[::2]        # the self attentions alone: kernel 7's work
        out[f"{tag} self graph"] = cs.graph_ms(
            lambda: run_kernel1(fa, selves), iters) / len(selves)
        out[f"{tag} eager"] = cs.cuda_ms(step, iters) / len(calls)
        out[f"{tag} host"] = host_ms(step) / len(calls)

    for f8 in (False, True):
        calls = kernel7_step(cs, dims, rng, 4, f8, dev)

        def step7():
            run_kernel7(fa, calls)

        tag = f"k7 {'e4m3' if f8 else 'bf16'} B=4"
        out[f"{tag} graph"] = cs.graph_ms(step7, iters) / len(calls)
        out[f"{tag} eager"] = cs.cuda_ms(step7, iters) / len(calls)

    for tag, calls in (("k5 4e verify pass", kernel5_pass(dims, rng, dev)),
                       ("k5 4g cross B=4", kernel5_cross(dims, rng, dev))):
        calls = kernel5_form(pa, calls)

        def step5():
            run_kernel5(pa, calls)

        out[f"{tag} graph"] = cs.graph_ms(step5, iters) / len(calls)
        out[f"{tag} eager"] = cs.cuda_ms(step5, iters) / len(calls)
    return out


def kernel5_case(dims, rng, dev, *, rows, chain, lens, pp, f8, layers):
    """One segment's inputs of kernel 5 in the chain form: ``rows`` cache
    rows of ``pp`` pages each in a slab of ``layers`` layers (layer 0's
    page tables), q of ``chain`` pseudo-rows a cache row."""
    import numpy as np
    import torch

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    hkv, hd = dims.num_kv_heads, dims.head_dim
    dtype = torch.float8_e4m3fn if f8 else torch.bfloat16
    return dict(q=t(rows * chain, dims.num_heads, hd),
                k_pages=t(hkv, layers * rows * pp, PAGE, hd).to(dtype),
                v_pages=t(hkv, layers * rows * pp, PAGE, hd).to(dtype),
                lengths=torch.tensor(lens, dtype=torch.int32, device=dev),
                page_indices=torch.arange(rows * pp, dtype=torch.int32,
                                          device=dev).reshape(rows, pp),
                chain=chain)


def kernel5_layers(case, pp, rows, layers) -> list:
    """``case`` for each of ``layers`` layers (layer li's page tables)."""
    return [dict(case, page_indices=case["page_indices"] + li * rows * pp)
            for li in range(layers)]


def kernel5_pass(dims, rng, dev, chain: int = 5) -> list:
    """The inputs of kernel 5's 78 calls in one 4e verify pass: prompt
    (1 token of one page), generation (``GEN`` of four pages) and cross
    (the 4.0 s request's text width, one page) for each layer, one cache
    row, e4m3 pages, a chain of ``chain``."""
    segs = [kernel5_layers(kernel5_case(dims, rng, dev, rows=1, chain=chain,
                                        lens=[n], pp=pp, f8=True,
                                        layers=dims.num_layers),
                           pp, 1, dims.num_layers)
            for n, pp in ((1, 1), (GEN, 4), (ENC4[-1], 1))]
    return [seg[li] for li in range(dims.num_layers) for seg in segs]


def kernel5_cross(dims, rng, dev) -> list:
    """The inputs of kernel 5's 26 calls of a 4g step's cross attention:
    batch 4 over one encoder page each, bf16 pages."""
    return kernel5_layers(kernel5_case(dims, rng, dev, rows=4, chain=1,
                                       lens=ENC4, pp=1, f8=False,
                                       layers=dims.num_layers),
                          1, 4, dims.num_layers)


def kernel5_form(pa, calls) -> list:
    """``calls`` as ``pa.paged_flash_parts`` takes them: as they are, or,
    where the wrapper takes no ``chain``, with the lengths and page tables
    repeated over the pseudo-rows (chain-position-major)."""
    if "chain" in inspect.signature(pa.paged_flash_parts).parameters:
        return calls
    return [{k: v for k, v in dict(
        a, lengths=a["lengths"].repeat_interleave(a["chain"]),
        page_indices=a["page_indices"].repeat_interleave(a["chain"], 0)
    ).items() if k != "chain"} for a in calls]


def run_kernel5(pa, calls) -> None:
    for a in calls:
        pa.paged_flash_parts(**a, attn_logits_soft_cap=50.0)


def run_kernel5_repeating(pa, calls) -> None:
    """A chain-less wrapper's verify pass as its caller ran it: the
    lengths repeated once a pass, each call's page table repeated."""
    reps = {}
    for a in calls:
        s = a["chain"]
        key = id(a["lengths"])
        if key not in reps:
            reps[key] = a["lengths"].repeat_interleave(s)
        pa.paged_flash_parts(a["q"], a["k_pages"], a["v_pages"], reps[key],
                             a["page_indices"].repeat_interleave(s, dim=0),
                             attn_logits_soft_cap=50.0)


# kernel 6's products of a decode step, (name, K, N) at 2b-2b widths
W8A16_SHAPES = (("qkv", 2304, 4096), ("o", 2048, 2304),
                ("cross q", 2304, 2048), ("cross o", 2048, 2304),
                ("gate_up", 2304, 18432), ("down", 9216, 2304))
HEAD_SHAPES = (("head w1", 2304, 2304), ("head w2", 2304, 65541))


def w8a16_weights(dims, dev) -> tuple:
    """Seeded random W8A16 weights of 26 layers at 2b-2b widths (each
    product of a step reads its own weights, as a step does), raw:
    ``by_shape`` maps each shape's name to its calls [(x, (levels, scale,
    N, 16))] (26 for a layer shape, one for the head's), ``x_of(m, k)``
    gives the bf16 activations of M = m, K = k."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(8)

    def weight(k, n):
        q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
        return q, scale, n, 16

    xs = {}

    def x_of(m, k):
        if (m, k) not in xs:
            xs[m, k] = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
        return xs[m, k]

    by_shape = {nm: [(x_of(4, k), weight(k, n))
                     for _ in range(dims.num_layers)]
                for nm, k, n in W8A16_SHAPES}
    by_shape.update({nm: [(x_of(4, k), weight(k, n))]
                     for nm, k, n in HEAD_SHAPES})
    return by_shape, x_of


def w8a16_step_calls(dims, by_shape) -> list:
    """The 158 products of a decode step at M = 4, in the order a step
    sends them: the six of each layer, then the head's w1 and w2."""
    step = [c for li in range(dims.num_layers)
            for nm, _, _ in W8A16_SHAPES for c in by_shape[nm][li:li + 1]]
    return step + [by_shape[nm][0] for nm, _, _ in HEAD_SHAPES]


def w8a16_step(cs, quant, dims, dev, iters: int) -> dict:
    """Kernel 6's device time over :func:`w8a16_weights`: the 158 products
    of a decode step at M = 4, each shape's calls alone, and the six layer
    products at M = 260 (the prefill). Means per launch."""
    raw, x_of = w8a16_weights(dims, dev)
    by_shape = {nm: [(x, quant.QuantWeight(*w)) for x, w in calls]
                for nm, calls in raw.items()}

    def run(calls):
        return lambda: [quant.w8a16_matmul(x, w) for x, w in calls]

    step = w8a16_step_calls(dims, by_shape)
    out = {"k6 step M=4 mean": cs.graph_ms(run(step), iters) / len(step),
           "k6 step launches": len(step)}
    for nm, calls in by_shape.items():
        out[f"k6 {nm} M=4"] = cs.graph_ms(run(calls), iters) / len(calls)
    for nm, k, n in W8A16_SHAPES:
        x, w = x_of(260, k), by_shape[nm][0][1]
        out[f"k6 {nm} M=260"] = cs.graph_ms(run([(x, w)]), iters)
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


def kernel7_step(cs, dims, rng, b: int, f8: bool, dev) -> list:
    """The inputs of kernel 7's 26 calls in one 4g decode step: the v1
    self-attention of every layer over the prompt (1) and the ``GEN``
    generated tokens, and the in-flight token; bf16 or e4m3 pages."""
    base = cs.attention_case(rng, b=b, h=dims.num_heads,
                             hkv=dims.num_kv_heads, hd=dims.head_dim,
                             quant=False, f8=f8, a_lens=[1] * b,
                             b_lens=[GEN] * b, pp_a=1, pp_b=4,
                             layers=dims.num_layers, li=0,
                             include_current=True, device=dev)
    args = cs.fused_args(base)
    return [dict(args, prompt_page_indices=args["prompt_page_indices"]
                 + li * b,
                 gen_page_indices=args["gen_page_indices"] + li * b * 4)
            for li in range(dims.num_layers)]


def run_kernel7(fa, calls) -> None:
    for a in calls:
        fa.fused_decode_attention(**a, attn_logits_soft_cap=50.0)


def run_kernel1(fa, calls) -> None:
    for a, cur in calls:
        fa.batch_paged_attention(**a, attn_logits_soft_cap=50.0,
                                 include_current=cur)


def measure_host(parent: str, change: str, reps: int = 41) -> dict:
    """Kernel 1's, kernel 7's, kernel 5's and kernel 6's host time a call, both
    checkouts' wrappers in one process and in turns (parent, change,
    change, parent; ``reps`` rounds), so that the host's speed, which
    differs between processes, is the same for both. Each checkout's
    package is imported under a name of its own and builds its own
    kernels; the inputs are those of ``kernel1_step``, ``kernel7_step``,
    ``kernel5_cross``, ``kernel5_pass`` and ``w8a16_step_calls``."""
    import importlib
    import importlib.util

    import numpy as np
    import torch

    os.chdir(change)
    sys.path.insert(0, change)
    import chip_smoke as cs
    from t5gemma_tts_tpu_torch.config import VoiceConfig

    fas, pas, quants = {}, {}, {}
    for tag, root in (("parent", parent), ("change", change)):
        name = f"_ab_{tag}"
        pkg = os.path.join(root, "t5gemma_tts_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
        importlib.import_module(f"{name}.ops.cuda_build").build(
            ["batch_paged_attention", "fused_decode_attention",
             "paged_flash_parts", "w8a16_matmul"])
        fas[tag] = importlib.import_module(f"{name}.ops.fused_attn")
        pas[tag] = importlib.import_module(f"{name}.ops.paged_attn")
        quants[tag] = importlib.import_module(f"{name}.ops.quant")
    dev = torch.device("cuda")
    dims = VoiceConfig().backbone.decoder
    rng = np.random.default_rng(1)
    out = {}
    for b, f8 in ((4, False), (1, True)):
        calls = kernel1_step(cs, dims, rng, b, f8, dev)
        label = f"k1 {'e4m3' if f8 else 'bf16'} B={b}"
        out[f"{label} outputs bit-equal"] = same_bits(
            {tag: [fa.batch_paged_attention(**a, attn_logits_soft_cap=50.0,
                                            include_current=cur)
                   for a, cur in calls] for tag, fa in fas.items()})
        out.update(host_turns(
            label, {tag: (lambda fa=fa: run_kernel1(fa, calls))
                    for tag, fa in fas.items()}, len(calls), reps))
    for f8 in (True, False):
        calls = kernel7_step(cs, dims, rng, 4, f8, dev)
        out[f"k7 {'e4m3' if f8 else 'bf16'} B=4 outputs bit-equal"] = (
            same_bits({tag: [fa.fused_decode_attention(
                **a, attn_logits_soft_cap=50.0) for a in calls]
                for tag, fa in fas.items()}))
    out.update(host_turns(
        "k7 bf16 B=4", {tag: (lambda fa=fa: run_kernel7(fa, calls))
                        for tag, fa in fas.items()}, len(calls), reps))
    calls = kernel5_cross(dims, rng, dev)
    out.update(host_turns(
        "k5 4g cross B=4", {tag: (lambda pa=pa, c=kernel5_form(pa, calls):
                                  run_kernel5(pa, c))
                            for tag, pa in pas.items()}, len(calls), reps))
    calls = kernel5_pass(dims, rng, dev)
    forms = {tag: kernel5_form(pa, calls) for tag, pa in pas.items()}
    out.update(host_turns(
        "k5 4e verify pass", {tag: (lambda pa=pa, c=forms[tag]:
                                    run_kernel5(pa, c))
                              for tag, pa in pas.items()}, len(calls), reps))
    out.update(host_turns(
        "k5 4e verify pass, the parent with its repeats",
        {"parent": lambda: run_kernel5_repeating(pas["parent"], calls),
         "change": lambda: run_kernel5(pas["change"], forms["change"])},
        len(calls), reps))
    del calls, forms
    raw = w8a16_step_calls(dims, w8a16_weights(dims, dev)[0])
    steps = {tag: [(x, q.QuantWeight(*w)) for x, w in raw]
             for tag, q in quants.items()}
    out.update(host_turns(
        "k6 step M=4", {tag: (lambda q=q, st=steps[tag]: [
            q.w8a16_matmul(x, w) for x, w in st])
            for tag, q in quants.items()}, len(raw), reps))
    return out


def same_bits(outs: dict) -> bool:
    """Whether the parent's and the change's outputs are equal bit for
    bit."""
    import torch

    return all(torch.equal(x, y)
               for x, y in zip(outs["parent"], outs["change"]))


def host_turns(label: str, fns: dict, calls: int, reps: int) -> dict:
    """Host time a call of ``fns["parent"]`` and ``fns["change"]`` (each
    ``calls`` calls), in turns (parent, change, change, parent) over
    ``reps`` rounds, each turn from an idle card; quartiles in ms."""
    import numpy as np
    import torch

    walls = {tag: [] for tag in fns}
    for fn in fns.values():
        fn()
    for _ in range(reps):
        for tag in ("parent", "change", "change", "parent"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[tag]()
            walls[tag].append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return {f"{label} host {tag}": [float(np.percentile(w, q))
                                    for q in (25, 50, 75)]
            for tag, w in walls.items()}


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


EAGER_STEPS = 65       # the long run of eager_steps_ms; the short run is 1


def eager_steps_ms(cs) -> dict:
    """The eager decode step of the main path's four requests at batch 4,
    as served: bf16 weights (both attentions on kernel 1), bf16 weights
    with ``T5G_FUSED_ATTN=1`` (4g: kernel 7 and kernel 5) and W8A16
    weights (4f: kernel 6 and kernel 1), each over paged bf16 pages."""
    import numpy as np
    import torch

    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.config import DecodeConfig, VoiceConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request

    cfg = VoiceConfig()
    reqs = [Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(cs.TEXTS, cs.DURATIONS)]
    out = {}
    for tag, w8a16, mode in (("bf16", False, None), ("4g", False, "1"),
                             ("4f", True, None)):
        if tag != "4g":
            pipe = None
            torch.cuda.empty_cache()
            pipe = cs.build_pipeline(cfg, XCodec2Config(), "cuda", 0,
                                     w8a16=w8a16)
            inputs, _ = cs.planned_inputs(pipe, reqs)

        def run(steps):
            dcfg = DecodeConfig(kv_cache="paged", seed=0, max_frames=steps)
            torch.cuda.synchronize()
            t0 = time.time()
            res = engine.decode_tokens(pipe.params, cfg, dcfg, *inputs, 0)
            torch.cuda.synchronize()
            return (time.time() - t0) * 1e3, res.steps

        with cs.attn_mode(mode):
            run(2)
            walls = {1: [], EAGER_STEPS: []}
            for _ in range(5):
                for steps in walls:
                    wall, ran = run(steps)
                    walls[steps].append(wall)
        one, full = (float(np.median(walls[s])) for s in walls)
        out[f"{tag} B=4 step eager"] = (full - one) / (ran - 1)
        out[f"{tag} B=4 walls ms"] = walls
    return out


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
    ap.add_argument("--attention", action="store_true",
                    help="with --decode: the attention kernels (1, 7, 5) "
                    "alone")
    ap.add_argument("--host", action="store_true",
                    help="kernels 1, 7, 5 and 6's host time a call, both "
                    "checkouts in one process")
    args = ap.parse_args(argv)
    if args.host:
        print(card_line(), flush=True)
        print("AB " + json.dumps(measure_host(os.path.abspath(args.parent),
                                              os.path.abspath(args.change))),
              flush=True)
        return 0
    if args.one:
        root = os.path.abspath(args.parent)
        res = (measure_decode(root, attention_only=args.attention)
               if args.decode else measure(root))
        print("AB " + json.dumps(res), flush=True)
        return 0
    print(card_line(), flush=True)
    mode = (["--decode"] if args.decode else []) + (
        ["--attention"] if args.attention else [])
    for root in (args.parent, args.change, args.change, args.parent):
        subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        root, "--one"] + mode, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

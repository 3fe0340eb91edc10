"""Two checkouts of the PyTorch/CUDA port, compared on one card: the wall
and device time of the quantized paths' prefill.

    python3 tools/torch_prefill_ab.py PARENT_ROOT CHANGE_ROOT

For each checkout, in turns (parent, change, change, parent), one process
builds that checkout's kernels, builds the 2b-2b pipeline with seeded random
weights (int8 at batch 4, then int4 at batch 1, int8 pages) and runs
``engine.decode_tokens`` over a prefill and 1 decode step, then a prefill
and 32 decode steps: five timed runs each (host clock around work that ends
in ``torch.cuda.synchronize``; the median is reported) and one under
``torch.profiler`` for the device's busy time. Prints one ``AB {...}`` JSON
line per process and the card's name and power limit. Needs a card;
imports nothing of JAX.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--one", action="store_true",
                    help="measure the first root only (one process)")
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(measure(os.path.abspath(args.parent))),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    for root in (args.parent, args.change, args.change, args.parent):
        subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        root, "--one"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

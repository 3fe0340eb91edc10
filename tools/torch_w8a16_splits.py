"""Kernel 6 (the W8A16 product) against its own split-K counts, on one card.

    python3 tools/torch_w8a16_splits.py

For each of the W8A16 main path's product shapes (2b-2b: the six layer
products at a decode step's M = 4 and the prefill's M = 260, the head's
w1 and w2 at M = 4) it times ``csrc/w8a16_matmul.cu``'s tensor-core route
at every K split count from 1 to the most its K tiles allow (each split at
least two K tiles), beside the count that the kernel's own plan picks
(``quant.product_plan``; ``csrc/w8a16_matmul.cu::w16_plan``). At M = 4
each layer shape runs over 26 seeded random weights in turn, as a step
reads them (no weight stays in the 50 MB L2); the device time is the mean
per call of a CUDA graph of those calls, replayed
(``chip_smoke.graph_ms``). Prints one ``SPLITS {...}`` JSON line per
shape and the card's name and power limit. Needs a card; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from t5gemma_tts_tpu_torch.ops import quant  # noqa: E402

LAYER_SHAPES = (("qkv", 2304, 4096), ("o", 2048, 2304),
                ("cross q", 2304, 2048), ("cross o", 2048, 2304),
                ("gate_up", 2304, 18432), ("down", 9216, 2304))
HEAD_SHAPES = (("head w1", 2304, 2304), ("head w2", 2304, 65541))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8a16_splits: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)

    def weight(k, n):
        q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
        return quant.QuantWeight(q, scale, n, 16)

    print(cs.card_line(), flush=True)
    cases = [(nm, 4, k, n, 26) for nm, k, n in LAYER_SHAPES]
    cases += [(nm, 4, k, n, 1) for nm, k, n in HEAD_SHAPES]
    cases += [(nm, 260, k, n, 1) for nm, k, n in LAYER_SHAPES]
    for nm, m, k, n, copies in cases:
        ws = [weight(k, n) for _ in range(copies)]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        plan = quant.product_plan(m, ws[0])
        want = quant.w8a16_matmul_plain(x, ws[0], torch.float32)
        times = {}
        for splits in range(1, plan["ktiles"] // 2 + 1):
            got = cs.w8a16_with_splits(x, ws[0], splits).float()
            rel = float((got - want).norm() / want.norm())
            if not rel < 1e-2:      # the bf16 output: 2^-8 relative a value
                raise AssertionError(f"{nm} M={m} splits={splits}: "
                                     f"relative error {rel:.2e}")
            times[splits] = cs.graph_ms(
                lambda: [cs.w8a16_with_splits(x, w, splits) for w in ws],
                5) / copies
        best = min(times, key=times.get)
        print("SPLITS " + json.dumps(dict(
            shape=nm, M=m, K=k, N=n, weights=copies,
            plan_splits=plan["splits"], plan_ms=times[plan["splits"]],
            best_splits=best, best_ms=times[best],
            ms={s: round(t, 5) for s, t in times.items()})), flush=True)
        del ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

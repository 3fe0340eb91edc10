"""Paged KV-cache helpers (counterpart of ``t5gemma_tts_tpu/ops/paged_attn.py``).

Only what the bf16/int8 paged decode path needs: the identity page table of
a [Hkv, L*B*pages, ps, hd] slab view and the page store dtypes. The float8
store (``paged_f8``) and the one-segment paged kernel come with a later
slice.
"""

from __future__ import annotations

import torch

KV_STORE_DTYPES = {
    "bf16": torch.bfloat16,
    "i8": torch.int8,    # + per-token scale planes (ops/fused_attn.quantize_kv)
}


def identity_page_indices(batch: int, pages_per_seq: int,
                          device=None) -> torch.Tensor:
    """[B, pages_per_seq] int32: row b owns pages b*pps ... b*pps + pps - 1."""
    rows = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(pages_per_seq, dtype=torch.int32, device=device)[None]
    return rows * pages_per_seq + cols

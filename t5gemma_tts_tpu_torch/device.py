"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. When
``cuda`` is asked for and there is no card they raise; they never fall back
to the CPU on their own.
"""

from __future__ import annotations

from typing import Any, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def tree_to(tree: Any, device: torch.device) -> Any:
    """A nested dict (or list) of tensors (and ``QuantWeight`` /
    ``Int4Weight`` leaves) moved to ``device`` (leaves already there are
    kept, not copied)."""
    from .ops.quant import Int4Weight, QuantWeight, map_weight

    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, (QuantWeight, Int4Weight)):
        return map_weight(tree, lambda t: t.to(device))
    return tree.to(device)

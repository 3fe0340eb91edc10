"""Weight bridge: parameter trees of the JAX package (as numpy) <-> the port.

The port keeps the JAX tree's key names and its stacked ``[L, ...]`` layer
axis (``voice.init_params``, ``codec.model.init_decoder_params``), so the
bridge renames nothing: it maps every numpy leaf to a tensor, byte for byte
(bfloat16 leaves, which numpy holds as ``ml_dtypes.bfloat16``, travel as
their 16-bit patterns).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _to_tensor(arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``.
    With ``dtype`` floating leaves are cast; without it they keep theirs."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), dev, dtype)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_jax` (bf16 leaves as ml_dtypes
    bfloat16 when ml_dtypes is installed, else as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()

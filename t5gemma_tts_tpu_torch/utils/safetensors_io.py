"""Reading and writing ``.safetensors`` files over ``torch`` alone.

The format: an 8-byte little-endian header length N, a JSON header of N
bytes, then the tensors' raw little-endian bytes. The header maps each
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into
the data that follows the header) and may hold ``"__metadata__"``, a map
of strings, which the reader ignores.

:func:`save_file` writes the bytes the ``safetensors`` library writes: the
tensors laid out by dtype, in the descending order of the library's dtype
list (I64, F64, F32, I32, BF16, F16, I16, I8, U8, BOOL), then by name; the
header in that order, compact, ``__metadata__`` first, padded with spaces
to a multiple of 8.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike

# the library's dtype names, in its own order (the layout sorts by it,
# largest rank first)
_DTYPES = (
    ("BOOL", torch.bool), ("U8", torch.uint8), ("I8", torch.int8),
    ("I16", torch.int16), ("F16", torch.float16), ("BF16", torch.bfloat16),
    ("I32", torch.int32), ("F32", torch.float32), ("F64", torch.float64),
    ("I64", torch.int64),
)
_NAME = {dt: name for name, dt in _DTYPES}
_TORCH = {name: dt for name, dt in _DTYPES}
_RANK = {name: i for i, (name, _) in enumerate(_DTYPES)}


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def save(tensors: Mapping[str, torch.Tensor],
         metadata: Optional[Dict[str, str]] = None) -> bytes:
    """The file's bytes for ``tensors`` (any device; written as their
    C-contiguous values)."""
    for k, t in tensors.items():
        if t.dtype not in _NAME:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(tensors, key=lambda k: (-_RANK[_NAME[tensors[k].dtype]],
                                           k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks = []
    offset = 0
    for k in order:
        t = tensors[k]
        raw = _raw(t)
        header[k] = {"dtype": _NAME[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    return b"".join([struct.pack("<Q", len(head)), head] + chunks)


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    with open(path, "wb") as f:
        f.write(save(tensors, metadata))


def _parse(buf) -> Dict[str, torch.Tensor]:
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    header = json.loads(bytes(buf[8:8 + n]))
    out: Dict[str, torch.Tensor] = {}
    for k, info in header.items():
        if k == "__metadata__":
            continue
        dt = _TORCH.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{k}: unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dt).element_size()
        count = (end - begin) // size
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{k}: {end - begin} bytes for shape {shape}")
        start = 8 + n + begin
        if count == 0:
            out[k] = torch.empty(shape, dtype=dt)
        elif start % size == 0:
            out[k] = torch.frombuffer(buf, dtype=dt, count=count,
                                      offset=start).reshape(shape)
        else:   # unaligned: a copy of its own
            out[k] = torch.frombuffer(bytearray(buf[start:8 + n + end]),
                                      dtype=dt).reshape(shape)
    return out


def load_file(path: str, device: DeviceLike = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device``. The file is read once into
    one host buffer, which the CPU tensors share."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(buf)
    out = _parse(buf)
    dev = torch.device(device)
    if dev.type != "cpu":
        out = {k: t.to(dev) for k, t in out.items()}
    return out


def load_numpy(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of ``path`` as a numpy array; bfloat16, which numpy
    lacks, is widened to float32 (exact)."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for k, t in load_file(path).items()}

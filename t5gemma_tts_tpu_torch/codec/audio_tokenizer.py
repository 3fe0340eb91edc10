"""User-facing audio tokenizer (decode direction), in PyTorch.

Counterpart of ``t5gemma_tts_tpu/codec/audio_tokenizer.py``:
``decode(frames [B, 1, T]) -> waveform [B, 1, T * hop]``, length-padded to
the same buckets as the JAX package and exact through the vocoder's length
masking. ``encode`` (voice cloning) comes with a later slice.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, tree_to
from . import model as model_mod
from .model import XCodec2Config

_BUCKETS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]


def _bucket(n: int) -> int:
    i = bisect.bisect_left(_BUCKETS, n)
    return _BUCKETS[min(i, len(_BUCKETS) - 1)] if n <= _BUCKETS[-1] else n


class AudioTokenizer:
    """XCodec2 decoder wrapper; ``params`` hold decoder parameters
    (``init_decoder_params`` or converted) as tensors."""

    def __init__(self, params, cfg: Optional[XCodec2Config] = None,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg or XCodec2Config()
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.sample_rate = self.cfg.sample_rate
        self.encode_sample_rate = self.cfg.encode_sample_rate
        self.channels = 1

    @torch.inference_mode()
    def decode(self, frames: np.ndarray,
               lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """frames [B, 1, T] or [B, T] int codes -> waveform [B, 1, S]."""
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[:, 0]
        t = frames.shape[1]
        if lengths is None:
            lengths = np.full((frames.shape[0],), t, np.int64)
        padded = np.pad(frames, ((0, 0), (0, _bucket(t) - t)))
        wav = model_mod.decode_code(
            self.params, self.cfg,
            torch.from_numpy(padded.astype(np.int64)).to(self.device),
            torch.from_numpy(np.asarray(lengths, np.int64)).to(self.device))
        return wav.float().cpu().numpy()[:, None, : t * self.cfg.hop_length]

    def encode(self, wav):
        raise NotImplementedError(
            "the codec encoder (voice cloning) is not ported yet "
            "(ROADMAP Queue 1 item 10)")

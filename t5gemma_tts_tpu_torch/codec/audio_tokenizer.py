"""User-facing audio tokenizer, wav <-> XCodec2 codes, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/codec/audio_tokenizer.py``:
``encode(wav) -> codes [B, T, 1]`` and ``decode(frames [B, 1, T]) ->
waveform [B, 1, T * hop]``, both length-padded to the same buckets as the
JAX package and exact through the encoder's and the vocoder's length
masking; ``tokenize_audio`` encodes a file.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, tree_to
from ..inference import audio_io
from . import model as model_mod
from .model import XCodec2Config

_BUCKETS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]


def _bucket(n: int) -> int:
    i = bisect.bisect_left(_BUCKETS, n)
    return _BUCKETS[min(i, len(_BUCKETS) - 1)] if n <= _BUCKETS[-1] else n


class AudioTokenizer:
    """XCodec2 wrapper; ``params`` hold decoder parameters
    (``init_decoder_params`` or converted) as tensors, and for ``encode``
    the encoder's as well (``init_encoder_params_for`` or converted)."""

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

    @torch.inference_mode()
    def encode(self, wav: np.ndarray) -> np.ndarray:
        """wav [S] or [B, S] float at ``encode_sample_rate`` -> codes
        [B, T, 1] int64, T = S // prod(acoustic ratios)."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if wav.ndim == 3:
            wav = wav.reshape(wav.shape[0], -1)
        s = wav.shape[1]
        padded = np.pad(wav, ((0, 0), (0, _bucket(s) - s)))
        lens = torch.full((wav.shape[0],), s, dtype=torch.int64,
                          device=self.device)
        codes = model_mod.encode_waveform(
            self.params, self.cfg, torch.from_numpy(padded).to(self.device),
            lens)
        t = min(s // int(np.prod(self.cfg.acoustic_cfg.ratios)),
                codes.shape[1])
        return codes[:, :t, None].cpu().numpy().astype(np.int64)


def tokenize_audio(tokenizer: AudioTokenizer, audio_path: str,
                   offset: int = -1, num_frames: int = -1) -> np.ndarray:
    """File -> codes [1, T, 1]: read, mixed to mono, resampled to the
    encode rate, then encoded (reference: data/tokenizer.py:125-143)."""
    wav = audio_io.load_for_encode(
        audio_path, tokenizer.encode_sample_rate,
        offset=offset if offset != -1 else 0,
        num_frames=num_frames if num_frames != -1 else None)
    return tokenizer.encode(wav)

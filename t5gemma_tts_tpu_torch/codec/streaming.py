"""Streaming vocoder decode: waveform chunks while tokens still arrive.

Counterpart of ``t5gemma_tts_tpu/codec/streaming.py``. The Vocos stack is
spatially local: the embed conv and the ConvNeXt blocks see (num_layers + 1)
* (kernel // 2) frames of context on each side, and each ISTFT sample
depends on frames within one n_fft window. So decoding a token window
[context | chunk | context] reproduces the whole utterance's waveform over
the chunk (up to the order of float sums), and audio for chunk N is ready
while the decode loop still generates chunk N + 1.

Each window goes through ``codec/model.py::decode_code`` padded to the
audio tokenizer's length buckets with its true length (the vocoder's length
masking keeps a padded decode exact), so every window size runs at one of a
few shapes.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from . import model as model_mod
from .audio_tokenizer import _bucket
from .model import XCodec2Config


def context_frames(cfg: XCodec2Config) -> int:
    """Frames of one-sided context past which the vocoder's output is
    final: the convolutions' reach plus the ISTFT window's."""
    v = cfg.vocos
    conv = (v.num_layers + 1) * (v.kernel_size // 2)
    istft = -(-v.n_fft // v.hop_length)
    return conv + istft


def _params_device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class StreamingVocoder:
    """Feed codec tokens incrementally; pull out waveform chunks.

        sv = StreamingVocoder(params, cfg, chunk=100)
        for tokens in token_chunks:
            wav_piece = sv.feed(tokens)     # may be empty early on
        tail = sv.flush()

    ``params`` are the codec's decoder parameters (on the device the
    vocoder runs on)."""

    def __init__(self, params, cfg: XCodec2Config, chunk: int = 100,
                 context: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.chunk = chunk
        self.context = context if context is not None else context_frames(cfg)
        self.device = _params_device(params)
        self._tokens = np.zeros((0,), np.int64)
        self._emitted_frames = 0          # frames whose audio is out

    @torch.inference_mode()
    def _window_decode(self, start: int, end: int) -> np.ndarray:
        """Audio for frames [start, end), decoded with up to ``context``
        frames on each side, padded to a length bucket."""
        hop = self.cfg.hop_length
        lo = max(0, start - self.context)
        hi = min(len(self._tokens), end + self.context)
        win = self._tokens[lo:hi]
        n = len(win)
        padded = np.pad(win, (0, _bucket(n) - n))
        wav = model_mod.decode_code(
            self.params, self.cfg,
            torch.from_numpy(padded[None]).to(self.device),
            torch.tensor([n], dtype=torch.int64, device=self.device))
        a = (start - lo) * hop
        return wav[0, a:a + (end - start) * hop].float().cpu().numpy()

    def feed(self, tokens) -> np.ndarray:
        """Append tokens; return the audio that became final."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        self._tokens = np.concatenate([self._tokens, tokens])
        out = []
        # a chunk is final once `context` frames exist past it
        while (len(self._tokens) - (self._emitted_frames + self.chunk)
               >= self.context):
            start = self._emitted_frames
            out.append(self._window_decode(start, start + self.chunk))
            self._emitted_frames += self.chunk
        if out:
            return np.concatenate(out)
        return np.zeros((0,), np.float32)

    def flush(self) -> np.ndarray:
        """Emit the rest of the utterance's audio."""
        start = self._emitted_frames
        end = len(self._tokens)
        self._emitted_frames = end
        if end <= start:
            return np.zeros((0,), np.float32)
        return self._window_decode(start, end)


def stream_decode(params, cfg: XCodec2Config, token_chunks: Iterable,
                  chunk: int = 100) -> Iterator[np.ndarray]:
    """Generator form: yields waveform pieces as token chunks come in."""
    sv = StreamingVocoder(params, cfg, chunk=chunk)
    for toks in token_chunks:
        piece = sv.feed(toks)
        if len(piece):
            yield piece
    tail = sv.flush()
    if len(tail):
        yield tail

"""Kaldi-style log-mel frontend of the semantic (w2v-BERT) branch, in
PyTorch.

Counterpart of ``t5gemma_tts_tpu/codec/features.py`` (the SeamlessM4T
feature extraction the XCodec2 encoder consumes): 16-bit scaling, per-frame
DC removal, 0.97 pre-emphasis, Povey window (400 samples, 10 ms hop),
512-point power spectrum, 80 Kaldi-mel triangular filters built in mel
space, natural log with a floor, per-utterance per-bin mean/variance
normalization (ddof = 1) and stride-2 frame stacking to 160-dim features at
50 Hz. The filter and window maths (numpy) are an own copy of the JAX
package's.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

FRAME_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
NUM_MEL = 80
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
STACK = 2


def _hz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


@lru_cache(maxsize=4)
def kaldi_mel_filters(sampling_rate: int = 16000) -> np.ndarray:
    """[257, 80] triangular filters, triangularized in mel space (Kaldi)."""
    num_bins = FFT_LENGTH // 2 + 1
    fft_freqs = np.linspace(0, sampling_rate / 2, num_bins)
    mel_min = _hz_to_mel_kaldi(20.0)
    mel_max = _hz_to_mel_kaldi(sampling_rate / 2)
    mel_points = np.linspace(mel_min, mel_max, NUM_MEL + 2)
    mel_freqs = _hz_to_mel_kaldi(fft_freqs)

    filters = np.zeros((num_bins, NUM_MEL), np.float64)
    for m in range(NUM_MEL):
        left, center, right = mel_points[m], mel_points[m + 1], mel_points[m + 2]
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        filters[:, m] = np.maximum(0.0, np.minimum(up, down))
    return filters.astype(np.float32)


@lru_cache(maxsize=1)
def povey_window() -> np.ndarray:
    n = np.arange(FRAME_LENGTH, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (FRAME_LENGTH - 1))
    return (hann ** 0.85).astype(np.float32)


def log_mel_frames(wav: torch.Tensor, sampling_rate: int = 16000
                   ) -> torch.Tensor:
    """wav [B, S] float in [-1, 1] at 16 kHz -> log-mel [B, T, 80],
    T = 1 + (S - 400) // 160 (no centering)."""
    wav = wav.float() * 32768.0               # Kaldi 16-bit compliance
    if wav.shape[1] < FRAME_LENGTH:           # no whole frame
        return wav.new_zeros((wav.shape[0], 0, NUM_MEL))
    frames = wav.unfold(1, FRAME_LENGTH, HOP_LENGTH)          # [B, T, 400]
    frames = frames - frames.mean(dim=-1, keepdim=True)       # DC offset
    # pre-emphasis: y[0] *= (1 - c); y[n] -= c * y[n-1]
    frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                        frames[..., 1:] - PREEMPHASIS * frames[..., :-1]],
                       dim=-1)
    dev = wav.device
    frames = frames * torch.from_numpy(povey_window()).to(dev)
    spec = torch.fft.rfft(frames, n=FFT_LENGTH, dim=-1)
    power = spec.abs() ** 2                                   # [B, T, 257]
    mel = power @ torch.from_numpy(kaldi_mel_filters(sampling_rate)).to(dev)
    return torch.log(mel.clamp_min(MEL_FLOOR))


def normalize_and_stack(feats: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin mean/variance over the valid frames (ddof = 1), padding
    zeroed, then ``STACK`` consecutive frames stacked: [B, T, 80] ->
    ([B, T // 2, 160], lengths // 2)."""
    b, t, c = feats.shape
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int64, device=feats.device)
    valid = (torch.arange(t, device=feats.device)[None, :]
             < lengths[:, None]).float()
    n = valid.sum(1).clamp_min(1.0)[:, None]
    vm = valid[..., None]
    mean = (feats * vm).sum(1) / n
    var = ((feats - mean[:, None]) ** 2 * vm).sum(1) / (n - 1.0).clamp_min(1.0)
    feats = (feats - mean[:, None]) / torch.sqrt(var[:, None] + 1e-7)
    feats = feats * vm

    t2 = t - (t % STACK)
    stacked = feats[:, :t2].reshape(b, t2 // STACK, c * STACK)
    return stacked, torch.div(lengths, STACK, rounding_mode="floor")


def extract_features(wav: torch.Tensor,
                     wav_lens: Optional[torch.Tensor] = None,
                     sampling_rate: int = 16000
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav [B, S] -> (input features [B, T50, 160], feature lengths [B])."""
    feats = log_mel_frames(wav, sampling_rate)
    lengths = None
    if wav_lens is not None:
        lengths = (torch.div(wav_lens.long() - FRAME_LENGTH, HOP_LENGTH,
                             rounding_mode="floor") + 1).clamp_min(0)
    return normalize_and_stack(feats, lengths)

"""Whisper log-mel frontend, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/asr/mel.py``, with the numerics of
transformers' ``WhisperFeatureExtractor``: pad or cut to 30 s at 16 kHz,
center reflect padding, a periodic Hann window, the 400-point power
spectrum (``torch.fft.rfft``; the JAX package's DFT written as matmuls is a
TPU workaround and is not copied), the Slaney mel filter bank (written here
in numpy: the card's machine has no ``transformers``), log10 with the
max - 8 floor and the (x + 4) / 4 normalization.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS           # 480000
N_FRAMES = N_SAMPLES // HOP                       # 3000

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = 27.0 / np.log(6.4)


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log = freq >= _MIN_LOG_HZ
    return np.where(log, _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10)
                                               / _MIN_LOG_HZ) * _LOGSTEP,
                    mels)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    log = mels >= _MIN_LOG_MEL
    return np.where(log, _MIN_LOG_HZ * np.exp((mels - _MIN_LOG_MEL)
                                              / _LOGSTEP), freq)


@lru_cache(maxsize=4)
def mel_filters(n_mels: int) -> np.ndarray:
    """[201, n_mels] Slaney-normalized triangular filters over 0-8 kHz on
    the Slaney mel scale (transformers' ``mel_filter_bank(..., norm=
    "slaney", mel_scale="slaney")``)."""
    filter_freqs = _mel_to_hz(np.linspace(_hz_to_mel(0.0),
                                          _hz_to_mel(8000.0), n_mels + 2))
    fft_freqs = np.linspace(0, SAMPLE_RATE // 2, 1 + N_FFT // 2)
    diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    filters = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:n_mels + 2] - filter_freqs[:n_mels])
    return (filters * enorm[None, :]).astype(np.float32)


def log_mel(wav, n_mels: int = 80) -> torch.Tensor:
    """wav [T] f32 at 16 kHz (a tensor, on its device, or an array: the
    CPU) -> [n_mels, 3000] normalized log-mel features."""
    wav = torch.as_tensor(wav, dtype=torch.float32).reshape(-1)[:N_SAMPLES]
    wav = torch.nn.functional.pad(wav, (0, N_SAMPLES - wav.shape[0]))
    x = torch.nn.functional.pad(wav[None, None], (N_FFT // 2, N_FFT // 2),
                                mode="reflect")[0, 0]
    # frames [3000, 400]: the last of the 3001 centred frames is dropped
    frames = x.unfold(0, N_FFT, HOP)[:N_FRAMES]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                               device=wav.device)
    spec = torch.view_as_real(torch.fft.rfft(frames * window, dim=-1))
    power = spec.square().sum(-1)                           # re² + im²
    filters = torch.from_numpy(mel_filters(n_mels)).to(wav.device)
    mel = power @ filters                                   # [3000, n_mels]
    log_spec = torch.log10(mel.clamp_min(1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).T

"""Self-contained audio file I/O and resampling (no torchaudio/soundfile).

An own copy of ``t5gemma_tts_tpu/inference/audio_io.py`` (the port imports
nothing of the JAX package).

The reference leans on torchaudio/soundfile/ffmpeg for wav handling
(reference: data/tokenizer.py:125-143 ``tokenize_audio``, models/*.py
``load_audio_segment`` header). This framework ships a dependency-free path:

- WAV read/write via the stdlib ``wave`` module + numpy (PCM16/24/32 and
  float32), mono-mixdown, frame offset/limit;
- windowed-sinc polyphase resampling (numpy host-side; it feeds device
  encode batches, so it is not on the device hot path);
- optional soundfile/librosa hooks if those packages exist (they are not
  required).
"""

from __future__ import annotations

import math
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, offset: int = 0,
             num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 waveform [S], sample_rate)."""
    try:
        import soundfile as sf  # optional fast path

        data, sr = sf.read(path, dtype="float32")
        if data.ndim == 2:
            data = data.mean(axis=1)
        end = None if num_frames in (None, -1) else offset + num_frames
        return data[offset:end].astype(np.float32), sr
    except ImportError:
        pass

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        w.setpos(min(offset, total))
        n = total - offset if num_frames in (None, -1) else min(
            num_frames, total - offset
        )
        raw = w.readframes(max(n, 0))

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")

    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write mono float waveform as 16-bit PCM."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(wav: np.ndarray, orig_sr: int, target_sr: int,
             num_zeros: int = 32) -> np.ndarray:
    """Windowed-sinc polyphase resampling, mono [S] -> [S * target/orig]."""
    if orig_sr == target_sr:
        return np.asarray(wav, np.float32)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g

    # anti-aliasing lowpass at min(orig, target)/2, windowed sinc
    cutoff = 0.5 / max(up, down) * 0.95
    half = num_zeros * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * n)
    window = np.hanning(len(n))
    kernel = (sinc * window * up).astype(np.float32)

    x = np.zeros(len(wav) * up, np.float32)
    x[::up] = np.asarray(wav, np.float32)
    y = np.convolve(x, kernel, mode="same")
    return y[::down].astype(np.float32)


def load_for_encode(path: str, target_sr: int, offset: int = 0,
                    num_frames: Optional[int] = None) -> np.ndarray:
    """Read + mono + resample to the codec's encode rate
    (reference: data/tokenizer.py:125-143)."""
    wav, sr = read_wav(path, offset=offset, num_frames=num_frames)
    return resample(wav, sr, target_sr)

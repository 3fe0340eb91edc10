"""Pitch-preserving time-stretch (WSOLA) + audio loading for augmentation.

The reference implements its ``target_time_stretch_prob`` augmentation by
piping the source audio through ffmpeg's ``atempo`` filter and re-encoding
the stretched waveform with the codec (reference:
data/combined_dataset.py:203-254). ``atempo`` is a WSOLA-family
time-stretcher; this module provides an in-process numpy WSOLA so the
augmentation works without an ffmpeg binary (it is host-side dataloader
work, not TPU work). When an ``ffmpeg`` binary IS present it is also used
to decode non-wav formats (.flac/.mp3/.ogg), exactly the formats the
reference probes (combined_dataset.py:206-211).

``time_stretch(wav, rate)``: rate > 1 speeds playback up (shorter output),
rate < 1 slows it down — the same convention as ``atempo=rate``. Pitch is
preserved (unlike a resample), which is the property that makes the
augmentation useful: the codec sees natural-pitch speech at a new pace.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np


def time_stretch(
    wav: np.ndarray,
    rate: float,
    sample_rate: int = 16000,
    frame_ms: float = 50.0,
    search_ms: float = 10.0,
) -> np.ndarray:
    """WSOLA time-stretch of a mono waveform. Output length ~= len(wav)/rate.

    Synthesis frames are Hann-windowed, 50%-overlap-added at a fixed hop;
    analysis frames advance at ``rate * hop`` and each is nudged within
    +-``search_ms`` to maximize cross-correlation with the natural
    continuation of the previously copied frame (the WSOLA criterion), so
    overlapping halves stay phase-coherent and pitch is untouched.
    """
    wav = np.asarray(wav, np.float32).reshape(-1)
    if abs(rate - 1.0) < 1e-6 or len(wav) == 0:
        return wav.copy()
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")

    n = int(sample_rate * frame_ms / 1000.0)
    n = max(2 * (n // 2), 64)              # even, sane minimum
    hop = n // 2                           # synthesis hop (50% overlap)
    delta = max(int(sample_rate * search_ms / 1000.0), 1)
    if len(wav) <= n + 1:
        # too short for framing: nearest-sample resample of the envelope
        idx = np.clip((np.arange(int(len(wav) / rate)) * rate).astype(np.int64),
                      0, len(wav) - 1)
        return wav[idx]

    window = np.hanning(n).astype(np.float32)
    analysis_hop = rate * hop
    out_frames = max(int((len(wav) - n - delta) / analysis_hop), 1)
    out = np.zeros(out_frames * hop + n, np.float32)
    norm = np.zeros_like(out)

    # frame 0: copied verbatim from the start
    out[:n] += wav[:n] * window
    norm[:n] += window
    src = 0                                # source start of the last frame

    for k in range(1, out_frames):
        p = int(round(k * analysis_hop))
        # natural continuation of the previous frame: its second half
        tpl_start = src + hop
        tpl = wav[tpl_start: tpl_start + hop]
        lo = max(p - delta, 0)
        hi = min(p + delta, len(wav) - n - 1)
        if hi <= lo or len(tpl) < hop:
            best = min(max(p, 0), len(wav) - n - 1)
        else:
            cands = np.lib.stride_tricks.sliding_window_view(
                wav[lo: hi + hop], hop
            )[: hi - lo + 1]
            # normalized cross-correlation (scale-invariant match)
            scores = cands @ tpl
            denom = np.sqrt(np.einsum("ij,ij->i", cands, cands) + 1e-12)
            best = lo + int(np.argmax(scores / denom))
        frame = wav[best: best + n]
        o = k * hop
        out[o: o + n] += frame * window
        norm[o: o + n] += window
        src = best

    out = out / np.maximum(norm, 1e-6)
    return out[: out_frames * hop + hop].astype(np.float32)


AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg")


def find_audio_file(audio_dir: str, utt_id: str) -> Optional[str]:
    """Probe the extensions the reference does (combined_dataset.py:206-211)."""
    for ext in AUDIO_EXTS:
        cand = os.path.join(audio_dir, utt_id + ext)
        if os.path.isfile(cand):
            return cand
    return None


def load_audio_mono(path: str, target_sr: int,
                    max_seconds: Optional[float] = None) -> np.ndarray:
    """Mono float32 at ``target_sr``; wav via stdlib, other formats via an
    ffmpeg binary when present (decode-only; no filters)."""
    from ..inference import audio_io

    if path.endswith(".wav"):
        wav, sr = audio_io.read_wav(path)
        if max_seconds is not None:
            wav = wav[: int(max_seconds * sr)]
        return audio_io.resample(wav, sr, target_sr)

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"non-wav audio {path} needs an ffmpeg binary")
    cmd = [ffmpeg, "-v", "error", "-i", path]
    if max_seconds is not None:
        cmd += ["-t", f"{max_seconds:.3f}"]
    cmd += ["-f", "f32le", "-ac", "1", "-ar", str(target_sr), "pipe:1"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(raw, np.float32).copy()

"""Validation-time generation diagnostics.

Counterpart of ``t5gemma_tts_tpu/train/diagnostics.py``: on the inference
cadence, synthesize one sample with the current parameters through the
port's ``TTSPipeline`` (graphed decode on the card), decode it with the
codec when one is attached, log frame count / RMS / max-abs and write a wav
into the experiment directory.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional

import numpy as np

from ..config import DecodeConfig, VoiceConfig
from ..device import DeviceLike

log = logging.getLogger(__name__)


def make_generation_hook(
    cfg: VoiceConfig,
    text_tokenizer: Callable[[str], List[int]],
    sample_text: str,
    exp_dir: str,
    audio_tokenizer=None,
    dcfg: Optional[DecodeConfig] = None,
    tb_writer=None,
    target_duration: float = 4.0,
    device: DeviceLike = "cuda",
):
    """Returns hook(params, step) for ``Trainer(generation_hook=...)``;
    ``params`` is a plain parameter tree (the trainer merges LoRA adapters
    first)."""
    from ..inference.pipeline import Request, TTSPipeline

    dcfg = dcfg or DecodeConfig(max_frames=512)
    out_dir = os.path.join(exp_dir, "val_generations")
    os.makedirs(out_dir, exist_ok=True)

    def hook(params, step: int) -> None:
        pipe = TTSPipeline(params, cfg, text_tokenizer, audio_tokenizer,
                           device=device)
        res = pipe.synthesize(
            Request(target_text=sample_text, target_duration=target_duration),
            dcfg, quiet=True, decode_audio=audio_tokenizer is not None)
        n = len(res.gen_frames)
        if res.wav is not None:
            rms = float(np.sqrt((res.wav ** 2).mean())) if len(res.wav) else 0.0
            max_abs = float(np.abs(res.wav).max()) if len(res.wav) else 0.0
            from ..inference.audio_io import write_wav

            path = os.path.join(out_dir, f"step{step}.wav")
            write_wav(path, res.wav, audio_tokenizer.sample_rate)
            log.info("val generation @ %d: %d frames, rms %.4f, max_abs %.4f "
                     "-> %s", step, n, rms, max_abs, path)
            if tb_writer is not None:
                tb_writer.add_scalar("val_gen/frames", n, step)
                tb_writer.add_scalar("val_gen/rms", rms, step)
                tb_writer.add_scalar("val_gen/max_abs", max_abs, step)
        else:
            log.info("val generation @ %d: %d frames (no codec attached)",
                     step, n)

    return hook

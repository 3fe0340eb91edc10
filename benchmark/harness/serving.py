"""What the serving drivers share: the program built from the benchmark's
inputs, the vocoder timed from outside, and the program freed before the
reference runs."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from . import model_config, weights
from .trace import Tracer


def with_control(p: Dict, control: bool) -> Dict:
    out = dict(p)
    if control:
        out.update(p.get("control", {}))
    return out


def _synced_clock(device: str) -> float:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return time.perf_counter()


def build_pipeline(cell, seed: int, device: str, precision: str,
                   phases: Dict[str, float]):
    """The program: its weights (drawn by the benchmark from the seed, on
    the device) handed to ``TTSPipeline`` with the vocoder. ``phases``
    gets the seconds of the draw and of the pipeline's build (fusion,
    quantization)."""
    from t5gemma_tts_tpu_torch.codec.audio_tokenizer import AudioTokenizer
    from t5gemma_tts_tpu_torch.inference.pipeline import TTSPipeline

    cfg = model_config.voice_config(cell.config)
    t0 = _synced_clock(device)
    codec = weights.codec_params(cell.config, seed, device)
    voice = weights.voice_params(cell.config, seed, device)
    t1 = _synced_clock(device)
    tok = AudioTokenizer(codec, model_config.codec_config(cell.config),
                         device=device)
    pipe = TTSPipeline(voice, cfg,
                       model_config.char_tokenizer(cfg.text_vocab_size), tok,
                       device=device, int8=precision == "int8",
                       int4=precision == "int4")
    del codec, voice
    phases.update(draw_s=t1 - t0, build_s=_synced_clock(device) - t1)
    return pipe, tok


class TimedVocoder:
    """Wraps the tokenizer's ``decode`` (it returns host arrays, so its
    wall is synchronized): seconds spent in it, and host spans."""

    def __init__(self, tok, tracer: Tracer):
        self.walls: List[tuple] = []
        self._decode = tok.decode
        self._tracer = tracer
        tok.decode = self

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self._tracer.span("vocoder", self._decode, *a, **k)
        finally:
            self.walls.append((t0, time.perf_counter()))

    def seconds_within(self, lo: float, hi: float) -> float:
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.walls)


def free_program(*objs) -> None:
    import torch
    from t5gemma_tts_tpu_torch.decode import engine

    for o in objs:
        close = getattr(o, "close", None)
        if close is not None:
            close()
    engine.release_sessions()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

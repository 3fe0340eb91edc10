"""Gradio web UI for interactive TTS, on the port.

Counterpart of ``t5gemma_tts_tpu/inference/gradio_app.py`` (reference:
inference_gradio.py:283-375): reference-audio upload, reference text (the
port's Whisper transcribes it when empty), target text, target duration
(estimated when 0), seed (random when blank) and the top_k / top_p /
min_p / temperature sliders. The pipeline and Whisper load once. ``gradio``
is imported only by :func:`build_demo`, so the callback runs and is tested
without it.

Run: python -m t5gemma_tts_tpu_torch.inference.gradio_app --model_dir DIR
     [--device cpu] ...
"""

from __future__ import annotations

import argparse
import logging
import random
from functools import lru_cache
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


@lru_cache(maxsize=1)
def _load_resources(model_dir: str, codec_dir: Optional[str],
                    random_codec: bool, quantize: str = "none",
                    device: str = "cuda"):
    from argparse import Namespace

    from ..device import resolve_device
    from .cli import _load_codec, _text_tokenizer
    from .loading import load_voice_model
    from .pipeline import TTSPipeline

    dev = resolve_device(device)
    params, cfg, hf_cfg = load_voice_model(model_dir, dev)
    codec_args = Namespace(codec_dir=codec_dir, random_codec=random_codec,
                           xcodec2_model_name=None)
    audio_tok = _load_codec(codec_args, hf_cfg, dev)
    return TTSPipeline(params, cfg, _text_tokenizer(hf_cfg), audio_tok,
                       device=dev, int8=quantize == "int8",
                       int4=quantize == "int4")


@lru_cache(maxsize=1)
def _load_whisper(device: str = "cuda"):
    from .transcribe import load_transcriber

    transcriber = load_transcriber(device=device)

    class _Compat:  # .transcribe(path)["text"], as the callback reads it
        def transcribe(self, path):
            return {"text": transcriber(path)}

    return _Compat()


def make_infer_fn(model_dir: str, codec_dir: Optional[str] = None,
                  random_codec: bool = False, *, quantize: str = "none",
                  device: str = "cuda", error_cls=RuntimeError,
                  whisper_loader=None):
    """The synthesis callback behind the UI's button, gradio-free so that
    tests drive it (errors raise ``error_cls``; :func:`build_demo` passes
    ``gr.Error``). ``whisper_loader()`` returns an object whose
    ``.transcribe(path)["text"]`` is the transcript (default: the port's
    Whisper on ``device``)."""
    from ..config import DecodeConfig
    from .pipeline import Request

    whisper_loader = whisper_loader or (lambda: _load_whisper(device))

    def infer(reference_audio, reference_text, target_text, target_duration,
              seed, top_k, top_p, min_p, temperature):
        pipe = _load_resources(model_dir, codec_dir, random_codec,
                               quantize, device)
        if not target_text:
            raise error_cls("target text is required")
        if seed in (None, "", 0):
            seed = random.randint(1, 2 ** 31 - 1)   # reference :70-85
        prefix = reference_text or None
        if reference_audio and not prefix:
            try:
                prefix = whisper_loader().transcribe(reference_audio)["text"]
            except Exception as exc:   # shown to the user as the UI error
                raise error_cls(
                    f"whisper transcription failed: {exc}") from exc
        dcfg = DecodeConfig(
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            temperature=float(temperature), seed=int(seed))
        res = pipe.synthesize(
            Request(target_text=target_text,
                    audio_path=reference_audio or None,
                    prompt_transcript=prefix,
                    target_duration=(float(target_duration)
                                     if target_duration else None)),
            dcfg, seed=int(seed))
        sr = pipe.audio_tokenizer.sample_rate
        info = (f"seed={seed} | {res.tokens_per_sec:.1f} tok/s | "
                f"RTF {res.rtf:.2f}x")
        return (sr, np.asarray(res.wav, np.float32)), info

    return infer


def build_demo(model_dir: str, codec_dir: Optional[str] = None,
               random_codec: bool = False, quantize: str = "none",
               device: str = "cuda"):
    import gradio as gr

    infer = make_infer_fn(model_dir, codec_dir, random_codec,
                          quantize=quantize, device=device,
                          error_cls=gr.Error)

    with gr.Blocks(title="T5Gemma-TTS (CUDA)") as demo:
        gr.Markdown("## T5Gemma-TTS: synthesis on the GPU")
        with gr.Row():
            with gr.Column():
                ref_audio = gr.Audio(label="Reference audio (voice cloning)",
                                     type="filepath")
                ref_text = gr.Textbox(label="Reference transcript "
                                            "(blank = Whisper)")
                tgt_text = gr.Textbox(label="Target text", lines=3)
                duration = gr.Number(label="Target duration (s, 0 = auto)",
                                     value=0)
                seed = gr.Number(label="Seed (blank = random)", value=1)
                with gr.Row():
                    top_k = gr.Slider(0, 100, value=30, step=1, label="top_k")
                    top_p = gr.Slider(0.0, 1.0, value=0.9, label="top_p")
                with gr.Row():
                    min_p = gr.Slider(0.0, 0.5, value=0.0, label="min_p")
                    temperature = gr.Slider(0.1, 2.0, value=0.8,
                                            label="temperature")
                btn = gr.Button("Synthesize", variant="primary")
            with gr.Column():
                audio_out = gr.Audio(label="Generated audio")
                stats = gr.Textbox(label="Stats")
        btn.click(
            infer,
            [ref_audio, ref_text, tgt_text, duration, seed, top_k, top_p,
             min_p, temperature],
            [audio_out, stats],
        )
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="T5Gemma-TTS (PyTorch/CUDA port) Gradio UI")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--codec_dir", default=None)
    ap.add_argument("--random_codec", action="store_true")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4"],
                    help="decode-weight quantization (int4: batch-1 latency)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    demo = build_demo(args.model_dir, args.codec_dir, args.random_codec,
                      args.quantize, args.device)
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()

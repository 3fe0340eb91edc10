"""TTS inference CLI of the PyTorch port (flag-compatible with the JAX
package's ``inference/cli.py``).

Run: python -m t5gemma_tts_tpu_torch.inference.cli --model_dir <hf dir> \
        --target_text "..." [--device cuda|cpu] ...

Runs on ``cuda`` unless ``--device cpu`` is given. ``--quantize int8``
serves with W8A8 decode weights (the decode-layer and W8A8 kernels);
``--quantize int4`` is the batch-1 latency mode (int4 decode-layer and head
weights: the decode-layer kernels' int4 variant and the W4A8 kernel).
``--kv_cache paged_f8`` stores float8 e4m3 pages (the paged attention
kernel's e4m3 variant). Not ported yet, and so refused with the ROADMAP
entry that will bring them: ``--reference_speech`` (the codec encoder) and
real XCodec2 weights (the codec converter; ``--random_codec`` works).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="T5Gemma-TTS (PyTorch/CUDA port) inference",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--reference_speech", default=None)
    p.add_argument("--target_text",
                   default="こんにちは、私はAIです。これは音声合成のテストです。")
    p.add_argument("--model_dir", default="./t5gemma_voice_hf")
    p.add_argument("--reference_text", default=None)
    p.add_argument("--target_duration", type=float, default=None)
    p.add_argument("--top_k", type=int, default=30)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--min_p", type=float, default=0.0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--silence_tokens", default=None)
    p.add_argument("--repeat_prompt", default="0")
    p.add_argument("--stop_repetition", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--output_dir", default="./generated_tts")
    p.add_argument("--cut_off_sec", type=float, default=100)
    p.add_argument("--dump_tokens", action="store_true")
    p.add_argument("--lang", default=None)
    p.add_argument("--xcodec2_model_name", default=None)
    p.add_argument("--codec_dir", default=None,
                   help="local dir with XCodec2 model.safetensors")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int4"],
                   help="decode-weight quantization (int4: batch-1 latency)")
    p.add_argument("--kv_cache", default="auto",
                   choices=["auto", "dense", "paged", "paged_f8", "paged_i8"],
                   help="decode KV-cache strategy (see DecodeConfig.kv_cache)")
    p.add_argument("--approx_top_k", action="store_true",
                   help="accepted for compatibility; exact top-k is used")
    p.add_argument("--random_codec", action="store_true",
                   help="random-init codec weights (smoke testing only)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p


def _check_ported(args) -> None:
    if args.reference_speech and str(args.reference_speech).lower() not in {
            "none", "null"}:
        raise NotImplementedError(
            "--reference_speech needs the codec encoder, which is not ported "
            "yet (ROADMAP Queue 1 item 10)")
    if not args.random_codec:
        raise NotImplementedError(
            "loading XCodec2 weights needs the codec converter, which is not "
            "ported yet (ROADMAP Queue 1 item 15); pass --random_codec")


def _text_tokenizer(hf_cfg):
    from transformers import AutoTokenizer

    name = (hf_cfg or {}).get("text_tokenizer_name") or (hf_cfg or {}).get(
        "t5gemma_model_name") or "google/t5gemma-2b-2b-ul2"
    tok = AutoTokenizer.from_pretrained(name)
    return lambda text: tok.encode(text.strip(), add_special_tokens=False)


def run_inference(args: argparse.Namespace) -> str:
    from ..codec.audio_tokenizer import AudioTokenizer
    from ..codec.model import XCodec2Config, init_decoder_params
    from ..config import DecodeConfig
    from ..device import resolve_device
    from .audio_io import write_wav
    from .loading import load_voice_model
    from .pipeline import Request, TTSPipeline
    from .textnorm import normalize_text_with_lang

    device = resolve_device(args.device)
    _check_ported(args)
    if args.reference_text and str(args.reference_text).strip().lower() not in {
            "", "none", "null"}:
        raise ValueError("reference_text provided without reference_speech")

    params, cfg, hf_cfg = load_voice_model(args.model_dir, device)
    ccfg = XCodec2Config()
    audio_tok = AudioTokenizer(init_decoder_params(0, ccfg, device), ccfg,
                               device)
    pipe = TTSPipeline(params, cfg, _text_tokenizer(hf_cfg), audio_tok,
                       device=device, int8=args.quantize == "int8",
                       int4=args.quantize == "int4")

    lang = None if args.lang in {None, "", "none", "null"} else str(args.lang)
    target_text, lang_code = normalize_text_with_lang(args.target_text, lang)
    silence = tuple(json.loads(str(args.silence_tokens))) \
        if args.silence_tokens else ()
    dcfg = DecodeConfig(
        top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        temperature=args.temperature, stop_repetition=args.stop_repetition,
        silence_tokens=silence, seed=args.seed, kv_cache=args.kv_cache,
        approx_top_k=args.approx_top_k)
    res = pipe.synthesize(
        Request(target_text=target_text, lang=lang_code,
                target_duration=args.target_duration),
        dcfg, seed=args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "generated.wav")
    write_wav(out, res.wav, audio_tok.sample_rate)
    max_abs = float(np.abs(res.wav).max())
    rms = float(np.sqrt((res.wav ** 2).mean()))
    print(f"[Info] Generated audio stats -> max_abs: {max_abs:.6f}, "
          f"rms: {rms:.6f}")
    if args.dump_tokens:
        np.save(os.path.join(args.output_dir, "generated_frames.npy"),
                res.gen_frames)
        np.save(os.path.join(args.output_dir, "concat_frames.npy"),
                res.concat_frames)
        print(f"[Info] Saved token arrays to {args.output_dir}")
    print(f"[Success] Generated audio saved to {out}")
    return out


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    run_inference(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

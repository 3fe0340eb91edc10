"""TTS inference CLI of the PyTorch port (flag-compatible with the JAX
package's ``inference/cli.py``).

Run: python -m t5gemma_tts_tpu_torch.inference.cli --model_dir <hf dir> \
        --target_text "..." [--device cuda|cpu] ...

Runs on ``cuda`` unless ``--device cpu`` is given. ``--quantize int8``
serves with W8A8 decode weights (the decode-layer and W8A8 kernels);
``--quantize int4`` is the batch-1 latency mode (int4 decode-layer and head
weights: the decode-layer kernels' int4 variant and the W4A8 kernel).
``--kv_cache paged_f8`` stores float8 e4m3 pages (the paged attention
kernel's e4m3 variant). The XCodec2 weights come from ``--codec_dir``
(a ``model.safetensors``, converted by ``codec/convert.py``; without the
flag the Hugging Face hub is asked for it), or are random with
``--random_codec`` (decoder only). ``--reference_speech`` with
``--reference_text`` clones the reference's voice (the codec encoder);
a reference without its transcript needs Whisper, which is not ported yet
(ROADMAP Queue 1 item 13), and is refused.
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
                   help="random-init codec decoder weights (smoke testing "
                        "only; no encoder, so no --reference_speech)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p


def _given(value) -> bool:
    return value is not None and str(value).strip().lower() not in {
        "", "none", "null"}


def _load_codec(args, hf_cfg, device):
    """The XCodec2 tokenizer: random decoder weights with
    ``--random_codec``, else ``model.safetensors`` from ``--codec_dir`` (or
    the hub) through the port's converter."""
    from ..codec.audio_tokenizer import AudioTokenizer
    from ..codec.model import XCodec2Config, init_decoder_params

    ccfg = XCodec2Config()
    if args.random_codec:
        return AudioTokenizer(init_decoder_params(0, ccfg, device), ccfg,
                              device)
    codec_dir = args.codec_dir
    if codec_dir is None:
        model_id = args.xcodec2_model_name or (hf_cfg or {}).get(
            "xcodec2_model_name") or "NandemoGHS/Anime-XCodec2-44.1kHz-v2"
        try:
            from huggingface_hub import hf_hub_download

            path = hf_hub_download(repo_id=model_id,
                                   filename="model.safetensors")
        except Exception as exc:
            raise RuntimeError(
                f"cannot download codec weights for {model_id}: {exc}. "
                "Pass --codec_dir with a local model.safetensors.") from exc
        codec_dir = os.path.dirname(path)
    from safetensors import safe_open

    from ..codec.convert import xcodec2_state_dict_to_params

    with safe_open(os.path.join(codec_dir, "model.safetensors"),
                   framework="np") as f:
        sd = {k: f.get_tensor(k) for k in f.keys()}
    return AudioTokenizer(
        xcodec2_state_dict_to_params(sd, ccfg, device=device), ccfg, device)


def _file_rate(path: str) -> int:
    from .audio_io import read_wav

    try:
        import wave

        with wave.open(path, "rb") as w:
            return w.getframerate()
    except (wave.Error, EOFError):
        return read_wav(path)[1]


def _text_tokenizer(hf_cfg):
    from transformers import AutoTokenizer

    name = (hf_cfg or {}).get("text_tokenizer_name") or (hf_cfg or {}).get(
        "t5gemma_model_name") or "google/t5gemma-2b-2b-ul2"
    tok = AutoTokenizer.from_pretrained(name)
    return lambda text: tok.encode(text.strip(), add_special_tokens=False)


def run_inference(args: argparse.Namespace) -> str:
    from ..config import DecodeConfig
    from ..device import resolve_device
    from .audio_io import write_wav
    from .loading import load_voice_model
    from .pipeline import Request, TTSPipeline
    from .textnorm import normalize_text_with_lang

    device = resolve_device(args.device)
    reference = args.reference_speech if _given(args.reference_speech) \
        else None
    has_ref_text = _given(args.reference_text)
    if reference is None and has_ref_text:
        raise ValueError("reference_text provided without reference_speech")
    if reference is not None and not has_ref_text:
        raise NotImplementedError(
            "--reference_speech without --reference_text needs Whisper "
            "auto-transcription, which is not ported yet (ROADMAP Queue 1 "
            "item 13); pass --reference_text")
    if reference is not None and args.random_codec:
        raise ValueError(
            "--random_codec gives random codec decoder weights and no "
            "encoder, so it cannot encode --reference_speech; pass "
            "--codec_dir")

    params, cfg, hf_cfg = load_voice_model(args.model_dir, device)
    audio_tok = _load_codec(args, hf_cfg, device)
    pipe = TTSPipeline(params, cfg, _text_tokenizer(hf_cfg), audio_tok,
                       device=device, int8=args.quantize == "int8",
                       int4=args.quantize == "int4")

    lang = None if args.lang in {None, "", "none", "null"} else str(args.lang)
    target_text, lang_code = normalize_text_with_lang(args.target_text, lang)
    silence = tuple(json.loads(str(args.silence_tokens))) \
        if args.silence_tokens else ()
    repeat = args.repeat_prompt
    if isinstance(repeat, str) and repeat.lower() != "max":
        repeat = int(repeat)
    # the reference read stops at cut_off_sec, at the file's sample rate
    # (reference inference_commandline_hf.py:173-182)
    prompt_end_frame = -1 if reference is None else int(
        args.cut_off_sec * _file_rate(reference))
    dcfg = DecodeConfig(
        top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        temperature=args.temperature, stop_repetition=args.stop_repetition,
        silence_tokens=silence, seed=args.seed, kv_cache=args.kv_cache,
        approx_top_k=args.approx_top_k)
    res = pipe.synthesize(
        Request(target_text=target_text, lang=lang_code,
                audio_path=reference,
                prompt_transcript=args.reference_text if reference else None,
                target_duration=args.target_duration, repeat_prompt=repeat,
                prompt_end_frame=prompt_end_frame),
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

"""Reference-audio transcription (voice cloning without a transcript), on
the port's own Whisper (``asr/``).

Counterpart of ``t5gemma_tts_tpu/inference/transcribe.py``: the whisper
package's robustness rules (a temperature-fallback ladder 0 -> 1.0 gated
on the compression ratio and the average log-probability, and the
``<|nospeech|>`` probability at the first decoder step, which turns a
silent clip into an empty transcript) around :func:`transcriber`, the
counterpart of ``jax_transcriber``. The mel frontend, the encoder and the
decode run on the params' device; the tokenizer only maps ids to text.

:func:`load_transcriber` reads a local directory only: the model name as a
path, or the name's snapshot in the local Hugging Face cache. It has no
route through the ``whisper`` package or a transformers model, which would
bypass the port's own model.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike

log = logging.getLogger(__name__)

Transcriber = Callable[[str], str]

WHISPER_SR = 16000
DEFAULT_MODEL = "openai/whisper-large-v3-turbo"

# whisper-package transcribe() defaults the reference inherits
# (reference inference_commandline.py:160-182 calls whisper.transcribe,
# which retries at rising temperatures when the output is degenerate)
FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6
LANGUAGES = ("en", "zh", "ja", "de", "es", "ru", "ko", "fr", "pt", "tr",
             "pl", "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi")


def compression_ratio(text: str) -> float:
    """zlib length ratio: high values flag looping output (the whisper
    package's repetition gate)."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(text: str, avg_logprob: float,
                   compression_ratio_threshold: float =
                   COMPRESSION_RATIO_THRESHOLD,
                   logprob_threshold: float = LOGPROB_THRESHOLD) -> bool:
    """Retry at a higher temperature when the transcript is too repetitive
    (compression ratio) or too unconfident (average log-probability)."""
    if compression_ratio(text) > compression_ratio_threshold:
        return True
    return avg_logprob < logprob_threshold


def decode_with_fallback(decode_fn: Callable[[float], tuple],
                         temperatures=FALLBACK_TEMPERATURES,
                         compression_ratio_threshold: float =
                         COMPRESSION_RATIO_THRESHOLD,
                         logprob_threshold: float = LOGPROB_THRESHOLD,
                         ) -> tuple:
    """Walk ``decode_fn(temperature) -> (text, avg_logprob)`` up the rungs
    until the quality gate passes; the last rung's output is returned as it
    is (whisper: temperature 1.0 is accepted). Returns the accepted rung's
    ``(text, avg_logprob)``."""
    text, avg_logprob = "", 0.0
    for i, temp in enumerate(temperatures):
        text, avg_logprob = decode_fn(temp)
        if not needs_fallback(text, avg_logprob,
                              compression_ratio_threshold,
                              logprob_threshold):
            return text, avg_logprob
        if i + 1 < len(temperatures):
            log.info("transcription gate failed at T=%.1f "
                     "(avg_logprob=%.2f, compression_ratio=%.2f); retrying",
                     temp, avg_logprob, compression_ratio(text))
    return text, avg_logprob


def is_no_speech(no_speech_prob: float, avg_logprob: float,
                 no_speech_threshold: float = NO_SPEECH_THRESHOLD,
                 logprob_threshold: float = LOGPROB_THRESHOLD) -> bool:
    """whisper's silence gate: silent when the ``<|nospeech|>``
    probability at the first decoder step exceeds the threshold, unless the
    decode is confident (``avg_logprob`` at or above the logprob
    threshold)."""
    if no_speech_prob <= no_speech_threshold:
        return False
    return avg_logprob < logprob_threshold


def transcriber(params, cfg, tokenizer, language: Optional[str] = None,
                max_new: int = 440) -> Transcriber:
    """The port's Whisper transcriber (JAX ``jax_transcriber``).

    ``params`` / ``cfg`` from ``asr/``; ``tokenizer`` any object with
    ``convert_tokens_to_ids`` and ``decode`` (the HF Whisper tokenizer).
    One decoder step from <|startoftranscript|> gives both the language,
    when ``language`` is None (the argmax over the language tokens), and
    the no-speech probability. Only the emitted ids and that step's logits
    leave the device."""
    from ..asr import mel as asr_mel
    from ..asr import model as asr_model
    from . import audio_io

    dev = params["decoder"]["embed"].device
    sot = cfg.decoder_start_token_id

    def tok_id(t):
        i = tokenizer.convert_tokens_to_ids(t)
        unk = getattr(tokenizer, "unk_token_id", None)
        if i is None or (unk is not None and i == unk):
            return None
        return int(i)

    task_id = tok_id("<|transcribe|>")
    nots_id = tok_id("<|notimestamps|>")
    # large-v3 vocab names it <|nospeech|>; earlier vocabs <|nocaptions|>
    nospeech_id = tok_id("<|nospeech|>")
    if nospeech_id is None:
        nospeech_id = tok_id("<|nocaptions|>")
    lang_ids = [i for i in (tok_id(f"<|{c}|>") for c in LANGUAGES)
                if i is not None]

    @torch.inference_mode()
    def transcribe(path: str) -> str:
        wav = audio_io.load_for_encode(path, WHISPER_SR)
        feats = asr_mel.log_mel(torch.from_numpy(wav).to(dev),
                                cfg.num_mel_bins)
        enc = asr_model.encode(params, cfg, feats)

        lang_tok = tok_id(f"<|{language}|>") if language else None
        no_speech_prob = 0.0
        if (lang_tok is None and lang_ids) or nospeech_id is not None:
            lf = asr_model.decoder_logits(
                params, cfg, torch.tensor([sot]), enc)[0].cpu().numpy()
            if nospeech_id is not None:
                probs = np.exp(lf - lf.max())
                probs /= probs.sum()
                no_speech_prob = float(probs[nospeech_id])
            if lang_tok is None and lang_ids:
                lang_tok = lang_ids[int(np.argmax(lf[lang_ids]))]

        forced = [t for t in (sot, lang_tok, task_id, nots_id)
                  if t is not None]
        budget = min(max_new, cfg.max_target_positions - len(forced) - 1)

        def decode_at(temp: float):
            # a rung's draws: step_uniform with the rung as its seed
            ids, n, sum_lp = asr_model.decode_with_stats(
                params, cfg, enc, forced, budget, temp,
                int(round(temp * 10)))
            ids = ids[:n].cpu().numpy()
            # generated count with eos == whisper's len(text_tokens) + 1
            avg_logprob = sum_lp / max(n - len(forced), 1)
            text = tokenizer.decode(ids, skip_special_tokens=True).strip()
            return text, avg_logprob

        text, avg_logprob = decode_with_fallback(decode_at)
        if is_no_speech(no_speech_prob, avg_logprob):
            log.info("no-speech gate: silent clip (no_speech_prob=%.2f, "
                     "avg_logprob=%.2f) -> empty transcript",
                     no_speech_prob, avg_logprob)
            return ""
        return text

    return transcribe


def _hub_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def local_model_dir(name: str) -> Optional[str]:
    """``name`` itself when it is a directory, else its snapshot in the
    local Hugging Face cache (the revision ``refs/main`` names, or the
    newest snapshot), else None."""
    if os.path.isdir(name):
        return name
    repo = os.path.join(_hub_cache(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snap = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isdir(snap):
            return snap
    snaps = sorted(glob.glob(os.path.join(repo, "snapshots", "*")),
                   key=os.path.getmtime)
    return snaps[-1] if snaps else None


def whisper_config(hf: dict):
    """``asr.model.WhisperConfig`` from a Whisper ``config.json``."""
    from ..asr.model import WhisperConfig

    fields = {f for f in WhisperConfig.__dataclass_fields__ if f != "eps"}
    return WhisperConfig(**{k: hf[k] for k in fields if k in hf})


def load_transcriber(hf_model_name: str = DEFAULT_MODEL,
                     device: DeviceLike = "cuda") -> Transcriber:
    """The port's Whisper on ``device`` from a local directory
    (:func:`local_model_dir`): ``config.json``, ``*.safetensors`` through
    ``asr/convert.py``, and the tokenizer through transformers. Raises
    RuntimeError, naming ``--reference_text``, when nothing loads."""
    from ..asr.convert import whisper_state_dict_to_params

    path = local_model_dir(hf_model_name)
    try:
        if path is None:
            raise FileNotFoundError(
                f"{hf_model_name!r} is neither a directory nor in the local "
                f"Hugging Face cache ({_hub_cache()})")
        with open(os.path.join(path, "config.json")) as f:
            cfg = whisper_config(json.load(f))
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors in {path}")
        from ..utils.safetensors_io import load_numpy

        sd = {}
        for fn in files:
            sd.update(load_numpy(fn))
        params = whisper_state_dict_to_params(sd, cfg, device=device)
        from transformers import WhisperTokenizer

        tokenizer = WhisperTokenizer.from_pretrained(path)
    except (OSError, ImportError, KeyError, ValueError) as exc:
        raise RuntimeError(
            f"no Whisper model could be loaded from {hf_model_name!r} "
            f"({exc}); Whisper loads only from a local directory, so pass "
            "the reference transcript with --reference_text") from exc
    return transcriber(params, cfg, tokenizer)

"""Phoneme-aware target-duration estimation.

An own copy of ``t5gemma_tts_tpu/inference/duration.py`` (the port imports
nothing of the JAX package).

Behavioral mirror of the reference duration estimator
(reference: duration_estimator.py:71-252): language-specific
seconds-per-phoneme pacing (optionally derived from a reference recording),
punctuation pause bonuses, and [0.5 s, 120 s] clamping. G2P backends
(g2p_en / pyopenjtalk / pypinyin) are optional; without them the reference's
own character-count fallbacks apply.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

from .audio_io import read_wav
from .textnorm import detect_language

SPP_DEFAULT = {"en": 0.085, "ja": 0.10, "zh": 0.27, "other": 0.11}
SPP_MINMAX = {
    "en": (0.06, 0.12),
    "ja": (0.07, 0.15),
    "zh": (0.18, 0.36),
    "other": (0.07, 0.18),
}
MIN_DURATION_SEC = 0.5
MAX_DURATION_SEC = 120.0

_g2p_en = None


def _phoneme_count_en(text: str) -> int:
    global _g2p_en
    try:
        if _g2p_en is None:
            from g2p_en import G2p

            _g2p_en = G2p()
        ph = _g2p_en(text)
        return len([p for p in ph
                    if p and p not in {" ", "<pad>", "<s>", "</s>", "<unk>"}])
    except ImportError:
        return len(text)


def _phoneme_count_ja(text: str) -> int:
    try:
        import pyopenjtalk

        ph = pyopenjtalk.g2p(text)
        return len([p for p in ph.split(" ") if p and p not in {"pau", "sil"}])
    except ImportError:
        return len(text)


def _phoneme_count_zh(text: str) -> int:
    try:
        from pypinyin import Style, lazy_pinyin

        syl = lazy_pinyin(text, style=Style.NORMAL, neutral_tone_with_five=True)
        return len([s for s in syl if s and re.search(r"[a-zA-Z]", s)])
    except ImportError:
        return len(text)


def phoneme_count(text: str, lang: str) -> int:
    if lang == "en":
        return _phoneme_count_en(text)
    if lang == "ja":
        return _phoneme_count_ja(text)
    if lang == "zh":
        return _phoneme_count_zh(text)
    return max(len(text), 1)


def punctuation_bonus_sec(text: str) -> float:
    """Pause bonuses (reference duration_estimator.py:154-181)."""
    t = text.strip()
    major_chars = ".!?。！？"
    major = len(re.findall(r"[.!?。！？]", t))
    minor = len(re.findall(r"[、，,;；:]", t))
    if t and t[-1] in major_chars:
        major = max(0, major - 1)
    ellipsis = len(re.findall(r"(…|\.\.\.)", t))
    dash = len(re.findall(r"(—|--)", t))
    return min(10.0, major * 0.40 + minor * 0.20 + ellipsis * 1.0 + dash * 0.12)


def _canonical(lang: Optional[str]) -> Optional[str]:
    if not lang:
        return None
    lang = lang.lower()
    if lang.startswith("ja"):
        return "ja"
    if lang.startswith("zh") or lang == "yue":
        return "zh"
    if lang.startswith("en"):
        return "en"
    return lang


def _clamp(v: float, bounds: Tuple[float, float]) -> float:
    lo, hi = bounds
    return max(lo, min(hi, v))


def audio_duration_sec(path: str) -> Optional[float]:
    try:
        wav, sr = read_wav(path)
        return len(wav) / sr if sr else None
    except Exception:
        return None


def estimate_duration(
    target_text: str,
    reference_speech: Optional[str] = None,
    reference_transcript: Optional[str] = None,
    target_lang: Optional[str] = None,
    reference_lang: Optional[str] = None,
) -> float:
    """Estimated target duration in seconds
    (reference: duration_estimator.py:207-252)."""
    target_text = target_text or ""
    ref_has_audio = bool(reference_speech) and os.path.isfile(reference_speech)

    tgt_lang = _canonical(target_lang) or (
        detect_language(target_text) if target_text else "en"
    )
    tgt_phonemes = max(phoneme_count(target_text, tgt_lang), 1)
    spp = SPP_DEFAULT.get(tgt_lang, SPP_DEFAULT["other"])

    if ref_has_audio:
        dur = audio_duration_sec(reference_speech)
        if dur and dur > 0:
            ref_text = reference_transcript or target_text
            ref_lang = _canonical(reference_lang) or detect_language(ref_text)
            ref_phonemes = max(phoneme_count(ref_text, ref_lang), 1)
            spp = _clamp(dur / ref_phonemes,
                         SPP_MINMAX.get(ref_lang, SPP_MINMAX["other"]))

    bonus = punctuation_bonus_sec(target_text) * (0.3 if ref_has_audio else 1.0)
    duration = tgt_phonemes * spp + bonus
    return max(MIN_DURATION_SEC, min(duration, MAX_DURATION_SEC))

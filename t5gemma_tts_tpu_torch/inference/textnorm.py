"""Language detection and Japanese text normalization.

An own copy of ``t5gemma_tts_tpu/inference/textnorm.py`` (the port imports
nothing of the JAX package).

Behavioral mirror of the reference's text front-end
(reference: inference_tts_utils.py:54-115 and duration_estimator.py:84-116):
normalization applies only when the language resolves to Japanese; language
detection prefers ``langdetect`` when installed and falls back to CJK
character-range heuristics (the TTS defaults work without any optional
dependency installed).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

try:  # optional
    from langdetect import DetectorFactory, LangDetectException, detect

    DetectorFactory.seed = 0
except ImportError:  # pragma: no cover - environment-dependent
    detect = None
    LangDetectException = Exception

# Normalization table mirrored from the reference JA pipeline
# (inference_tts_utils.py:54-66) — this is behavioral data, not code.
_REPLACE_MAP = {
    r"\t": "",
    r"\[n\]": "",
    r" ": "",
    r"　": "",
    r"[;▼♀♂《》≪≫①②③④⑤⑥]": "",
    r"[˗‐-―⁃−⎯⏤─━⸺⸻]": "",
    r"[～〜]": "ー",
    r"？": "?",
    r"！": "!",
    r"[●◯〇]": "○",
    r"♥": "♡",
}

_FULLWIDTH_ALPHA = str.maketrans({
    chr(full): chr(half)
    for full, half in zip(
        list(range(0xFF21, 0xFF3B)) + list(range(0xFF41, 0xFF5B)),
        list(range(0x41, 0x5B)) + list(range(0x61, 0x7B)),
    )
})
_FULLWIDTH_DIGITS = str.maketrans({
    chr(full): chr(half)
    for full, half in zip(range(0xFF10, 0xFF1A), range(0x30, 0x3A))
})
_HALF_KATA = "ｦｧｨｩｪｫｬｭｮｯｰｱｲｳｴｵｶｷｸｹｺｻｼｽｾｿﾀﾁﾂﾃﾄﾅﾆﾇﾈﾉﾊﾋﾌﾍﾎﾏﾐﾑﾒﾓﾔﾕﾖﾗﾘﾙﾚﾛﾜﾝ"
_FULL_KATA = "ヲァィゥェォャュョッーアイウエオカキクケコサシスセソタチツテトナニヌネノハヒフヘホマミムメモヤユヨラリルレロワン"
_HALF_TO_FULL_KATA = str.maketrans(_HALF_KATA, _FULL_KATA)


def normalize_japanese(text: str) -> str:
    for pattern, repl in _REPLACE_MAP.items():
        text = re.sub(pattern, repl, text)
    text = text.translate(_FULLWIDTH_ALPHA)
    text = text.translate(_FULLWIDTH_DIGITS)
    text = text.translate(_HALF_TO_FULL_KATA)
    return re.sub(r"…{3,}", "……", text)


def detect_language(text: str) -> str:
    """Coarse language code en/ja/zh/other, mirroring
    duration_estimator.py:84-116 (langdetect first, CJK heuristics after)."""
    text = text.strip()
    if not text:
        return "other"

    def heuristic() -> Optional[str]:
        if re.search(r"[぀-ヿ]", text):
            return "ja"
        if re.search(r"[一-鿿]", text):
            return "zh"
        return None

    if detect is not None:
        try:
            lang = detect(text)
            if lang.startswith("ja"):
                return "ja"
            if lang.startswith("zh") or lang == "yue":
                return "zh"
            if lang.startswith("en"):
                return "en"
        except LangDetectException:
            pass
    return heuristic() or "en"


def normalize_text_with_lang(
    text: str, lang: Optional[str]
) -> Tuple[str, Optional[str]]:
    """Normalize iff Japanese; returns (text, resolved_lang)
    (reference: inference_tts_utils.py:103-115)."""
    resolved = lang.lower() if isinstance(lang, str) else None
    if not text:
        return text, resolved
    if resolved is None:
        resolved = detect_language(text)
    if resolved and resolved.startswith("ja"):
        return normalize_japanese(text), resolved
    return text, resolved

"""Training dataset: transcripts + codec codes + neighbor prompts.

The port's own copy of ``t5gemma_tts_tpu/data/dataset.py``, a behavioral
mirror of the reference dataset (reference:
data/combined_dataset.py:375-462 ``__getitem__`` and :270-373
``find_neighbor``): per-example it loads text tokens and codec codes,
optionally prepends a same-speaker neighbor prompt (x_sep / y_sep separators
and the loss-prefix position used by no_loss_on_prefix), and appends text
eos/bos.

The time-stretch augmentation (reference :203-254) is implemented with an
in-process WSOLA stretcher (data/stretch.py — no ffmpeg needed for .wav
sources) plus a caller-supplied ``codec_encode`` hook that re-encodes the
stretched waveform; when the hook or the source audio is absent the on-disk
codes are used, exactly like the reference's failure fallback (:248-254).
"""

from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from . import manifest as mani
from . import stretch
from .manifest import DataConfig, ManifestEntry

log = logging.getLogger(__name__)


@dataclass
class Example:
    x: np.ndarray              # text token ids
    y: np.ndarray              # codec codes
    y_sep_position: int        # loss-prefix cut (0 when no prompt)
    x_sep_position: int


class VoiceDataset:
    def __init__(
        self,
        dcfg: DataConfig,
        split: str,
        text_tokenizer: Callable[[str], List[int]],
        x_sep_token: Optional[int],
        y_sep_token: Optional[int],
        add_eos_to_text: int = 0,
        add_bos_to_text: int = 0,
        seed: int = 1,
        codec_encode: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        encode_sample_rate: int = 16000,
    ):
        if split not in ("train", "valid", "test"):
            raise ValueError(f"bad split {split}")
        self.cfg = dcfg
        self.split = split
        self.encode_text = text_tokenizer
        self.x_sep_token = x_sep_token
        self.y_sep_token = y_sep_token
        self.add_eos_to_text = add_eos_to_text
        self.add_bos_to_text = add_bos_to_text
        self.codec_encode = codec_encode
        self.encode_sample_rate = encode_sample_rate
        self.entries, self.roots = mani.load_manifest(dcfg, split)
        self.lengths = [e.length for e in self.entries]
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.entries)

    # -- raw loading ---------------------------------------------------------

    def _paths(self, entry: ManifestEntry):
        root = self.roots[entry.root_idx]
        base = entry.utt_id + ".txt"
        return (
            os.path.join(root, self.cfg.text_folder_name, base),
            os.path.join(root, self.cfg.encodec_folder_name, base),
            os.path.join(root, self.cfg.neighbor_folder_name, base),
            root,
        )

    def _load(self, idx: int):
        entry = self.entries[idx]
        text_fn, enc_fn, _, root = self._paths(entry)
        try:
            text = mani.read_text(text_fn)
            if not text:
                return None, None
            x = self.encode_text(text)
            if len(x) == 0:
                return None, None
            y = self._stretched_codes(entry, root)
            if y is None:
                y = mani.read_codes(enc_fn)
            if len(y) == 0:
                return None, None
            return np.asarray(x, np.int32), y
        except Exception as exc:  # tolerate per-sample failures
            log.info("loading failed for %s: %s", entry.utt_id, exc)
            return None, None

    def _stretched_codes(self, entry: ManifestEntry, root: str):
        """Time-stretch augmentation: load source audio, WSOLA-stretch by a
        random factor, re-encode with the codec (reference
        combined_dataset.py:203-254). Returns None to use the on-disk codes
        (prob miss, no audio, no encoder, or any failure)."""
        cfg = self.cfg
        if cfg.target_time_stretch_prob <= 0 or self.codec_encode is None:
            return None
        # the reference draws the factor before the probability gate (:216)
        speed = 1.0 + self._rng.uniform(-cfg.target_time_stretch_bound,
                                        cfg.target_time_stretch_bound)
        duration = entry.length / cfg.encodec_sr
        length_ok = duration / speed < cfg.audio_max_length
        if self._rng.random() >= cfg.target_time_stretch_prob or not length_ok:
            return None
        audio_fn = stretch.find_audio_file(
            os.path.join(root, cfg.audio_folder_name), entry.utt_id)
        if audio_fn is None:
            return None
        try:
            wav = stretch.load_audio_mono(
                audio_fn, self.encode_sample_rate, max_seconds=duration)
            wav = stretch.time_stretch(wav, speed, self.encode_sample_rate)
            codes = np.asarray(self.codec_encode(wav), np.int32).reshape(-1)
            return codes if len(codes) else None
        except Exception as exc:
            log.info("time stretch + re-encode failed for %s: %s",
                     entry.utt_id, exc)
            return None

    # -- neighbor prompting (reference :270-373) -----------------------------

    def _find_neighbor(self, neighbors, y_len: int, root: str):
        nb = self._rng.choice(neighbors)
        enc_fn = os.path.join(root, self.cfg.encodec_folder_name, nb[0])
        text_fn = os.path.join(root, self.cfg.text_folder_name, nb[0])
        if not (os.path.isfile(enc_fn) and os.path.isfile(text_fn)):
            return None, None
        text = mani.read_text(text_fn)
        if not text:
            return None, None
        x_nb = self.encode_text(text)
        if not x_nb:
            return None, None
        try:
            y_nb = mani.read_codes(enc_fn)
        except ValueError:
            return None, None
        dur = nb[2] if nb[2] > 0 else len(y_nb) / self.cfg.encodec_sr
        if (dur + y_len / self.cfg.encodec_sr > self.cfg.audio_max_length
                or dur < self.cfg.min_prompt_len):
            return None, None
        return np.asarray(x_nb, np.int32), y_nb

    def __getitem__(self, idx: int) -> Optional[Example]:
        x, y = self._load(idx)
        if x is None:
            return None
        entry = self.entries[idx]
        _, _, nb_fn, root = self._paths(entry)

        y_sep_pos = x_sep_pos = 0
        if (self.cfg.neighbor_prompt_prob > 0
                and self._rng.random() < self.cfg.neighbor_prompt_prob
                and os.path.isfile(nb_fn)):
            neighbors = mani.read_neighbors(nb_fn)
            method = self.cfg.neighbor_selection_method
            if method.startswith("maxdist"):
                maxdist = float(method.split("_")[-1])
                neighbors = [n for n in neighbors if n[1] <= maxdist]
            else:
                raise NotImplementedError(method)
            x_nb = y_nb = None
            for _ in range(max(1, min(self.cfg.num_trial, len(neighbors)))):
                if not neighbors:
                    break
                x_nb, y_nb = self._find_neighbor(neighbors, len(y), root)
                if x_nb is not None:
                    break
            if x_nb is not None:
                if self.x_sep_token is not None:
                    x = np.concatenate([x_nb, [self.x_sep_token], x]).astype(np.int32)
                else:
                    x = np.concatenate([x_nb, x]).astype(np.int32)
                if self.y_sep_token is not None:
                    y = np.concatenate([y_nb, [self.y_sep_token], y]).astype(np.int32)
                else:
                    y = np.concatenate([y_nb, y]).astype(np.int32)
                # position right after the prompt (reference :416-427)
                y_sep_pos = len(y_nb) + 1
                x_sep_pos = len(x_nb) + 1

        if self.add_eos_to_text:
            x = np.concatenate([x, [self.add_eos_to_text]]).astype(np.int32)
        if self.add_bos_to_text:
            x = np.concatenate([[self.add_bos_to_text], x]).astype(np.int32)
        x = x[: self.cfg.text_max_length]
        return Example(x=x, y=np.asarray(y, np.int32),
                       y_sep_position=y_sep_pos, x_sep_position=x_sep_pos)

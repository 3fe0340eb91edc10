"""On-disk dataset layout: manifests, token files, transcripts, neighbors.

The port's own copy of ``t5gemma_tts_tpu/data/manifest.py`` (numpy only):

  <root>/text/<shard>/<utt>.txt          raw transcript
  <root>/xcodec2_1cb/<shard>/<utt>.txt   one line of space-separated codes
  <root>/manifest_final/{train,valid}.txt  "utt_id \t token_len" rows
  <root>/neighbors/<utt>.txt             "fn \t distance \t duration" rows

Multi-root datasets use the ['a','b'] list syntax for dataset_dir /
manifest_name, parsed with ast.literal_eval. Sharded manifests
(train_*=*.txt) are combined. Token files are parsed with numpy.
"""

from __future__ import annotations

import ast
import glob
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


def parse_list_flag(value: str) -> List[str]:
    """'['a','b']' -> [a, b]; bare string -> [value]."""
    if isinstance(value, (list, tuple)):
        return list(value)
    value = value.strip()
    if value.startswith("["):
        parsed = ast.literal_eval(value)
        if not isinstance(parsed, (list, tuple)):
            raise ValueError(f"expected list syntax, got {value!r}")
        return [str(v) for v in parsed]
    return [value]


@dataclass
class ManifestEntry:
    utt_id: str
    length: int     # codec frames
    root_idx: int


@dataclass
class DataConfig:
    dataset_dir: str = ""
    manifest_name: str = "manifest_final"
    encodec_folder_name: str = "xcodec2_1cb"
    text_folder_name: str = "text"
    neighbor_folder_name: str = "neighbors"
    audio_folder_name: str = "audio"
    encodec_sr: float = 50.0
    audio_min_length: float = 2.0
    audio_max_length: float = 120.0
    text_max_length: int = 1000
    drop_long: bool = True
    validation_sample_cap: Optional[int] = None
    # neighbor prompting (reference config.py:177-184)
    neighbor_prompt_prob: float = 0.0
    neighbor_selection_method: str = "maxdist_60"
    num_trial: int = 5
    min_prompt_len: float = 0.5
    seed: int = 1
    # target-audio time-stretch augmentation (reference config.py:173-174)
    target_time_stretch_prob: float = 0.0
    target_time_stretch_bound: float = 0.1


def load_manifest(cfg: DataConfig, split: str) -> Tuple[List[ManifestEntry], List[str]]:
    """Returns (entries filtered by min/max length, dataset roots)."""
    roots = parse_list_flag(cfg.dataset_dir)
    manifests = parse_list_flag(cfg.manifest_name)
    if len(manifests) != len(roots):
        if len(manifests) != 1:
            raise ValueError("manifest_name must have 1 entry or match dataset_dir")
        manifests = manifests * len(roots)

    rows: List[ManifestEntry] = []
    for i, root in enumerate(roots):
        fn = os.path.join(root, manifests[i], split + ".txt")
        files = [fn] if os.path.isfile(fn) else sorted(
            glob.glob(fn.replace(".txt", "_*=*.txt"))
        )
        if not files:
            log.info("no manifest for %s split in %s", split, root)
            continue
        n = 0
        for f in files:
            with open(f) as rf:
                for line in rf:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        rows.append(ManifestEntry(parts[0], int(parts[1]), i))
                        n += 1
        log.info("%d datapoints for %s split in %s", n, split, root)

    if split == "valid" and cfg.validation_sample_cap:
        cap = cfg.validation_sample_cap
        if len(rows) > cap:
            rng = np.random.default_rng(cfg.seed)
            keep = set(rng.permutation(len(rows))[:cap].tolist())
            rows = [r for i, r in enumerate(rows) if i in keep]

    min_frames = cfg.encodec_sr * cfg.audio_min_length
    max_frames = cfg.encodec_sr * cfg.audio_max_length
    out = []
    for r in rows:
        if r.length < min_frames:
            continue
        if cfg.drop_long and r.length > max_frames:
            continue
        out.append(r)
    if not out:
        raise RuntimeError(f"no data found for {split} split")
    total_h = sum(r.length for r in out) / cfg.encodec_sr / 3600
    log.info("%s split: %d utts, %.1f hours", split, len(out), total_h)
    return out, roots


def read_codes(path: str) -> np.ndarray:
    """Read a single-codebook token file (one line of space-separated ints)."""
    with open(path) as f:
        first = f.readline()
    return np.asarray(first.split(), dtype=np.int32)


def read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read().strip()


def read_neighbors(path: str) -> List[Tuple[str, float, float]]:
    """Rows of (neighbor_fn, distance, duration)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("\t")
            if not parts or not parts[0]:
                continue
            dist = float(parts[1]) if len(parts) > 1 else 0.0
            dur = float(parts[2]) if len(parts) > 2 else 0.0
            out.append((parts[0], dist, dur))
    return out

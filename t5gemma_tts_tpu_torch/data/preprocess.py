"""Corpus preprocessing: raw speech -> the on-disk training layout.

Counterpart of ``t5gemma_tts_tpu/data/preprocess.py`` (reference:
examples/data_preprocess/prepare_emilia_en.py): filtering (language
allow-list, id blocklist, bad substrings, repetition detector, 0.1-30 s
duration gates), XCodec2 tokenization, md5-sharded writes of
``text/ xcodec2_1cb/ manifest_final/``, manifest-based resume, and
same-speaker ``neighbors/`` generation (duration-diff distance, strided
subsampling).

Batches of zero-padded waveforms are encoded by the port's
``AudioTokenizer.encode`` on one device (``cuda`` unless ``--device cpu``)
or, under ``torchrun`` (``WORLD_SIZE`` above 1), spread over the ranks:
each rank encodes its contiguous rows of every batch with its own
tokenizer, the codes are all-gathered, and rank 0 alone writes, the same
files a one-process run writes. The reference runs one encoder thread per
GPU, the JAX package one SPMD program over its mesh. The files are the JAX
package's, byte for byte, for the same codes. ``iter_hf_dataset`` reads a
dataset from a local path only.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

MIN_DURATION_SEC = 0.1
MAX_DURATION_SEC = 30.0

_ID_SAFE_RE = re.compile(r"[^A-Za-z0-9_\-./]")

DEFAULT_BAD_SUBSTRINGS = ("http://", "https://", "www.")


def sanitize_utt_id(raw_id: str) -> str:
    return _ID_SAFE_RE.sub("_", str(raw_id))


def normalize_text(text: str) -> str:
    return " ".join(str(text).lstrip().split())


def repetition_found(text: str, length: int = 4, tolerance: int = 10) -> bool:
    """Over-repetition of short substrings marks junk transcripts
    (reference prepare_emilia_en.py:369-378)."""
    if length <= 0 or len(text) < length:
        return False
    counts: Dict[str, int] = defaultdict(int)
    for i in range(len(text) - length + 1):
        counts[text[i:i + length]] += 1
        if counts[text[i:i + length]] > tolerance:
            return True
    return False


@dataclass
class Sample:
    utt_id: str
    text: str
    wav: np.ndarray          # float32 at encode sample rate
    speaker: str = ""
    language: str = ""
    duration_sec: float = 0.0


@dataclass
class PreprocessConfig:
    out_dir: str = "prepared"
    split: str = "train"
    valid_fraction: float = 0.002
    languages: Tuple[str, ...] = ()   # empty = allow all
    blocklist: Tuple[str, ...] = ()
    bad_substrings: Tuple[str, ...] = DEFAULT_BAD_SUBSTRINGS
    repetition_length: int = 4
    repetition_tolerance: int = 10
    encode_batch: int = 16
    encodec_sr: int = 50
    overwrite: bool = False
    max_neighbors_per_utt: Optional[int] = 64
    seed: int = 0
    min_duration_sec: float = MIN_DURATION_SEC
    max_duration_sec: float = MAX_DURATION_SEC
    max_samples: Optional[int] = None
    make_neighbors: bool = True


def ensure_dirs(base: str) -> Dict[str, str]:
    dirs = {
        "text": os.path.join(base, "text"),
        "codes": os.path.join(base, "xcodec2_1cb"),
        "manifest": os.path.join(base, "manifest_final"),
        "neighbors": os.path.join(base, "neighbors"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def write_outputs(dirs: Dict[str, str], split: str, utt_id: str,
                  tokens: np.ndarray, text: str, overwrite: bool) -> int:
    """md5-sharded text/codes/manifest write
    (reference prepare_emilia_en.py:306-344)."""
    shard = hashlib.md5(utt_id.encode()).hexdigest()[:2]
    tdir = os.path.join(dirs["text"], shard)
    cdir = os.path.join(dirs["codes"], shard)
    os.makedirs(tdir, exist_ok=True)
    os.makedirs(cdir, exist_ok=True)
    tpath = os.path.join(tdir, f"{utt_id}.txt")
    cpath = os.path.join(cdir, f"{utt_id}.txt")
    if not overwrite and (os.path.exists(tpath) or os.path.exists(cpath)):
        raise FileExistsError(f"outputs exist for {utt_id}")
    with open(tpath, "w", encoding="utf-8") as f:
        f.write(text.strip() + "\n")
    tokens = np.asarray(tokens).reshape(-1)
    with open(cpath, "w") as f:
        f.write(" ".join(str(int(t)) for t in tokens) + "\n")
    with open(os.path.join(dirs["manifest"], f"{split}.txt"), "a") as f:
        f.write(f"{shard}/{utt_id}\t{len(tokens)}\n")
    return len(tokens)


def load_done_ids(dirs: Dict[str, str]) -> set:
    """Resume support: utt ids already present in any manifest
    (reference prepare_emilia_en.py:947-976)."""
    done = set()
    mdir = dirs["manifest"]
    if os.path.isdir(mdir):
        for fn in os.listdir(mdir):
            with open(os.path.join(mdir, fn)) as f:
                for line in f:
                    utt = line.split("\t")[0].split("/")[-1].strip()
                    if utt:
                        done.add(utt)
    return done


def sample_filter(cfg: PreprocessConfig, s: Sample,
                  encode_sr: int) -> Optional[str]:
    """Returns a rejection reason or None (accepted)."""
    if cfg.languages and s.language and s.language.lower() not in cfg.languages:
        return "language"
    if s.utt_id in cfg.blocklist:
        return "blocklist"
    text = normalize_text(s.text)
    if not text:
        return "empty_text"
    low = text.lower()
    if any(b in low for b in cfg.bad_substrings):
        return "bad_substring"
    if repetition_found(text, cfg.repetition_length, cfg.repetition_tolerance):
        return "repetition"
    dur = s.duration_sec or len(s.wav) / encode_sr
    if dur < cfg.min_duration_sec or dur > cfg.max_duration_sec:
        return "duration"
    return None


@dataclass
class SampleRecord:
    utt_id: str
    speaker: str
    duration_sec: float
    split: str


def _encode(audio_tokenizer, wavs: np.ndarray, mesh) -> np.ndarray:
    """Codes [B, T, 1] of a zero-padded batch: one ``encode`` call, or over
    ``mesh`` (data-parallel over all ranks) each rank's contiguous rows
    (the batch padded with silent rows to a multiple of the world), then
    all-gathered."""
    if mesh is None:
        return audio_tokenizer.encode(wavs)
    import torch

    from ..parallel import mesh as mesh_mod

    b = wavs.shape[0]
    per = -(-b // mesh.world)
    padded = np.zeros((per * mesh.world, wavs.shape[1]), np.float32)
    padded[:b] = wavs
    lo = mesh.rank * per
    mine = audio_tokenizer.encode(padded[lo:lo + per])
    codes = mesh_mod.all_gather(
        torch.from_numpy(np.ascontiguousarray(mine)).to(mesh.device), 0,
        None, mesh.world)
    return codes[:b].cpu().numpy()


def prepare(
    samples: Iterable[Sample],
    audio_tokenizer,
    cfg: PreprocessConfig,
    mesh=None,
) -> List[SampleRecord]:
    """Filter + batch-encode + write. ``audio_tokenizer`` is a
    ``codec.audio_tokenizer.AudioTokenizer`` with encoder weights; each
    batch of ``cfg.encode_batch`` waveforms, zero-padded to the longest, is
    one ``encode`` call, and each utterance keeps ``len(wav) // hop`` of its
    codes (at least one). ``mesh`` (a ``parallel.Mesh``; every rank calls
    with the same samples): the batch's rows are encoded across the ranks
    and rank 0 writes."""
    from ..parallel import mesh as mesh_mod

    lead = mesh is None or mesh.lead
    dirs = ensure_dirs(cfg.out_dir)
    done = load_done_ids(dirs)
    mesh_mod.barrier(mesh)      # every rank has read what is done
    encode_sr = audio_tokenizer.encode_sample_rate
    rng = np.random.default_rng(cfg.seed)

    records: List[SampleRecord] = []
    stats: Dict[str, int] = defaultdict(int)
    buf: List[Sample] = []

    def flush():
        if not buf:
            return
        max_len = max(len(s.wav) for s in buf)
        wavs = np.zeros((len(buf), max_len), np.float32)
        for i, s in enumerate(buf):
            wavs[i, : len(s.wav)] = s.wav
        codes = _encode(audio_tokenizer, wavs, mesh)  # [B, T, 1]
        for i, s in enumerate(buf):
            t = int(len(s.wav) // np.prod(audio_tokenizer.cfg.acoustic_cfg.ratios))
            toks = codes[i, : max(t, 1), 0]
            split = s_split[i]
            if lead:
                write_outputs(dirs, split, s.utt_id, toks,
                              normalize_text(s.text), cfg.overwrite)
            records.append(SampleRecord(
                utt_id=f"{hashlib.md5(s.utt_id.encode()).hexdigest()[:2]}/{s.utt_id}",
                speaker=s.speaker,
                duration_sec=s.duration_sec or len(s.wav) / encode_sr,
                split=split,
            ))
            stats["written"] += 1
        buf.clear()
        s_split.clear()

    s_split: List[str] = []
    accepted = 0
    for s in samples:
        if cfg.max_samples is not None and accepted >= cfg.max_samples:
            break
        s.utt_id = sanitize_utt_id(s.utt_id)
        if s.utt_id in done:
            stats["resumed"] += 1
            continue
        reason = sample_filter(cfg, s, encode_sr)
        if reason:
            stats[reason] += 1
            continue
        split = cfg.split
        if cfg.valid_fraction > 0 and rng.random() < cfg.valid_fraction:
            split = "valid"
        buf.append(s)
        s_split.append(split)
        accepted += 1
        if len(buf) >= cfg.encode_batch:
            flush()
    flush()
    if lead:
        log.info("preprocess stats: %s", dict(stats))
    if cfg.make_neighbors and lead:
        generate_neighbors(records, dirs["neighbors"],
                           cfg.max_neighbors_per_utt, cfg.seed)
    mesh_mod.barrier(mesh)      # the files are written
    return records


def generate_neighbors(records: Sequence[SampleRecord], out_dir: str,
                       max_per_utt: Optional[int], seed: int = 0) -> None:
    """Same-speaker neighbor lists with duration-diff distance
    (reference prepare_emilia_en.py:1293-1483)."""
    rng = np.random.default_rng(seed)
    groups: Dict[Tuple[str, str], List[SampleRecord]] = defaultdict(list)
    for r in records:
        groups[(r.split, r.speaker)].append(r)
    for g in groups.values():
        g.sort(key=lambda r: r.utt_id)

    for r in records:
        neighbors = [n for n in groups[(r.split, r.speaker)]
                     if n.utt_id != r.utt_id]
        path = os.path.join(out_dir, f"{r.utt_id}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not neighbors:
            open(path, "a").close()
            continue
        neighbors.sort(key=lambda n: abs(n.duration_sec - r.duration_sec))
        if max_per_utt is not None and len(neighbors) > max_per_utt:
            stride = len(neighbors) / float(max_per_utt)
            sampled = []
            for i in range(max_per_utt):
                pos = int(rng.uniform(i * stride, (i + 1) * stride))
                sampled.append(neighbors[min(pos, len(neighbors) - 1)])
            neighbors = sampled
        with open(path, "w", encoding="utf-8") as f:
            for n in neighbors:
                dist = abs(n.duration_sec - r.duration_sec)
                f.write(f"{n.utt_id}.txt\t{dist:.3f}\t{n.duration_sec:.3f}\n")


# ---------------------------------------------------------------------------
# input adapters
# ---------------------------------------------------------------------------


def iter_wav_folder(folder: str, encode_sr: int) -> Iterator[Sample]:
    """Simple adapter: folder of <utt>.wav + <utt>.txt pairs."""
    from ..inference import audio_io

    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".wav"):
            continue
        utt = fn[:-4]
        txt = os.path.join(folder, utt + ".txt")
        if not os.path.isfile(txt):
            continue
        wav = audio_io.load_for_encode(os.path.join(folder, fn), encode_sr)
        with open(txt, encoding="utf-8") as f:
            text = f.read().strip()
        speaker = utt.rsplit("_", 1)[0]
        yield Sample(utt_id=utt, text=text, wav=wav, speaker=speaker,
                     duration_sec=len(wav) / encode_sr)


def iter_wav_folder_meta(folder: str, encode_sr: int) -> Iterator[Sample]:
    """Metadata-only pass over a wav folder (audio not decoded) — used by
    ``--neighbors-only`` replay, mirroring the reference's no-audio dataset
    replay (prepare_emilia_en.py:1293-1483)."""
    import wave

    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".wav"):
            continue
        utt = fn[:-4]
        txt = os.path.join(folder, utt + ".txt")
        if not os.path.isfile(txt):
            continue
        with wave.open(os.path.join(folder, fn), "rb") as w:
            dur = w.getnframes() / float(w.getframerate())
        with open(txt, encoding="utf-8") as f:
            text = f.read().strip()
        yield Sample(utt_id=utt, text=text, wav=np.zeros(0, np.float32),
                     speaker=utt.rsplit("_", 1)[0], duration_sec=dur)


def iter_hf_dataset(name_or_path: str, encode_sr: int,
                    split: str = "train", streaming: bool = True,
                    text_column: str = "text",
                    speaker_column: str = "speaker",
                    audio_column: str = "audio",
                    id_column: str = "id") -> Iterator[Sample]:
    """HF datasets adapter (Emilia-YODAS-style,
    reference prepare_emilia_en.py:791-818) over a dataset on a local path
    (a directory of data files, or a data file); a hub name, which needs
    the network, raises. ``datasets`` is imported here."""
    if not os.path.exists(name_or_path):
        raise FileNotFoundError(
            f"{name_or_path}: not a local path; the port reads datasets "
            "from a local path only (download it first)")
    from datasets import load_dataset

    from ..inference.audio_io import resample

    ds = load_dataset(name_or_path, split=split, streaming=streaming)
    for ex in ds:
        audio = ex.get(audio_column) or {}
        arr = np.asarray(audio.get("array"), np.float32)
        sr = int(audio.get("sampling_rate", encode_sr))
        if arr.ndim > 1:
            arr = arr.mean(axis=-1)
        if sr != encode_sr:
            arr = resample(arr, sr, encode_sr)
        meta = ex.get("json") or ex
        yield Sample(
            utt_id=str(ex.get(id_column) or meta.get("id") or ""),
            text=str(meta.get(text_column) or ""),
            wav=arr,
            speaker=str(meta.get(speaker_column) or ""),
            language=str(meta.get("language") or ""),
            duration_sec=float(meta.get("duration") or len(arr) / encode_sr),
        )


# ---------------------------------------------------------------------------
# CLI entry point: python -m t5gemma_tts_tpu_torch.data.preprocess
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The flags of the JAX package's CLI (reference:
    examples/data_preprocess/prepare_emilia_en.py:404-507): dataset source
    and columns, language allow-list, blocklist, bad-substring and
    repetition filters, duration gates, valid split, resume/overwrite,
    neighbors on/off; --wav-folder (local source), --codec-dir (local
    safetensors), --tiny-random-codec (the port's seeded tiny codec, for
    layout tests), --encode-batch, and --device."""
    p = argparse.ArgumentParser(
        prog="python -m t5gemma_tts_tpu_torch.data.preprocess",
        description="Raw speech -> training layout "
                    "(text/ xcodec2_1cb/ manifest_final/ neighbors/)")
    src = p.add_argument_group("source")
    src.add_argument("--dataset-name", default=None,
                     help="HF dataset (Emilia-YODAS-style) on a local "
                          "path.")
    src.add_argument("--wav-folder", default=None,
                     help="Local folder of <utt>.wav + <utt>.txt pairs.")
    src.add_argument("--split", default="train")
    src.add_argument("--streaming", action="store_true", default=True)
    src.add_argument("--no-streaming", dest="streaming", action="store_false")
    src.add_argument("--audio-column", default="mp3")
    src.add_argument("--text-column", default="text")
    src.add_argument("--id-column", default="_id")
    src.add_argument("--speaker-column", default="speaker")
    src.add_argument("--max-samples", type=int, default=None)

    out = p.add_argument_group("output")
    out.add_argument("--output-dir", required=True)
    out.add_argument("--valid-ratio", type=float, default=0.0)
    out.add_argument("--overwrite", action="store_true")
    out.add_argument("--seed", type=int, default=42)

    codec = p.add_argument_group("codec")
    codec.add_argument("--tokenizer-model",
                       default="NandemoGHS/Anime-XCodec2-44.1kHz-v2",
                       help="XCodec2 checkpoint (HF hub) for tokenisation.")
    codec.add_argument("--codec-dir", default=None,
                       help="Local dir with model.safetensors (offline).")
    codec.add_argument("--tiny-random-codec", action="store_true",
                       help="Random tiny codec (layout smoke tests only; "
                            "tokens are NOT meaningful).")
    codec.add_argument("--encode-batch", type=int, default=16)
    codec.add_argument("--encodec-sr", type=float, default=50.0)

    filt = p.add_argument_group("filters")
    filt.add_argument("--allowed-languages", default="",
                      help="Comma-separated codes to keep; empty keeps all.")
    filt.add_argument("--blocklist-file", default=None,
                      help="File of utterance ids to drop, one per line.")
    filt.add_argument("--extra-blocklist", nargs="*", default=None)
    filt.add_argument("--bad-substrings",
                      default=",".join(DEFAULT_BAD_SUBSTRINGS))
    filt.add_argument("--repetition-length", type=int, default=4)
    filt.add_argument("--repetition-tolerance", type=int, default=10)
    filt.add_argument("--min-duration", type=float, default=MIN_DURATION_SEC)
    filt.add_argument("--max-duration", type=float, default=MAX_DURATION_SEC)

    nb = p.add_argument_group("neighbors")
    nb.add_argument("--max-neighbors-per-utt", type=int, default=64,
                    help="cap each utterance's neighbor list (the library "
                         "default; <=0 means unbounded — quadratic output "
                         "for large single-speaker corpora)")
    nb.add_argument("--neighbors-only", action="store_true",
                    help="Skip encoding; rebuild neighbors/ from the "
                         "existing manifests + source metadata.")
    nb.add_argument("--no-neighbors", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the codec encodes: cuda (default) or cpu")
    return p


def _cli_tokenizer(args, device):
    if args.tiny_random_codec:
        from ..codec.audio_tokenizer import AudioTokenizer
        from ..codec.model import (
            init_decoder_params, init_encoder_params_for, tiny_codec_config,
        )

        ccfg = tiny_codec_config()
        params = init_decoder_params(0, ccfg, device)
        params.update(init_encoder_params_for(1, ccfg, device))
        return AudioTokenizer(params, ccfg, device)

    from ..inference.cli import _load_codec

    ns = argparse.Namespace(codec_dir=args.codec_dir,
                            xcodec2_model_name=args.tokenizer_model,
                            random_codec=False)
    return _load_codec(ns, None, device)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
    args = build_parser().parse_args(argv)
    if not args.dataset_name and not args.wav_folder:
        raise SystemExit("one of --dataset-name / --wav-folder is required")

    blocklist = list(args.extra_blocklist or ())
    if args.blocklist_file:
        with open(args.blocklist_file, encoding="utf-8") as f:
            blocklist += [ln.strip() for ln in f if ln.strip()]
    langs = tuple(s.strip().lower()
                  for s in args.allowed_languages.split(",") if s.strip())
    max_nb = (args.max_neighbors_per_utt
              if args.max_neighbors_per_utt and args.max_neighbors_per_utt > 0
              else None)
    cfg = PreprocessConfig(
        out_dir=args.output_dir,
        split=args.split,
        make_neighbors=not args.no_neighbors,
        valid_fraction=args.valid_ratio,
        languages=langs,
        blocklist=tuple(blocklist),
        bad_substrings=tuple(
            s for s in args.bad_substrings.split(",") if s),
        repetition_length=args.repetition_length,
        repetition_tolerance=args.repetition_tolerance,
        encode_batch=args.encode_batch,
        encodec_sr=int(args.encodec_sr),
        overwrite=args.overwrite,
        max_neighbors_per_utt=max_nb,
        seed=args.seed,
        min_duration_sec=args.min_duration,
        max_duration_sec=args.max_duration,
        max_samples=args.max_samples,
    )

    if args.neighbors_only:
        # Replay metadata for utterances already in the manifests and rebuild
        # neighbors/ (reference prepare_emilia_en.py:1293-1483); under
        # torchrun rank 0 alone
        if int(os.environ.get("RANK", 0)) != 0:
            return 0
        dirs = ensure_dirs(cfg.out_dir)
        done = load_done_ids(dirs)
        if args.wav_folder:
            it = iter_wav_folder_meta(args.wav_folder, int(args.encodec_sr))
        else:
            it = iter_hf_dataset(
                args.dataset_name, int(args.encodec_sr), split=args.split,
                streaming=args.streaming, text_column=args.text_column,
                speaker_column=args.speaker_column,
                audio_column=args.audio_column, id_column=args.id_column)
        records = []
        split_of = {}
        for fn in os.listdir(dirs["manifest"]) if os.path.isdir(
                dirs["manifest"]) else []:
            with open(os.path.join(dirs["manifest"], fn)) as f:
                for line in f:
                    utt = line.split("\t")[0].split("/")[-1].strip()
                    split_of[utt] = fn[:-len(".txt")]
        for s in it:
            utt = sanitize_utt_id(s.utt_id)
            if utt not in done:
                continue
            records.append(SampleRecord(
                utt_id=f"{hashlib.md5(utt.encode()).hexdigest()[:2]}/{utt}",
                speaker=s.speaker,
                duration_sec=s.duration_sec,
                split=split_of.get(utt, cfg.split)))
        generate_neighbors(records, dirs["neighbors"],
                           cfg.max_neighbors_per_utt, cfg.seed)
        log.info("neighbors rebuilt for %d utterances", len(records))
        return 0

    mesh = None
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        from ..parallel import mesh as mesh_mod

        device = mesh_mod.init_distributed(args.device)
        mesh = mesh_mod.make_mesh()
    else:
        from ..device import resolve_device

        device = resolve_device(args.device)
    tok = _cli_tokenizer(args, device)
    encode_sr = tok.encode_sample_rate
    if args.wav_folder:
        it = iter_wav_folder(args.wav_folder, encode_sr)
    else:
        it = iter_hf_dataset(
            args.dataset_name, encode_sr, split=args.split,
            streaming=args.streaming, text_column=args.text_column,
            speaker_column=args.speaker_column,
            audio_column=args.audio_column, id_column=args.id_column)
    records = prepare(it, tok, cfg, mesh)
    log.info("wrote %d utterances to %s", len(records), cfg.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

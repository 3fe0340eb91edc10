"""A checkout for the CPU tests: a copy of ``benchmark/`` with a tiny
configuration, tiny traffic mixes and their cells added as files only, and
a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

CONFIG = {
    "source": "a toy of the Flan-T5 layout, for tests",
    "d_model": 64, "d_ff": 128, "d_kv": 16, "num_heads": 4,
    "num_layers": 2, "num_decoder_layers": 2, "vocab_size": 512,
    "feed_forward_proj": "gated-gelu", "layer_norm_epsilon": 1e-6,
    "tts": {"audio_vocab_size": 64, "n_special": 5, "frames_per_s": 50,
            "progress_scale": 2000.0, "rope_theta": 10000.0,
            "query_pre_attn_scalar": 16, "sliding_window": 4096,
            "extra_cutoff": 0.0, "dtype": "float32"},
    "codec": {"fsq_levels": [4, 4, 4], "fsq_dim": 32,
              "vocos_input_dim": 16, "vocos_dim": 24,
              "vocos_intermediate_dim": 48, "vocos_layers": 2,
              "vocos_kernel": 7, "n_fft": 32, "hop_length": 10,
              "sample_rate": 500, "layer_norm_eps": 1e-6},
    "assumed": [], "reduced": []}

OFFLINE = {"kind": "offline", "precision": "int8", "kv_cache": "paged_i8",
           "server": {"max_batch": 4, "max_wait_ms": 5,
                      "warm": {"batch": [4], "text": [64], "prompt": [64],
                               "frames": [256]}},
           "per_batch": 4, "duration_s": {"low": 0.2, "high": 0.4},
           "chars_per_s": 14, "frames_per_s": 50, "check_requests": 3,
           "trace_batch": 1, "control": {"precision": "int4"}}

ARRIVALS = {"kind": "arrivals", "precision": "bf16", "kv_cache": "paged",
            "server": {"slots": 4, "text_bucket": 64, "prompt_bucket": 64,
                       "segment_frames": 5, "max_frames": 64,
                       "warm_requests": [0.1]},
            "rate_per_s": 8.0, "schedule_seed": 1,
            "duration_s": {"median": 0.3, "sigma": 0.5, "low": 0.1,
                           "high": 0.8},
            "chars_per_s": 14, "frames_per_s": 50, "check_requests": "all",
            "trace_start_s": 0.0, "trace_seconds": 0.2, "wait_s": 60.0,
            "control": {"precision": "int8"}}

# each tiny cell compares the numbers its real cell compares, at values for
# the CPU's float32 at a tiny size: the tests check the plumbing, and the
# cells' own limits are set on the card
CPU_LIMIT = {"logit_gap": 1e-3, "logit_gap_mean": 1e-4, "wav_rel_err": 1e-4}
REAL = {"tiny-offline": "xxl-int8-offline",
        "tiny-arrivals": "xl-bf16-arrivals"}
LIMITS = {cell: {k: CPU_LIMIT[k] for k in json.loads(
    (BENCH / "limits" / f"{real}.json").read_text())}
    for cell, real in REAL.items()}


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding ``benchmark/`` (copied) plus the tiny cells' files,
    and a ``BENCHMARK.json`` whose cells are the tiny ones."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp / "benchmark"
    (b / "configs" / "tiny-t5-tts.json").write_text(json.dumps(CONFIG))
    (b / "traffic" / "tiny-offline.json").write_text(json.dumps(OFFLINE))
    (b / "traffic" / "tiny-arrivals.json").write_text(json.dumps(ARRIVALS))
    for cell, limits in LIMITS.items():
        (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    real["workloads"] = [
        {"name": "tiny-offline", "config": "tiny-t5-tts",
         "traffic": "tiny-offline", "chips": 1, "why": "test"},
        {"name": "tiny-arrivals", "config": "tiny-t5-tts",
         "traffic": "tiny-arrivals", "chips": 1, "why": "test"}]
    for m in real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [("tiny-offline" if "offline" in w
                               else "tiny-arrivals") for w in m["workloads"]]
    for m in real["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [("tiny-offline" if "offline" in w
                               else "tiny-arrivals") for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(real))
    return tmp

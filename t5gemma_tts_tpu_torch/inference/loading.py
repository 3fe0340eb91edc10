"""Model loading from HF-interchange safetensors directories.

Counterpart of ``load_hf_dir`` in ``t5gemma_tts_tpu/inference/loading.py``:
reads the directory that ``export/hf_export.py::export_hf`` (or the
reference's HF export) writes, ``config.json`` + ``*.safetensors``, and
rebuilds the VoiceConfig from the exported fields. ``safetensors`` is
imported inside the loader, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import BackboneConfig, ModuleDims, VoiceConfig
from ..device import DeviceLike, resolve_device
from ..models import convert
from ..models.voice import DTYPES


def _dims_from_t5_config(sub: Dict[str, Any]) -> ModuleDims:
    return ModuleDims(
        vocab_size=sub.get("vocab_size", 256000),
        hidden_size=sub.get("hidden_size", 2304),
        intermediate_size=sub.get("intermediate_size", 9216),
        num_layers=sub.get("num_hidden_layers", 26),
        num_heads=sub.get("num_attention_heads", 8),
        num_kv_heads=sub.get("num_key_value_heads", 4),
        head_dim=sub.get("head_dim", 256),
        rope_theta=sub.get("rope_theta", 10000.0),
        rms_norm_eps=sub.get("rms_norm_eps", 1e-6),
        attn_logit_softcap=sub.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=sub.get("final_logit_softcapping", 30.0),
        query_pre_attn_scalar=sub.get("query_pre_attn_scalar", 256.0),
        sliding_window=sub.get("sliding_window", 4096),
        layer_types=tuple(sub.get("layer_types") or ()),
    )


def voice_config_from_hf(hf_cfg: Dict[str, Any]) -> VoiceConfig:
    """T5GemmaVoiceConfig json -> VoiceConfig (bf16 compute)."""
    t5 = hf_cfg.get("t5_config_dict") or {}
    enc = _dims_from_t5_config(t5.get("encoder", t5))
    dec = _dims_from_t5_config(t5.get("decoder", t5))
    return VoiceConfig(
        backbone=BackboneConfig(encoder=enc, decoder=dec),
        audio_vocab_size=int(hf_cfg.get("audio_vocab_size", 65536)),
        n_special=int(hf_cfg.get("n_special", 5)),
        encodec_sr=int(hf_cfg.get("encodec_sr", 50)),
        codec_audio_sr=int(hf_cfg.get("codec_audio_sr") or 44100),
        use_pm_rope=bool(hf_cfg.get("use_pm_rope", 1)),
        progress_scale=float(hf_cfg.get("progress_scale", 2000.0)),
        x_sep_token=hf_cfg.get("x_sep_token", 255999),
        add_eos_to_text=int(hf_cfg.get("add_eos_to_text", 0)),
        add_bos_to_text=int(hf_cfg.get("add_bos_to_text", 0)),
        special_first=bool(hf_cfg.get("special_first", 0)),
        text_guard_frames_per_token=int(
            hf_cfg.get("text_guard_frames_per_token", 0)),
        extra_cutoff=float(hf_cfg.get("extra_cutoff", 5.0)),
        dtype="bfloat16",
    )


def load_hf_dir(model_dir: str, device: DeviceLike = "cuda",
                dtype: Optional[str] = None
                ) -> Tuple[Any, VoiceConfig, Dict[str, Any]]:
    """Load an HF export directory -> (params on ``device``, cfg, hf json)."""
    dev = resolve_device(device)
    from safetensors.torch import load_file

    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = voice_config_from_hf(hf_cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    sd: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(model_dir)):
        if fn.endswith(".safetensors"):
            sd.update(load_file(os.path.join(model_dir, fn)))
    params = convert.torch_state_dict_to_params(sd, cfg, DTYPES[cfg.dtype],
                                                dev)
    return params, cfg, hf_cfg


def load_voice_model(model_dir: str, device: DeviceLike = "cuda"):
    """Load a checkpoint directory. Only the HF safetensors layout is
    ported; orbax bundles and reference .pth files come later."""
    if os.path.isdir(model_dir) and any(
            f.endswith(".safetensors") for f in os.listdir(model_dir)):
        return load_hf_dir(model_dir, device)
    raise NotImplementedError(
        f"{model_dir}: only HF safetensors export directories load in the "
        "port so far (orbax bundles and .pth files: ROADMAP Queue 1 item 15)")

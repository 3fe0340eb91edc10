"""Model loading: the port's training bundles, HF-interchange safetensors
directories and reference ``.pth`` training bundles.

Counterpart of ``t5gemma_tts_tpu/inference/loading.py``:

- :func:`load_hf_dir` reads the directory ``export/hf_export.py::export_hf``
  (the port's or the JAX package's) or the reference's HF export writes,
  ``config.json`` + ``*.safetensors`` (through the port's own reader,
  ``utils/safetensors_io.py``), and rebuilds the VoiceConfig from the
  exported fields;
- :func:`load_bundle_dir` reads the port trainer's experiment directory,
  ``config.json`` and ``{best_bundle,bundle,bundle_prev}/state.pt``. A LoRA
  run's bundle holds only adapters and reaches synthesis through the
  export's ``--lora_bundle``; an orbax bundle of the JAX trainer is refused
  and reaches the port through the JAX package's export;
- :func:`load_reference_pth` reads the reference trainer's ``bundle.pth``;
- :func:`load_voice_model` picks one of the three.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import BackboneConfig, ModuleDims, VoiceConfig, backbone_preset
from ..device import DeviceLike, resolve_device, tree_to
from ..models import convert
from ..models.voice import DTYPES
from ..utils.safetensors_io import load_file
from ..utils.tree import leaves_with_path

LORA_BUNDLE_REFUSAL = (
    "{path} holds LoRA adapters only (a LoRA run's bundle): merge them into "
    "their base with `python -m t5gemma_tts_tpu_torch.export.hf_export "
    "--bundle <base exp_dir> --lora_bundle {path} --out <dir>` and load "
    "that directory")


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


def voice_config_from_json(raw: Dict[str, Any]) -> VoiceConfig:
    """The ``config.json`` a trainer writes (``dataclasses.asdict`` of the
    VoiceConfig) -> VoiceConfig."""
    b = raw.get("backbone", {})

    def dims(d):
        d = dict(d)
        d["layer_types"] = tuple(d.get("layer_types") or ())
        if isinstance(d["layer_types"], str):
            d["layer_types"] = tuple(ast.literal_eval(d["layer_types"]))
        return ModuleDims(**d)

    kw = {k: v for k, v in raw.items() if k != "backbone"}
    if isinstance(kw.get("x_sep_token"), str):
        kw["x_sep_token"] = int(kw["x_sep_token"])
    return VoiceConfig(
        backbone=BackboneConfig(encoder=dims(b["encoder"]),
                                decoder=dims(b["decoder"])),
        **kw,
    )


def is_lora_tree(tree: Any) -> bool:
    """Whether ``tree`` is a LoRA adapter tree (leaves ``a`` / ``b``)."""
    return any(p and p[-1] in ("a", "b") for p, _ in leaves_with_path(tree))


def load_bundle_dir(model_dir: str, device: DeviceLike = "cuda"
                    ) -> Tuple[Any, VoiceConfig, Dict[str, Any]]:
    """Load the port trainer's experiment directory (params only): the
    first of ``best_bundle``, ``bundle`` and ``bundle_prev`` there, with
    its params in the dtype they were saved in, on ``device``."""
    from ..train import checkpoint as ckpt

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    cfg = voice_config_from_json(raw)
    for name in (ckpt.BEST_BUNDLE, ckpt.BUNDLE, ckpt.BUNDLE_PREV):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            params = ckpt.read_params(path)
            if is_lora_tree(params):
                raise ValueError(LORA_BUNDLE_REFUSAL.format(path=path))
            return tree_to(params, dev), cfg, raw
    raise FileNotFoundError(f"no bundle under {model_dir}")


def args_to_voice_config(args_ns) -> VoiceConfig:
    """The VoiceConfig of a reference bundle's pickled training args (an
    own copy of ``tools/convert_reference_bundle.py::args_to_voice_config``
    of the JAX package; ``backbone_dims`` gives a backbone outside the
    presets)."""
    get = lambda k, d=None: getattr(args_ns, k, d)  # noqa: E731
    name = str(get("t5gemma_model_name", "google/t5gemma-2b-2b-ul2"))
    preset = "2b-2b" if "2b-2b" in name else (
        "b-b" if "-b-b-" in name else "2b-2b")
    dims = get("backbone_dims")
    if dims:
        md = ModuleDims(**dims)
        backbone = BackboneConfig(encoder=md, decoder=md)
    else:
        backbone = backbone_preset(preset)
    av = get("audio_vocab_size", 65536)
    if isinstance(av, list):
        av = av[0]
    return VoiceConfig(
        backbone=backbone,
        audio_vocab_size=int(av),
        n_special=int(get("n_special", 5)),
        encodec_sr=int(get("encodec_sr", 50)),
        use_pm_rope=bool(get("use_pm_rope", 1)),
        progress_scale=float(get("progress_scale", 2000.0)),
        x_sep_token=get("x_sep_token", 255999),
        add_eos_to_text=int(get("add_eos_to_text", 0) or 0),
        add_bos_to_text=int(get("add_bos_to_text", 0) or 0),
        eog_weight=float(get("eog_weight", 1.0)),
        text_guard_frames_per_token=int(
            get("text_guard_frames_per_token", 0) or 0),
        extra_cutoff=float(get("extra_cutoff", 5.0)),
    )


def read_reference_pth(path: str) -> Tuple[Dict[str, torch.Tensor],
                                           VoiceConfig]:
    """A reference ``bundle.pth`` ({model, optimizer, scheduler, args}
    pickles) -> (its model state dict in float32, its VoiceConfig). The
    file holds a pickled ``argparse.Namespace``, so it is read with
    ``weights_only=False``: load only files you trust."""
    bundle = torch.load(path, map_location="cpu", weights_only=False)
    cfg = args_to_voice_config(bundle.get("args") or argparse.Namespace())
    sd = {k: v.float() for k, v in bundle["model"].items()
          if isinstance(v, torch.Tensor)}
    return sd, cfg


def load_reference_pth(path: str, device: DeviceLike = "cuda"
                       ) -> Tuple[Any, VoiceConfig, Dict[str, Any]]:
    """Load a reference training bundle (peft LoRA keys merged) ->
    (params in the config's dtype on ``device``, cfg, {})."""
    dev = resolve_device(device)
    sd, cfg = read_reference_pth(path)
    params = convert.torch_state_dict_to_params(sd, cfg, DTYPES[cfg.dtype],
                                                dev)
    return params, cfg, {}


def load_voice_model(model_dir: str, device: DeviceLike = "cuda"):
    """Load a checkpoint: a reference ``.pth``/``.pt`` file, an HF
    safetensors directory, or the port trainer's experiment directory."""
    if os.path.isfile(model_dir) and model_dir.endswith((".pth", ".pt")):
        return load_reference_pth(model_dir, device)
    if any(f.endswith(".safetensors") for f in os.listdir(model_dir)):
        return load_hf_dir(model_dir, device)
    return load_bundle_dir(model_dir, device)

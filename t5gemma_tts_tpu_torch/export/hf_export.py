"""Export the port's parameters to the HF interchange format.

Counterpart of ``t5gemma_tts_tpu/export/hf_export.py``: a directory with
``model.safetensors`` + ``config.json`` carrying the tensor names and the
``T5GemmaVoiceConfig`` fields of the reference's export, plus the
``trust_remote_code`` shims (``templates/``, copied, never imported here),
so that :func:`~..inference.loading.load_hf_dir`, the JAX package's loader
and the reference's model class all read it. The files are byte-equal to
the JAX package's export of the same parameters. ``export_peft_adapter``
writes a PEFT adapter directory instead of a merged checkpoint.

Usage: python -m t5gemma_tts_tpu_torch.export.hf_export --bundle <exp_dir> \
           --out <dir> [--lora_bundle <lora exp_dir>/bundle] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..config import VoiceConfig
from ..models import convert
from ..utils.safetensors_io import save_file

TEMPLATES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "templates")
TEMPLATE_FILES = ("configuration_t5gemma_voice.py",
                  "modeling_t5gemma_voice.py")


def _module_config_dict(dims, is_decoder: bool,
                        cross_hidden: int) -> Dict[str, Any]:
    d = {
        "vocab_size": dims.vocab_size,
        "hidden_size": dims.hidden_size,
        "intermediate_size": dims.intermediate_size,
        "num_hidden_layers": dims.num_layers,
        "num_attention_heads": dims.num_heads,
        "num_key_value_heads": dims.num_kv_heads,
        "head_dim": dims.head_dim,
        "rope_theta": dims.rope_theta,
        "rms_norm_eps": dims.rms_norm_eps,
        "attn_logit_softcapping": dims.attn_logit_softcap,
        "final_logit_softcapping": dims.final_logit_softcap,
        "query_pre_attn_scalar": dims.query_pre_attn_scalar,
        "sliding_window": dims.sliding_window,
        "layer_types": list(dims.layer_types),
        "is_decoder": is_decoder,
        "use_cache": True,
    }
    if is_decoder:
        d["cross_attention_hidden_size"] = cross_hidden
    return d


def voice_config_to_hf(cfg: VoiceConfig,
                       xcodec2_model_name: Optional[str] = None,
                       text_tokenizer_name: Optional[str] = None
                       ) -> Dict[str, Any]:
    """VoiceConfig -> the T5GemmaVoiceConfig json."""
    s = cfg.special
    enc = _module_config_dict(cfg.backbone.encoder, False, 0)
    dec = _module_config_dict(cfg.backbone.decoder, True,
                              cfg.backbone.cross_attention_hidden_size)
    return {
        "model_type": "t5gemma_voice",
        "is_encoder_decoder": True,
        "architectures": ["T5GemmaVoiceForConditionalGeneration"],
        "t5_config_dict": {"encoder": enc, "decoder": dec,
                           "is_encoder_decoder": True},
        "t5gemma_model_name": "google/t5gemma-2b-2b-ul2",
        "attn_implementation": "eager",
        "precision": cfg.dtype,
        "prune_text_modules": 2,
        "use_pm_rope": int(cfg.use_pm_rope),
        "n_codebooks": cfg.n_codebooks,
        "audio_vocab_size": cfg.audio_vocab_size,
        "n_special": cfg.n_special,
        "empty_token": s.empty,
        "eog": s.eog,
        "eos": s.eos,
        "audio_pad_token": s.pad,
        "y_sep_token": s.y_sep,
        "x_sep_token": cfg.x_sep_token,
        "special_first": int(cfg.special_first),
        "encodec_sr": float(cfg.encodec_sr),
        "progress_scale": cfg.progress_scale,
        "extra_cutoff": cfg.extra_cutoff,
        "text_guard_frames_per_token": cfg.text_guard_frames_per_token,
        "add_eos_to_text": cfg.add_eos_to_text,
        "add_bos_to_text": cfg.add_bos_to_text,
        "audio_tokenizer": "xcodec2",
        "codec_audio_sr": float(cfg.codec_audio_sr),
        "xcodec2_model_name": xcodec2_model_name,
        "text_tokenizer_name": text_tokenizer_name,
        "bos_token_id": s.empty,
        "eos_token_id": s.eos,
        "pad_token_id": s.pad,
        "auto_map": {
            "AutoConfig": "configuration_t5gemma_voice.T5GemmaVoiceConfig",
            "AutoModelForSeq2SeqLM":
                "modeling_t5gemma_voice.T5GemmaVoiceForConditionalGeneration",
        },
    }


def export_hf(params: Any, cfg: VoiceConfig, out_dir: str,
              dtype: str = "bfloat16", **cfg_kwargs) -> str:
    """Write ``params`` (any device) to ``out_dir``: bfloat16 tensors for
    ``dtype="bfloat16"`` (rounded to nearest even), float32 otherwise."""
    os.makedirs(out_dir, exist_ok=True)
    sd = convert.params_to_torch_state_dict(
        params, dtype=torch.bfloat16 if dtype == "bfloat16"
        else torch.float32)
    save_file(sd, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(voice_config_to_hf(cfg, **cfg_kwargs), f, indent=2)
    for fn in TEMPLATE_FILES:
        shutil.copy(os.path.join(TEMPLATES, fn), os.path.join(out_dir, fn))
    return out_dir


def export_peft_adapter(adapters: Any, lcfg, out_dir: str,
                        base_model_name: str = "") -> str:
    """Write a PEFT adapter directory (``adapter_model.safetensors`` +
    ``adapter_config.json``) from an adapter tree: keys
    ``base_model.model.model.{encoder|decoder}.layers.{i}.{self_attn|
    cross_attn|mlp}.{t}_proj.lora_{A|B}.weight``, A = [r, in] and
    B = [out, r] in float32; peft applies alpha / r at load, as
    ``train/lora.py``'s merge does."""
    os.makedirs(out_dir, exist_ok=True)
    sd = {}
    for side in ("encoder", "decoder"):
        tree = (adapters or {}).get(side)
        layer_tree = (tree or {}).get("layers") if isinstance(tree, dict) \
            else None
        if not layer_tree:
            continue
        for mod in ("self_attn", "cross_attn", "mlp"):
            for tgt, ad in (layer_tree.get(mod) or {}).items():
                if ad is None:
                    continue
                a = ad["a"].detach().float().cpu()
                b = ad["b"].detach().float().cpu()
                for i in range(a.shape[0]):
                    base = (f"base_model.model.model.{side}.layers.{i}."
                            f"{mod}.{tgt}_proj")
                    sd[base + ".lora_A.weight"] = a[i].t().contiguous()
                    sd[base + ".lora_B.weight"] = b[i].t().contiguous()
    if not sd:
        raise ValueError("adapter tree contains no adapters to export")
    save_file(sd, os.path.join(out_dir, "adapter_model.safetensors"))
    config = {
        "peft_type": "LORA",
        "base_model_name_or_path": base_model_name,
        "task_type": None,
        "inference_mode": True,
        "r": lcfg.r,
        "lora_alpha": lcfg.alpha,
        "lora_dropout": 0.05,
        "bias": "none",
        "fan_in_fan_out": False,
        "target_modules": sorted({t + "_proj" for t in lcfg.targets}),
        "modules_to_save": None,
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def read_adapters(path: str) -> Any:
    """The adapter tree of a LoRA run's bundle directory
    (``<exp_dir>/bundle``)."""
    from ..inference.loading import is_lora_tree
    from ..train import checkpoint as ckpt

    adapters = ckpt.read_params(path)
    if not is_lora_tree(adapters):
        raise ValueError(f"{path} holds no LoRA adapters (a full model's "
                         "bundle: pass it as --bundle)")
    return adapters


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m t5gemma_tts_tpu_torch.export.hf_export")
    ap.add_argument("--bundle", required=True,
                    help="the base: a training exp_dir (config.json + "
                         "bundle/)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--lora_bundle", default=None,
                    help="a LoRA run's bundle directory "
                         "(<exp_dir>/bundle), whose adapters are merged "
                         "before export")
    ap.add_argument("--lora_r", type=int, default=16)
    ap.add_argument("--lora_alpha", type=int, default=32)
    ap.add_argument("--save_adapter_dir", default=None,
                    help="also write a PEFT-format adapter directory")
    ap.add_argument("--device", default="cuda",
                    help="where the merge runs: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..inference.loading import load_bundle_dir
    from ..train import lora

    params, cfg, _ = load_bundle_dir(args.bundle, args.device)
    if args.lora_bundle:
        from ..device import resolve_device, tree_to

        adapters = tree_to(read_adapters(args.lora_bundle),
                           resolve_device(args.device))
        lcfg = lora.LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        if args.save_adapter_dir:
            export_peft_adapter(adapters, lcfg, args.save_adapter_dir)
            print(f"saved PEFT adapter to {args.save_adapter_dir}")
        params = lora.merge(params, adapters, lcfg)
        print(f"merged LoRA adapters from {args.lora_bundle}")
    export_hf(params, cfg, args.out, dtype=args.dtype)
    print(f"exported to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

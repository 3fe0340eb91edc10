"""HF/PyTorch state dict -> the port's parameter tree.

Counterpart of ``torch_state_dict_to_params`` in
``t5gemma_tts_tpu/models/convert.py``, for the key layouts the JAX package's
``export/hf_export.py::export_hf`` writes and the reference's HF export
uses (``model.{encoder,decoder}...``, ``audio_embedding.0``,
``predict_layer.0``). ``nn.Linear`` stores [out, in] and the port's kernels
are [in, out], so linears are transposed; layers are stacked on axis 0.
LoRA-wrapped checkpoints are not merged here (export merges them).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping, Optional

import torch

from ..config import VoiceConfig

log = logging.getLogger(__name__)

_DROP_PREFIXES = (
    "lm_head.", "encoder_module.", "decoder_module.",
    "class_weight", "accuracy_metrics",
    "decoder.embed_tokens.",   # pruned text embedding of the decoder
)

_NORM_MAP = {
    "pre_self_attn_layernorm": "pre_self_attn_norm",
    "post_self_attn_layernorm": "post_self_attn_norm",
    "pre_cross_attn_layernorm": "pre_cross_attn_norm",
    "post_cross_attn_layernorm": "post_cross_attn_norm",
    "pre_feedforward_layernorm": "pre_ff_norm",
    "post_feedforward_layernorm": "post_ff_norm",
}


def _strip_prefix(key: str) -> Optional[str]:
    """Normalize any supported naming scheme to ``{encoder|decoder}...`` or
    ``audio_embedding...`` / ``predict_layer...``; None -> dropped."""
    for pre in ("backbone.base_model.model.model.", "backbone.model.",
                "backbone.", "model."):
        if key.startswith(pre):
            key = key[len(pre):]
            break
    if key.startswith("model."):
        key = key[len("model."):]
    for d in _DROP_PREFIXES:
        if key.startswith(d) or f".{d}" in key:
            return None
    if "rotary_emb" in key or key.endswith("inv_freq"):
        return None
    return key


def torch_state_dict_to_params(sd: Mapping[str, torch.Tensor],
                               cfg: VoiceConfig, dtype: torch.dtype,
                               device: torch.device) -> Dict[str, Any]:
    """Build the port's parameter tree from a torch state dict."""
    layers: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {
        "encoder": {}, "decoder": {}}
    flat: Dict[str, torch.Tensor] = {}
    for raw_key, val in sd.items():
        key = _strip_prefix(raw_key)
        if key is None:
            continue
        m = re.match(r"(encoder|decoder)\.layers\.(\d+)\.(.*)", key)
        if m:
            layers[m.group(1)].setdefault(int(m.group(2)), {})[m.group(3)] = val
        else:
            flat[key] = val
    used = set()

    def take(store, key, transpose=False):
        used.add((id(store), key))
        t = store[key]
        return (t.t() if transpose else t).to(device=device, dtype=dtype)

    def stack(side: str, n: int, is_decoder: bool) -> Dict[str, Any]:
        ls = layers[side]
        if len(ls) != n:
            raise ValueError(f"expected {n} {side} layers, found {sorted(ls)}")

        def st(key, transpose=False):
            return torch.stack([take(ls[i], key, transpose) for i in range(n)])

        out: Dict[str, Any] = {
            new: st(f"{old}.weight") for old, new in _NORM_MAP.items()
            if is_decoder or "cross" not in old}
        attns = ("self_attn", "cross_attn") if is_decoder else ("self_attn",)
        for name in attns:
            out[name] = {p: st(f"{name}.{p}_proj.weight", True)
                         for p in ("q", "k", "v", "o")}
        out["mlp"] = {p: st(f"mlp.{p}_proj.weight", True)
                      for p in ("gate", "up", "down")}
        return out

    enc, dec = cfg.backbone.encoder, cfg.backbone.decoder
    params: Dict[str, Any] = {
        "encoder": {"embed": take(flat, "encoder.embed_tokens.weight"),
                    "layers": stack("encoder", enc.num_layers, False),
                    "final_norm": take(flat, "encoder.norm.weight")},
        "decoder": {"layers": stack("decoder", dec.num_layers, True),
                    "final_norm": take(flat, "decoder.norm.weight")},
    }
    if "audio_embedding.0.weight" in flat:
        params["audio_embed"] = take(flat, "audio_embedding.0.weight")
        params["head"] = {
            "w1": take(flat, "predict_layer.0.0.weight", True),
            "b1": take(flat, "predict_layer.0.0.bias"),
            "w2": take(flat, "predict_layer.0.2.weight", True),
            "b2": take(flat, "predict_layer.0.2.bias"),
        }
    else:
        log.warning("state dict has no audio head; backbone-only conversion")
    stores = [flat] + [d for side in layers.values() for d in side.values()]
    left = sum(1 for s in stores for k in s if (id(s), k) not in used)
    if left:
        log.warning("%d state-dict tensors were not consumed", left)
    return params

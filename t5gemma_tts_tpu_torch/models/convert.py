"""HF/PyTorch state dicts <-> the port's parameter tree.

Counterpart of ``t5gemma_tts_tpu/models/convert.py``, for the key layouts
``export/hf_export.py::export_hf`` writes, the reference's HF export uses
(``model.{encoder,decoder}...``, ``audio_embedding.0``,
``predict_layer.0``) and the reference's training bundle uses
(``backbone.model...``, peft LoRA keys merged on the fly).
``nn.Linear`` stores [out, in] and the port's kernels are [in, out], so
linears are transposed; layers are stacked on axis 0.
:func:`params_to_torch_state_dict` is the inverse, for export.
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


def _merge_lora(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge peft LoRA keys (``*.lora_A/B[.default].weight``, the base at
    ``*.base_layer.weight``) into plain weights, in float32.

    As the JAX function does, the merge is ``W + 2.0 * B @ A``: raw peft
    adapters carry no alpha here, so this assumes alpha == 2r (the
    reference's merge_and_unload folds alpha / r in its own export). An
    adapter missing its A or its B is dropped."""
    if not any("lora_A" in k for k in sd):
        return dict(sd)
    out: Dict[str, torch.Tensor] = {}
    loras: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = re.match(r"(.*)\.lora_(A|B)(?:\.default)?\.weight$", k)
        if m:
            loras.setdefault(m.group(1), {})[m.group(2)] = v
            continue
        out[k.replace(".base_layer.weight", ".weight")] = v
    for base, ab in loras.items():
        if "A" not in ab or "B" not in ab:
            continue
        wkey = base + ".weight"
        if wkey in out:
            out[wkey] = out[wkey].float() + 2.0 * (ab["B"].float()
                                                   @ ab["A"].float())
    return out


def torch_state_dict_to_params(sd: Mapping[str, torch.Tensor],
                               cfg: VoiceConfig, dtype: torch.dtype,
                               device: torch.device, strict: bool = False
                               ) -> Dict[str, Any]:
    """Build the port's parameter tree from a torch state dict.

    Every tensor must be read by the conversion or match a prunable
    pattern (lm_head, the tied text embeddings, rotary buffers); the
    leftovers are logged, or raised with ``strict``. Asking whether a key
    is present does not count as reading it."""
    sd = _merge_lora(sd)
    layers: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {
        "encoder": {}, "decoder": {}}
    flat: Dict[str, torch.Tensor] = {}
    locations: Dict[str, tuple] = {}
    for raw_key, val in sd.items():
        key = _strip_prefix(raw_key)
        if key is None:
            continue
        m = re.match(r"(encoder|decoder)\.layers\.(\d+)\.(.*)", key)
        if m:
            store = layers[m.group(1)].setdefault(int(m.group(2)), {})
            key = m.group(3)
        else:
            store = flat
        store[key] = val
        locations[raw_key] = (id(store), key)
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
    leftovers = sorted(raw for raw, loc in locations.items()
                       if loc not in used)
    if leftovers:
        msg = (f"{len(leftovers)} state-dict tensors were not consumed by "
               f"the conversion (first few: {leftovers[:8]})")
        if strict:
            raise ValueError(msg)
        log.warning(msg)
    return params


def _host(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.detach().to(dtype).contiguous().cpu()


def params_to_torch_state_dict(params: Dict[str, Any], prefix: str = "model.",
                               dtype: torch.dtype = torch.float32
                               ) -> Dict[str, torch.Tensor]:
    """The inverse conversion, for export: C-contiguous CPU tensors in
    ``dtype`` (float32 as the JAX function writes; the cast from a
    float32 leaf rounds to nearest even, as ``ml_dtypes`` does), linears
    back to [out, in], layers unstacked, under the HF export's names."""
    sd: Dict[str, torch.Tensor] = {}
    inv_norm = {v: k for k, v in _NORM_MAP.items()}

    def unstack(side: str, layers: Dict[str, Any]):
        n = layers["pre_self_attn_norm"].shape[0]
        for i in range(n):
            base = f"{prefix}{side}.layers.{i}."
            for new, arr in layers.items():
                if new in inv_norm:
                    sd[base + inv_norm[new] + ".weight"] = _host(arr[i],
                                                                 dtype)
            for name in ("self_attn", "cross_attn"):
                if name not in layers:
                    continue
                for p in ("q", "k", "v", "o"):
                    sd[base + f"{name}.{p}_proj.weight"] = _host(
                        layers[name][p][i].t(), dtype)
            for p in ("gate", "up", "down"):
                sd[base + f"mlp.{p}_proj.weight"] = _host(
                    layers["mlp"][p][i].t(), dtype)

    unstack("encoder", params["encoder"]["layers"])
    unstack("decoder", params["decoder"]["layers"])
    sd[f"{prefix}encoder.embed_tokens.weight"] = _host(
        params["encoder"]["embed"], dtype)
    sd[f"{prefix}encoder.norm.weight"] = _host(
        params["encoder"]["final_norm"], dtype)
    sd[f"{prefix}decoder.norm.weight"] = _host(
        params["decoder"]["final_norm"], dtype)
    if "audio_embed" in params:
        head = params["head"]
        sd["audio_embedding.0.weight"] = _host(params["audio_embed"], dtype)
        sd["predict_layer.0.0.weight"] = _host(head["w1"].t(), dtype)
        sd["predict_layer.0.0.bias"] = _host(head["b1"], dtype)
        sd["predict_layer.0.2.weight"] = _host(head["w2"].t(), dtype)
        sd["predict_layer.0.2.bias"] = _host(head["b2"], dtype)
    return sd

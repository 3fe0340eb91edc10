"""HF Whisper state dict -> the port's Whisper parameter tree
(key-exhaustive).

Counterpart of ``t5gemma_tts_tpu/asr/convert.py``: reads a
``WhisperForConditionalGeneration`` (or bare ``WhisperModel``) state dict of
numpy arrays or tensors and builds ``asr/model.py``'s tree, in f32 on a
device: linears [in, out], convolutions [K, Cin, Cout], layers stacked on
a leading axis. Every tensor must be read, or be the ``proj_out.weight``
tied to the token embedding; a missing tensor raises ``KeyError`` and
leftovers raise ``ValueError`` with their names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .model import WhisperConfig

KNOWN_TIED = ("proj_out.weight",)          # tied to decoder.embed_tokens


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def whisper_state_dict_to_params(sd: Mapping[str, Any], cfg: WhisperConfig,
                                 device: DeviceLike = "cuda"
                                 ) -> Dict[str, Any]:
    dev = resolve_device(device)
    flat = {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in sd.items()}
    used = set()

    def take(key):
        if key not in flat:
            raise KeyError(f"whisper conversion: missing tensor {key!r}")
        used.add(key)
        return _np(flat[key])

    def lin_w(key):
        return take(key).T

    def attn(p):
        return {"q_w": lin_w(p + ".q_proj.weight"),
                "q_b": take(p + ".q_proj.bias"),
                "k_w": lin_w(p + ".k_proj.weight"),
                "v_w": lin_w(p + ".v_proj.weight"),
                "v_b": take(p + ".v_proj.bias"),
                "o_w": lin_w(p + ".out_proj.weight"),
                "o_b": take(p + ".out_proj.bias")}

    def lnp(p):
        return {"g": take(p + ".weight"), "b": take(p + ".bias")}

    def mlp(p):
        return {"fc1_w": lin_w(p + ".fc1.weight"),
                "fc1_b": take(p + ".fc1.bias"),
                "fc2_w": lin_w(p + ".fc2.weight"),
                "fc2_b": take(p + ".fc2.bias")}

    def enc_layer(i):
        p = f"encoder.layers.{i}"
        return {"ln1": lnp(p + ".self_attn_layer_norm"),
                "attn": attn(p + ".self_attn"),
                "ln2": lnp(p + ".final_layer_norm"), "mlp": mlp(p)}

    def dec_layer(i):
        p = f"decoder.layers.{i}"
        return {"ln1": lnp(p + ".self_attn_layer_norm"),
                "self_attn": attn(p + ".self_attn"),
                "ln2": lnp(p + ".encoder_attn_layer_norm"),
                "cross_attn": attn(p + ".encoder_attn"),
                "ln3": lnp(p + ".final_layer_norm"), "mlp": mlp(p)}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def conv(p):   # torch [out, in, k] -> [k, in, out]
        return {"w": take(p + ".weight").transpose(2, 1, 0),
                "b": take(p + ".bias")}

    tree = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "conv2": conv("encoder.conv2"),
            "pos": take("encoder.embed_positions.weight"),
            "layers": stack([enc_layer(i)
                             for i in range(cfg.encoder_layers)]),
            "ln_post": lnp("encoder.layer_norm"),
        },
        "decoder": {
            "embed": take("decoder.embed_tokens.weight"),
            "pos": take("decoder.embed_positions.weight"),
            "layers": stack([dec_layer(i)
                             for i in range(cfg.decoder_layers)]),
            "ln_post": lnp("decoder.layer_norm"),
        },
    }
    leftovers = sorted(set(flat) - used - set(KNOWN_TIED))
    if leftovers:
        raise ValueError(
            "whisper conversion left unconsumed tensors (layout mismatch): "
            + ", ".join(leftovers[:12])
            + ("..." if len(leftovers) > 12 else ""))

    def to_device(t):
        if isinstance(t, dict):
            return {k: to_device(v) for k, v in t.items()}
        return torch.from_numpy(np.ascontiguousarray(t)).to(dev)

    return to_device(tree)

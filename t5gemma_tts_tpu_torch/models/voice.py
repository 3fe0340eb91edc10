"""T5GemmaVoice: backbone + audio embedding + prediction head, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/models/voice.py`` (the inference half):
:func:`init_params`, :func:`embed_audio`, :func:`encode_text` and
:func:`predict_head` (a 2-layer head with exact erf GELU, unlike the
backbone MLP's tanh GELU).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import VoiceConfig
from ..device import DeviceLike, resolve_device
from ..ops import masks as mask_ops
from ..ops import rope as rope_ops
from ..ops.quant import q_matmul
from . import t5gemma

PyTree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: VoiceConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def init_params(seed: int, cfg: VoiceConfig,
                device: DeviceLike = "cuda") -> PyTree:
    """Seeded random parameters, generated on ``device`` (a full-size model
    never passes through host memory)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = compute_dtype(cfg)
    d = cfg.backbone.hidden_size
    va = cfg.audio_embedding_vocab

    def normal(*shape):
        return t5gemma._normal(gen, shape, dtype, dev)

    return {
        "encoder": t5gemma.init_stack(
            gen, cfg.backbone.encoder, is_decoder=False, with_embed=True,
            dtype=dtype, device=dev),
        "decoder": t5gemma.init_stack(
            gen, cfg.backbone.decoder, is_decoder=True, with_embed=False,
            dtype=dtype, device=dev,
            cross_hidden=cfg.backbone.cross_attention_hidden_size),
        "audio_embed": normal(va, d),
        "head": {
            "w1": normal(d, d),
            "b1": torch.zeros((d,), dtype=dtype, device=dev),
            "w2": normal(d, va),
            "b2": torch.zeros((va,), dtype=dtype, device=dev),
        },
    }


def predict_head(head: Dict[str, torch.Tensor],
                 hidden: torch.Tensor) -> torch.Tensor:
    """2-layer head with exact (erf) GELU -> audio-token logits; ``w1`` and
    ``w2`` may be W8A8 ``QuantWeight`` leaves, ``w2`` an ``Int4Weight``."""
    h = F.gelu(q_matmul(hidden, head["w1"]) + head["b1"])
    return q_matmul(h, head["w2"]) + head["b2"]


def embed_audio(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), params["audio_embed"])


def encode_text(params: PyTree, cfg: VoiceConfig, x: torch.Tensor,
                x_lens: torch.Tensor):
    """Run the text encoder -> (memory [B, Tx, D], encoder PM positions)."""
    dims = cfg.backbone.encoder
    tx = x.shape[1]
    if cfg.use_pm_rope:
        enc_pos = rope_ops.progress_position_ids(x_lens, tx, cfg.progress_scale)
    else:
        enc_pos = torch.arange(tx, dtype=torch.float32,
                               device=x.device)[None].expand(x.shape[0], tx)
    memory = t5gemma.encoder_forward(
        params["encoder"], dims, input_ids=x,
        full_bias=mask_ops.encoder_self_bias(x_lens, tx),
        sliding_bias=mask_ops.encoder_sliding_bias(x_lens, tx,
                                                   dims.sliding_window),
        position_ids=enc_pos,
    )
    return memory, enc_pos

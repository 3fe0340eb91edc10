"""XCodec2 token decode (vocoder) path, in PyTorch.

Counterpart of the decode half of ``t5gemma_tts_tpu/codec/model.py``:
codes [B, T] -> FSQ.project_out -> fc_post_a -> Vocos backbone -> ISTFT ->
waveform at 44.1 kHz. The encode path (voice cloning) comes with a later
slice, so this config holds only the fields the decoder reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import fsq as fsq_mod
from . import vocos as vocos_mod
from .fsq import FSQConfig
from .vocos import VocosConfig

PyTree = Any


@dataclass(frozen=True)
class XCodec2Config:
    fsq: FSQConfig = field(default_factory=FSQConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    sample_rate: int = 44100        # output (Anime-XCodec2-44.1kHz)
    encode_sample_rate: int = 16000  # codec encoders consume 16 kHz
    frame_rate: int = 50

    @property
    def hop_length(self) -> int:
        return self.vocos.hop_length


def tiny_codec_config() -> XCodec2Config:
    """Toy sizes, real structure (the decode fields of the JAX package's
    ``tiny_codec_config``) — for tests."""
    return XCodec2Config(
        fsq=FSQConfig(levels=(4, 4, 4), dim=32),
        vocos=VocosConfig(input_dim=16, dim=24, intermediate_dim=48,
                          num_layers=2, n_fft=32, hop_length=10),
        sample_rate=500,
        encode_sample_rate=200,
        frame_rate=50,
    )


def init_decoder_params(seed: int, cfg: XCodec2Config,
                        device: DeviceLike = "cuda",
                        dtype=torch.float32) -> PyTree:
    """Seeded random decoder parameters, generated on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((cfg.fsq.dim, cfg.vocos.input_dim), generator=gen,
                    device=dev) * cfg.fsq.dim ** -0.5
    return {
        "fsq": fsq_mod.init_params(gen, cfg.fsq, dtype, dev),
        "fc_post_a": {"w": w.to(dtype),
                      "b": torch.zeros((cfg.vocos.input_dim,), dtype=dtype,
                                       device=dev)},
        "vocos": vocos_mod.init_params(gen, cfg.vocos, dtype, dev),
    }


def decode_code(params: PyTree, cfg: XCodec2Config, codes: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes int [B, T] -> waveform [B, T * hop]; ``lengths`` makes a
    length-padded decode exact (see vocos.backbone)."""
    emb = fsq_mod.decode(params["fsq"], cfg.fsq, codes)
    feats = emb @ params["fc_post_a"]["w"] + params["fc_post_a"]["b"]
    return vocos_mod.vocode(params["vocos"], feats, cfg.vocos, lengths)

"""XCodec2 model assembly, in PyTorch: token decode (vocoder) and audio
encode.

Counterpart of ``t5gemma_tts_tpu/codec/model.py``.

Decode: codes [B, T] -> FSQ.project_out -> fc_post_a -> Vocos backbone ->
ISTFT -> waveform at 44.1 kHz.

Encode (voice cloning): wav at 16 kHz -> { semantic: mel -> w2v-BERT
conformer -> SemanticEncoder, acoustic: CodecEncoder conv stack } -> concat
-> fc_prior -> FSQ -> codes (``encoder.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import encoder as enc_mod
from . import fsq as fsq_mod
from . import vocos as vocos_mod
from .encoder import (AcousticEncoderConfig, SemanticEncoderConfig,
                      tiny_encoder_configs)
from .fsq import FSQConfig
from .semantic import ConformerConfig
from .vocos import VocosConfig

PyTree = Any


@dataclass(frozen=True)
class XCodec2Config:
    fsq: FSQConfig = field(default_factory=FSQConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    acoustic_cfg: AcousticEncoderConfig = field(
        default_factory=AcousticEncoderConfig)
    semantic_cfg: SemanticEncoderConfig = field(
        default_factory=SemanticEncoderConfig)
    conformer_cfg: ConformerConfig = field(default_factory=ConformerConfig)
    sample_rate: int = 44100        # output (Anime-XCodec2-44.1kHz)
    encode_sample_rate: int = 16000  # codec encoders consume 16 kHz
    frame_rate: int = 50
    semantic_dim: int = 1024
    acoustic_dim: int = 1024
    fused_dim: int = 2048           # semantic_dim + acoustic_dim

    @property
    def hop_length(self) -> int:
        return self.vocos.hop_length


def tiny_codec_config() -> XCodec2Config:
    """Toy sizes, real structure (the JAX package's ``tiny_codec_config``)
    — for tests."""
    acfg, scfg, ccfg = tiny_encoder_configs()
    return XCodec2Config(
        fsq=FSQConfig(levels=(4, 4, 4), dim=32),
        vocos=VocosConfig(input_dim=16, dim=24, intermediate_dim=48,
                          num_layers=2, n_fft=32, hop_length=10),
        acoustic_cfg=acfg,
        semantic_cfg=scfg,
        conformer_cfg=ccfg,
        semantic_dim=16,
        acoustic_dim=16,
        fused_dim=32,
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


def init_encoder_params_for(seed: int, cfg: XCodec2Config,
                            device: DeviceLike = "cuda",
                            dtype=torch.float32) -> PyTree:
    """Seeded random encoder parameters (acoustic, semantic_model,
    semantic_encoder, fc_prior), generated on ``device``; merge them into
    decoder parameters to encode."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return enc_mod.init_encoder_params(gen, cfg.acoustic_cfg,
                                       cfg.semantic_cfg, cfg.conformer_cfg,
                                       cfg.fused_dim, dtype, dev)


def encode_prior(params: PyTree, cfg: XCodec2Config, wav: torch.Tensor,
                 wav_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav [B, S] at ``encode_sample_rate`` -> the quantizer's input
    ``fc_prior(fused features)``, [B, T, fused_dim]."""
    fused = enc_mod.fuse_features(params, cfg, wav, wav_lens)
    return fused @ params["fc_prior"]["w"] + params["fc_prior"]["b"]


def encode_waveform(params: PyTree, cfg: XCodec2Config, wav: torch.Tensor,
                    wav_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav [B, S] at ``encode_sample_rate`` -> codes [B, T] (int64). Needs
    the encoder parameters as well as the FSQ's."""
    prior = encode_prior(params, cfg, wav, wav_lens)
    return fsq_mod.encode(params["fsq"], cfg.fsq, prior)[1]

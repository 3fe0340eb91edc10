"""A configuration file's sizes as the port's config objects. The file keeps
the published model's own keys (T5's ``d_model``, ``d_ff``, ``d_kv``,
``num_heads``, ...), the TTS recipe around the backbone under ``tts``, and
the vocoder's widths under ``codec``; this is the one place that maps them
onto the port's dataclasses, which it imports only when called."""

from __future__ import annotations

from typing import Any, Dict


def voice_config(config: Dict[str, Any]):
    from t5gemma_tts_tpu_torch.config import (BackboneConfig, ModuleDims,
                                              VoiceConfig)

    t = config["tts"]
    heads = int(config["num_heads"])

    def dims(layers: int) -> ModuleDims:
        return ModuleDims(
            vocab_size=int(config["vocab_size"]),
            hidden_size=int(config["d_model"]),
            intermediate_size=int(config["d_ff"]),
            num_layers=layers, num_heads=heads,
            num_kv_heads=int(config.get("num_key_value_heads", heads)),
            head_dim=int(config["d_kv"]),
            rope_theta=float(t["rope_theta"]),
            rms_norm_eps=float(config["layer_norm_epsilon"]),
            attn_logit_softcap=None, final_logit_softcap=None,
            query_pre_attn_scalar=float(t["query_pre_attn_scalar"]),
            sliding_window=int(t["sliding_window"]),
            layer_types=("full_attention",) * layers)

    return VoiceConfig(
        backbone=BackboneConfig(encoder=dims(int(config["num_layers"])),
                                decoder=dims(int(config["num_decoder_layers"]))),
        audio_vocab_size=int(t["audio_vocab_size"]),
        encodec_sr=int(t["frames_per_s"]),
        codec_audio_sr=int(config["codec"]["sample_rate"]),
        use_pm_rope=True, progress_scale=float(t["progress_scale"]),
        text_vocab_size=int(config["vocab_size"]),
        x_sep_token=int(config["vocab_size"]) - 1,
        extra_cutoff=float(t["extra_cutoff"]), dtype=t["dtype"])


def codec_config(config: Dict[str, Any]):
    from t5gemma_tts_tpu_torch.codec.fsq import FSQConfig
    from t5gemma_tts_tpu_torch.codec.model import XCodec2Config
    from t5gemma_tts_tpu_torch.codec.vocos import VocosConfig

    c = config["codec"]
    return XCodec2Config(
        fsq=FSQConfig(levels=tuple(int(x) for x in c["fsq_levels"]),
                      dim=int(c["fsq_dim"])),
        vocos=VocosConfig(input_dim=int(c["vocos_input_dim"]),
                          dim=int(c["vocos_dim"]),
                          intermediate_dim=int(c["vocos_intermediate_dim"]),
                          num_layers=int(c["vocos_layers"]),
                          kernel_size=int(c["vocos_kernel"]),
                          n_fft=int(c["n_fft"]),
                          hop_length=int(c["hop_length"]),
                          eps=float(c["layer_norm_eps"])),
        sample_rate=int(c["sample_rate"]),
        frame_rate=int(config["tts"]["frames_per_s"]),
        fused_dim=int(c["fsq_dim"]))


def char_tokenizer(vocab: int):
    """Text to ids, one a character, into the model's text vocabulary (no
    SentencePiece model is in the repository): ``chip_smoke``'s rule."""
    def encode(text: str):
        return [3 + (ord(c) % (vocab - 10)) for c in text]
    return encode

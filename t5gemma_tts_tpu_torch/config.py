"""Typed configuration (an own copy of the JAX package's ``config.py``).

The port keeps its own copy of the dataclasses it needs so that it imports
nothing of ``t5gemma_tts_tpu``. Field names, defaults and the special-token
derivation match the JAX package exactly, so configs and checkpoints
interoperate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Backbone (T5Gemma module) dimensions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModuleDims:
    """Dimensions of one T5Gemma stack (encoder or decoder).

    Field semantics follow the HF T5GemmaModuleConfig the reference backbone is
    built from (reference: models/t5gemma.py:288 loads
    ``google/t5gemma-2b-2b-ul2``); values here describe the architecture only —
    the implementation is independent.
    """

    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096
    # layer i uses sliding attention iff (i+1) % 2 == 1 (odd 1-indexed layers),
    # i.e. pattern [sliding, full, sliding, full, ...].
    layer_types: Tuple[str, ...] = ()
    dropout_rate: float = 0.0
    attention_dropout: float = 0.0
    # "gelu_pytorch_tanh" is the only activation used by T5Gemma checkpoints.
    hidden_activation: str = "gelu_pytorch_tanh"

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(
                self,
                "layer_types",
                tuple(
                    "sliding_attention" if (i + 1) % 2 else "full_attention"
                    for i in range(self.num_layers)
                ),
            )
        if len(self.layer_types) != self.num_layers:
            raise ValueError("layer_types length must equal num_layers")

    @property
    def q_scale(self) -> float:
        return self.query_pre_attn_scalar ** -0.5

    @property
    def sliding_flags(self) -> Tuple[bool, ...]:
        return tuple(t == "sliding_attention" for t in self.layer_types)


@dataclass(frozen=True)
class BackboneConfig:
    """Encoder-decoder pair. For t5gemma-2b-2b both stacks share dims."""

    encoder: ModuleDims = field(default_factory=ModuleDims)
    decoder: ModuleDims = field(default_factory=ModuleDims)

    @property
    def hidden_size(self) -> int:
        return self.decoder.hidden_size

    @property
    def cross_attention_hidden_size(self) -> int:
        return self.encoder.hidden_size


def backbone_preset(name: str) -> BackboneConfig:
    """Named architecture presets.

    ``2b-2b`` matches google/t5gemma-2b-2b-ul2 (Gemma2-2B dims on both sides),
    the checkpoint the reference trains from (reference: config.py:83,
    examples/training/t5gemma_2b-2b.sh).
    """
    presets = {
        "2b-2b": ModuleDims(),
        # approximate dims for google/t5gemma-b-b (not verifiable in a
        # zero-egress build); the 2b-2b preset is the recipe flagship
        "b-b": ModuleDims(
            hidden_size=768,
            intermediate_size=6144,
            num_layers=12,
            num_heads=12,
            num_kv_heads=4,
            head_dim=64,
            query_pre_attn_scalar=64.0,
        ),
        # Tiny config for tests: real structure, toy sizes.
        "test": ModuleDims(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            query_pre_attn_scalar=16.0,
            sliding_window=8,
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown backbone preset {name!r}; have {sorted(presets)}")
    dims = presets[name]
    return BackboneConfig(encoder=dims, decoder=dims)


# ---------------------------------------------------------------------------
# Voice model / task configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpecialTokens:
    """Audio special-token ids derived from the codec vocabulary size.

    Derivation matches reference config.py:220-231 (``apply_repo_defaults``):
    empty = V, eog = V+1, pad = V+2, eos = V+3, y_sep = V+4.
    """

    empty: int
    eog: int
    pad: int
    eos: int
    y_sep: int

    @staticmethod
    def from_vocab(audio_vocab_size: int) -> "SpecialTokens":
        v = audio_vocab_size
        return SpecialTokens(empty=v, eog=v + 1, pad=v + 2, eos=v + 3, y_sep=v + 4)


@dataclass(frozen=True)
class VoiceConfig:
    """Task-level configuration of the TTS voice model.

    Mirrors the subset of the ~110 reference flags that shape model behavior
    (reference: config.py:47-207). Data-pipeline and trainer knobs live in
    their own configs.
    """

    backbone: BackboneConfig = field(default_factory=lambda: backbone_preset("2b-2b"))
    audio_vocab_size: int = 65536
    n_special: int = 5
    n_codebooks: int = 1  # XCodec2 is single-codebook (reference config.py:221)
    # codec rates (reference config.py:229-231)
    codec_audio_sr: int = 44100
    encodec_sr: int = 50  # codec frame rate, tokens/sec of audio
    # PM-RoPE (reference config.py:190-191, t5gemma_2b-2b.sh uses 2000)
    use_pm_rope: bool = True
    progress_scale: float = 2000.0
    # text side
    text_vocab_size: int = 256000
    x_sep_token: Optional[int] = 255999
    add_eos_to_text: int = 0
    add_bos_to_text: int = 0
    # training-loss knobs
    eog_weight: float = 1.0
    no_loss_on_prefix: bool = True
    special_first: bool = False
    # inference guards (reference config.py:111-114, 201)
    text_guard_frames_per_token: int = 0
    extra_cutoff: float = 5.0
    # dtype of parameters/activations ("bfloat16" | "float32")
    dtype: str = "bfloat16"
    # rematerialize layers in backward (reference --t5_gradient_checkpointing,
    # config.py:84); training-path only, decode paths ignore it
    gradient_checkpointing: bool = False
    # training CE in vocab blocks of this many columns, never materializing
    # the [B, T, 65541] logits tensor (ops/chunked_ce.py); 0 = dense path.
    # Only engages when the vocab exceeds the chunk, so tiny test configs
    # keep the dense path unless they opt in.
    ce_vocab_chunk: int = 8192

    def __post_init__(self):
        if self.n_codebooks != 1:
            raise ValueError("XCodec2 path supports n_codebooks=1 only")

    @property
    def special(self) -> SpecialTokens:
        return SpecialTokens.from_vocab(self.audio_vocab_size)

    @property
    def audio_embedding_vocab(self) -> int:
        """Rows in the audio embedding / prediction head: V + n_special."""
        return self.audio_vocab_size + self.n_special

    @property
    def eog_inference(self) -> int:
        """Token that terminates inference: eos when defined, else eog.

        (reference: models/t5gemma.py:861-863)
        """
        s = self.special
        return s.eos if s.eos > 0 else s.eog


@dataclass(frozen=True)
class DecodeConfig:
    """Sampling/stopping parameters for autoregressive decode.

    Defaults match the reference HF CLI defaults
    (reference: inference_commandline_hf.py:80-89).
    """

    top_k: int = 30
    top_p: float = 0.9
    min_p: float = 0.0
    temperature: float = 0.8
    stop_repetition: int = 3
    silence_tokens: Tuple[int, ...] = ()
    # static decode-buffer length in codec frames; bucketing keeps recompiles rare
    max_frames: int = 2048
    seed: int = 1
    # KV cache strategy for the AR decode loop:
    #   "auto"     — paged cache on CUDA when it fits the sliding window,
    #                dense elsewhere
    #   "dense"    — pre-allocated dense cache, full-extent reads every step
    #   "paged"    — paged decode attention (CUDA kernel), bf16 pages
    #   "paged_i8" — paged with int8 pages + per-token scales
    #   "paged_f8" — paged with float8 e4m3 pages (no scales)
    kv_cache: str = "auto"
    # approximate top-k candidate fetch: accepted for flag compatibility;
    # the port always takes the exact top-k
    approx_top_k: bool = False


def tiny_voice_config(**overrides) -> VoiceConfig:
    """Tiny VoiceConfig wired to the 'test' backbone preset."""
    kw = dict(
        backbone=backbone_preset("test"),
        audio_vocab_size=128,
        text_vocab_size=512,
        x_sep_token=511,
        dtype="float32",
    )
    kw.update(overrides)
    return VoiceConfig(**kw)

"""HF configuration for exported T5Gemma-TTS voice models.

Shipped into every export directory so ``trust_remote_code=True`` loading is
self-contained. Field names follow the interchange contract of the
t5gemma_tts_tpu exporter (export/hf_export.py::voice_config_to_hf); special
audio tokens derive from ``audio_vocab_size`` exactly as in training
(empty=V, eog=V+1, pad=V+2, eos=V+3, y_sep=V+4).
"""

from transformers import PretrainedConfig


class T5GemmaVoiceConfig(PretrainedConfig):
    model_type = "t5gemma_voice"

    def __init__(
        self,
        t5_config_dict=None,
        t5gemma_model_name="google/t5gemma-2b-2b-ul2",
        attn_implementation="eager",
        precision="bfloat16",
        prune_text_modules=2,
        use_pm_rope=1,
        n_codebooks=1,
        audio_vocab_size=65536,
        n_special=5,
        empty_token=65536,
        eog=65537,
        eos=65539,
        audio_pad_token=65538,
        y_sep_token=65540,
        x_sep_token=255999,
        special_first=0,
        encodec_sr=50.0,
        progress_scale=2000.0,
        extra_cutoff=5.0,
        text_guard_frames_per_token=0,
        add_eos_to_text=0,
        add_bos_to_text=0,
        audio_tokenizer="xcodec2",
        codec_audio_sr=44100.0,
        xcodec2_model_name=None,
        text_tokenizer_name=None,
        **kwargs,
    ):
        self.t5_config_dict = t5_config_dict or {}
        self.t5gemma_model_name = t5gemma_model_name
        self.attn_implementation = attn_implementation
        self.precision = precision
        self.prune_text_modules = prune_text_modules
        self.use_pm_rope = use_pm_rope
        self.n_codebooks = n_codebooks
        self.audio_vocab_size = audio_vocab_size
        self.n_special = n_special
        self.empty_token = empty_token
        self.eog = eog
        self.eos = eos
        self.audio_pad_token = audio_pad_token
        self.y_sep_token = y_sep_token
        self.x_sep_token = x_sep_token
        self.special_first = special_first
        self.encodec_sr = encodec_sr
        self.progress_scale = progress_scale
        self.extra_cutoff = extra_cutoff
        self.text_guard_frames_per_token = text_guard_frames_per_token
        self.add_eos_to_text = add_eos_to_text
        self.add_bos_to_text = add_bos_to_text
        self.audio_tokenizer = audio_tokenizer
        self.codec_audio_sr = codec_audio_sr
        self.xcodec2_model_name = xcodec2_model_name
        self.text_tokenizer_name = text_tokenizer_name
        kwargs.setdefault("is_encoder_decoder", True)
        super().__init__(**kwargs)

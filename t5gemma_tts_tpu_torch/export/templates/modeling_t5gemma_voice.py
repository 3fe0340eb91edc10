"""Self-contained torch model for exported T5Gemma-TTS voice checkpoints.

Shipped into every export directory so consumers can
``AutoModelForSeq2SeqLM.from_pretrained(dir, trust_remote_code=True)`` with
nothing but torch + transformers installed. The implementation mirrors the
TPU framework's functional JAX stack (t5gemma_tts_tpu/models/t5gemma.py and
decode/engine.py): the HF ``T5GemmaEncoder`` is reused as-is for the text
side, while the audio decoder — PM-RoPE cross-attention is a first-class
module here, no layer patching — and the sampling/stop-rule loop are
implemented below. Parameter names match the exporter's safetensors layout
(model.{encoder,decoder}.layers.N..., audio_embedding.0, predict_layer.0.*).
"""

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from transformers import PreTrainedModel
from transformers.models.t5gemma.configuration_t5gemma import (
    T5GemmaConfig,
    T5GemmaModuleConfig,
)
from transformers.models.t5gemma.modeling_t5gemma import T5GemmaEncoder

from .configuration_t5gemma_voice import T5GemmaVoiceConfig

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# primitives (semantics pinned by the JAX implementation's parity tests)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """Rotary tables for float (PM progress) positions. [B,T] -> [B,T,hd]."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv  # [B, T, half]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B,H,T,hd]; cos/sin [B,T,hd]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[:, None] + rot.float() * sin[:, None]).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def gqa_attention(q, k, v, bias, scale: float, softcap: Optional[float]):
    """q [B,H,Tq,hd], k/v [B,Hkv,Tk,hd], bias [B,1,Tq,Tk] additive."""
    b, h, tq, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, tq, hd).float()
    logits = torch.einsum("bkgth,bksh->bkgts", qg, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + bias[:, :, None].float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksh->bkgth", weights, v)
    return out.reshape(b, h, tq, hd)


def _split_heads(x, n_heads, head_dim):
    b, t, _ = x.shape
    return x.view(b, t, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------------------
# decoder modules
# ---------------------------------------------------------------------------


class VoiceSelfAttention(nn.Module):
    def __init__(self, cfg: T5GemmaModuleConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd, bias=False)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, bias=False)
        self.cfg = cfg

    def forward(self, x, cos, sin, bias, kv_cache: Optional[list] = None):
        c = self.cfg
        q = _split_heads(self.q_proj(x), c.num_attention_heads, c.head_dim)
        k = _split_heads(self.k_proj(x), c.num_key_value_heads, c.head_dim)
        v = _split_heads(self.v_proj(x), c.num_key_value_heads, c.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if kv_cache is not None:
            if kv_cache:
                k = torch.cat([kv_cache[0], k], dim=2)
                v = torch.cat([kv_cache[1], v], dim=2)
            kv_cache[:] = [k, v]
        out = gqa_attention(q, k, v, bias, c.query_pre_attn_scalar ** -0.5,
                            c.attn_logit_softcapping)
        return self.o_proj(_merge_heads(out))


class VoiceCrossAttention(nn.Module):
    """PM-RoPE cross-attention: rotary (progress positions) on the decoder
    query; encoder keys are rotated once at memory-KV precompute."""

    def __init__(self, cfg: T5GemmaModuleConfig, cross_hidden: int):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(cross_hidden, cfg.num_key_value_heads * hd,
                                bias=False)
        self.v_proj = nn.Linear(cross_hidden, cfg.num_key_value_heads * hd,
                                bias=False)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, bias=False)
        self.cfg = cfg

    def build_kv(self, memory, enc_cos=None, enc_sin=None):
        c = self.cfg
        k = _split_heads(self.k_proj(memory), c.num_key_value_heads, c.head_dim)
        v = _split_heads(self.v_proj(memory), c.num_key_value_heads, c.head_dim)
        if enc_cos is not None:
            k = apply_rope(k, enc_cos, enc_sin)
        return k, v

    def forward(self, x, kv, bias, q_cos=None, q_sin=None):
        c = self.cfg
        q = _split_heads(self.q_proj(x), c.num_attention_heads, c.head_dim)
        if q_cos is not None:
            q = apply_rope(q, q_cos, q_sin)
        out = gqa_attention(q, kv[0], kv[1], bias,
                            c.query_pre_attn_scalar ** -0.5,
                            c.attn_logit_softcapping)
        return self.o_proj(_merge_heads(out))


class VoiceMLP(nn.Module):
    def __init__(self, cfg: T5GemmaModuleConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x):
        return self.down_proj(
            F.gelu(self.gate_proj(x), approximate="tanh") * self.up_proj(x))


class VoiceDecoderLayer(nn.Module):
    def __init__(self, cfg: T5GemmaModuleConfig, cross_hidden: int):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.self_attn = VoiceSelfAttention(cfg)
        self.cross_attn = VoiceCrossAttention(cfg, cross_hidden)
        self.mlp = VoiceMLP(cfg)
        self.pre_self_attn_layernorm = RMSNorm(d, eps)
        self.post_self_attn_layernorm = RMSNorm(d, eps)
        self.pre_cross_attn_layernorm = RMSNorm(d, eps)
        self.post_cross_attn_layernorm = RMSNorm(d, eps)
        self.pre_feedforward_layernorm = RMSNorm(d, eps)
        self.post_feedforward_layernorm = RMSNorm(d, eps)

    def forward(self, h, cos, sin, self_bias, cross_kv, cross_bias,
                q_cos, q_sin, kv_cache):
        # self_bias already carries this layer's (full or sliding) mask
        r = h
        a = self.self_attn(self.pre_self_attn_layernorm(h), cos, sin,
                           self_bias, kv_cache)
        h = r + self.post_self_attn_layernorm(a)
        r = h
        a = self.cross_attn(self.pre_cross_attn_layernorm(h), cross_kv,
                            cross_bias, q_cos, q_sin)
        h = r + self.post_cross_attn_layernorm(a)
        r = h
        h = r + self.post_feedforward_layernorm(
            self.mlp(self.pre_feedforward_layernorm(h)))
        return h


class VoiceDecoder(nn.Module):
    def __init__(self, cfg: T5GemmaModuleConfig, cross_hidden: int):
        super().__init__()
        self.layers = nn.ModuleList(
            VoiceDecoderLayer(cfg, cross_hidden)
            for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.cfg = cfg


class _Backbone(nn.Module):
    def __init__(self, encoder, decoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder


# ---------------------------------------------------------------------------
# sampling helpers (semantics of t5gemma_tts_tpu/ops/sampling.py)
# ---------------------------------------------------------------------------


def filter_logits(logits, top_k: int, top_p: float, min_p: float):
    if top_k and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]))[0][..., -1, None]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if 0.0 < top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, descending=True)
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        remove = cum > top_p
        remove[..., 1:] = remove[..., :-1].clone()
        remove[..., 0] = False
        logits = logits.masked_fill(
            remove.scatter(-1, sorted_idx, remove), NEG_INF)
    if 0.0 < min_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        logits = logits.masked_fill(
            probs < min_p * probs.max(dim=-1, keepdim=True).values, NEG_INF)
    return logits


def sample_token(logits, top_k, top_p, min_p, temperature):
    if temperature and temperature != 1.0:
        logits = logits / temperature
    logits = filter_logits(logits, top_k, top_p, min_p)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1)[..., 0]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class T5GemmaVoiceForConditionalGeneration(PreTrainedModel):
    config_class = T5GemmaVoiceConfig
    base_model_prefix = "model"
    _supports_cache_class = False

    def __init__(self, config: T5GemmaVoiceConfig):
        super().__init__(config)
        # build through the parent config so propagated fields
        # (dropout_rate etc.) get their defaults
        t5 = T5GemmaConfig(
            encoder=dict(config.t5_config_dict["encoder"]),
            decoder=dict(config.t5_config_dict["decoder"]),
            is_encoder_decoder=True,
            # the composite config propagates its top-level vocab_size into
            # the sub-configs; keep the encoder's (text) vocabulary
            vocab_size=config.t5_config_dict["encoder"]["vocab_size"],
        )
        enc_cfg, dec_cfg = t5.encoder, t5.decoder
        enc_cfg._attn_implementation = "eager"
        encoder = T5GemmaEncoder(enc_cfg)
        cross_hidden = config.t5_config_dict["decoder"].get(
            "cross_attention_hidden_size", enc_cfg.hidden_size)
        decoder = VoiceDecoder(dec_cfg, cross_hidden)
        self.model = _Backbone(encoder, decoder)
        d = dec_cfg.hidden_size
        vocab = config.audio_vocab_size + config.n_special
        self.audio_embedding = nn.ModuleList([nn.Embedding(vocab, d)])
        self.predict_layer = nn.ModuleList([
            nn.Sequential(nn.Linear(d, d), nn.GELU(approximate="tanh"),
                          nn.Linear(d, vocab))
        ])
        self.dec_cfg = dec_cfg
        self.post_init()

    # -- helpers ----------------------------------------------------------

    def _pm_positions(self, lengths, t, device):
        """Progress positions pos/(len-1)*scale, per row, zero past length."""
        pos = torch.arange(t, device=device, dtype=torch.float32)[None, :]
        denom = (lengths.float() - 1.0).clamp(min=1.0)[:, None]
        out = pos / denom * float(self.config.progress_scale)
        return out * (pos < lengths[:, None].float())

    def _encode(self, x, x_lens):
        device = x.device
        mask = (torch.arange(x.shape[1], device=device)[None, :]
                < x_lens[:, None]).long()
        pos = None
        if self.config.use_pm_rope:
            pos = self._pm_positions(x_lens, x.shape[1], device)
        memory = self.model.encoder(
            input_ids=x, attention_mask=mask, position_ids=pos
        ).last_hidden_state
        return memory, pos, mask

    def _decoder_pass(self, embedded, positions, memory, enc_pos, enc_mask,
                      kv_caches, causal_offset: int):
        """One decoder pass over ``embedded`` [B, T, D] (prefill or 1 step).

        ``causal_offset`` = number of cached positions before this pass.
        """
        dec = self.model.decoder
        c = dec.cfg
        b, t, _ = embedded.shape
        device = embedded.device
        h = embedded * math.sqrt(c.hidden_size)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        q_cos, q_sin = (cos, sin) if self.config.use_pm_rope else (None, None)

        tk = causal_offset + t
        qi = torch.arange(t, device=device)[:, None] + causal_offset
        ki = torch.arange(tk, device=device)[None, :]
        causal = ki <= qi
        full_bias = torch.where(causal, 0.0, NEG_INF)[None, None]
        full_bias = full_bias.expand(b, 1, t, tk)
        slid = causal & (qi - c.sliding_window < ki)
        sliding_bias = torch.where(slid, 0.0, NEG_INF)[None, None]
        sliding_bias = sliding_bias.expand(b, 1, t, tk)
        layer_types = list(getattr(c, "layer_types", []) or [])
        cross_bias = torch.where(enc_mask.bool(), 0.0, NEG_INF)
        cross_bias = cross_bias[:, None, None, :].expand(b, 1, t, -1)

        if self.config.use_pm_rope and enc_pos is not None:
            enc_cos, enc_sin = rope_cos_sin(enc_pos, c.head_dim, c.rope_theta)
        else:
            enc_cos = enc_sin = None

        for i, layer in enumerate(dec.layers):
            cache = kv_caches["self"][i]
            if kv_caches["cross"][i] is None:
                kv_caches["cross"][i] = layer.cross_attn.build_kv(
                    memory, enc_cos, enc_sin)
            sliding = (layer_types[i] == "sliding_attention"
                       if i < len(layer_types) else bool(i % 2 == 0))
            h = layer(h, cos, sin,
                      sliding_bias if sliding else full_bias,
                      kv_caches["cross"][i],
                      cross_bias, q_cos, q_sin, cache)
        return dec.norm(h)

    def forward(self, x, x_lens, y, y_lens=None, **kw):
        """Teacher-forced logits over BOS-shifted audio tokens.

        y: [B, K=1, T] codec tokens. Returns logits [B, T+1, vocab]."""
        memory, enc_pos, enc_mask = self._encode(x, x_lens)
        b = x.shape[0]
        device = x.device
        bos = torch.full((b, 1), self.config.empty_token, dtype=torch.long,
                         device=device)
        tokens = torch.cat([bos, y[:, 0]], dim=1)
        emb = self.audio_embedding[0](tokens)
        t = tokens.shape[1]
        # per-row decoder lengths: y_lens + 1 (BOS shift), matching the JAX
        # training model's prepare_decoder_io; padded rows otherwise get
        # progress positions scaled by the buffer width instead of their
        # own length (wrong rotary angles for any padded batch)
        if y_lens is not None:
            lens = y_lens.to(device=device, dtype=torch.long) + 1
        else:
            lens = torch.full((b,), t, device=device)
        if self.config.use_pm_rope:
            pos = self._pm_positions(lens, t, device)
        else:
            pos = torch.arange(t, device=device, dtype=torch.float32
                               )[None, :].expand(b, -1)
        caches = {"self": [[] for _ in self.model.decoder.layers],
                  "cross": [None] * len(self.model.decoder.layers)}
        h = self._decoder_pass(emb, pos, memory, enc_pos, enc_mask, caches, 0)
        return self.predict_layer[0](h)

    # -- generation (same guard order/values as the TPU decode engine) -----

    @torch.inference_mode()
    def inference_tts(
        self,
        x: torch.Tensor,
        x_lens: torch.Tensor,
        y: torch.Tensor,
        tgt_y_lens: Optional[torch.Tensor] = None,
        top_k: Union[int, List[int]] = -100,
        top_p: float = 1.0,
        min_p: float = 0.0,
        temperature: float = 1.0,
        stop_repetition: int = 3,
        silence_tokens: Optional[List[int]] = None,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        device = x.device
        if x.shape[0] != 1:
            raise ValueError("inference_tts supports batch size 1 (use the "
                             "TPU engine for batched synthesis)")
        silence = set(silence_tokens or [])
        eog = cfg.eos if cfg.eos > 0 else cfg.eog
        sr = int(cfg.encodec_sr)
        if isinstance(top_k, (list, tuple)):
            top_k = top_k[0]

        memory, enc_pos, enc_mask = self._encode(x, x_lens)
        bos = torch.full((1, 1, 1), cfg.empty_token, dtype=torch.long,
                         device=device)
        cated = torch.cat([bos, y], dim=2)[:, 0]   # [1, P+1]
        cur_len = cated.shape[1]
        target_total = int(tgt_y_lens[0]) if tgt_y_lens is not None else None
        est_total = max((target_total or 0) + 1, cur_len)
        time_budget = ((target_total or 10 ** 9) - cur_len
                       + int(sr * float(cfg.extra_cutoff)))
        if cfg.text_guard_frames_per_token > 0:
            text_budget = max(1, int(x_lens[0])) * cfg.text_guard_frames_per_token
        else:
            text_budget = 10 ** 9

        def pm_pos(idx_from, idx_to):
            base = torch.arange(idx_from, idx_to, device=device,
                                dtype=torch.float32)[None, :]
            if cfg.use_pm_rope:
                return base / max(1, est_total - 1) * float(cfg.progress_scale)
            return base

        caches = {"self": [[] for _ in self.model.decoder.layers],
                  "cross": [None] * len(self.model.decoder.layers)}
        emb = self.audio_embedding[0](cated)
        h = self._decoder_pass(emb, pm_pos(0, cur_len), memory, enc_pos,
                               enc_mask, caches, 0)
        last = h[:, -1:]

        generated: List[int] = []
        prev_token, consec_silence = -1, 0
        max_steps = est_total - cur_len + int(sr * 10)
        for step in range(max(1, max_steps)):
            logits = self.predict_layer[0](last)[0, 0].float()
            # guard order pinned by the TPU engine (decode/engine.py):
            # EOG suppression, silence-repetition penalty, then force-stops
            if step == 0:
                logits[eog] = -1e9
            elif step <= sr // 5:
                logits[eog] = -10000.0
            if (stop_repetition > 0 and prev_token in silence
                    and consec_silence > stop_repetition):
                factor = consec_silence - (stop_repetition - 1)
                if logits[prev_token] < 0:
                    logits[prev_token] *= float(factor)
                else:
                    logits[prev_token] /= float(factor)
            token = int(sample_token(logits[None], top_k, top_p, min_p,
                                     temperature)[0])
            if (token == eog or int(logits.argmax()) == eog
                    or step > text_budget or step > time_budget):
                generated.append(eog)
                break
            generated.append(token)
            if token in silence and token == prev_token:
                consec_silence += 1
            else:
                consec_silence = 0
            prev_token = token

            emb = self.audio_embedding[0](
                torch.tensor([[token]], device=device))
            pos = pm_pos(cur_len, cur_len + 1)
            h = self._decoder_pass(emb, pos, memory, enc_pos, enc_mask,
                                   caches, cur_len)
            last = h[:, -1:]
            cur_len += 1

        gen = torch.tensor([generated], dtype=torch.long, device=device)
        res = torch.cat([y[0], gen], dim=1).unsqueeze(0)
        if cfg.special_first:
            res = res - int(cfg.n_special)
            gen = gen - int(cfg.n_special)
        return res, gen.unsqueeze(0)

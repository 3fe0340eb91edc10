"""Functional Whisper (encoder-decoder ASR) and its KV-cached decode loop,
in PyTorch.

Counterpart of ``t5gemma_tts_tpu/asr/model.py``, with the compute graph of
HF ``WhisperForConditionalGeneration``: pre-LN transformer, a k projection
without bias, q scaled by head_dim**-0.5, the GELU conv frontend, learned
decoder positions, logits tied to the token embedding. One utterance at a
time (batch 1): transcription runs once per cloning request.

Everything runs in f32 on the tensors' device; the frontend's convolutions
are sums of three shifted matmuls, as in the JAX package, so no cuDNN
convolution (whose default allows TF32) is involved. Attention is plain
matmul and softmax: the JAX model has no Pallas kernel. The parameter tree
has the JAX tree's keys and its stacked ``[L, ...]`` layer axis, so
``bridge.params_from_jax`` carries JAX weights across unchanged.

:func:`decode_with_stats` is a host loop of one decoder step per token over
a preallocated per-layer KV cache (the JAX package's ``lax.while_loop``);
it reads each emitted id back to stop at eos. Sampled draws (temperature >
0) come from ``ops/sampling.step_uniform(seed, step, 1, vocab)``: the CPU
and the card draw the same bits (``jax.random``'s cannot be matched).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import sampling

PyTree = Any


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866              # large-v3-turbo family
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 4
    encoder_attention_heads: int = 20
    decoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    eos_token_id: int = 50257            # <|endoftext|>
    eps: float = 1e-5


def tiny_whisper_config(**overrides) -> WhisperConfig:
    kw = dict(vocab_size=200, num_mel_bins=16, d_model=32,
              encoder_layers=2, decoder_layers=2,
              encoder_attention_heads=4, decoder_attention_heads=4,
              encoder_ffn_dim=64, decoder_ffn_dim=64,
              max_source_positions=40, max_target_positions=24,
              decoder_start_token_id=3, eos_token_id=2)
    kw.update(overrides)
    return WhisperConfig(**kw)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps)


def _heads(x, h):
    t, d = x.shape
    return x.reshape(t, h, d // h).transpose(0, 1)       # [H, T, hd]


def _merge(x):
    h, t, hd = x.shape
    return x.transpose(0, 1).reshape(t, h * hd)


def _attend(q, k, v, mask=None):
    """q [H, Tq, hd] (pre-scaled), k / v [H, Tk, hd] -> [Tq, H * hd]."""
    logits = q @ k.transpose(1, 2)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return _merge(torch.softmax(logits, dim=-1) @ v)


def _mha(p, q_x, kv_x, heads, causal=False):
    """k_proj has no bias (HF Whisper); q pre-scaled."""
    hd = q_x.shape[-1] // heads
    q = _heads((q_x @ p["q_w"] + p["q_b"]) * (hd ** -0.5), heads)
    k = _heads(kv_x @ p["k_w"], heads)
    v = _heads(kv_x @ p["v_w"] + p["v_b"], heads)
    mask = None
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)[None]
    return _attend(q, k, v, mask) @ p["o_w"] + p["o_b"]


def _mlp(p, x):
    return F.gelu(x @ p["fc1_w"] + p["fc1_b"]) @ p["fc2_w"] + p["fc2_b"]


def _layer(layers, i):
    """Layer ``i`` of a stacked layer tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _conv1d(x, w, b, stride):
    """x [T, Cin], w [3, Cin, Cout] (pad 1) -> [T // stride, Cout]."""
    t_out = x.shape[0] // stride
    xp = F.pad(x, (0, 0, 1, 1))
    acc = 0.0
    for k in range(3):
        acc = acc + xp[k:k + stride * t_out:stride] @ w[k]
    return acc + b


def encode(params: PyTree, cfg: WhisperConfig,
           mel: torch.Tensor) -> torch.Tensor:
    """mel [n_mels, 3000] -> encoder states [max_source_positions, D]."""
    enc = params["encoder"]
    x = mel.T.to(torch.float32)                          # [T, n_mels]
    x = F.gelu(_conv1d(x, enc["conv1"]["w"], enc["conv1"]["b"], 1))
    x = F.gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], 2))
    x = x + enc["pos"]
    for i in range(cfg.encoder_layers):
        lp = _layer(enc["layers"], i)
        hn = _ln(x, lp["ln1"], cfg.eps)
        x = x + _mha(lp["attn"], hn, hn, cfg.encoder_attention_heads)
        x = x + _mlp(lp["mlp"], _ln(x, lp["ln2"], cfg.eps))
    return _ln(x, enc["ln_post"], cfg.eps)


# ---------------------------------------------------------------------------
# decoder (full teacher-forced pass)
# ---------------------------------------------------------------------------


def decoder_logits(params: PyTree, cfg: WhisperConfig, ids: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """ids [T] -> logits [T, V] (full causal pass)."""
    dec = params["decoder"]
    ids = ids.to(device=enc_out.device, dtype=torch.long)
    h = dec["embed"][ids] + dec["pos"][:ids.shape[0]]
    heads = cfg.decoder_attention_heads
    for i in range(cfg.decoder_layers):
        lp = _layer(dec["layers"], i)
        hn = _ln(h, lp["ln1"], cfg.eps)
        h = h + _mha(lp["self_attn"], hn, hn, heads, causal=True)
        h = h + _mha(lp["cross_attn"], _ln(h, lp["ln2"], cfg.eps), enc_out,
                     heads)
        h = h + _mlp(lp["mlp"], _ln(h, lp["ln3"], cfg.eps))
    return _ln(h, dec["ln_post"], cfg.eps) @ dec["embed"].T


# ---------------------------------------------------------------------------
# KV-cached generation
# ---------------------------------------------------------------------------


@torch.inference_mode()
def decode_with_stats(params: PyTree, cfg: WhisperConfig,
                      enc_out: torch.Tensor, forced_ids, max_new: int,
                      temperature: float = 0.0,
                      seed: int = 0) -> Tuple[torch.Tensor, int, float]:
    """Continuation of ``forced_ids`` (a list or 1-D tensor of the forced
    prefix) with the statistics that the whisper package's fallback ladder
    gates on (JAX ``decode_with_stats``).

    ``temperature`` 0 takes the argmax; above 0 it draws from
    softmax(logits / T) by the Gumbel-max trick over
    ``step_uniform(seed, t, 1, vocab)`` at position t. Returns (ids [F +
    max_new] on the device, padded with eos; length, the eos included;
    sum_logprob), where sum_logprob adds the chosen token's log-softmax (of
    the raw logits) over the generated steps, the terminating eos
    included: whisper's avg_logprob numerator."""
    dec = params["decoder"]
    dev = enc_out.device
    heads = cfg.decoder_attention_heads
    hd = cfg.d_model // heads
    forced = torch.as_tensor(forced_ids, dtype=torch.long).reshape(-1)
    n_forced = forced.shape[0]
    max_t = n_forced + max_new
    eos = cfg.eos_token_id

    layers = [_layer(dec["layers"], i) for i in range(cfg.decoder_layers)]
    xkv = [(_heads(enc_out @ lp["cross_attn"]["k_w"], heads),
            _heads(enc_out @ lp["cross_attn"]["v_w"]
                   + lp["cross_attn"]["v_b"], heads)) for lp in layers]
    ck = torch.zeros((cfg.decoder_layers, heads, max_t, hd),
                     dtype=torch.float32, device=dev)
    cv = torch.zeros_like(ck)
    tokens = torch.full((max_t,), eos, dtype=torch.long, device=dev)
    tokens[:n_forced] = forced.to(dev)
    positions = torch.arange(max_t, device=dev)
    sum_lp = torch.zeros((), dtype=torch.float32, device=dev)

    t = 1
    while t < max_t:
        h = (dec["embed"][tokens[t - 1]] + dec["pos"][t - 1])[None]  # [1, D]
        for li, lp in enumerate(layers):
            sa = lp["self_attn"]
            hn = _ln(h, lp["ln1"], cfg.eps)
            q = _heads((hn @ sa["q_w"] + sa["q_b"]) * (hd ** -0.5), heads)
            ck[li, :, t - 1] = _heads(hn @ sa["k_w"], heads)[:, 0]
            cv[li, :, t - 1] = _heads(hn @ sa["v_w"] + sa["v_b"], heads)[:, 0]
            mask = (positions < t)[None, None]
            h = h + (_attend(q, ck[li], cv[li], mask) @ sa["o_w"]
                     + sa["o_b"])
            ca = lp["cross_attn"]
            hn2 = _ln(h, lp["ln2"], cfg.eps)
            q2 = _heads((hn2 @ ca["q_w"] + ca["q_b"]) * (hd ** -0.5), heads)
            h = h + (_attend(q2, *xkv[li]) @ ca["o_w"] + ca["o_b"])
            h = h + _mlp(lp["mlp"], _ln(h, lp["ln3"], cfg.eps))
        if t < n_forced:          # inside the forced prefix: fill the cache
            t += 1
            continue
        logits = (_ln(h, dec["ln_post"], cfg.eps) @ dec["embed"].T)[0]
        if temperature > 0:
            u = sampling.step_uniform(seed, t, 1, logits.shape[0],
                                      device=dev)
            nxt = sampling.categorical(logits[None] / temperature, u)[0]
        else:
            nxt = torch.argmax(logits)
        sum_lp = sum_lp + torch.log_softmax(logits, dim=-1)[nxt]
        tokens[t] = nxt
        t += 1
        if int(nxt) == eos:       # the one host read of a step
            break
    return tokens, t, float(sum_lp)


def greedy_decode(params: PyTree, cfg: WhisperConfig, enc_out: torch.Tensor,
                  forced_ids, max_new: int) -> Tuple[torch.Tensor, int]:
    """Greedy continuation of ``forced_ids`` (:func:`decode_with_stats` at
    temperature 0): (ids [F + max_new] padded with eos, length)."""
    ids, n, _ = decode_with_stats(params, cfg, enc_out, forced_ids, max_new)
    return ids, n


def init_params(seed: int, cfg: WhisperConfig,
                device: DeviceLike = "cuda") -> PyTree:
    """Seeded random parameters with the HF shapes, generated on
    ``device`` (weights N(0, 0.02), layer norms at identity, sinusoidal
    encoder positions by the HF formula)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def w(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev) * 0.02

    def attn():
        return {"q_w": w(d, d), "q_b": w(d), "k_w": w(d, d),
                "v_w": w(d, d), "v_b": w(d), "o_w": w(d, d), "o_b": w(d)}

    def lnp():
        return {"g": torch.ones((d,), device=dev),
                "b": torch.zeros((d,), device=dev)}

    def mlp(ffn):
        return {"fc1_w": w(d, ffn), "fc1_b": w(ffn), "fc2_w": w(ffn, d),
                "fc2_b": w(d)}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    pos = np.arange(cfg.max_source_positions)[:, None]
    inv = np.exp(-np.log(10000.0) / (d // 2 - 1) * np.arange(d // 2)[None])
    enc_pos = np.concatenate([np.sin(pos * inv), np.cos(pos * inv)], axis=1)

    return {
        "encoder": {
            "conv1": {"w": w(3, cfg.num_mel_bins, d), "b": w(d)},
            "conv2": {"w": w(3, d, d), "b": w(d)},
            "pos": torch.from_numpy(enc_pos.astype(np.float32)).to(dev),
            "layers": stack([{"ln1": lnp(), "attn": attn(), "ln2": lnp(),
                              "mlp": mlp(cfg.encoder_ffn_dim)}
                             for _ in range(cfg.encoder_layers)]),
            "ln_post": lnp(),
        },
        "decoder": {
            "embed": w(cfg.vocab_size, d),
            "pos": w(cfg.max_target_positions, d),
            "layers": stack([{"ln1": lnp(), "self_attn": attn(),
                              "ln2": lnp(), "cross_attn": attn(),
                              "ln3": lnp(), "mlp": mlp(cfg.decoder_ffn_dim)}
                             for _ in range(cfg.decoder_layers)]),
            "ln_post": lnp(),
        },
    }

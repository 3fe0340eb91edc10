"""The plain reference of the TTS model: plain PyTorch in float32 (TF32 off),
one request at a time, layer by layer, with no cache, no kernel and no
batching. It imports nothing of the port or of the JAX package and takes
the raw weights the benchmark drew (``harness/weights.py``); whatever the
program derives from them (fused, quantized, cached) it works out again.

The architecture, as the configuration file states it:

- encoder: text ids -> embedding x sqrt(d) -> layers of [RMSNorm (1 + w)
  -> self-attention (bidirectional, rotary at PM positions
  ``i / (len - 1) * progress_scale``) -> RMSNorm] + residual, [RMSNorm ->
  GeGLU with the tanh GELU -> RMSNorm] + residual -> final RMSNorm;
- decoder: [empty, t_0, ..., t_{n-2}] audio embeddings x sqrt(d), at PM
  positions ``j / target * progress_scale`` (clamped to the scale), causal
  self-attention with rotary at those positions, cross-attention whose
  queries take rotary at the decoder's and whose keys at the encoder's
  positions, GeGLU, each sub-layer between two RMSNorms; final RMSNorm;
- head: ``gelu_erf(h @ w1 + b1) @ w2 + b2`` over the audio vocabulary.

Logits ``[n, V + 5]``: row j scores the j-th generated token.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rotary(x, pos, theta):
    """x [H, T, hd] rotated at positions pos [T] (halves layout)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q, k, v, scale, causal):
    """q [Hq, Tq, hd], k/v [Hkv, Tk, hd] -> [Tq, Hq * hd]."""
    hq, tq, hd = q.shape
    rep = hq // k.shape[0]
    k = k.repeat_interleave(rep, 0)
    v = v.repeat_interleave(rep, 0)
    logits = q @ k.transpose(1, 2) * scale
    if causal:
        mask = torch.ones(tq, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    out = torch.softmax(logits, -1) @ v
    return out.transpose(0, 1).reshape(tq, hq * hd)


def heads(x, n, hd):
    return x.reshape(x.shape[0], n, hd).transpose(0, 1)


class Reference:
    def __init__(self, config: Dict, raw: Dict):
        self.c = config
        self.raw = raw
        self.h = int(config["num_heads"])
        self.hkv = int(config.get("num_key_value_heads", self.h))
        self.hd = int(config["d_kv"])
        self.d = int(config["d_model"])
        t = config["tts"]
        self.eps = float(config["layer_norm_epsilon"])
        self.theta = float(t["rope_theta"])
        self.scale = float(t["query_pre_attn_scalar"]) ** -0.5
        self.progress = float(t["progress_scale"])
        self.empty = int(t["audio_vocab_size"])

    def _layer(self, stack: str, li: int) -> Dict:
        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return tree[li].float()
        return walk(self.raw[stack]["layers"])

    def _mlp(self, p, x):
        return (F.gelu(x @ p["gate"], approximate="tanh") * (x @ p["up"])
                ) @ p["down"]

    def encode(self, ids: Sequence[int]):
        """-> (memory [T, d], encoder PM positions [T])."""
        dev = self.raw["encoder"]["embed"].device
        ids_t = torch.tensor(list(ids), dtype=torch.long, device=dev)
        n = len(ids)
        pos = (torch.arange(n, dtype=torch.float32, device=dev)
               / (max(n, 2) - 1) * self.progress)
        x = self.raw["encoder"]["embed"][ids_t].float() * math.sqrt(self.d)
        for li in range(int(self.c["num_layers"])):
            p = self._layer("encoder", li)
            a = p["self_attn"]
            hn = rms_norm(x, p["pre_self_attn_norm"], self.eps)
            q = rotary(heads(hn @ a["q"], self.h, self.hd), pos, self.theta)
            k = rotary(heads(hn @ a["k"], self.hkv, self.hd), pos, self.theta)
            v = heads(hn @ a["v"], self.hkv, self.hd)
            o = attention(q, k, v, self.scale, causal=False) @ a["o"]
            x = x + rms_norm(o, p["post_self_attn_norm"], self.eps)
            m = self._mlp(p["mlp"], rms_norm(x, p["pre_ff_norm"], self.eps))
            x = x + rms_norm(m, p["post_ff_norm"], self.eps)
        return (rms_norm(x, self.raw["encoder"]["final_norm"].float(),
                         self.eps), pos)

    @torch.no_grad()
    def logits(self, ids: Sequence[int], tokens: Sequence[int],
               target: int) -> torch.Tensor:
        """The logits that score ``tokens`` (the request's generated codes,
        in order) for the text ``ids`` and a target of ``target`` frames."""
        with exact_f32():
            memory, enc_pos = self.encode(ids)
            dev = memory.device
            inputs = torch.tensor([self.empty] + list(tokens[:-1]),
                                  dtype=torch.long, device=dev)
            n = inputs.shape[0]
            pos = (torch.arange(n, dtype=torch.float32, device=dev)
                   / max(target, 1) * self.progress).clamp_max(self.progress)
            x = self.raw["audio_embed"][inputs].float() * math.sqrt(self.d)
            for li in range(int(self.c["num_decoder_layers"])):
                p = self._layer("decoder", li)
                a, c = p["self_attn"], p["cross_attn"]
                hn = rms_norm(x, p["pre_self_attn_norm"], self.eps)
                q = rotary(heads(hn @ a["q"], self.h, self.hd), pos,
                           self.theta)
                k = rotary(heads(hn @ a["k"], self.hkv, self.hd), pos,
                           self.theta)
                v = heads(hn @ a["v"], self.hkv, self.hd)
                o = attention(q, k, v, self.scale, causal=True) @ a["o"]
                x = x + rms_norm(o, p["post_self_attn_norm"], self.eps)
                hn = rms_norm(x, p["pre_cross_attn_norm"], self.eps)
                q = rotary(heads(hn @ c["q"], self.h, self.hd), pos,
                           self.theta)
                k = rotary(heads(memory @ c["k"], self.hkv, self.hd),
                           enc_pos, self.theta)
                v = heads(memory @ c["v"], self.hkv, self.hd)
                o = attention(q, k, v, self.scale, causal=False) @ c["o"]
                x = x + rms_norm(o, p["post_cross_attn_norm"], self.eps)
                m = self._mlp(p["mlp"],
                              rms_norm(x, p["pre_ff_norm"], self.eps))
                x = x + rms_norm(m, p["post_ff_norm"], self.eps)
            x = rms_norm(x, self.raw["decoder"]["final_norm"].float(),
                         self.eps)
            hd = self.raw["head"]
            hid = F.gelu(x @ hd["w1"].float() + hd["b1"].float())
            return hid @ hd["w2"].float() + hd["b2"].float()

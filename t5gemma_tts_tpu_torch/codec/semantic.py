"""w2v-BERT conformer encoder (the semantic branch of XCodec2), in PyTorch.

Counterpart of ``t5gemma_tts_tpu/codec/semantic.py``: XCodec2 conditions
its quantizer on hidden layer 16 of facebook/w2v-bert-2.0, computed as

  feature_projection:  LayerNorm(160) -> Linear(160 -> D)
  per layer:           0.5 * FFN1 + x
                       SelfAttention(relative_key distance bias) + x
                       ConvModule (GLU -> causal depthwise -> swish) + x
                       0.5 * FFN2 + x -> final LayerNorm
  output:              the hidden state after ``num_layers`` layers.

The parameters keep the JAX tree: the layers stacked on a leading axis, the
convolutions in the JAX ``WIO`` layout ([K, Cin / groups, Cout]), so the
bridge and the checkpoint converter fill both packages alike. Attention is
written out with the JAX einsums: the relative-distance bias is added to
the scores as JAX adds it, which ``scaled_dot_product_attention`` would not
allow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.masks import NEG_INF
from .vocos import layer_norm

PyTree = Any


@dataclass(frozen=True)
class ConformerConfig:
    input_dim: int = 160
    hidden_size: int = 1024
    num_layers: int = 16          # layers computed (hidden_states[16])
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_kernel: int = 31
    left_max_pos: int = 64
    right_max_pos: int = 8
    eps: float = 1e-5

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_distance_embeddings(self) -> int:
        return self.left_max_pos + self.right_max_pos + 1


def tiny_conformer_config() -> ConformerConfig:
    return ConformerConfig(input_dim=160, hidden_size=32, num_layers=2,
                           num_heads=4, intermediate_size=64, conv_kernel=7,
                           left_max_pos=8, right_max_pos=3)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ConformerConfig,
                dtype=torch.float32, device=None) -> PyTree:
    """Seeded random parameters drawn from ``gen`` (on ``device``)."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std
                ).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin(i, o, lead=(n,)):
        return {"w": normal(*lead, i, o, std=i ** -0.5), "b": zeros(*lead, o)}

    def ln(dim, lead=(n,)):
        return {"w": torch.ones((*lead, dim), dtype=dtype, device=device),
                "b": zeros(*lead, dim)}

    def ffn():
        return {"norm": ln(d), "in": lin(d, f), "out": lin(f, d)}

    layers = {
        "ffn1": ffn(),
        "attn_norm": ln(d),
        "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                 "o": lin(d, d),
                 "distance_embedding": normal(
                     n, cfg.num_distance_embeddings, cfg.head_size,
                     std=0.02)},
        "conv": {"norm": ln(d),
                 "pw1": normal(n, 1, d, 2 * d, std=d ** -0.5),
                 "dw": normal(n, cfg.conv_kernel, 1, d, std=0.1),
                 "dw_norm": ln(d),
                 "pw2": normal(n, 1, d, d, std=d ** -0.5)},
        "ffn2": ffn(),
        "final_norm": ln(d),
    }
    return {"feature_projection": {"norm": ln(cfg.input_dim, lead=()),
                                   "proj": lin(cfg.input_dim, d, lead=())},
            "layers": layers}


def layer_params(layers: PyTree, li: int) -> PyTree:
    """Layer ``li`` of a tree stacked on a leading layer axis."""
    if isinstance(layers, dict):
        return {k: layer_params(v, li) for k, v in layers.items()}
    return layers[li]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _swish(x):
    return x * torch.sigmoid(x)


def _linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _ffn(p, x, eps):
    h = _swish(_linear(p["in"], layer_norm(p["norm"], x, eps)))
    return _linear(p["out"], h)


def _attention(p, x, bias, cfg: ConformerConfig):
    b, t, d = x.shape
    h, hs = cfg.num_heads, cfg.head_size

    def split(z):
        return z.reshape(b, t, h, hs).transpose(1, 2)

    q = split(_linear(p["q"], x))
    k = split(_linear(p["k"], x))
    v = split(_linear(p["v"], x))
    scale = hs ** -0.5
    scores = torch.einsum("bhld,bhrd->bhlr", q, k) * scale

    # relative_key distance bias (HF Wav2Vec2BertSelfAttention)
    pos = torch.arange(t, device=x.device)
    dist = (pos[None, :] - pos[:, None]).clamp(-cfg.left_max_pos,
                                               cfg.right_max_pos)
    demb = p["distance_embedding"][dist + cfg.left_max_pos]     # [t, t, hs]
    rel = torch.einsum("bhld,lrd->bhlr", q.float(), demb.float()) * scale
    scores = scores + rel
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhlr,bhrd->bhld", w, v)
    return _linear(p["o"], out.transpose(1, 2).reshape(b, t, d))


def _conv_module(p, x, pad_mask, cfg: ConformerConfig):
    h = layer_norm(p["norm"], x, cfg.eps)
    if pad_mask is not None:
        h = torch.where(pad_mask[..., None], 0.0, h)
    h = h @ p["pw1"][0]                        # pointwise, kernel 1
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)                   # GLU over channels
    # causal depthwise: kernel - 1 zeros on the left
    ht = F.pad(h.transpose(1, 2), (cfg.conv_kernel - 1, 0))
    h = F.conv1d(ht, p["dw"].permute(2, 1, 0),
                 groups=cfg.hidden_size).transpose(1, 2)
    h = _swish(layer_norm(p["dw_norm"], h, cfg.eps))
    return h @ p["pw2"][0]


def forward(params: PyTree, cfg: ConformerConfig,
            input_features: torch.Tensor,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, input_dim] features -> the hidden state after the stacked
    conformer layers (``cfg.num_layers`` of them), [B, T, hidden_size]."""
    fp = params["feature_projection"]
    h = _linear(fp["proj"], layer_norm(fp["norm"], input_features, cfg.eps))

    pad = bias = None
    if lengths is not None:
        t = h.shape[1]
        pad = torch.arange(t, device=h.device)[None, :] >= lengths[:, None]
        h = torch.where(pad[..., None], 0.0, h)
        bias = torch.where(pad[:, None, None, :], NEG_INF, 0.0)

    for li in range(params["layers"]["final_norm"]["w"].shape[0]):
        lp = layer_params(params["layers"], li)
        h = h + 0.5 * _ffn(lp["ffn1"], h, cfg.eps)
        h = h + _attention(lp["attn"], layer_norm(lp["attn_norm"], h,
                                                  cfg.eps), bias, cfg)
        h = h + _conv_module(lp["conv"], h, pad, cfg)
        h = h + 0.5 * _ffn(lp["ffn2"], h, cfg.eps)
        h = layer_norm(lp["final_norm"], h, cfg.eps)
    return h

"""XCodec2 encode-side modules, in PyTorch: the acoustic conv encoder, the
semantic conv encoder, and the fusion that gives the quantizer its input.

Counterpart of ``t5gemma_tts_tpu/codec/encoder.py``. Acoustic branch: a
BigCodec-style strided conv stack that downsamples 16 kHz audio 320x to 50
Hz (ratios 2, 4, 5, 8), channels doubling per block, with dilated residual
units (dilations 1, 3, 9) and an optional LSTM. Semantic branch: the
w2v-BERT conformer (``semantic.py``) followed by a residual conv
``SemanticEncoder``. The fusion concatenates both branches (semantic first)
into the quantizer's input (``fc_prior`` -> FSQ in ``model.py``).

Activations are [B, T, C] and convolution weights keep the JAX ``WIO``
layout ([K, Cin, Cout]), permuted to PyTorch's at the call, so the bridge
and the checkpoint converter (``convert.py``) fill one layout. XLA's
``SAME`` padding at stride 1 pads (K - 1) * dilation in total, the lower
half on the left; :func:`conv1d` pads the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import features as feat_mod
from . import semantic as sem_mod
from .semantic import ConformerConfig

PyTree = Any


@dataclass(frozen=True)
class AcousticEncoderConfig:
    ngf: int = 48
    ratios: Tuple[int, ...] = (2, 4, 5, 8)  # product 320 (16 kHz -> 50 Hz)
    dilations: Tuple[int, ...] = (1, 3, 9)
    out_dim: int = 1024
    kernel: int = 7
    # BigCodec-family encoders place an LSTM between the conv stack and the
    # final projection; the converter infers its layers from the checkpoint
    rnn_layers: int = 0
    rnn_residual: bool = True


@dataclass(frozen=True)
class SemanticEncoderConfig:
    input_channels: int = 1024
    code_dim: int = 1024
    encode_channels: int = 1024
    kernel: int = 3


def tiny_encoder_configs():
    return (
        AcousticEncoderConfig(ngf=4, ratios=(2, 2), out_dim=16, kernel=3),
        SemanticEncoderConfig(input_channels=32, code_dim=16,
                              encode_channels=24),
        sem_mod.tiny_conformer_config(),
    )


def conv1d(x: torch.Tensor, p: dict, stride: int = 1, dilation: int = 1,
           padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [B, T, Cin], ``p["w"]`` [K, Cin, Cout] (and an optional ``p["b"]``)
    -> [B, T', Cout]. ``padding`` (left, right); None is XLA's ``SAME`` at
    stride 1: (K - 1) * dilation zeros, the lower half on the left."""
    w = p["w"]
    if padding is None:
        total = (w.shape[0] - 1) * dilation
        padding = (total // 2, total - total // 2)
    xt = F.pad(x.transpose(1, 2), padding)
    out = F.conv1d(xt, w.permute(2, 1, 0), stride=stride,
                   dilation=dilation).transpose(1, 2)
    return out + p["b"] if "b" in p else out


# ---------------------------------------------------------------------------
# acoustic encoder
# ---------------------------------------------------------------------------


def init_acoustic_params(gen: torch.Generator, cfg: AcousticEncoderConfig,
                         dtype=torch.float32, device=None) -> PyTree:
    def conv(k, cin, cout):
        w = torch.randn((k, cin, cout), generator=gen, device=device)
        return {"w": (w * (k * cin) ** -0.5).to(dtype),
                "b": torch.zeros((cout,), dtype=dtype, device=device)}

    ch = cfg.ngf
    params = {"conv_in": conv(cfg.kernel, 1, ch), "blocks": []}
    for ratio in cfg.ratios:
        units = [{"conv1": conv(cfg.kernel, ch, ch), "conv2": conv(1, ch, ch)}
                 for _ in cfg.dilations]
        params["blocks"].append({"units": units,
                                 "down": conv(2 * ratio, ch, 2 * ch)})
        ch *= 2
    if cfg.rnn_layers:
        params["rnn"] = [_lstm_init(gen, ch, ch, dtype, device)
                         for _ in range(cfg.rnn_layers)]
    params["conv_out"] = conv(3, ch, cfg.out_dim)
    return params


def _lstm_init(gen, cin, hidden, dtype, device):
    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std
                ).to(dtype)

    return {"w_ih": normal(cin, 4 * hidden, std=cin ** -0.5),
            "w_hh": normal(hidden, 4 * hidden, std=hidden ** -0.5),
            "b_ih": torch.zeros((4 * hidden,), dtype=dtype, device=device),
            "b_hh": torch.zeros((4 * hidden,), dtype=dtype, device=device)}


def lstm_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Unidirectional LSTM over [B, T, C], gate order i, f, g, o (torch's),
    as a plain loop over time."""
    b, t, _ = x.shape
    hidden = p["w_hh"].shape[0]
    pre = x @ p["w_ih"] + (p["b_ih"] + p["b_hh"])             # [B, T, 4H]
    h = x.new_zeros((b, hidden))
    cell = x.new_zeros((b, hidden))
    out = []
    for i in range(t):
        gi, gf, gg, go = (pre[:, i] + h @ p["w_hh"]).chunk(4, dim=-1)
        cell = torch.sigmoid(gf) * cell + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(cell)
        out.append(h)
    return torch.stack(out, dim=1) if out else pre[..., :hidden]


def _mask_time(h: torch.Tensor, lens) -> torch.Tensor:
    """Positions >= lens[b] along the time axis zeroed ([B, T, C])."""
    if lens is None:
        return h
    keep = torch.arange(h.shape[1], device=h.device)[None, :, None] \
        < lens[:, None, None]
    return torch.where(keep, h, 0.0)


def acoustic_forward(params: PyTree, cfg: AcousticEncoderConfig,
                     wav: torch.Tensor, wav_lens=None) -> torch.Tensor:
    """wav [B, S] -> [B, S // prod(ratios), out_dim].

    Down convs pad symmetrically by ceil(ratio / 2) on kernel 2 * ratio (as
    the PyTorch checkpoints do). With ``wav_lens`` every conv's output is
    zeroed past each row's valid length (the exact strided length carried
    through the down convs), so a length-padded encode equals the unpadded
    one: conv biases would otherwise leak into the last valid frames'
    receptive fields."""
    lens = None if wav_lens is None else wav_lens.long()
    h = _mask_time(conv1d(wav[..., None].float(), params["conv_in"]), lens)
    for block, ratio in zip(params["blocks"], cfg.ratios):
        for unit, d in zip(block["units"], cfg.dilations):
            u = _mask_time(conv1d(F.elu(h), unit["conv1"], dilation=d), lens)
            u = _mask_time(conv1d(F.elu(u), unit["conv2"]), lens)
            h = h + u
        pad = -(-ratio // 2)
        h = conv1d(F.elu(h), block["down"], stride=ratio,
                   padding=(pad, pad))
        if lens is not None:
            lens = torch.div(lens + 2 * pad - 2 * ratio, ratio,
                             rounding_mode="floor") + 1
            h = _mask_time(h, lens)
    if cfg.rnn_layers and "rnn" in params:
        r = h
        for lp in params["rnn"]:
            h = lstm_forward(lp, h)   # causal: in-range outputs unaffected
        if cfg.rnn_residual:
            h = h + r
        h = _mask_time(h, lens)
    return _mask_time(conv1d(F.elu(h), params["conv_out"]), lens)


# ---------------------------------------------------------------------------
# semantic conv encoder (after the conformer)
# ---------------------------------------------------------------------------


def init_semantic_encoder_params(gen: torch.Generator,
                                 cfg: SemanticEncoderConfig,
                                 dtype=torch.float32, device=None) -> PyTree:
    def w(cin, cout):
        k = cfg.kernel
        return (torch.randn((k, cin, cout), generator=gen, device=device)
                * (k * cin) ** -0.5).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    e = cfg.encode_channels
    return {"initial": {"w": w(cfg.input_channels, e)},
            "res1": {"w": w(e, e), "b": zeros(e)},
            "res2": {"w": w(e, e), "b": zeros(e)},
            "final": {"w": w(e, cfg.code_dim)}}


def semantic_encoder_forward(params: PyTree, cfg: SemanticEncoderConfig,
                             x: torch.Tensor) -> torch.Tensor:
    """[B, T, input_channels] -> [B, T, code_dim]: initial conv, then
    (relu, conv, relu, conv) + the residual, then the final conv."""
    h = conv1d(x, params["initial"])
    r = conv1d(F.relu(h), params["res1"])
    r = conv1d(F.relu(r), params["res2"])
    return conv1d(h + r, params["final"])


# ---------------------------------------------------------------------------
# the encode side assembled
# ---------------------------------------------------------------------------


def init_encoder_params(gen: torch.Generator, acfg: AcousticEncoderConfig,
                        scfg: SemanticEncoderConfig, ccfg: ConformerConfig,
                        fused_dim: int, dtype=torch.float32,
                        device=None) -> PyTree:
    w = torch.randn((fused_dim, fused_dim), generator=gen, device=device)
    return {
        "acoustic": init_acoustic_params(gen, acfg, dtype, device),
        "semantic_model": sem_mod.init_params(gen, ccfg, dtype, device),
        "semantic_encoder": init_semantic_encoder_params(gen, scfg, dtype,
                                                         device),
        "fc_prior": {"w": (w * fused_dim ** -0.5).to(dtype),
                     "b": torch.zeros((fused_dim,), dtype=dtype,
                                      device=device)},
    }


def fuse_features(params: PyTree, cfg, wav: torch.Tensor,
                  wav_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav [B, S] at 16 kHz -> fused [B, T50, semantic + acoustic]: the two
    branches truncated to the shorter one, semantic first. ``cfg`` is an
    ``XCodec2Config``."""
    acoustic = acoustic_forward(params["acoustic"], cfg.acoustic_cfg, wav,
                                wav_lens)
    feats, feat_lens = feat_mod.extract_features(wav, wav_lens)
    sem_hidden = sem_mod.forward(params["semantic_model"], cfg.conformer_cfg,
                                 feats, feat_lens)
    sem = semantic_encoder_forward(params["semantic_encoder"],
                                   cfg.semantic_cfg, sem_hidden)
    t = min(acoustic.shape[1], sem.shape[1])
    return torch.cat([sem[:, :t], acoustic[:, :t]], dim=-1)

"""Vocos-style vocoder: ConvNeXt backbone + ISTFT head, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/codec/vocos.py``. Activations are
[B, T, C] at the public functions (the JAX layout); convolutions transpose
to PyTorch's [B, C, T] inside. The inverse real FFT uses ``torch.fft.irfft``
(the JAX package writes it as two matmuls only to avoid the TPU's FFT
lowering); the imaginary parts of the DC and Nyquist bins drop out of both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class VocosConfig:
    input_dim: int = 1024        # channels fed by fc_post_a
    dim: int = 1024              # backbone width
    intermediate_dim: int = 3072
    num_layers: int = 12
    kernel_size: int = 7
    n_fft: int = 2048
    hop_length: int = 882        # 44100 / 50 frames per second
    layer_scale_init: float = 1e-6
    eps: float = 1e-6


def init_params(gen: torch.Generator, cfg: VocosConfig, dtype=torch.float32,
                device=None) -> Dict:
    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    n, d, f, k = cfg.num_layers, cfg.dim, cfg.intermediate_dim, cfg.kernel_size
    blocks = {
        "dwconv": {"w": normal(n, k, 1, d, std=0.02), "b": torch.zeros(
            (n, d), dtype=dtype, device=device)},
        "norm": {"w": torch.ones((n, d), dtype=dtype, device=device),
                 "b": torch.zeros((n, d), dtype=dtype, device=device)},
        "pw1": {"w": normal(n, d, f, std=d ** -0.5),
                "b": torch.zeros((n, f), dtype=dtype, device=device)},
        "pw2": {"w": normal(n, f, d, std=f ** -0.5),
                "b": torch.zeros((n, d), dtype=dtype, device=device)},
        "gamma": torch.full((n, d), cfg.layer_scale_init, dtype=dtype,
                            device=device),
    }
    return {
        "embed": {"w": normal(k, cfg.input_dim, d, std=0.02), "b": full(d, 0.0)},
        "norm": {"w": full(d, 1.0), "b": full(d, 0.0)},
        "blocks": blocks,
        "final_norm": {"w": full(d, 1.0), "b": full(d, 0.0)},
        "head": {"w": normal(d, cfg.n_fft + 2, std=d ** -0.5),
                 "b": full(cfg.n_fft + 2, 0.0)},
    }


def layer_norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["w"].float() + p["b"].float()).to(x.dtype)


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                groups: int = 1) -> torch.Tensor:
    """x [B, T, Cin]; w [K, Cin/groups, Cout] (JAX WIO layout); SAME
    padding (left (K-1)//2, right the rest)."""
    k = w.shape[0]
    left = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, k - 1 - left))
    out = F.conv1d(xt, w.permute(2, 1, 0), groups=groups)
    return out.transpose(1, 2) + b


def convnext_block(p: Dict, x: torch.Tensor, cfg: VocosConfig) -> torch.Tensor:
    h = conv1d_same(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=cfg.dim)
    h = layer_norm(p["norm"], h, cfg.eps)
    h = F.gelu(h @ p["pw1"]["w"] + p["pw1"]["b"])
    h = h @ p["pw2"]["w"] + p["pw2"]["b"]
    return x + p["gamma"] * h


def _block(blocks: Dict, li: int) -> Dict:
    if isinstance(blocks, dict):
        return {k: _block(v, li) for k, v in blocks.items()}
    return blocks[li]


def backbone(params: Dict, x: torch.Tensor, cfg: VocosConfig,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, input_dim] -> [B, T, dim]. With ``lengths`` features beyond
    each row's length are zeroed after the embed conv and every block, so a
    padded buffer decodes exactly like the unpadded sequence."""
    valid = None
    if lengths is not None:
        t = x.shape[1]
        valid = (torch.arange(t, device=x.device)[None, :]
                 < lengths[:, None])[..., None]
        x = torch.where(valid, x, 0.0)
    h = conv1d_same(x, params["embed"]["w"], params["embed"]["b"])
    h = layer_norm(params["norm"], h, cfg.eps)
    if valid is not None:
        h = torch.where(valid, h, 0.0)
    for li in range(params["blocks"]["gamma"].shape[0]):
        h = convnext_block(_block(params["blocks"], li), h, cfg)
        if valid is not None:
            h = torch.where(valid, h, 0.0)
    return layer_norm(params["final_norm"], h, cfg.eps)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """frames [B, T, n_fft] -> [B, (T-1)*hop + n_fft] by K = ceil(n_fft/hop)
    shifted adds of hop-sized chunks."""
    b, t, n_fft = frames.shape
    k = -(-n_fft // hop)
    chunks = F.pad(frames, (0, k * hop - n_fft)).reshape(b, t, k, hop)
    out = frames.new_zeros((b, t + k - 1, hop))
    for j in range(k):
        out[:, j:j + t] += chunks[:, :, j]
    return out.reshape(b, (t + k - 1) * hop)[:, : (t - 1) * hop + n_fft]


def istft_same(spec_real: torch.Tensor, spec_imag: torch.Tensor,
               cfg: VocosConfig,
               frame_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vocos "same"-padded ISTFT: spec [B, T, n_fft//2 + 1] -> [B, T*hop].
    With ``frame_lengths`` frames beyond each row's length are zeroed and
    left out of the window envelope."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    t = spec_real.shape[1]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=spec_real.device)
    spec = torch.complex(spec_real.float(), spec_imag.float())
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    if frame_lengths is not None:
        valid = (torch.arange(t, device=frames.device)[None, :]
                 < frame_lengths[:, None])[..., None]
        frames = torch.where(valid, frames, 0.0)
        env = overlap_add(torch.where(valid, window ** 2, 0.0), hop)
    else:
        env = overlap_add((window ** 2).expand(1, t, n_fft), hop)
    audio = overlap_add(frames, hop)
    pad = (n_fft - hop) // 2
    audio = audio[:, pad:audio.shape[1] - pad]
    env = env[:, pad:env.shape[1] - pad].clamp_min(1e-11)
    return audio / env


def head(params: Dict, x: torch.Tensor, cfg: VocosConfig,
         lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backbone features [B, T, dim] -> waveform [B, T*hop]. The magnitude
    (not the exponent) is clipped at 100, as in the Vocos ISTFT head."""
    h = x @ params["head"]["w"] + params["head"]["b"]
    half = cfg.n_fft // 2 + 1
    mag = torch.exp(h[..., :half].float()).clamp_max(100.0)
    phase = h[..., half:].float()
    return istft_same(mag * torch.cos(phase), mag * torch.sin(phase), cfg,
                      frame_lengths=lengths)


def vocode(params: Dict, features: torch.Tensor, cfg: VocosConfig,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantizer-output features [B, T, input_dim] -> waveform [B, T*hop]."""
    return head(params, backbone(params, features, cfg, lengths), cfg, lengths)

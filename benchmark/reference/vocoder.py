"""The plain reference of the XCodec2 vocoder (codes -> 44.1 kHz waveform),
in plain PyTorch at a stated type, one request at a time and unpadded:

- FSQ: index -> base-``levels`` digits -> codes ``(digit - half) / half``
  -> ``project_out``; then ``fc_post_a``;
- Vocos backbone: a k-tap "same" convolution, LayerNorm, ConvNeXt blocks
  (depthwise k-tap convolution, LayerNorm, ``pw1``, exact GELU, ``pw2``,
  times ``gamma``, plus the residual), a final LayerNorm;
- ISTFT head: ``exp`` of the magnitude half clipped at 100, the phase half
  through cos / sin, an inverse real FFT of ``n_fft`` windowed by a
  periodic Hann window, overlap-added at ``hop`` and divided by the
  window's squared envelope, trimmed by ``(n_fft - hop) / 2`` a side.

It imports nothing of the port; it reads the raw weights the benchmark
drew.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def _conv_same(x, w, b, groups=1):
    """x [T, Cin]; w [K, Cin/groups, Cout] -> [T, Cout]."""
    k = w.shape[0]
    left = (k - 1) // 2
    xt = F.pad(x.t()[None], (left, k - 1 - left))
    return F.conv1d(xt, w.permute(2, 1, 0), groups=groups)[0].t() + b


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _overlap_add(frames, hop):
    """frames [T, n] -> [(T - 1) * hop + n]."""
    t, n = frames.shape
    return F.fold(frames.t()[None], output_size=(1, (t - 1) * hop + n),
                  kernel_size=(1, n), stride=(1, hop))[0, 0, 0]


@torch.no_grad()
def vocode(raw: Dict, codec: Dict, codes: Sequence[int],
           dtype=torch.float32) -> torch.Tensor:
    """The waveform [len(codes) * hop] of one request's codes, the weights
    and activations in ``dtype`` (the FFT in float32)."""
    levels = [int(x) for x in codec["fsq_levels"]]
    eps = float(codec["layer_norm_eps"])
    n_fft, hop = int(codec["n_fft"]), int(codec["hop_length"])
    dev = raw["fsq"]["project_out"]["w"].device

    def p(*path):
        t = raw
        for k in path:
            t = t[k]
        return t.to(dtype)

    idx = torch.tensor(list(codes), dtype=torch.long, device=dev)
    basis, acc = [], 1
    for lv in levels:
        basis.append(acc)
        acc *= lv
    basis_t = torch.tensor(basis, dtype=torch.long, device=dev)
    lv_t = torch.tensor(levels, dtype=torch.long, device=dev)
    half = torch.tensor([lv // 2 for lv in levels], dtype=torch.float32,
                        device=dev)
    digits = torch.div(idx[:, None], basis_t, rounding_mode="floor") % lv_t
    q = ((digits.float() - half) / half).to(dtype)
    x = q @ p("fsq", "project_out", "w") + p("fsq", "project_out", "b")
    x = x @ p("fc_post_a", "w") + p("fc_post_a", "b")
    x = _conv_same(x, p("vocos", "embed", "w"), p("vocos", "embed", "b"))
    x = _layer_norm(x, p("vocos", "norm", "w"), p("vocos", "norm", "b"), eps)
    d = x.shape[1]
    for li in range(raw["vocos"]["blocks"]["gamma"].shape[0]):
        def bp(*path):
            return p("vocos", "blocks", *path)[li]
        y = _conv_same(x, bp("dwconv", "w"), bp("dwconv", "b"), groups=d)
        y = _layer_norm(y, bp("norm", "w"), bp("norm", "b"), eps)
        y = F.gelu(y @ bp("pw1", "w") + bp("pw1", "b"))
        y = y @ bp("pw2", "w") + bp("pw2", "b")
        x = x + bp("gamma") * y
    x = _layer_norm(x, p("vocos", "final_norm", "w"),
                    p("vocos", "final_norm", "b"), eps)
    h = (x @ p("vocos", "head", "w") + p("vocos", "head", "b")).float()
    nb = n_fft // 2 + 1
    mag = torch.exp(h[:, :nb]).clamp_max(100.0)
    spec = torch.complex(mag * torch.cos(h[:, nb:]), mag * torch.sin(h[:, nb:]))
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=dev)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    t = frames.shape[0]
    audio = _overlap_add(frames, hop)
    env = _overlap_add((window ** 2).expand(t, n_fft), hop)
    pad = (n_fft - hop) // 2
    audio = audio[pad:audio.shape[0] - pad]
    env = env[pad:env.shape[0] - pad].clamp_min(1e-11)
    return audio / env

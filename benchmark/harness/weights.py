"""The benchmark's inputs that stand for weights: drawn from ``--seed`` on the
card by one ``torch.Generator``, a leaf a call (layers stacked), in the type
they are served in. The same seed gives the same numbers, so the plain
reference draws the weights again after the timed window rather than keep a
copy beside the program's.

The trees have the layout the port's entry points take (the JAX package's
key names, stacked ``[L, ...]`` layers, kernels ``[in, out]``). The values
are the benchmark's own: matrices N(0, 0.02), norm weights N(0, 0.05)
around the ``(1 + w)`` scale, and the head's bias on the five special audio
rows at ``SPECIAL_BIAS``, so that a request ends at its duration budget (a
greedy random model would otherwise emit a separator or an end token about
once in 65541 steps).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

STD = 0.02
NORM_STD = 0.05
SPECIAL_BIAS = -20.0
N_SPECIAL = 5

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def voice_leaves(config: dict) -> List[Leaf]:
    """(path, shape, law, scale) of every leaf of the TTS model, in the
    order they are drawn. Laws: "normal" (std ``scale``), "zeros",
    "special" (zeros, the last five entries ``scale``)."""
    d, f = int(config["d_model"]), int(config["d_ff"])
    h = int(config["num_heads"])
    hkv = int(config.get("num_key_value_heads", h))
    hd = int(config["d_kv"])
    qh, kh = h * hd, hkv * hd
    tts = config["tts"]
    va = int(tts["audio_vocab_size"]) + N_SPECIAL
    out: List[Leaf] = []

    def stack(top: str, n: int, decoder: bool) -> None:
        norms = ["pre_self_attn_norm", "post_self_attn_norm", "pre_ff_norm",
                 "post_ff_norm"]
        if decoder:
            norms += ["pre_cross_attn_norm", "post_cross_attn_norm"]
        for name in norms:
            out.append(((top, "layers", name), (n, d), "normal", NORM_STD))
        for name, shape in (("q", (d, qh)), ("k", (d, kh)), ("v", (d, kh)),
                            ("o", (qh, d))):
            out.append(((top, "layers", "self_attn", name), (n, *shape),
                        "normal", STD))
        if decoder:
            for name, shape in (("q", (d, qh)), ("k", (d, kh)),
                                ("v", (d, kh)), ("o", (qh, d))):
                out.append(((top, "layers", "cross_attn", name), (n, *shape),
                            "normal", STD))
        for name, shape in (("gate", (d, f)), ("up", (d, f)),
                            ("down", (f, d))):
            out.append(((top, "layers", "mlp", name), (n, *shape), "normal",
                        STD))
        out.append(((top, "final_norm"), (d,), "normal", NORM_STD))

    stack("encoder", int(config["num_layers"]), False)
    out.append((("encoder", "embed"), (int(config["vocab_size"]), d),
                "normal", STD))
    stack("decoder", int(config["num_decoder_layers"]), True)
    out.append((("audio_embed",), (va, d), "normal", STD))
    out.append((("head", "w1"), (d, d), "normal", STD))
    out.append((("head", "b1"), (d,), "zeros", 0.0))
    out.append((("head", "w2"), (d, va), "normal", STD))
    out.append((("head", "b2"), (va,), "special", SPECIAL_BIAS))
    return out


def codec_leaves(codec: dict) -> List[Leaf]:
    """The XCodec2 decoder (FSQ projections, ``fc_post_a``, the Vocos
    backbone and its ISTFT head) at the widths of ``codec``."""
    fd, cd = int(codec["fsq_dim"]), len(codec["fsq_levels"])
    i, d, f = (int(codec["vocos_input_dim"]), int(codec["vocos_dim"]),
               int(codec["vocos_intermediate_dim"]))
    n, k, nfft = (int(codec["vocos_layers"]), int(codec["vocos_kernel"]),
                  int(codec["n_fft"]))
    return [
        (("fsq", "project_in", "w"), (fd, cd), "normal", fd ** -0.5),
        (("fsq", "project_in", "b"), (cd,), "zeros", 0.0),
        (("fsq", "project_out", "w"), (cd, fd), "normal", cd ** -0.5),
        (("fsq", "project_out", "b"), (fd,), "zeros", 0.0),
        (("fc_post_a", "w"), (fd, i), "normal", fd ** -0.5),
        (("fc_post_a", "b"), (i,), "zeros", 0.0),
        (("vocos", "embed", "w"), (k, i, d), "normal", (k * i) ** -0.5),
        (("vocos", "embed", "b"), (d,), "zeros", 0.0),
        (("vocos", "norm", "w"), (d,), "ones", 0.0),
        (("vocos", "norm", "b"), (d,), "zeros", 0.0),
        (("vocos", "blocks", "dwconv", "w"), (n, k, 1, d), "normal",
         k ** -0.5),
        (("vocos", "blocks", "dwconv", "b"), (n, d), "zeros", 0.0),
        (("vocos", "blocks", "norm", "w"), (n, d), "ones", 0.0),
        (("vocos", "blocks", "norm", "b"), (n, d), "zeros", 0.0),
        (("vocos", "blocks", "pw1", "w"), (n, d, f), "normal", d ** -0.5),
        (("vocos", "blocks", "pw1", "b"), (n, f), "zeros", 0.0),
        (("vocos", "blocks", "pw2", "w"), (n, f, d), "normal", f ** -0.5),
        (("vocos", "blocks", "pw2", "b"), (n, d), "zeros", 0.0),
        (("vocos", "blocks", "gamma"), (n, d), "normal", 0.1),
        (("vocos", "final_norm", "w"), (d,), "ones", 0.0),
        (("vocos", "final_norm", "b"), (d,), "zeros", 0.0),
        (("vocos", "head", "w"), (d, nfft + 2), "normal", d ** -0.5),
        (("vocos", "head", "b"), (nfft + 2,), "zeros", 0.0),
    ]


def _draw(gen: torch.Generator, shape, law: str, scale: float, dtype,
          device) -> torch.Tensor:
    if law == "normal":
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)
    if law == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.zeros(shape, dtype=dtype, device=device)
    if law == "special":
        x[-N_SPECIAL:] = scale
    return x


def _insert(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def draw(leaves: List[Leaf], seed: int, dtype, device,
         offset: int = 0) -> Dict[str, Any]:
    """The tree of ``leaves`` drawn from ``seed`` (``offset`` separates two
    trees drawn from one seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2 + offset) % (1 << 63))
    tree: Dict[str, Any] = {}
    for path, shape, law, scale in leaves:
        _insert(tree, path, _draw(gen, shape, law, scale, dtype, device))
    return tree


def voice_params(config: dict, seed: int, device) -> Dict[str, Any]:
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[config["tts"]["dtype"]]
    return draw(voice_leaves(config), seed, dtype, device, offset=0)


def codec_params(config: dict, seed: int, device) -> Dict[str, Any]:
    return draw(codec_leaves(config["codec"]), seed, torch.float32, device,
                offset=1)

"""Weight converters: published XCodec2 / w2v-BERT PyTorch checkpoints ->
the port's parameter trees.

Counterpart of ``t5gemma_tts_tpu/codec/convert.py``, with the same key
mapping and the same contracts: the ``.beta -> .bias`` rename of the
XCodec2 safetensors (reference: data/tokenizer.py:82-84), weight-norm pairs
folded, the acoustic encoder's conv / LSTM layout inferred from the key
inventory, and a strict, key-exhaustive conversion of the whole checkpoint.
It reads a state dict of numpy arrays (as ``safetensors``'
``framework="np"`` gives them) and returns tensors on a device, in the
layout the port shares with the JAX package: linears [in, out],
convolutions ``WIO`` [K, Cin, Cout], the conformer and Vocos layers
stacked on a leading axis.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .encoder import AcousticEncoderConfig
from .semantic import ConformerConfig

log = logging.getLogger(__name__)


def _t(x):  # linear: torch [out, in] -> [in, out]
    return np.asarray(x).T


def _conv(x):  # conv1d: torch [out, in, k] -> WIO [k, in, out]
    return np.asarray(x).transpose(2, 1, 0)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def _stack(trees):
    """A list of like trees -> one tree, each leaf stacked on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def rename_beta_keys(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """XCodec2 safetensors store some biases as ``.beta``
    (reference: data/tokenizer.py:82-84)."""
    return {k.replace(".beta", ".bias"): np.asarray(v) for k, v in sd.items()}


def merge_weight_norm(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight_norm pairs (``.weight_g``/``.weight_v``, and the
    parametrize spelling ``.parametrizations.weight.original{0,1}``) into
    plain ``.weight`` tensors: w = g * v / ||v||, the norm over the
    non-output dims."""
    out: Dict[str, np.ndarray] = {}
    consumed = set()
    for k, v in sd.items():
        if k.endswith(".weight_v"):
            base = k[: -len(".weight_v")]
            gk = base + ".weight_g"
        elif k.endswith(".parametrizations.weight.original1"):
            base = k[: -len(".parametrizations.weight.original1")]
            gk = base + ".parametrizations.weight.original0"
        else:
            continue
        if gk not in sd:
            continue
        vv = np.asarray(v, np.float64)
        g = np.asarray(sd[gk], np.float64)
        axes = tuple(range(1, vv.ndim))
        norm = np.sqrt((vv ** 2).sum(axis=axes, keepdims=True))
        out[base + ".weight"] = (g.reshape(norm.shape) * vv / np.maximum(
            norm, 1e-12)).astype(np.float32)
        consumed.update({k, gk})
    for k, v in sd.items():
        if k not in consumed:
            out.setdefault(k, np.asarray(v))
    return out


def _natkey(k: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", k)]


def acoustic_state_dict_to_params(sd: Mapping[str, np.ndarray],
                                  prefix: str = "CodecEnc.",
                                  dtype=torch.float32,
                                  device: DeviceLike = "cuda"):
    """Structured conversion of the BigCodec-style acoustic encoder.

    The layout is inferred from the (weight-norm-merged) key inventory: the
    first conv (in_channels 1) is conv_in, even-kernel convs that double
    the channels are the strided downsamplers (stride = kernel / 2), the
    kernel-K / kernel-1 pairs between them are the dilated residual units,
    LSTM ``weight_ih/hh`` keys are the recurrent stage, and the last conv
    is the output projection. Returns (params, AcousticEncoderConfig,
    consumed keys); raises naming the keys under ``prefix`` it cannot
    place."""
    dev = resolve_device(device)
    sub = {k[len(prefix):]: np.asarray(v) for k, v in sd.items()
           if k.startswith(prefix)}
    sub = merge_weight_norm(sub)
    consumed = set()

    convs = [(k[: -len(".weight")], sub[k]) for k in sorted(sub, key=_natkey)
             if k.endswith(".weight") and sub[k].ndim == 3]

    def take_conv(base, w):
        consumed.add(base + ".weight")
        out = {"w": _tensor(_conv(w), dtype, dev)}
        bk = base + ".bias"
        if bk in sub:
            out["b"] = _tensor(sub[bk], dtype, dev)
            consumed.add(bk)
        else:
            out["b"] = torch.zeros((w.shape[0],), dtype=dtype, device=dev)
        return out

    if len(convs) < 3:
        raise ValueError(
            f"acoustic encoder: expected conv stack under {prefix!r}, found "
            f"{len(convs)} conv weights")
    first_base, first_w = convs[0]
    if first_w.shape[1] != 1:
        raise ValueError(
            f"acoustic encoder: first conv {prefix}{first_base} has "
            f"in_channels={first_w.shape[1]}, expected 1 (waveform input)")
    params = {"conv_in": take_conv(first_base, first_w)}
    ngf, kernel = int(first_w.shape[0]), int(first_w.shape[2])

    last_base, last_w = convs[-1]
    ratios, n_units = [], None
    units, blocks = [], []
    for base, w in convs[1:-1]:
        if w.shape[2] % 2 == 0 and w.shape[0] == 2 * w.shape[1]:
            # strided downsampler: kernel 2 * stride, channels double
            if n_units is None:
                n_units = len(units)
            elif len(units) != n_units:
                raise ValueError(
                    f"acoustic encoder: inconsistent residual-unit count "
                    f"({len(units)} vs {n_units}) before {prefix}{base}")
            if len(units) % 2:
                raise ValueError(
                    f"acoustic encoder: odd conv count ({len(units)}) in "
                    f"residual units before {prefix}{base}")
            blocks.append({
                "units": [{"conv1": units[i], "conv2": units[i + 1]}
                          for i in range(0, len(units), 2)],
                "down": take_conv(base, w)})
            ratios.append(w.shape[2] // 2)
            units = []
        else:
            units.append(take_conv(base, w))
    if units:
        raise ValueError(
            f"acoustic encoder: {len(units)} residual convs after the last "
            f"downsampler under {prefix!r}: unexpected layout")
    params["blocks"] = blocks
    params["conv_out"] = take_conv(last_base, last_w)

    rnn_layers = []
    li = 0
    while any(k.endswith(f"weight_ih_l{li}") for k in sub):
        base = next(k[: -len(f"weight_ih_l{li}")] for k in sub
                    if k.endswith(f"weight_ih_l{li}"))
        layer = {}
        for ours, theirs in (("w_ih", f"weight_ih_l{li}"),
                             ("w_hh", f"weight_hh_l{li}"),
                             ("b_ih", f"bias_ih_l{li}"),
                             ("b_hh", f"bias_hh_l{li}")):
            arr = np.asarray(sub[base + theirs])
            layer[ours] = _tensor(arr.T if ours.startswith("w") else arr,
                                  dtype, dev)
            consumed.add(base + theirs)
        rnn_layers.append(layer)
        li += 1
    if rnn_layers:
        params["rnn"] = rnn_layers

    leftovers = sorted(set(sub) - consumed)
    if leftovers:
        raise ValueError(
            f"acoustic encoder: {len(leftovers)} unconsumed keys under "
            f"{prefix!r}: {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")

    n_pairs = (n_units or 0) // 2
    acfg = AcousticEncoderConfig(
        ngf=ngf, ratios=tuple(ratios),
        dilations=(1, 3, 9, 27)[:n_pairs] if n_pairs else (),
        out_dim=int(last_w.shape[0]), kernel=kernel,
        rnn_layers=len(rnn_layers))
    return params, acfg, {prefix + k for k in consumed}


def w2vbert_state_dict_to_params(sd: Mapping[str, np.ndarray],
                                 cfg: ConformerConfig, prefix: str = "",
                                 dtype=torch.float32,
                                 device: DeviceLike = "cuda") -> Dict:
    """The w2v-BERT conformer's first ``cfg.num_layers`` layers (HF
    ``Wav2Vec2BertModel`` keys under ``prefix``), stacked."""
    dev = resolve_device(device)

    def g(k):
        return np.asarray(sd[prefix + k])

    def ln(base):
        return {"w": _tensor(g(base + ".weight"), dtype, dev),
                "b": _tensor(g(base + ".bias"), dtype, dev)}

    def lin(base):
        return {"w": _tensor(_t(g(base + ".weight")), dtype, dev),
                "b": _tensor(g(base + ".bias"), dtype, dev)}

    def conv(base):
        return _tensor(_conv(g(base + ".weight")), dtype, dev)

    layers = []
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}."
        layers.append({
            "ffn1": {"norm": ln(base + "ffn1_layer_norm"),
                     "in": lin(base + "ffn1.intermediate_dense"),
                     "out": lin(base + "ffn1.output_dense")},
            "attn_norm": ln(base + "self_attn_layer_norm"),
            "attn": {
                "q": lin(base + "self_attn.linear_q"),
                "k": lin(base + "self_attn.linear_k"),
                "v": lin(base + "self_attn.linear_v"),
                "o": lin(base + "self_attn.linear_out"),
                "distance_embedding": _tensor(
                    g(base + "self_attn.distance_embedding.weight"), dtype,
                    dev),
            },
            "conv": {
                "norm": ln(base + "conv_module.layer_norm"),
                "pw1": conv(base + "conv_module.pointwise_conv1"),
                "dw": conv(base + "conv_module.depthwise_conv"),
                "dw_norm": ln(base + "conv_module.depthwise_layer_norm"),
                "pw2": conv(base + "conv_module.pointwise_conv2"),
            },
            "ffn2": {"norm": ln(base + "ffn2_layer_norm"),
                     "in": lin(base + "ffn2.intermediate_dense"),
                     "out": lin(base + "ffn2.output_dense")},
            "final_norm": ln(base + "final_layer_norm"),
        })
    return {"feature_projection": {
                "norm": ln("feature_projection.layer_norm"),
                "proj": lin("feature_projection.projection")},
            "layers": _stack(layers)}


class _Reads(dict):
    """Dict recording keys actually read (``[]``); membership probes via
    ``in`` are not counted, so a tensor that is only sniffed but never
    consumed still shows up as a leftover."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


#: State-dict keys that are legitimately not converted: torch-side training /
#: buffer artifacts with no inference-time meaning.
_IGNORABLE = (
    re.compile(r"(^|\.)masked_spec_embed$"),     # spec-augment buffer
    re.compile(r"num_batches_tracked$"),
    re.compile(r"(^|\.)position_ids$"),
)


def xcodec2_state_dict_to_params(sd: Mapping[str, np.ndarray], cfg,
                                 dtype=torch.float32,
                                 decode_only: bool = False,
                                 strict: bool = True,
                                 device: DeviceLike = "cuda") -> Dict[str, Any]:
    """An XCodec2 ``model.safetensors`` state dict -> decoder + encoder
    parameters (``cfg``: an ``XCodec2Config``).

    Key-exhaustive (reference contract: data/tokenizer.py:79-98 loads the
    checkpoint strictly): every tensor must be read, be a known-ignorable
    torch buffer, or belong to a conformer layer at or past
    ``cfg.conformer_cfg.num_layers`` (the reference taps hidden_states[16]
    of a 24-layer w2v-BERT). Anything else raises under ``strict`` and is
    logged otherwise. Required sections: fsq, vocos and fc_post_a, and
    unless ``decode_only`` the encoder's (semantic_model,
    semantic_encoder, acoustic, fc_prior). A checkpoint whose acoustic
    layout differs from ``cfg.acoustic_cfg`` raises."""
    dev = resolve_device(device)
    sd = _Reads(rename_beta_keys(sd))

    def t(x):
        return _tensor(x, dtype, dev)

    def lin(base):
        return {"w": t(_t(sd[base + ".weight"])), "b": t(sd[base + ".bias"])}

    def ln(base):
        return {"w": t(sd[base + ".weight"]), "b": t(sd[base + ".bias"])}

    def conv(base):
        out = {"w": t(_conv(sd[base + ".weight"]))}
        if base + ".bias" in sd:
            out["b"] = t(sd[base + ".bias"])
        else:
            out["b"] = torch.zeros((out["w"].shape[-1],), dtype=dtype,
                                   device=dev)
        return out

    params: Dict[str, Any] = {}

    # the quantizer (a ResidualFSQ of one quantizer)
    for cand in ("generator.quantizer", "quantizer"):
        if cand + ".project_in.weight" in sd:
            params["fsq"] = {"project_in": lin(cand + ".project_in"),
                             "project_out": lin(cand + ".project_out")}
            break

    if "fc_post_a.weight" in sd:
        params["fc_post_a"] = lin("fc_post_a")
    if "fc_prior.weight" in sd:
        params["fc_prior"] = lin("fc_prior")

    # the Vocos backbone and head
    vb = next((c for c in ("generator.backbone", "backbone")
               if c + ".embed.weight" in sd), None)
    if vb is not None:
        n_blocks = 0
        while f"{vb}.convnext.{n_blocks}.dwconv.weight" in sd:
            n_blocks += 1
        blocks = []
        for i in range(n_blocks):
            b = f"{vb}.convnext.{i}."
            blocks.append({"dwconv": conv(b + "dwconv"), "norm": ln(b + "norm"),
                           "pw1": lin(b + "pwconv1"), "pw2": lin(b + "pwconv2"),
                           "gamma": t(sd[b + "gamma"])})
        params["vocos"] = {
            "embed": conv(vb + ".embed"),
            "norm": ln(vb + ".norm"),
            "blocks": _stack(blocks),
            "final_norm": ln(vb + ".final_layer_norm"),
            "head": lin(vb.replace("backbone", "head") + ".out"),
        }

    # the semantic conformer
    if ("semantic_model.feature_projection.projection.weight" in sd
            or "semantic_model.encoder.layers.0.ffn1.intermediate_dense.weight"
            in sd):
        params["semantic_model"] = w2vbert_state_dict_to_params(
            sd, cfg.conformer_cfg, prefix="semantic_model.", dtype=dtype,
            device=dev)

    # the semantic conv encoder
    if "SemanticEncoder_module.initial_conv.weight" in sd:
        base = "SemanticEncoder_module."
        params["semantic_encoder"] = {
            "initial": {"w": t(_conv(sd[base + "initial_conv.weight"]))},
            "res1": conv(base + "residual_blocks.1"),
            "res2": conv(base + "residual_blocks.3"),
            "final": {"w": t(_conv(sd[base + "final_conv.weight"]))},
        }

    # the acoustic encoder (structured and exhaustive over its prefix)
    if any(k.startswith("CodecEnc.") for k in sd):
        acoustic, acfg, _ = acoustic_state_dict_to_params(
            sd, prefix="CodecEnc.", dtype=dtype, device=dev)
        params["acoustic"] = acoustic
        if cfg.acoustic_cfg != acfg:
            raise ValueError(
                "checkpoint acoustic-encoder layout differs from the "
                f"configured one:\n  checkpoint: {acfg}\n  config:     "
                f"{cfg.acoustic_cfg}\nconstruct XCodec2Config with the "
                "inferred acoustic_cfg")
        # the sub-converter raised on any key of its prefix it could not
        # place, but it reads the weight-norm-merged keys: account for the
        # raw ones here
        sd.read.update(k for k in sd if k.startswith("CodecEnc."))

    required = ["fsq", "vocos", "fc_post_a"]
    if not decode_only:
        required += ["fc_prior", "semantic_model", "semantic_encoder",
                     "acoustic"]
    missing = [s for s in required if s not in params]
    if missing:
        raise ValueError(
            f"XCodec2 conversion: required sections missing from the "
            f"checkpoint: {missing} (decode_only={decode_only}). The key "
            f"inventory did not match any known layout for these sections; "
            f"first few keys: {sorted(sd)[:6]}")

    n_sem_layers = cfg.conformer_cfg.num_layers
    sem_layer_re = re.compile(r"^semantic_model\.encoder\.layers\.(\d+)\.")

    def ignorable(k: str) -> bool:
        m = sem_layer_re.match(k)
        if m and int(m.group(1)) >= n_sem_layers:
            return True     # past the tapped hidden layer
        return any(p.search(k) for p in _IGNORABLE)

    leftovers = sorted(k for k in sd if k not in sd.read and not ignorable(k))
    if leftovers:
        msg = (f"XCodec2 conversion: {len(leftovers)} state-dict tensors were "
               f"not consumed: {leftovers[:8]}"
               f"{'...' if len(leftovers) > 8 else ''}")
        if strict:
            raise ValueError(msg)
        log.warning(msg)
    return params

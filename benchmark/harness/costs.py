"""The yardstick: the card's published peaks, and the bytes and operations
that a kernel or a model step needs, worked out from shapes alone. Each
input is counted once and each output written once, at this run's own
lengths: what these inputs need, not what a kernel happens to read.

The kernel arithmetic is a copy of ``chip_smoke.py``'s (``bound_ms``,
``decode_layer_bytes``, ``attention_bytes_ops``, ``w8a8_cost``), taken
into the benchmark so that a change to the program cannot move it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
# the peak a step is held to, by the precision its products run in
PEAKS = {"bf16": PEAK_BF16_FLOPS, "int8": PEAK_INT8_OPS,
         "int4": PEAK_INT8_OPS}


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak_ops)


@dataclass(frozen=True)
class Widths:
    """One stack's widths, as the benchmark's configuration states them."""

    d: int        # hidden
    f: int        # intermediate (each of gate and up)
    h: int        # query heads
    hkv: int      # key/value heads
    hd: int       # head size

    @property
    def ho(self) -> int:
        return self.h * self.hd

    @property
    def nkv(self) -> int:
        return self.hkv * self.hd


def widths_of(config: dict) -> Widths:
    heads = int(config["num_heads"])
    return Widths(d=int(config["d_model"]), f=int(config["d_ff"]), h=heads,
                  hkv=int(config.get("num_key_value_heads", heads)),
                  hd=int(config["d_kv"]))


# -- kernels ---------------------------------------------------------------


def w8a8_cost(m: int, k: int, n: int, x_bytes: float, out_bytes: float,
              w_bytes: float = 1.0) -> Tuple[int, int]:
    """Bytes of a quantized product (x, the weight levels -- ``w_bytes`` a
    level, 0.5 for int4 -- their f32 scales, the output) and its integer
    operations."""
    return (int(m * k * x_bytes + n * k * w_bytes + n * 4 + m * n * out_bytes),
            2 * m * k * n)


def decode_layer_bytes(w: Widths, rows: Sequence[Tuple[int, int, int]],
                       kv_elem: int, kv_scales: bool,
                       w_bytes: float = 1.0) -> int:
    """Bytes one decoder layer of kernel 2 must move for one step: its
    weights (``w_bytes`` a level) with f32 scales and norms, the valid K/V
    (and scales) of each row's (prompt, generated, encoder) tokens, h in
    and out, the rope tables and the new k/v."""
    nk = ((w.ho + 2 * w.nkv, w.d), (w.d, w.ho), (w.ho, w.d), (w.d, w.ho),
          (2 * w.f, w.d), (w.d, w.f))
    weights = sum(int(n * k * w_bytes) + 4 * n for n, k in nk) + 6 * w.d * 4
    b = len(rows)
    tokens = sum(p + g + max(e, 1) for p, g, e in rows)
    per_token = 2 * w.nkv * kv_elem + (2 * w.hkv * 4 if kv_scales else 0)
    return (weights + tokens * per_token + 2 * b * w.d * 4
            + 4 * b * w.hd * 4 + 2 * b * w.nkv * 4 + 3 * b * 4)


def attention_bytes_ops(w: Widths, rows: Iterable[Sequence[int]],
                        kv_elem: int, kv_scales: bool, include_current: bool,
                        page: int = 128) -> Tuple[int, int]:
    """Bytes and operations of one kernel-1 call: ``rows`` holds each row's
    valid key counts by segment (prompt pages, generated pages; or the
    text's pages). It counts the K/V (and scales) of the valid tokens, the
    page-table entries that hold them, the lengths, q in and the output
    (f32), and the in-flight k/v when the call takes them."""
    rows = [[max(int(n), 0) for n in r] for r in rows]
    b = len(rows)
    tokens = sum(sum(r) for r in rows)
    pages = sum(-(-n // page) for r in rows for n in r)
    per_token = 2 * w.nkv * kv_elem + (2 * w.hkv * 4 if kv_scales else 0)
    nbytes = (tokens * per_token + pages * 4 + 2 * b * 4
              + 2 * b * w.ho * 4 + (2 * b * w.nkv * 4 if include_current else 0))
    ops = 4 * w.h * w.hd * (tokens + (b if include_current else 0))
    return nbytes, ops


# -- the model --------------------------------------------------------------


def encoder_flops(w: Widths, layers: int, text_len: int) -> int:
    """One text's encoder: the projections and GeGLU of every token, and
    attention over the text."""
    per_token = 2 * (w.d * (w.ho + 2 * w.nkv) + w.ho * w.d + 3 * w.d * w.f)
    attn = 4 * w.h * w.hd * text_len
    return layers * text_len * (per_token + attn)


def cross_kv_flops(w: Widths, layers: int, text_len: int) -> int:
    """Every decoder layer's cross keys and values of one text."""
    return layers * text_len * 2 * (2 * w.d * w.nkv)


def decoder_flops(w: Widths, layers: int, tokens: int, first_keys: int,
                  text_len: int) -> int:
    """``tokens`` consecutive tokens through the decoder, the first of them
    attending over ``first_keys`` keys (itself included): the projections,
    GeGLU, self attention over the keys so far and cross attention over the
    text."""
    proj = 2 * (w.d * (w.ho + 2 * w.nkv) + w.ho * w.d + 2 * w.d * w.ho
                + 3 * w.d * w.f)
    keys = tokens * (first_keys - 1) + tokens * (tokens + 1) // 2
    attn = 4 * w.h * w.hd * (keys + tokens * text_len)
    return layers * (tokens * proj + attn)


def head_flops(w: Widths, rows: int, audio_vocab: int) -> int:
    """The 2-layer head over ``rows`` hidden rows."""
    return 2 * rows * (w.d * w.d + w.d * audio_vocab)


def request_flops(w: Widths, enc_layers: int, dec_layers: int, text_len: int,
                  prompt_len: int, generated: int, audio_vocab: int) -> int:
    """A whole request's model FLOPs: the encoder, the cross K/V, the
    prefill of BOS and the prompt, and each generated token (the head, then
    the decoder on the token)."""
    return (encoder_flops(w, enc_layers, text_len)
            + cross_kv_flops(w, dec_layers, text_len)
            + decoder_flops(w, dec_layers, prompt_len + 1 + generated, 1,
                            text_len)
            + head_flops(w, generated, audio_vocab))

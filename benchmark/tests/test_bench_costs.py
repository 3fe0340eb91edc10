"""The cost functions against counts made by hand, at two shapes each."""

import pytest

from benchmark.harness import costs

SMALL = costs.Widths(d=64, f=128, h=4, hkv=2, hd=16)
XL = costs.Widths(d=2048, f=5120, h=32, hkv=32, hd=64)


def test_widths_of_config():
    w = costs.widths_of({"d_model": 4096, "d_ff": 10240, "num_heads": 64,
                         "d_kv": 64})
    assert (w.d, w.f, w.h, w.hkv, w.hd, w.ho, w.nkv) == (
        4096, 10240, 64, 64, 64, 4096, 4096)


def test_bound_is_the_larger_side():
    assert costs.bound_s(3.35e12, 1.0, 1e12) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 2e12, 1e12) == pytest.approx(2.0)


@pytest.mark.parametrize("m,k,n,wb,want", [
    (16, 4096, 4096, 1.0, 16 * 4096 + 4096 * 4096 + 4096 * 4 + 16 * 4096 * 2),
    (1, 2048, 65541, 0.5, 2048 + 65541 * 1024 + 65541 * 4 + 65541 * 2)])
def test_w8a8_cost(m, k, n, wb, want):
    nbytes, ops = costs.w8a8_cost(m, k, n, 1, 2, wb)
    assert nbytes == want and ops == 2 * m * k * n


def test_decode_layer_bytes_by_hand():
    # SMALL: qkv 128 x 64, o 64 x 64, cross q 64 x 64, cross o 64 x 64,
    # gate_up 256 x 64, down 64 x 128 int8, each with f32 scales, 6 norms
    weights = (128 * 64 + 4 * 128) + 3 * (64 * 64 + 4 * 64) + (
        256 * 64 + 4 * 256) + (64 * 128 + 4 * 64) + 6 * 64 * 4
    rows = [(1, 10, 20), (1, 0, 0)]         # (prompt, generated, text)
    tokens = (1 + 10 + 20) + (1 + 0 + 1)    # an empty text reads one token
    per_token = 2 * 32 * 1 + 2 * 2 * 4      # int8 k and v, f32 scales
    want = (weights + tokens * per_token + 2 * 2 * 64 * 4 + 4 * 2 * 16 * 4
            + 2 * 2 * 32 * 4 + 3 * 2 * 4)
    assert costs.decode_layer_bytes(SMALL, rows, 1, True) == want


def test_decode_layer_bytes_xxl_weights():
    w = costs.Widths(d=4096, f=10240, h=64, hkv=64, hd=64)
    one = costs.decode_layer_bytes(w, [(1, 0, 1)], 1, True)
    # 8 * 4096^2 + 3 * 4096 * 10240 levels: 5.44 GB over 24 layers
    assert 24 * one == pytest.approx(5.44e9, rel=0.01)


@pytest.mark.parametrize("w,rows,cur,elem,scales", [
    (SMALL, [(3, 130), (1, 0)], True, 1, True),
    (XL, [(160,), (45,)], False, 2, False)])
def test_attention_bytes_ops_by_hand(w, rows, cur, elem, scales):
    tokens = sum(sum(r) for r in rows)
    pages = sum(-(-n // 128) for r in rows for n in r)
    b = len(rows)
    per = 2 * w.hkv * w.hd * elem + (2 * w.hkv * 4 if scales else 0)
    want = (tokens * per + pages * 4 + 2 * b * 4 + 2 * b * w.h * w.hd * 4
            + (2 * b * w.hkv * w.hd * 4 if cur else 0))
    nbytes, ops = costs.attention_bytes_ops(w, rows, elem, scales, cur)
    assert nbytes == want
    assert ops == 4 * w.h * w.hd * (tokens + (b if cur else 0))


@pytest.mark.parametrize("w,text,gen", [(SMALL, 7, 5), (XL, 140, 500)])
def test_request_flops_token_by_token(w, text, gen):
    proj = 2 * (w.d * (w.ho + 2 * w.nkv) + w.ho * w.d + 2 * w.d * w.ho
                + 3 * w.d * w.f)
    dec = sum(3 * (proj + 4 * w.h * w.hd * ((i + 1) + text))
              for i in range(1 + gen))
    enc = 2 * text * (2 * (w.d * (w.ho + 2 * w.nkv) + w.ho * w.d
                           + 3 * w.d * w.f) + 4 * w.h * w.hd * text)
    cross = 3 * text * 4 * w.d * w.nkv
    head = 2 * gen * (w.d * w.d + w.d * 69)
    assert costs.request_flops(w, 2, 3, text, 0, gen, 69) == (
        enc + cross + dec + head)

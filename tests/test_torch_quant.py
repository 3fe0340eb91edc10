"""The port's W8A8 quantization (ops/quant.py) against the JAX package's.

Weight levels and scales and the per-row activation quantization are
array-equal (``round`` is half to even on both sides); the W8A8 product's
plain version is equal to ``_w8a8_2d_xla`` in f32 and in bf16, and in f32
within 3 f32 ULP of the Pallas kernel ``_w8a8_2d_pallas(interpret=True)``,
whose interpreted epilogue is that far from the XLA lowering itself. The tests
marked ``cuda`` hold the hand-written kernels to the plain versions on a
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import tiny_voice_config
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import quant as jquant
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 200), (3, 64, 1024)])
def test_quantize_weight_levels_and_scales_equal(shape):
    w = _weights(0, shape)
    want = jquant.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    got = tquant.quantize_weight(
        bridge.params_from_jax(np.asarray(jnp.asarray(w, jnp.bfloat16)),
                               "cpu"))
    n = shape[-1]
    assert got.n == want.n == n
    np.testing.assert_array_equal(
        got.values.transpose(-1, -2).numpy(), np.asarray(want.values)[..., :n])
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(want.scale)[..., :n])
    np.testing.assert_allclose(
        tquant.dequantize(got).numpy(), np.asarray(jquant.dequantize(want)),
        rtol=0, atol=0)


def test_quantize_act_equal_with_half_ties():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 96)) * 3.0).astype(np.float32)
    # row 0: absmax 127 makes the scale exactly 1, so x / sx lands on .5
    x[0, :8] = [127.0, 2.5, 3.5, -0.5, -1.5, 0.5, -2.5, 126.5]
    x[1] = 0.0                                     # the 1e-8 scale floor
    want8, want_s = jquant._quantize_act(jnp.asarray(x))
    got8, got_s = tquant.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got8[0, :8].tolist() == [127, 2, 4, 0, -2, 0, -2, 126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_plain_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((37, 64)) * 1.5).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(_weights(3, (64, 200))))
    tw = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jw), "cpu")
    jx = jnp.asarray(x, dtype)
    tx = bridge.params_from_jax(np.asarray(jx), "cpu")
    xla = np.asarray(jquant._w8a8_2d_xla(jx, jw))[:, :200]
    pallas = np.asarray(jquant._w8a8_2d_pallas(jx, jw, interpret=True))[:, :200]
    got = tquant.w8a8_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (37, 200)
    # the XLA lowering rounds each rescale multiply in turn, as the port
    np.testing.assert_array_equal(got.float().numpy(), xla.astype(np.float32))
    # the Pallas kernel in interpret mode: the same int32 sums, an epilogue
    # up to 3 f32 ULP away from the XLA lowering's (measured). With bf16
    # activations its jitted wrapper quantizes some rows to other levels
    # than the eager _quantize_act does (measured: one row of 37), so bf16
    # is held to the XLA lowering alone
    if dtype == "float32":
        np.testing.assert_array_max_ulp(got.numpy(), pallas, maxulp=3)
    # q_matmul: the same product over [..., K] activations
    lead = tquant.q_matmul(tx.reshape(37, 1, 64), tw)
    assert torch.equal(lead.reshape(37, 200), got)


@pytest.mark.parametrize("m", [17, 65, 129])
def test_w8a8_plain_matches_jax_at_tile_edges(m):
    """The plain W8A8 product equals ``_w8a8_2d_xla`` at row counts one past
    a tile of the card's routes (16, 64 and 128 rows), odd N, small K."""
    rng = np.random.default_rng(20 + m)
    x = (rng.standard_normal((m, 96)) * 1.5).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(_weights(21, (96, 77))))
    tw = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jw), "cpu")
    want = np.asarray(jquant._w8a8_2d_xla(jnp.asarray(x), jw))[:, :77]
    got = tquant.w8a8_matmul_plain(torch.from_numpy(x), tw)
    assert got.shape == (m, 77)
    np.testing.assert_array_equal(got.numpy(), want)


def test_q_matmul_plain_tensor_is_matmul():
    x = torch.from_numpy(_weights(4, (3, 5, 64)))
    w = torch.from_numpy(_weights(5, (64, 32)))
    assert torch.equal(tquant.q_matmul(x, w), x @ w)


@pytest.fixture(scope="module")
def voice_params():
    cfg = tiny_voice_config()
    params = jt5.fuse_for_decode(jvoice.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("tiled", [False, True])
def test_quantize_params_through_bridge_equal_port(voice_params, tiled):
    """JAX ``quantize_params_for_decode`` (kn or streaming-tiled layouts)
    carried over the bridge equals the port's own quantization of the same
    tree, leaf for leaf; the encoder stays unquantized."""
    jq = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, voice_params),
        streaming_tiled=tiled)
    via_bridge = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jq), "cpu")
    own = tquant.quantize_params_for_decode(
        bridge.params_from_jax(voice_params, "cpu"))
    got, want = dict(_leaves(via_bridge)), dict(_leaves(own))
    assert got.keys() == want.keys()
    n_quant = 0
    for path, w in want.items():
        g = got[path]
        if isinstance(w, tquant.QuantWeight):
            n_quant += 1
            assert path[0] in ("decoder", "head"), path
            assert isinstance(g, tquant.QuantWeight) and g.n == w.n
            assert torch.equal(g.values, w.values), path
            assert torch.equal(g.scale, w.scale), path
        else:
            assert torch.equal(g, w), path
    # decoder qkv, o, cross q/k/v/o, gate_up, down; head w1, w2
    assert n_quant == 10


def test_quantize_params_refuses_unported_modes():
    """Bit widths other than those ported are errors: act_bits outside
    {8, 16} and weight_bits outside {8, 4}. An act_bits=16 (W8A16) leaf
    goes through q_matmul, as the W8A16 product."""
    w = torch.from_numpy(_weights(8, (64, 32)))
    for bits in (4, 32):
        with pytest.raises(ValueError, match="act_bits"):
            tquant.quantize_params_for_decode({}, act_bits=bits)
        with pytest.raises(ValueError, match="act_bits"):
            tquant.quantize_params_for_decode({}, act_bits=bits,
                                              weight_bits=4)
        with pytest.raises(ValueError, match="act_bits"):
            tquant.quantize_weight(w, act_bits=bits)
    w16 = tquant.quantize_weight(w, act_bits=16)
    x = torch.from_numpy(_weights(9, (2, 3, 64)))
    got = tquant.q_matmul(x, w16)
    assert got.shape == (2, 3, 32) and got.dtype == x.dtype
    assert torch.equal(got.reshape(6, 32),
                       tquant.w8a16_matmul_plain(x.reshape(6, 64), w16))
    with pytest.raises(ValueError, match="weight_bits"):
        tquant.quantize_params_for_decode({}, weight_bits=2)


def test_layer_params_slices_quant_weights():
    w = tquant.quantize_weight(torch.from_numpy(_weights(6, (3, 64, 48))))
    lw = tt5.layer_params({"a": {"w": w}}, 2)["a"]["w"]
    assert isinstance(lw, tquant.QuantWeight) and lw.n == 48
    assert torch.equal(lw.values, w.values[2])
    assert torch.equal(lw.scale, w.scale[2])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 5, 13, 16, 17, 64, 129, 260])
@pytest.mark.parametrize("k,n", [(2304, 1000), (2304, 1001), (9216, 1000)])
def test_cuda_w8a8_matches_plain(m, k, n):
    """The W8A8 kernel on the card, on both routes (the GEMV up to 16 rows,
    the tensor cores above; N = 1001 odd, K = 9216 split over CTAs): int8
    levels and scales equal to the plain version's, outputs within 1 f32
    ULP (bf16: equal). tests/test_torch_w8a8_cuda.py holds the same
    without JAX, for a machine that has a card and no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(m)
    w = tquant.quantize_weight(torch.from_numpy(_weights(7, (k, n))).cuda())
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(
        np.float32)).cuda()
    x8, sx = tquant.quantize_act(x)
    w8, wsx = tquant.quantize_act_plain(x)
    assert torch.equal(x8, w8) and torch.equal(sx, wsx)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        before = tquant.w8a8_matmul.launches
        got = tquant.w8a8_matmul(xd, w)
        assert tquant.w8a8_matmul.launches == before + 1
        want = tquant.w8a8_matmul_plain(xd, w)
        if dtype == torch.float32:
            np.testing.assert_array_max_ulp(got.cpu().numpy(),
                                            want.cpu().numpy(), maxulp=1)
        else:
            assert torch.equal(got, want)

"""Port ops against the JAX package: weight bridge, RoPE, masks, sampling,
int8 KV quantization. Inputs come from numpy with fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.config import tiny_voice_config
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import fused_attn as jfa
from t5gemma_tts_tpu.ops import masks as jmasks
from t5gemma_tts_tpu.ops import rope as jrope
from t5gemma_tts_tpu.ops import sampling as jsampling
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import masks as tmasks
from t5gemma_tts_tpu_torch.ops import rope as trope
from t5gemma_tts_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
TOL = 1e-6   # f32 elementwise math: only the last ulp may differ


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_equal(dtype):
    """voice + codec trees: numpy -> port tensors -> numpy, same bytes,
    same key names, same stacked shapes."""
    cfg = tiny_voice_config(dtype=dtype)
    tree = {"voice": jvoice.init_params(jax.random.PRNGKey(0), cfg),
            "codec": jcodec.init_decoder_params(jax.random.PRNGKey(1),
                                                jcodec.tiny_codec_config())}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = bridge.params_to_numpy(bridge.params_from_jax(tree, "cpu"))
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_rope_tables_and_application():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 2000, (2, 7)).astype(np.float32)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = trope.apply_rope(torch.from_numpy(x), torch.tensor(np.array(jc)),
                           torch.tensor(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_pm_positions():
    lens = np.asarray([1, 2, 9, 16], np.int32)
    want = jrope.progress_position_ids(jnp.asarray(lens), 16, 2000.0)
    got = trope.progress_position_ids(torch.from_numpy(lens), 16, 2000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)
    cur = np.asarray([1, 5, 40, 90], np.int32)
    est = np.asarray([1, 10, 41, 60], np.int32)
    want = jrope.decode_step_position(jnp.asarray(cur), jnp.asarray(est), 2000.0)
    got = trope.decode_step_position(torch.from_numpy(cur),
                                     torch.from_numpy(est), 2000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("name", [
    "encoder_self_bias", "encoder_sliding_bias", "decoder_self_bias",
    "decoder_sliding_bias", "cross_bias", "step_full", "step_sliding"])
def test_mask_builders(name):
    lens = np.asarray([3, 11, 12], np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    calls = {
        "encoder_self_bias": lambda m, l: m.encoder_self_bias(l, 12),
        "encoder_sliding_bias": lambda m, l: m.encoder_sliding_bias(l, 12, 4),
        "decoder_self_bias": lambda m, l: m.decoder_self_bias(l, 12),
        "decoder_sliding_bias": lambda m, l: m.decoder_sliding_bias(l, 12, 4),
        "cross_bias": lambda m, l: m.cross_bias(l, 5, 12),
        "step_full": lambda m, l: m.step_self_bias(l, 12),
        "step_sliding": lambda m, l: m.step_self_bias(l, 12, window=4),
    }
    want = np.asarray(calls[name](jmasks, jl))
    got = calls[name](tmasks, tl).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)
    assert tmasks.NEG_INF == jmasks.NEG_INF


@pytest.mark.parametrize("top_k,top_p,min_p", [
    (4, 1.0, 0.0), (7, 0.9, 0.0), (0, 0.8, 0.0), (0, 1.0, 0.05)])
def test_filter_logits_equal(top_k, top_p, min_p):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    logits[0, 5] = logits[0, 6]                       # a tie
    want = jsampling.filter_logits(jnp.asarray(logits), top_k=top_k,
                                   top_p=top_p, min_p=min_p)
    got = tsampling.filter_logits(torch.from_numpy(logits), top_k=top_k,
                                  top_p=top_p, min_p=min_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (1, 0.9, 0.8), (5, 0.9, 0.8), (5, 1.0, 1.0), (8, 0.5, 1.3)])
def test_sample_from_candidates_filtered_values_equal(monkeypatch, top_k,
                                                       top_p, temperature):
    """The candidate logits that reach the draw are equal (the draw itself
    cannot match: JAX's threefry stream has no torch counterpart)."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((4, top_k + 2)).astype(np.float32) * 2
    idx = rng.permutation(100)[: 4 * (top_k + 2)].reshape(4, -1).astype(np.int32)
    seen = {}

    def capture(key, logits, axis=-1):
        seen["kept"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jsampling.jax.random, "categorical", capture)
    jsampling.sample_from_candidates(
        jax.random.PRNGKey(0), jnp.asarray(vals), jnp.asarray(idx),
        top_k=top_k, top_p=top_p, temperature=temperature)
    kept, _ = tsampling.filter_candidates(
        torch.from_numpy(vals), torch.from_numpy(idx), top_k, top_p,
        temperature)
    np.testing.assert_array_equal(kept.numpy(), seen["kept"])


def test_draw_follows_the_filtered_distribution():
    """Frequencies of 20000 draws match softmax(kept) within 4 sigma."""
    vals = torch.tensor([[2.0, 1.5, 1.0, 0.2, -1.0, -3.0]])
    idx = torch.arange(6, dtype=torch.int32)[None]
    kept, order = tsampling.filter_candidates(vals, idx, top_k=4, top_p=0.95)
    probs = torch.softmax(kept, dim=-1)[0]
    n = 20000
    draws = tsampling.sample_from_candidates(
        tsampling.step_uniform(0, 0, n, 6), vals.expand(n, 6),
        idx.expand(n, 6), top_k=4, top_p=0.95)
    freq = torch.bincount(draws.long(), minlength=6).double() / n
    want = torch.zeros(6, dtype=torch.float64)
    want[order[0].long()] = probs.double()
    sigma = (want * (1 - want) / n).sqrt()
    assert bool((freq - want).abs().le(4 * sigma + 1e-12).all()), (freq, want)
    assert float(freq[want == 0].sum()) == 0.0


def test_quantize_kv_equal():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 16)) * 4).astype(np.float32)
    jq, js = jfa.quantize_kv(jnp.asarray(x))
    tq, ts = tfa.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

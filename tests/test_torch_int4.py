"""The port's int4 batch-1 latency mode (``--quantize int4``) against the JAX
package's lanes4 int4 path.

- Levels and scales: ``quantize_weight_int4_lanes`` equals the JAX
  ``quantize_weight_lanes4`` level for level (``dequantize_lanes4`` at unit
  scale) and scale for scale; the bridge carries ``Lanes4Weight`` leaves
  ("l4n" stacked and 2-D, "l4k") over with equal levels and back byte-equal.
- The W4A8 product: the plain version equals ``_w4a8_2d_xla`` bit for bit
  (f32 and bf16 activations) and, in f32, is within 3 f32 ULP of the Pallas
  kernel ``_w4a8_2d_pallas(interpret=True)``, the band measured between the
  JAX package's own W8A8 lowerings (tests/test_torch_quant.py).
- The int4 decode layer: the port's plain version against the JAX
  megakernel's w4 variant in interpret mode, relative Frobenius error
  <= 1e-3 (both sides take the same exact integer sums; only f32 summation
  order differs).
- Greedy (top_k=1) token traces equal to the JAX engine with its megakernel
  (``T5G_FUSED_ATTN=3``, layer scan) for the ``paged``, ``paged_i8`` and
  ``dense`` caches, with the head int4 and with ``head_bits=8``, on model
  seed 1. Exact equality needs that no int8 rounding decision (an
  activation or page level) lands within f32 rounding of its boundary, or
  the flipped level grows through the later quantizations into the
  logits. Int4 weights make such flips frequent, so a sweep over model
  seeds 0-7 (``paged_i8``, the JAX loop compiled) holds every seed to what
  a flip allows: each row's logits agree with the JAX engine's to f32
  rounding (relative 1e-5) until one step where they jump by a flip's
  size (>= 1e-3) and stay within its cascade (<= 5e-2), and the tokens
  part only at or after that jump.
- The grouped int4 reference (``Quant4Weight``, ``q4_matmul``) bit-equal to
  the JAX package's.

The hand-written kernels are held to the plain versions on a card by
tests/test_torch_int4_cuda.py, which imports no JAX.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, backbone_preset, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import megakernel as jmk
from t5gemma_tts_tpu.ops import quant as jquant
from t5gemma_tts_tpu.ops import rope as jrope
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.device import tree_to
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import quant as tquant

from test_torch_megakernel import LAYERS, _dims, _layer_params, _rel, _slabs

torch.set_num_threads(1)
TOL = 1e-3
MAX_FRAMES = 48


def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# levels, scales, bridge
# ---------------------------------------------------------------------------

SHAPES = [((64, 1000), False), ((64, 1000), True), ((3, 64, 200), False),
          ((3, 128, 64), True), ((2, 1024, 64), True)]


@pytest.fixture(scope="module")
def lanes4():
    """Each shape's weights and their JAX lanes4 quantization, once."""
    out = {}
    for shape, k_major in SHAPES:
        w = _weights(0, shape)
        jw = jquant.quantize_weight_lanes4(jnp.asarray(w), k_major=k_major)
        levels = jquant.dequantize_lanes4(
            jw._replace(scale=jnp.ones_like(jw.scale)))
        out[shape, k_major] = (w, _np(jw), np.asarray(levels),
                               np.asarray(jquant.dequantize_lanes4(jw)))
    return out


@pytest.mark.parametrize("shape,k_major", SHAPES)
def test_int4_levels_and_scales_equal_lanes4(lanes4, shape, k_major):
    """N not a multiple of 512, stacked leaves, both pairings."""
    w, jw, levels, deq = lanes4[shape, k_major]
    tw = tquant.quantize_weight_int4_lanes(torch.from_numpy(w))
    n = shape[-1]
    assert tw.n == jw.n == n and tw.packed.shape == (*shape[:-2], n,
                                                     shape[-2] // 2)
    np.testing.assert_array_equal(
        tquant.weight_levels(tw).transpose(-1, -2).numpy(), levels)
    np.testing.assert_array_equal(tw.scale.numpy(), jw.scale[..., :n])
    np.testing.assert_array_equal(tquant.dequantize(tw).numpy(), deq)
    assert int(tquant.weight_levels(tw).abs().max()) == 7


def test_int4_packing_round_trips_every_level():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 4)        # [3, 64]
    q = q[:, torch.randperm(64, generator=torch.Generator().manual_seed(0))]
    packed = tquant.pack_int4(q)
    assert packed.shape == (3, 32) and packed.dtype == torch.int8
    assert torch.equal(tquant.int4_levels(packed), q)
    # byte 4g + j: level 8g + j low, level 8g + 4 + j high
    b = int(packed[1, 5]) & 0xFF
    assert (b & 15) == int(q[1, 9]) & 15 and (b >> 4) == int(q[1, 13]) & 15


@pytest.mark.parametrize("shape,k_major", SHAPES)
def test_bridge_carries_lanes4_both_ways(lanes4, shape, k_major):
    w, jw, _, _ = lanes4[shape, k_major]
    got = bridge.params_from_jax(jw, "cpu")
    want = tquant.quantize_weight_int4_lanes(torch.from_numpy(w))
    assert isinstance(got, tquant.Int4Weight) and got.n == want.n
    assert torch.equal(got.packed, want.packed)
    assert torch.equal(got.scale, want.scale)
    if len(shape) == 2 and k_major:
        return      # no tree holds a 2-D "l4k" leaf: the head's w2 is "l4n"
    name = "down" if k_major else "qkv"
    path = ("decoder", name) if len(shape) == 3 else ("head", "w2")
    back = bridge.params_to_numpy({path[0]: {path[1]: got}})[path[0]][path[1]]
    assert back.layout == jw.layout
    np.testing.assert_array_equal(back.packed, jw.packed)
    np.testing.assert_array_equal(back.scale, jw.scale)


def test_bridge_to_numpy_product_equals_port():
    """Port weight -> numpy -> the JAX XLA product equals the port's plain
    product on the same activations."""
    tw = tquant.quantize_weight_int4_lanes(torch.from_numpy(
        _weights(2, (64, 700))))
    jw = bridge.params_to_numpy({"head": {"w2": tw}})["head"]["w2"]
    x = (np.random.default_rng(3).standard_normal((5, 64)) * 2).astype(
        np.float32)
    want = np.asarray(jquant._w4a8_2d_xla(jnp.asarray(x),
                                          jquant.Lanes4Weight(*jw)))[:, :700]
    got = tquant.w4a8_matmul_plain(torch.from_numpy(x), tw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_layer_params_and_tree_to_carry_int4():
    w = tquant.quantize_weight_int4_lanes(torch.from_numpy(
        _weights(9, (3, 64, 48))))
    lw = tt5.layer_params({"a": {"w": w}}, 2)["a"]["w"]
    assert isinstance(lw, tquant.Int4Weight) and lw.n == 48
    assert torch.equal(lw.packed, w.packed[2])
    assert torch.equal(lw.scale, w.scale[2])
    moved = tree_to({"w": w}, torch.device("cpu"))["w"]
    assert isinstance(moved, tquant.Int4Weight) and moved.packed is w.packed


# ---------------------------------------------------------------------------
# the W4A8 product and the grouped reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [17, 65, 129])
def test_w4a8_plain_matches_jax_at_tile_edges(m):
    """The plain W4A8 product equals ``_w4a8_2d_xla`` at row counts one past
    a tile of the card's routes (16, 64 and 128 rows), odd N, small K."""
    rng = np.random.default_rng(30 + m)
    x = (rng.standard_normal((m, 96)) * 1.5).astype(np.float32)
    jw = jquant.quantize_weight_lanes4(jnp.asarray(_weights(31, (96, 77))),
                                       k_major=False)
    tw = bridge.params_from_jax(_np(jw), "cpu")
    want = np.asarray(jquant._w4a8_2d_xla(jnp.asarray(x), jw))[:, :77]
    got = tquant.w4a8_matmul_plain(torch.from_numpy(x), tw)
    assert got.shape == (m, 77)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a8_plain_matches_jax(dtype, m):
    rng = np.random.default_rng(10 + m)
    x = (rng.standard_normal((m, 64)) * 1.5).astype(np.float32)
    jw = jquant.quantize_weight_lanes4(jnp.asarray(_weights(4, (64, 1000))),
                                       k_major=False)
    tw = bridge.params_from_jax(_np(jw), "cpu")
    jx = jnp.asarray(x, dtype)
    tx = bridge.params_from_jax(np.asarray(jx), "cpu")
    xla = np.asarray(jquant._w4a8_2d_xla(jx, jw).astype(jnp.float32))
    got = tquant.w4a8_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, 1000)
    np.testing.assert_array_equal(got.float().numpy(), xla[:, :1000])
    if dtype == "float32":
        pallas = np.asarray(jquant._w4a8_2d_pallas(jx, jw, interpret=True))
        np.testing.assert_array_max_ulp(got.numpy(), pallas[:, :1000],
                                        maxulp=3)
    lead = tquant.q_matmul(tx.reshape(m, 1, 64), tw)
    assert torch.equal(lead.reshape(m, 1000), got)


def test_grouped_int4_reference_matches_jax():
    w = _weights(5, (2, 256, 300))
    jg = jquant.quantize_weight_int4(jnp.asarray(w))
    tg = tquant.quantize_weight_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(tg.packed.numpy(),
                                  np.asarray(jg.packed)[..., :300])
    np.testing.assert_array_equal(tg.scale.numpy(),
                                  np.asarray(jg.scale)[..., :300])
    np.testing.assert_array_equal(tquant.unpack_int4(tg.packed).numpy(),
                                  np.asarray(jquant.unpack_int4(jg.packed))
                                  [..., :300])
    np.testing.assert_array_equal(tquant.dequantize_int4(tg).numpy(),
                                  np.asarray(jquant.dequantize_int4(jg)))
    jg2 = jquant.quantize_weight_int4(jnp.asarray(w[0]), group=64)
    tg2 = tquant.quantize_weight_int4(torch.from_numpy(w[0]), group=64)
    x = np.random.default_rng(6).standard_normal((3, 7, 256)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tquant.q4_matmul(torch.from_numpy(x), tg2).numpy(),
        np.asarray(jquant.q4_matmul(jnp.asarray(x), jg2)))
    with pytest.raises(ValueError, match="multiple of group"):
        tquant.quantize_weight_int4(torch.zeros((200, 8)))


# ---------------------------------------------------------------------------
# the int4 decode layer against the JAX megakernel (w4, interpret mode)
# ---------------------------------------------------------------------------


def _case(b, quant, seed=0):
    jdims, tdims = _dims(128)
    rng = np.random.default_rng(seed + 10 * b + int(quant))
    jparams = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, _layer_params(jdims, seed)),
        streaming_tiled=True, weight_bits=4)
    jlayers = jparams["decoder"]["layers"]
    assert jmk.uses_w4(jlayers)
    hd = jdims.head_dim
    cos, sin = (np.asarray(x)[:, 0] for x in jrope.rope_cos_sin(
        jnp.asarray(rng.uniform(0, 100, (b, 1)), jnp.float32), hd,
        jdims.rope_theta))
    qcos, qsin = (np.asarray(x)[:, 0] for x in jrope.rope_cos_sin(
        jnp.asarray(rng.uniform(0, 2000, (b, 1)), jnp.float32), hd,
        jdims.rope_theta))
    slabs, scales = _slabs(rng, jdims, b, quant)
    inputs = dict(
        h=(rng.standard_normal((b, jdims.hidden_size)) * 2.0).astype(
            np.float32),
        cos=cos, sin=sin, qcos=qcos, qsin=qsin,
        plens=np.asarray([130, 77][:b], np.int32),
        glens=np.asarray([5, 0][:b], np.int32),
        elens=np.asarray([9, 0][:b], np.int32),
        prompt_k=slabs[0], prompt_v=slabs[1], gen_k=slabs[2], gen_v=slabs[3],
        cross_k=slabs[4], cross_v=slabs[5])
    args = {k: jnp.asarray(v) for k, v in inputs.items()}
    ks = None if scales is None else tuple(jnp.asarray(s) for s in scales)
    want = jmk.decode_layer(jlayers, jdims, li=1, kv_scales=ks,
                            interpret=True, **args)
    return dict(tdims=tdims, inputs=inputs, scales=scales,
                tlayers=bridge.params_from_jax(_np(jlayers), "cpu"),
                want=tuple(np.asarray(x) for x in want))


def _targs(c):
    """Fresh port copies of a case's inputs (tests may write into them)."""
    ks = None if c["scales"] is None else tuple(
        torch.from_numpy(np.array(s)) for s in c["scales"])
    return bridge.params_from_jax(c["inputs"], "cpu"), ks


LAYER_CASES = {"bf16-b1": (1, False), "bf16-b2": (2, False),
               "i8-b1": (1, True), "i8-b2": (2, True)}


@pytest.fixture(scope="module")
def layer_cases():
    """Each case with the JAX w4 megakernel's outputs for its layer 1."""
    return {name: _case(b, quant) for name, (b, quant) in LAYER_CASES.items()}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_int4_decode_layer_matches_jax(layer_cases, name):
    c = layer_cases[name]
    assert isinstance(c["tlayers"]["mlp"]["down"], tquant.Int4Weight)
    args, ks = _targs(c)
    got = tmk.decode_layer(c["tlayers"], c["tdims"], li=1, kv_scales=ks,
                           **args)
    for g, w in zip(got, c["want"]):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("name", ["bf16-b2", "i8-b2"])
def test_int4_decode_layer_ignores_tokens_past_lengths(layer_cases, name):
    c = layer_cases[name]
    args, ks = _targs(c)
    clean = tmk.decode_layer(c["tlayers"], c["tdims"], li=1, kv_scales=ks,
                             **args)
    b = args["h"].shape[0]
    for seg, lens, value in (("prompt", "plens", 99), ("gen", "glens", 55),
                             ("cross", "elens", 77)):
        for row in range(b):
            n = int(args[lens][row])
            keep = max(n, 1) if seg == "cross" else n
            for li in range(LAYERS):
                args[seg + "_k"][:, li * b + row, keep:] = value
                args[seg + "_v"][:, li * b + row, keep:] = -value
    got = tmk.decode_layer(c["tlayers"], c["tdims"], li=1, kv_scales=ks,
                           **args)
    for g, cl, w in zip(got, clean, c["want"]):
        assert torch.equal(g, cl)
        assert _rel(g, w) <= TOL


def test_int4_decode_stack_is_a_loop_of_layers(layer_cases):
    c = layer_cases["i8-b2"]
    args, ks = _targs(c)
    h, k, v = tmk.decode_stack(c["tlayers"], c["tdims"], kv_scales=ks,
                               **args)
    hl = args["h"]
    for li in range(LAYERS):
        hl, kl, vl = tmk.decode_layer(c["tlayers"], c["tdims"], li=li,
                                      kv_scales=ks, **dict(args, h=hl))
        assert torch.equal(kl, k[li]) and torch.equal(vl, v[li])
    assert torch.equal(hl, h)


def test_supports_int4_and_refuses_mixed(layer_cases):
    c = layer_cases["bf16-b1"]
    dims = dataclasses.replace(c["tdims"], sliding_window=512)
    cache = tt5.init_paged_cache(dims, 1, 5, 6, 7)
    assert tmk.supports(c["tlayers"], dims, cache)
    mixed = dict(c["tlayers"], mlp=dict(c["tlayers"]["mlp"]))
    w = tquant.dequantize(mixed["mlp"]["down"])
    mixed["mlp"]["down"] = tquant.QuantWeight(
        *tquant.quantize_weight(w)[:2], w.shape[-1])
    assert not tmk.supports(mixed, dims, cache)


# ---------------------------------------------------------------------------
# the slice end to end: greedy traces, leaf choice, pipeline, CLI
# ---------------------------------------------------------------------------


def _cfg(preset, tiny):
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, extra_cutoff=0.3)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    params = jt5.fuse_for_decode(jvoice.init_params(jax.random.PRNGKey(1),
                                                    jcfg))
    rng = np.random.default_rng(5)
    b = 3
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([4, 19, 32], np.int32)
    prompt = np.full((b, 64), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 12, 30], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([8, 20, 14], np.int32)
    return dict(jcfg=jcfg, params=_np(params),
                tcfg=_cfg(tconfig.backbone_preset, tconfig.tiny_voice_config),
                inputs=(x, x_lens, prompt, plens, targets))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _kernel_counts():
    return (tmk.decode_stack.launches, tmk.decode_layer.launches,
            tquant.w4a8_matmul.launches, tquant.w8a8_matmul.launches)


@pytest.mark.parametrize("kv_cache,head_bits", [
    ("paged", 4), ("paged_i8", 4), ("dense", 4), ("paged_i8", 8)])
def test_int4_greedy_token_traces_equal(setup, kv_cache, head_bits):
    qparams = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]),
        streaming_tiled=True, weight_bits=4, head_bits=head_bits)
    assert isinstance(qparams["head"]["w2"],
                      jquant.Lanes4Weight if head_bits == 4
                      else jquant.QuantWeight)
    tparams = bridge.params_from_jax(_np(qparams), "cpu")
    jd = DecodeConfig(top_k=1, kv_cache=kv_cache, max_frames=MAX_FRAMES)
    td = tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache,
                              max_frames=MAX_FRAMES)
    os.environ["T5G_FUSED_ATTN"] = "3"
    os.environ["T5G_MK_STACKED"] = "0"
    try:
        want = jeng.decode_tokens(
            qparams, setup["jcfg"], jd,
            *(jnp.asarray(a) for a in setup["inputs"]),
            jax.random.PRNGKey(0))
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
        os.environ.pop("T5G_MK_STACKED", None)
    before = _kernel_counts()
    got = teng.decode_tokens(
        tparams, setup["tcfg"], td,
        *(torch.from_numpy(a) for a in setup["inputs"]),
        0)
    # the CPU runs the plain versions: no kernel was launched
    assert _kernel_counts() == before
    want_lens = np.asarray(want.gen_lens)
    assert len(set(want_lens.tolist())) == 3 and want_lens.max() < MAX_FRAMES
    np.testing.assert_array_equal(got.gen_lens.numpy(), want_lens)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)


SWEEP_SEEDS = range(8)
F32_REL = 1e-5       # logits from equal inputs: summation order alone
FLIP_REL = 1e-3      # the least jump one flipped int8 level makes
CASCADE_REL = 5e-2   # the most a flip's cascade reaches


def _int4_params(seed, jcfg):
    return jquant.quantize_params_for_decode(
        jt5.fuse_for_decode(jvoice.init_params(jax.random.PRNGKey(seed),
                                               jcfg)),
        streaming_tiled=True, weight_bits=4)


@pytest.fixture(scope="module")
def jax_sweep(setup):
    """Per sweep seed: the int4 weights (numpy) and the JAX engine's tokens,
    lengths and per-step logits [steps, B, V] (``paged_i8``, the loop
    compiled once for all seeds)."""
    logits = {}
    sample = jeng._candidate_sample

    def recorded(cfg, dcfg, lg, step, *a, **k):
        jax.debug.callback(
            lambda s, v: logits.__setitem__(int(s), np.asarray(v, np.float32)),
            step, lg)
        return sample(cfg, dcfg, lg, step, *a, **k)

    jd = DecodeConfig(top_k=1, kv_cache="paged_i8", max_frames=MAX_FRAMES)
    names = ("x", "x_lens", "prompt", "prompt_lens", "target_totals")
    inputs = dict(zip(names, map(jnp.asarray, setup["inputs"])))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_candidate_sample", recorded)
        mp.setenv("T5G_FUSED_ATTN", "3")
        mp.setenv("T5G_MK_STACKED", "0")
        run = jax.jit(functools.partial(jeng.decode_tokens,
                                        cfg=setup["jcfg"], dcfg=jd))
        for seed in SWEEP_SEEDS:
            q = _int4_params(seed, setup["jcfg"])
            logits.clear()
            res = run(q, rng=jax.random.PRNGKey(0), **inputs)
            jax.effects_barrier()
            out[seed] = (_np(q), np.asarray(res.tokens),
                         np.asarray(res.gen_lens),
                         np.stack([logits[t] for t in range(len(logits))]))
    return out


@pytest.mark.parametrize("seed", SWEEP_SEEDS)
def test_int4_greedy_traces_part_only_after_a_rounding_flip(
        setup, jax_sweep, seed, monkeypatch):
    """Any model seed: per row, the logits agree with the JAX engine's to
    f32 rounding until one step where they jump by a flipped int8 level's
    effect, stay within that cascade's size, and the tokens part only at
    or after the jump; some row starts at f32 rounding."""
    qparams, want, want_lens, jlogits = jax_sweep[seed]
    tlogits = {}
    sample = teng._candidate_sample

    def recorded(cfg, dcfg, lg, step, *a, **k):
        tlogits[int(step)] = lg.float().numpy().copy()
        return sample(cfg, dcfg, lg, step, *a, **k)

    monkeypatch.setattr(teng, "_candidate_sample", recorded)
    got = teng.decode_tokens(
        bridge.params_from_jax(qparams, "cpu"), setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache="paged_i8",
                             max_frames=MAX_FRAMES),
        *(torch.from_numpy(a) for a in setup["inputs"]),
        0)
    tokens, lens = got.tokens.numpy(), got.gen_lens.numpy()
    first = []
    for r in range(len(want_lens)):
        n = max(lens[r], want_lens[r])
        parted = np.nonzero(tokens[r, :n] != want[r, :n])[0]
        if not len(parted):
            assert lens[r] == want_lens[r], (seed, r)
        end = parted[0] + 1 if len(parted) else n
        rel = np.asarray([np.linalg.norm(tlogits[t][r] - jlogits[t, r])
                          / np.linalg.norm(jlogits[t, r])
                          for t in range(end)])
        jump = np.nonzero(rel > F32_REL)[0]
        first.append(rel[0])
        assert rel.max() <= CASCADE_REL, (seed, r, rel.max())
        if len(jump):
            assert rel[jump[0]] >= FLIP_REL, (seed, r, rel[jump[0]])
        if len(parted):
            assert len(jump) and jump[0] <= parted[0], (seed, r)
    # a flip is a rare event: a fault that moves every row's logits from
    # the first step on is not one
    assert min(first) <= F32_REL, (seed, first)


def test_int4_leaf_choice_equals_jax(setup):
    """The port's own weight_bits=4 quantization holds exactly the JAX
    package's int4 and int8 leaves, level for level: the six decode-layer
    products and the head's w2 int4, cross K/V and the head's w1 int8, the
    encoder unquantized."""
    jq = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]),
        streaming_tiled=True, weight_bits=4)
    via_bridge = dict(_leaves(bridge.params_from_jax(_np(jq), "cpu")))
    own = dict(_leaves(tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), weight_bits=4)))
    assert via_bridge.keys() == own.keys()
    kinds = {}
    for path, w in own.items():
        g = via_bridge[path]
        assert type(g) is type(w), path
        if isinstance(w, (tquant.QuantWeight, tquant.Int4Weight)):
            kinds[path] = type(w).__name__
            assert g.n == w.n and torch.equal(g.scale, w.scale), path
            assert torch.equal(tquant.weight_levels(g),
                               tquant.weight_levels(w)), path
        else:
            assert torch.equal(g, w), path
    lay = ("decoder", "layers")
    assert {p for p, k in kinds.items() if k == "Int4Weight"} == {
        lay + ("self_attn", "qkv"), lay + ("self_attn", "o"),
        lay + ("cross_attn", "q"), lay + ("cross_attn", "o"),
        lay + ("mlp", "gate_up"), lay + ("mlp", "down"), ("head", "w2")}
    assert {p for p, k in kinds.items() if k == "QuantWeight"} == {
        lay + ("cross_attn", "k"), lay + ("cross_attn", "v"),
        ("head", "w1")}
    head8 = tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), weight_bits=4,
        head_bits=8)
    assert isinstance(head8["head"]["w2"], tquant.QuantWeight)


def test_int4_falls_back_to_int8_when_widths_do_not_fit(setup, caplog):
    params = bridge.params_from_jax(setup["params"], "cpu")
    dec = params["decoder"]["layers"]
    # an intermediate size of 640 neither tiles by 512 nor fits one tile
    mlp = dict(dec["mlp"], gate_up=torch.zeros((4, 64, 1280)),
               down=torch.zeros((4, 640, 64)))
    params["decoder"]["layers"] = dict(dec, mlp=mlp)
    assert tmk.widths_fit(64, 64, 128) and not tmk.widths_fit(64, 64, 640)
    out = tquant.quantize_params_for_decode(params, weight_bits=4)
    assert "quantizing int8" in caplog.text
    assert all(not isinstance(w, tquant.Int4Weight)
               for _, w in _leaves(out))


def test_int4_step_takes_the_decode_layer_path(setup, monkeypatch):
    """With int4 decoder weights each paged step is one decode_stack call
    and no batch_paged_attention call; the head's w2 is one W4A8 product
    per step."""
    from t5gemma_tts_tpu_torch.ops import fused_attn

    tparams = tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), weight_bits=4)
    calls = {"stack": 0, "attn": 0, "w4": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tmk, "decode_stack",
                        count("stack", tmk.decode_stack))
    monkeypatch.setattr(fused_attn, "batch_paged_attention",
                        count("attn", fused_attn.batch_paged_attention))
    monkeypatch.setattr(tquant, "w4a8_matmul", count("w4", tquant.w4a8_matmul))
    out = teng.decode_tokens(
        tparams, setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache="paged_i8", max_frames=8),
        *(torch.from_numpy(a) for a in setup["inputs"]),
        0)
    assert calls["stack"] == out.steps and calls["attn"] == 0
    assert calls["w4"] >= out.steps


def _char_tokenizer(text):
    return [3 + (ord(c) % 500) for c in text]


def test_int4_pipeline_gives_finite_waveforms(setup):
    tparams = bridge.params_from_jax(
        _np(jvoice.init_params(jax.random.PRNGKey(7), setup["jcfg"])), "cpu")
    ccfg = tcodec.tiny_codec_config()
    tok = ttok.AudioTokenizer(tcodec.init_decoder_params(0, ccfg, "cpu"),
                              ccfg, device="cpu")
    pipe = tpipe.TTSPipeline(tparams, setup["tcfg"], _char_tokenizer, tok,
                             device="cpu", int4=True)
    dec = pipe.params["decoder"]["layers"]
    assert isinstance(dec["self_attn"]["qkv"], tquant.Int4Weight)
    assert isinstance(dec["cross_attn"]["k"], tquant.QuantWeight)
    assert isinstance(pipe.params["head"]["w2"], tquant.Int4Weight)
    reqs = [tpipe.Request(target_text="int4 weights", target_duration=0.4,
                          lang="en")]
    for kv_cache in ("paged", "paged_i8"):
        (r,) = pipe.synthesize_batch(
            reqs, tconfig.DecodeConfig(top_k=4, kv_cache=kv_cache), seed=0,
            quiet=True)
        assert len(r.gen_frames) > 0
        assert r.wav.shape == (len(r.gen_frames) * ccfg.hop_length,)
        assert np.isfinite(r.wav).all()


def test_cli_serves_int4(tmp_path):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from t5gemma_tts_tpu.export import hf_export
    from t5gemma_tts_tpu_torch.inference import audio_io, cli

    from test_torch_pipeline import _offline_tokenizer

    cfg = tiny_voice_config()
    params = jvoice.init_params(jax.random.PRNGKey(0), cfg)
    model_dir, tok_dir = str(tmp_path / "model"), str(tmp_path / "tok")
    _offline_tokenizer(tok_dir, cfg.text_vocab_size)
    hf_export.export_hf(params, cfg, model_dir, dtype="float32",
                        text_tokenizer_name=tok_dir)
    out_dir = str(tmp_path / "out")
    cli.main(["--model_dir", model_dir,
              "--target_text", "hello world this is a test",
              "--target_duration", "0.4", "--output_dir", out_dir,
              "--random_codec", "--top_k", "4", "--lang", "en",
              "--dump_tokens", "--device", "cpu", "--quantize", "int4"])
    wav, sr = audio_io.read_wav(os.path.join(out_dir, "generated.wav"))
    frames = np.load(os.path.join(out_dir, "generated_frames.npy"))
    assert sr == 44100 and len(frames) > 0
    assert len(wav) == len(frames) * 882 and np.isfinite(wav).all()


@pytest.mark.parametrize("weights,batch", [("int4", 1), ("int8", 4)])
def test_chip_smoke_holds_every_product_of_the_path(weights, batch,
                                                    monkeypatch):
    """chip_smoke.py holds the W8A8 and W4A8 kernels to their plain versions
    at the products its run_products names for a main-path run: exactly
    the (kernel, M, N) that the path sends them (here on the CPU, at the
    tiny config)."""
    from collections import Counter

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bb = tconfig.backbone_preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    cfg = tconfig.tiny_voice_config(backbone=dataclasses.replace(
        bb, encoder=dims, decoder=dims), extra_cutoff=0.5)
    pipe = smoke.build_pipeline(cfg, tcodec.tiny_codec_config(), "cpu",
                                seed=0, int8=weights == "int8",
                                int4=weights == "int4")
    sent = Counter()
    for name in ("w4a8_matmul", "w8a8_matmul"):
        def counted(x, w, *a, _fn=getattr(tquant, name), _name=name, **k):
            sent[_name, x.shape[0], w.n] += 1
            return _fn(x, w, *a, **k)
        monkeypatch.setattr(tquant, name, counted)
    reqs = [tpipe.Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(smoke.TEXTS, smoke.DURATIONS)][-batch:]
    pipe.synthesize_batch(reqs, tconfig.DecodeConfig(kv_cache="paged_i8"),
                          seed=0, quiet=True, decode_audio=False)
    tx, p_max, _ = pipe.widths([pipe.plan_request(r) for r in reqs])
    run = {"pipe": pipe, "batch": batch, "prefill_rows": batch * (p_max + 1),
           "cross_rows": batch * tx}
    named = {("w4a8_matmul" if isinstance(w, tquant.Int4Weight)
              else "w8a8_matmul", m, w.n)
             for _, m, w in smoke.run_products(run)}
    assert named == set(sent)

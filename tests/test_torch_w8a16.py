"""The port's W8A16 weights (``act_bits=16``) against the JAX package's.

- Levels and scales: ``quantize_weight(act_bits=16)`` equals the JAX
  ``quantize_weight(act_bits=16)`` bit for bit (they are the W8A8 levels;
  only the flag differs).
- The product: ``w8a16_matmul_plain`` against ``_qmm_2d(interpret=True)``
  (the Pallas kernel in interpret mode) and against the JAX ``q_matmul`` on
  an ``act_bits=16`` weight. Every bf16 x int8 product is exact in f32, so
  only the order of the f32 sums differs: an f32 output is held to 1e-6 of
  the sum of its terms' magnitudes, a bf16 output to one bf16 ulp.
- ``quantize_params_for_decode(act_bits=16)``, alone, with
  ``weight_bits=4`` and with ``quantize_encoder``, gives the JAX package's
  leaves through the bridge, byte for byte, and the bridge carries them
  back byte-equal.
- Greedy traces of the port's engine against the JAX engine's (``paged``,
  ``paged_i8``, ``dense``; the JAX engine runs its CPU attention modes: 0
  for bf16 pages, 2 for int8 pages). The tiny model computes in f32 and
  the W8A16 product rounds its input to bf16, so an activation that the
  two engines compute 1e-7 apart next to a bf16 rounding midpoint rounds
  to neighbouring bf16 values, and the flip grows through the later
  layers (traced element by element for the encoder below). The traces
  are held to the int4 protocol of tests/test_torch_int4.py: per-step
  logits equal to f32 rounding until a flip's jump, tokens parting only
  after it. Speculative == sequential over ``paged``, the verify pass
  running the W8A16 product at M = B x (k + 1).

The hand-written kernel is held to the plain version on a card by
tests/test_torch_slice5_cuda.py, which imports no JAX, and by
``chip_smoke.py``.
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
from t5gemma_tts_tpu.ops import quant as jquant
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.decode import speculative as tspec
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
MAX_FRAMES = 48
K = 4
SUM_REL = 1e-6       # f32 output: of the sum of |x| |q| s, order of sums alone
F32_REL = 1e-5       # logits from equal bf16 inputs: summation order alone
FLIP_REL = 1e-3      # the least jump one flipped rounding makes in the logits
CASCADE_REL = 5e-2   # the most a flip's cascade reaches


def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# levels, scales, the product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 200), (3, 64, 1024)])
def test_w8a16_levels_and_scales_equal_jax(shape):
    wb = np.asarray(jnp.asarray(_weights(0, shape), jnp.bfloat16))
    want = jquant.quantize_weight(jnp.asarray(wb), act_bits=16)
    got = tquant.quantize_weight(bridge.params_from_jax(wb, "cpu"),
                                 act_bits=16)
    n = shape[-1]
    assert got.act_bits == want.act_bits == 16 and got.n == want.n == n
    np.testing.assert_array_equal(
        got.values.transpose(-1, -2).numpy(), np.asarray(want.values)[..., :n])
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(want.scale)[..., :n])
    # the W8A8 levels and scales, bit for bit
    w8 = tquant.quantize_weight(bridge.params_from_jax(wb, "cpu"))
    assert torch.equal(w8.values, got.values)
    assert torch.equal(w8.scale, got.scale)


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a16_plain_matches_jax(dtype, m):
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, 64)) * 1.5).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(_weights(3, (64, 200))),
                                act_bits=16)
    tw = bridge.params_from_jax(_np(jw), "cpu")
    assert tw.act_bits == 16 and tw.values.shape == (200, 64)
    jx = jnp.asarray(x, dtype)
    tx = bridge.params_from_jax(np.asarray(jx), "cpu")
    kernel = np.asarray(jquant._qmm_2d(jx, jw.values, jw.scale,
                                       interpret=True))[:, :200]
    dispatch = np.asarray(jquant.q_matmul(jx, jw))
    got = tquant.w8a16_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, 200)
    assert torch.equal(tquant.q_matmul(tx.reshape(m, 1, 64), tw)
                       .reshape(m, 200), got)
    g = got.float().numpy()
    if dtype == "float32":
        xb = tx.to(torch.bfloat16).float().abs()
        mag = ((xb @ tw.values.float().abs().t()) * tw.scale).numpy()
        for want in (kernel, dispatch):
            assert np.all(np.abs(g - want) <= SUM_REL * mag)
    else:
        for want in (kernel, dispatch):
            want = want.astype(np.float32)
            assert np.all(np.abs(g - want) <= _bf16_ulp(want))


# ---------------------------------------------------------------------------
# the decode tree
# ---------------------------------------------------------------------------


def _cfg(preset, tiny):
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, extra_cutoff=0.3)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    params = jt5.fuse_for_decode(jvoice.init_params(jax.random.PRNGKey(3),
                                                    jcfg))
    qparams = jquant.quantize_params_for_decode(params, act_bits=16,
                                                streaming_tiled=False)
    rng = np.random.default_rng(5)
    b = 3
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([4, 19, 32], np.int32)
    prompt = np.full((b, 64), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 12, 30], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([8, 20, 14], np.int32)
    return dict(jcfg=jcfg, params=_np(params), qparams=_np(qparams),
                tcfg=_cfg(tconfig.backbone_preset, tconfig.tiny_voice_config),
                tparams=bridge.params_from_jax(_np(qparams), "cpu"),
                inputs=(x, x_lens, prompt, plens, targets))


def _assert_same_leaves(got, want, kinds=None):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        if isinstance(w, (tquant.QuantWeight, tquant.Int4Weight)):
            assert g.n == w.n and torch.equal(g.scale, w.scale), path
            assert torch.equal(tquant.weight_levels(g),
                               tquant.weight_levels(w)), path
            if isinstance(w, tquant.QuantWeight):
                assert g.act_bits == w.act_bits, path
            if kinds is not None:
                kinds[path] = (type(w).__name__,
                               getattr(w, "act_bits", None))
        else:
            assert torch.equal(g, w), path


LAY = ("decoder", "layers")


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_quantize_params_w8a16_equal_jax(setup, weight_bits):
    """The port's act_bits=16 quantization holds the JAX package's leaves:
    alone, every decoder projection and the head's w1/w2 W8A16; with
    weight_bits=4 the six decode-layer products and the head's w2 int4,
    cross K/V and the head's w1 W8A16. The bridge carries them back to the
    JAX layout byte-equal."""
    jq = _np(jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]), act_bits=16,
        weight_bits=weight_bits, streaming_tiled=False))
    own = tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), act_bits=16,
        weight_bits=weight_bits)
    kinds = {}
    _assert_same_leaves(bridge.params_from_jax(jq, "cpu"), own, kinds)
    w16 = {p for p, k in kinds.items() if k == ("QuantWeight", 16)}
    int4 = {p for p, k in kinds.items() if k[0] == "Int4Weight"}
    cross_kv = {LAY + ("cross_attn", "k"), LAY + ("cross_attn", "v")}
    if weight_bits == 8:
        assert not int4 and len(w16) == 10 and cross_kv <= w16
        assert ("head", "w2") in w16
    else:
        assert w16 == cross_kv | {("head", "w1")} and len(int4) == 7
    back = dict(_leaves(bridge.params_to_numpy(own)))
    for path, leaf in _leaves(jq):
        b = back[path]
        if isinstance(leaf, tuple) and hasattr(leaf, "act_bits"):
            assert (b.n, b.act_bits, b.layout) == (leaf.n, 16, leaf.layout)
            assert b.values.tobytes() == np.asarray(leaf.values).tobytes()
            assert b.scale.tobytes() == np.asarray(leaf.scale).tobytes()


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def test_quantize_encoder_equal_jax(setup, monkeypatch):
    """quantize_encoder=True: the encoder's projections become W8A16 leaves
    equal to the JAX package's, and the encoder run through q_matmul gives
    the JAX hidden states within 1e-5, but for rows where one engine rounds
    an activation to the other bf16 neighbour: the two f32 values straddle
    a bf16 rounding midpoint and lie within f32 rounding of each other, and
    the flip then cascades through the later layers. Every product's input
    up to the first flip agrees to f32 rounding; rows without a flip hold
    to 1e-5."""
    jq = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]), act_bits=16,
        quantize_encoder=True, streaming_tiled=False)
    own = tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), act_bits=16,
        quantize_encoder=True)
    kinds = {}
    _assert_same_leaves(bridge.params_from_jax(_np(jq), "cpu"), own, kinds)
    enc = {p for p in kinds if p[0] == "encoder"}
    assert len(enc) == 4 and all(kinds[p] == ("QuantWeight", 16)
                                 for p in enc)
    plain = tquant.quantize_params_for_decode(
        bridge.params_from_jax(setup["params"], "cpu"), act_bits=16)
    assert not isinstance(plain["encoder"]["layers"]["mlp"]["down"],
                          tquant.QuantWeight)

    jx, tx = [], []
    qmm, plain_mm = jquant._qmm_2d, tquant.w8a16_matmul_plain

    def jrec(x, values, scale, interpret=False):
        jax.debug.callback(lambda a: jx.append(np.asarray(a, np.float32)), x,
                           ordered=True)
        return qmm(x, values, scale, interpret=interpret)

    def trec(x, w, out_dtype=None):
        tx.append(x.float().numpy().copy())
        return plain_mm(x, w, out_dtype)

    monkeypatch.setattr(jquant, "_qmm_2d", jrec)
    monkeypatch.setattr(tquant, "w8a16_matmul_plain", trec)
    x, x_lens = setup["inputs"][:2]
    want, _ = jvoice.encode_text(jq, setup["jcfg"], jnp.asarray(x),
                                 jnp.asarray(x_lens))
    jax.effects_barrier()
    got, _ = tvoice.encode_text(own, setup["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(x_lens))
    layers = setup["tcfg"].backbone.encoder.num_layers
    assert len(jx) == len(tx) == 4 * layers
    b, t = x.shape
    flipped = set()
    for a, c in zip(jx, tx):
        a = a.reshape(c.shape)
        if not flipped:            # up to the first flip: f32 rounding
            assert np.all(np.abs(a - c) <= 1e-5 * np.maximum(
                np.abs(a), 1.0)), "inputs part before any flip"
            for row, col in np.argwhere(_bf16(a) != _bf16(c)):
                lo, hi = sorted((float(a[row, col]), float(c[row, col])))
                mid = (_bf16(np.float32(lo)) + _bf16(np.float32(hi))) / 2
                assert lo <= mid <= hi and hi - lo <= 1e-6 * abs(hi)
                flipped.add(row // t)
        else:
            flipped |= {r // t for r in np.nonzero(
                (_bf16(a) != _bf16(c)).any(axis=1))[0]}
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max(axis=(1, 2))
    for row in range(b):
        if row not in flipped:
            assert err[row] <= 1e-5 * max(1.0, np.abs(want[row]).max()), row
    assert len(flipped) < b


# ---------------------------------------------------------------------------
# greedy traces against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_traces(setup):
    """Per cache: the JAX engine's tokens, lengths and per-step logits
    [steps, B, V] on the W8A16 tree (its CPU modes: T5G_FUSED_ATTN unset)."""
    logits = {}
    sample = jeng._candidate_sample

    def recorded(cfg, dcfg, lg, step, *a, **k):
        jax.debug.callback(
            lambda s, v: logits.__setitem__(int(s), np.asarray(v, np.float32)),
            step, lg, ordered=True)
        return sample(cfg, dcfg, lg, step, *a, **k)

    names = ("x", "x_lens", "prompt", "prompt_lens", "target_totals")
    inputs = dict(zip(names, map(jnp.asarray, setup["inputs"])))
    qparams = jax.tree_util.tree_map(jnp.asarray, setup["qparams"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_candidate_sample", recorded)
        mp.delenv("T5G_FUSED_ATTN", raising=False)
        for kv in ("paged", "paged_i8", "dense"):
            jd = DecodeConfig(top_k=1, kv_cache=kv, max_frames=MAX_FRAMES)
            run = jax.jit(functools.partial(jeng.decode_tokens,
                                            cfg=setup["jcfg"], dcfg=jd))
            logits.clear()
            res = run(qparams, rng=jax.random.PRNGKey(0), **inputs)
            jax.effects_barrier()
            out[kv] = (np.asarray(res.tokens), np.asarray(res.gen_lens),
                       int(res.steps),
                       np.stack([logits[t] for t in range(len(logits))]))
    return out


@pytest.mark.parametrize("kv_cache", ["paged", "paged_i8", "dense"])
def test_w8a16_greedy_traces_equal_jax(setup, jax_traces, kv_cache,
                                       monkeypatch):
    """Per row, the logits agree with the JAX engine's to f32 rounding
    until one step where they jump by a flipped bf16 rounding's effect
    (an activation that the two engines, 1e-7 apart, round to neighbouring
    bf16 values before a W8A16 product, or a page level of paged_i8), stay
    within that cascade's size until the tokens part, and the tokens part
    only at or after the jump; some row agrees at f32 rounding at step 0,
    and some row's tokens never part."""
    want, want_lens, want_steps, jlogits = jax_traces[kv_cache]
    tlogits = {}
    sample = teng._candidate_sample

    def recorded(cfg, dcfg, lg, step, *a, **k):
        tlogits[int(step)] = lg.float().numpy().copy()
        return sample(cfg, dcfg, lg, step, *a, **k)

    monkeypatch.setattr(teng, "_candidate_sample", recorded)
    before = (tquant.w8a16_matmul.launches, tmk.decode_stack.launches)
    got = teng.decode_tokens(
        setup["tparams"], setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache,
                             max_frames=MAX_FRAMES),
        *(torch.from_numpy(a) for a in setup["inputs"]), 0)
    # the CPU runs the plain versions: no kernel was launched
    assert (tquant.w8a16_matmul.launches, tmk.decode_stack.launches) == before
    assert len(set(want_lens.tolist())) == 3 and want_lens.max() < MAX_FRAMES
    tokens, lens = got.tokens.numpy(), got.gen_lens.numpy()
    first, whole = [], []
    for r in range(len(want_lens)):
        n = max(lens[r], want_lens[r])
        parted = np.nonzero(tokens[r, :n] != want[r, :n])[0]
        whole.append(not len(parted) and lens[r] == want_lens[r])
        end = parted[0] + 1 if len(parted) else n
        rel = np.asarray([np.linalg.norm(tlogits[t][r] - jlogits[t, r])
                          / np.linalg.norm(jlogits[t, r])
                          for t in range(end)])
        jump = np.nonzero(rel > F32_REL)[0]
        first.append(rel[0])
        assert rel.max() <= CASCADE_REL, (r, rel.max())
        if len(jump):
            assert rel[jump[0]] >= FLIP_REL, (r, rel[jump[0]])
        if len(parted):
            assert len(jump) and jump[0] <= parted[0], r
    assert min(first) <= F32_REL and any(whole), (first, whole)


def test_w8a16_step_takes_the_layer_loop(setup, monkeypatch):
    """W8A16 weights are refused by the decode-layer path: a paged step
    runs the layer loop with the two-segment kernel (mode 3 falls to 2),
    every projection and the head through the W8A16 product."""
    from t5gemma_tts_tpu_torch.ops import fused_attn

    assert not tmk.supports(setup["tparams"]["decoder"]["layers"],
                            setup["tcfg"].backbone.decoder,
                            tt5.init_paged_cache(
                                setup["tcfg"].backbone.decoder, 1, 1, 1, 1))
    calls = {"stack": 0, "attn": 0, "w16": 0, "w8": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tmk, "decode_stack", count("stack", tmk.decode_stack))
    monkeypatch.setattr(fused_attn, "batch_paged_attention",
                        count("attn", fused_attn.batch_paged_attention))
    monkeypatch.setattr(tquant, "w8a16_matmul",
                        count("w16", tquant.w8a16_matmul))
    monkeypatch.setattr(tquant, "w8a8_matmul", count("w8", tquant.w8a8_matmul))
    out = teng.decode_tokens(
        setup["tparams"], setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache="paged", max_frames=8),
        *(torch.from_numpy(a) for a in setup["inputs"]), 0)
    layers = setup["tcfg"].backbone.decoder.num_layers
    assert calls["stack"] == calls["w8"] == 0
    assert calls["attn"] == 2 * layers * out.steps
    # cross K/V and the six prefill products, then per step the six layer
    # products and the head's w1 and w2
    assert calls["w16"] == 8 * layers + out.steps * (6 * layers + 2)


def test_w8a16_speculative_equals_sequential(setup, monkeypatch):
    """Speculative == sequential over bf16 pages with W8A16 weights: the
    verify pass takes the unfused chain, its projections the W8A16 product
    at M = B x (k + 1)."""
    dcfg = tconfig.DecodeConfig(top_k=1, kv_cache="paged",
                                max_frames=MAX_FRAMES)
    inputs = tuple(torch.from_numpy(a) for a in setup["inputs"])
    seq = teng.decode_tokens(setup["tparams"], setup["tcfg"], dcfg, *inputs, 7)
    rows = set()
    product = tquant.w8a16_matmul

    def recorded(x, w, *a, **k):
        rows.add(x.shape[0])
        return product(x, w, *a, **k)

    monkeypatch.setattr(tquant, "w8a16_matmul", recorded)
    bad = seq.tokens.clone()
    bad[:, 3::4] = (bad[:, 3::4] + 1) % setup["tcfg"].audio_vocab_size
    for trace in (seq.tokens, bad):
        got = tspec.decode_tokens_speculative(
            setup["tparams"], setup["tcfg"], dcfg, *inputs, 7,
            tspec.trace_draft_fn(trace, K), K)
        np.testing.assert_array_equal(got.tokens.numpy(), seq.tokens.numpy())
        np.testing.assert_array_equal(got.gen_lens.numpy(),
                                      seq.gen_lens.numpy())
        assert got.passes < got.steps
    assert len(inputs[0]) * (K + 1) in rows


def _char_tokenizer(text):
    return [3 + (ord(c) % 500) for c in text]


def test_w8a16_pipeline_gives_finite_waveforms(setup):
    """The W8A16 route: quantize_params_for_decode(fuse_for_decode(params),
    act_bits=16), then TTSPipeline(params, fuse_matmuls=False)."""
    params = bridge.params_from_jax(
        _np(jvoice.init_params(jax.random.PRNGKey(7), setup["jcfg"])), "cpu")
    params = tquant.quantize_params_for_decode(tt5.fuse_for_decode(params),
                                               act_bits=16)
    ccfg = tcodec.tiny_codec_config()
    tok = ttok.AudioTokenizer(tcodec.init_decoder_params(0, ccfg, "cpu"),
                              ccfg, device="cpu")
    pipe = tpipe.TTSPipeline(params, setup["tcfg"], _char_tokenizer, tok,
                             fuse_matmuls=False, device="cpu")
    qkv = pipe.params["decoder"]["layers"]["self_attn"]["qkv"]
    assert isinstance(qkv, tquant.QuantWeight) and qkv.act_bits == 16
    assert pipe.params["head"]["w2"].act_bits == 16
    reqs = [tpipe.Request(target_text=t, target_duration=d, lang="en")
            for t, d in (("hello world", 0.3), ("w8a16 weights", 0.4))]
    for kv_cache in ("paged", "paged_i8", "dense"):
        res = pipe.synthesize_batch(
            reqs, tconfig.DecodeConfig(top_k=4, kv_cache=kv_cache), seed=0,
            quiet=True)
        for r in res:
            assert len(r.gen_frames) > 0
            assert r.wav.shape == (len(r.gen_frames) * ccfg.hop_length,)
            assert np.isfinite(r.wav).all()


def test_chip_smoke_holds_every_w8a16_product_of_the_path(monkeypatch):
    """chip_smoke.py holds the W8A16 kernel at exactly the (M, N) that its
    main path sends it (run_products), and its launch count formula
    matches the path's calls (here on the CPU, at the tiny config)."""
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
                                seed=0, w8a16=True)
    sent = Counter()
    product = tquant.w8a16_matmul

    def counted(x, w, *a, **k):
        sent[x.shape[0], w.n] += 1
        return product(x, w, *a, **k)

    monkeypatch.setattr(tquant, "w8a16_matmul", counted)
    reqs = [tpipe.Request(target_text=t, target_duration=d, lang="en")
            for t, d in zip(smoke.TEXTS, smoke.DURATIONS)]
    (res, *_) = pipe.synthesize_batch(
        reqs, tconfig.DecodeConfig(kv_cache="paged"), seed=0, quiet=True,
        decode_audio=False)
    tx, p_max, _ = pipe.widths([pipe.plan_request(r) for r in reqs])
    run = {"pipe": pipe, "batch": 4, "prefill_rows": 4 * (p_max + 1),
           "cross_rows": 4 * tx}
    assert {(m, w.n) for _, m, w in smoke.run_products(run)} == set(sent)
    assert sum(sent.values()) == smoke.w8a16_launches(cfg.backbone.decoder
                                                      .num_layers, res.steps)

"""The port's speculative decode (decode/speculative.py) and its verify pass
against the JAX package, and against the port's own sequential engine.

- bf16 weights, ``dense`` and ``paged`` caches: greedy traces token-equal to
  the JAX speculative engine with the MTP draft (random heads, carried over
  by the bridge) and with an oracle draft, at the JAX suite's
  ``paged_setup`` widths; the same at the buffer's end (``max_frames=8``).
  The paged verify pass runs the one-segment kernel's plain version and the
  chain merge; the JAX one its dense branch of ``paged_flash_parts``.
- ``paged_f8``: the port's sequential engine (kernel 1's e4m3 variant, plain
  on the CPU) token-equal to the JAX engine's.
- The port against itself: speculative == sequential, token for token, for
  greedy and sampled decoding (top-k 8, top-p 0.9, T 0.8) with both
  drafts, on the dense, paged and paged_f8 caches. This holds because the
  draws of step s depend only on (seed, s) (``sampling.step_uniform``).
- The chain paths (int8 and int4 decode weights over ``paged`` and
  ``paged_i8`` pages: ``decode_stack(chain=5)``, plain on the CPU): the
  decode layer at chain 5 against the JAX megakernel's chain variant in
  interpret mode (relative Frobenius 1e-3, as for chain 1); greedy traces
  against the JAX speculative engine (``T5G_FUSED_ATTN=3``) with the same
  draft, held as tests/test_torch_int4.py holds int4 traces: per row the
  logits agree to f32 rounding until one step where an int8 rounding
  decision flips (a jump of at least 1e-3 relative, at most 5e-2), and the
  tokens part only at or after it; and the JAX suite's own properties:
  the stream barely depends on the draft (agreement above 0.85) and the
  oracle draft gives more than 2 tokens per pass.
- ``paged_i8`` without quantized weights raises, naming the megakernel;
  the draft heads cross the bridge both ways byte for byte.
- ``mtp_loss``: its value within 1e-6 relative of JAX's and its gradient
  within 1e-5 of each leaf's largest, over masked positions; ten gradient
  steps lower it.

The hand-written kernels are held to these plain versions on a card by
tests/test_torch_spec_cuda.py, which imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.decode import speculative as jspec
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import megakernel as jmk
from t5gemma_tts_tpu.ops import quant as jquant
from t5gemma_tts_tpu.ops import rope as jrope
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.decode import speculative as tspec
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import paged_attn as tpa
from t5gemma_tts_tpu_torch.ops import sampling as tsampling

from test_torch_int4 import CASCADE_REL, F32_REL, FLIP_REL
from test_torch_megakernel import _dims, _layer_params, _rel, _slabs

torch.set_num_threads(1)
K = 4
MAX_FRAMES = 48
TOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(tiny):
    """The JAX suite's ``paged_setup``: the sliding window widened so that
    the paged cache is legal."""
    bb = tiny().backbone
    bb = dataclasses.replace(
        bb, encoder=dataclasses.replace(bb.encoder, sliding_window=512),
        decoder=dataclasses.replace(bb.decoder, sliding_window=512))
    return dataclasses.replace(tiny(backbone=bb), extra_cutoff=0.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(tiny_voice_config)
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    heads = jspec.init_mtp_heads(jax.random.PRNGKey(3), jcfg, K)
    rng = np.random.default_rng(0)
    b = 2
    inputs = (rng.integers(3, jcfg.text_vocab_size, (b, 12)).astype(np.int32),
              np.asarray([12, 9], np.int32),
              rng.integers(0, jcfg.audio_vocab_size, (b, 5)).astype(np.int32),
              np.asarray([5, 3], np.int32), np.asarray([40, 30], np.int32))
    return dict(jcfg=jcfg, params=_np(params), heads=_np(heads),
                tcfg=_cfg(tconfig.tiny_voice_config),
                tparams=bridge.params_from_jax(_np(params), "cpu"),
                theads=bridge.params_from_jax(_np(heads), "cpu"),
                inputs=inputs)


def _jax_inputs(setup):
    names = ("x", "x_lens", "prompt", "prompt_lens", "target_totals")
    return dict(zip(names, map(jnp.asarray, setup["inputs"])),
                rng=jax.random.PRNGKey(7))


def _tinputs(setup):
    return tuple(torch.from_numpy(a) for a in setup["inputs"])


def _jdcfg(kv, max_frames=MAX_FRAMES, **kw):
    return DecodeConfig(max_frames=max_frames, kv_cache=kv,
                        **(kw or dict(top_k=1)))


def _tdcfg(kv, max_frames=MAX_FRAMES, **kw):
    return tconfig.DecodeConfig(max_frames=max_frames, kv_cache=kv,
                                **(kw or dict(top_k=1)))


def _port_seq(setup, params, kv, **kw):
    return teng.decode_tokens(params, setup["tcfg"], _tdcfg(kv, **kw),
                              *_tinputs(setup), 7)


def _port_spec(setup, params, kv, draft, **kw):
    return tspec.decode_tokens_speculative(
        params, setup["tcfg"], _tdcfg(kv, **kw), *_tinputs(setup), 7, draft,
        K)


def _drafts(setup, trace):
    return {"mtp": tspec.mtp_draft_fn(setup["theads"]),
            "oracle": tspec.trace_draft_fn(trace, K)}


# ---------------------------------------------------------------------------
# bf16 weights against the JAX speculative engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_spec_greedy_traces_equal_jax(setup, kv):
    seq = _port_seq(setup, setup["tparams"], kv)
    jparams = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    jheads = jax.tree_util.tree_map(jnp.asarray, setup["heads"])
    jdrafts = {"mtp": jspec.mtp_draft_fn(jheads),
               "oracle": jspec.trace_draft_fn(
                   jnp.asarray(seq.tokens.numpy()), K)}
    for name, draft in _drafts(setup, seq.tokens).items():
        want = jspec.decode_tokens_speculative(
            jparams, setup["jcfg"], _jdcfg(kv), draft_fn=jdrafts[name], k=K,
            **_jax_inputs(setup))
        got = _port_spec(setup, setup["tparams"], kv, draft)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens), err_msg=name)
        np.testing.assert_array_equal(got.gen_lens.numpy(),
                                      np.asarray(want.gen_lens), err_msg=name)
        assert (got.steps, got.passes) == (int(want.steps), int(want.passes))
        # the port's speculative stream is its sequential stream
        np.testing.assert_array_equal(got.tokens.numpy(), seq.tokens.numpy())
    # the oracle draft multiplies tokens per pass (the chain is exercised)
    assert got.steps / got.passes > 0.8 * (K + 1)


def test_spec_paged_buffer_boundary_equals_jax(setup):
    """Rows that run into max_frames: the chain's tail writes land in the
    cache slack, never on valid slots."""
    want = jspec.decode_tokens_speculative(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]), setup["jcfg"],
        _jdcfg("paged", max_frames=8),
        draft_fn=jspec.mtp_draft_fn(
            jax.tree_util.tree_map(jnp.asarray, setup["heads"])),
        k=K, **_jax_inputs(setup))
    run = tspec.speculative_decoder(setup["tcfg"], _tdcfg("paged", 8), K)
    got = run(setup["tparams"], *_tinputs(setup), 7,
              tspec.mtp_draft_fn(setup["theads"]))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    seq = _port_seq(setup, setup["tparams"], "paged", max_frames=8)
    np.testing.assert_array_equal(got.tokens.numpy(), seq.tokens.numpy())


def test_sequential_paged_f8_equals_jax(setup):
    want = jeng.decode_tokens(
        jax.tree_util.tree_map(jnp.asarray, setup["params"]), setup["jcfg"],
        _jdcfg("paged_f8"), **_jax_inputs(setup))
    got = _port_seq(setup, setup["tparams"], "paged_f8")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.gen_lens.numpy(),
                                  np.asarray(want.gen_lens))


# ---------------------------------------------------------------------------
# the port against itself: step-indexed draws
# ---------------------------------------------------------------------------


SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)


@pytest.mark.parametrize("kv", ["dense", "paged", "paged_f8"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_equals_sequential(setup, kv, mode):
    kw = SAMPLED if mode == "sampled" else {}
    seq = _port_seq(setup, setup["tparams"], kv, **kw)
    for name, draft in _drafts(setup, seq.tokens).items():
        got = _port_spec(setup, setup["tparams"], kv, draft, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), seq.tokens.numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(got.gen_lens.numpy(),
                                      seq.gen_lens.numpy(), err_msg=name)
        assert got.passes <= got.steps


def test_step_draws_depend_on_seed_and_step_only():
    x = tsampling.step_uniform(7, 12, 2, 4)
    assert torch.equal(x, tsampling.step_uniform(7, 12, 2, 4))
    assert torch.equal(x, tsampling.step_uniform(torch.tensor(7),
                                                 torch.tensor(12), 2, 4))
    assert not torch.equal(x, tsampling.step_uniform(7, 13, 2, 4))
    assert not torch.equal(x, tsampling.step_uniform(8, 12, 2, 4))


# ---------------------------------------------------------------------------
# the chain paths: decode_stack(chain=k+1) with int8 and int4 weights
# ---------------------------------------------------------------------------


def _chain_layer_case(w4, quant, b=2, seed=0):
    """Layer 1 of a two-layer stack at chain 5: b cache rows, 5 pseudo-rows
    each, the JAX megakernel's chain variant in interpret mode."""
    s_len = K + 1
    jdims, tdims = _dims(128)
    rng = np.random.default_rng(seed + 10 * b + int(quant) + 100 * w4)
    jparams = jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, _layer_params(jdims, seed)),
        streaming_tiled=True, weight_bits=4 if w4 else 8)
    jlayers = jparams["decoder"]["layers"]
    assert jmk.uses_w4(jlayers) == w4
    hd = jdims.head_dim
    n = b * s_len
    pos = rng.uniform(0, 100, (n, 1)).astype(np.float32)
    cos, sin = (np.asarray(x)[:, 0] for x in jrope.rope_cos_sin(
        jnp.asarray(pos), hd, jdims.rope_theta))
    qcos, qsin = (np.asarray(x)[:, 0] for x in jrope.rope_cos_sin(
        jnp.asarray(pos * 10), hd, jdims.rope_theta))
    slabs, scales = _slabs(rng, jdims, b, quant)
    rep = lambda v: np.repeat(np.asarray(v, np.int32), s_len)  # noqa: E731
    inputs = dict(
        h=(rng.standard_normal((n, jdims.hidden_size)) * 2.0).astype(
            np.float32),
        cos=cos, sin=sin, qcos=qcos, qsin=qsin,
        plens=rep([130, 77][:b]), glens=rep([5, 0][:b]),
        elens=rep([9, 3][:b]),
        prompt_k=slabs[0], prompt_v=slabs[1], gen_k=slabs[2], gen_v=slabs[3],
        cross_k=slabs[4], cross_v=slabs[5])
    ks = None if scales is None else tuple(map(jnp.asarray, scales))
    want = jmk.decode_layer(jlayers, jdims, li=1, kv_scales=ks,
                            interpret=True, chain=s_len,
                            **{k: jnp.asarray(v) for k, v in inputs.items()})
    tks = None if scales is None else tuple(
        torch.from_numpy(np.array(s)) for s in scales)
    got = tmk.decode_layer(
        bridge.params_from_jax(_np(jlayers), "cpu"), tdims, li=1,
        kv_scales=tks, chain=s_len,
        **bridge.params_from_jax(inputs, "cpu"))
    return got, tuple(np.asarray(x) for x in want)


@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "i8"])
def test_chain_decode_layer_matches_jax(w4, quant):
    """k/v to f32 rounding; h within 1e-3 relative over the layer, and row
    by row either to f32 rounding or, for at most one of the ten
    pseudo-rows, by a rounding flip's size: an f32 difference in the
    attention that crosses a bf16 (q, p) or int8 (activation) rounding
    boundary moves that row alone, by 1e-3 to 1e-2 (measured once, in the
    int4 weights / int8 pages case: 9.2e-3, all other rows below 1.2e-7)."""
    got, want = _chain_layer_case(w4, quant)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert _rel(got[1], want[1]) <= F32_REL
    assert _rel(got[2], want[2]) <= F32_REL
    h, wh = got[0].numpy(), want[0]
    rows = np.linalg.norm(h - wh, axis=1) / np.linalg.norm(wh, axis=1)
    flipped = rows > F32_REL
    assert flipped.sum() <= 1 and rows.max() <= CASCADE_REL, rows
    assert _rel(got[0], want[0]) <= (CASCADE_REL if flipped.any() else TOL)


def test_chain_position_zero_is_the_step_layer():
    """The first chain position of each cache row sees only the slabs and
    itself, raw: it is the decode step's layer for that row (to f32
    summation order), whatever the other positions hold."""
    jdims, tdims = _dims(128)
    layers = bridge.params_from_jax(_np(jquant.quantize_params_for_decode(
        jax.tree_util.tree_map(jnp.asarray, _layer_params(jdims, 1)),
        streaming_tiled=True))["decoder"]["layers"], "cpu")
    slabs, scales = _slabs(np.random.default_rng(1), jdims, 2, True)
    rng = np.random.default_rng(2)
    s_len, hd = K + 1, jdims.head_dim

    def rows(n, scale=1.0):
        return (rng.standard_normal((n,)) * scale).astype(np.float32)

    pos = np.repeat(rows(2, 50.0), s_len)
    chain = bridge.params_from_jax(dict(
        h=rng.standard_normal((2 * s_len, jdims.hidden_size)).astype(
            np.float32),
        plens=np.repeat([130, 2], s_len).astype(np.int32),
        glens=np.repeat([5, 0], s_len).astype(np.int32),
        elens=np.repeat([9, 1], s_len).astype(np.int32),
        prompt_k=slabs[0], prompt_v=slabs[1], gen_k=slabs[2],
        gen_v=slabs[3], cross_k=slabs[4], cross_v=slabs[5]), "cpu")
    cos, sin = (np.asarray(x)[:, 0] for x in jrope.rope_cos_sin(
        jnp.asarray(pos)[:, None], hd, jdims.rope_theta))
    chain.update(bridge.params_from_jax(
        dict(cos=cos, sin=sin, qcos=cos, qsin=sin), "cpu"))
    ks = tuple(torch.from_numpy(np.array(x)) for x in scales)
    got = tmk.decode_layer_plain(layers, tdims, li=0, chain=s_len,
                                 kv_scales=ks, **chain)
    first = slice(0, None, s_len)
    step = {k: (v[first] if k not in ("prompt_k", "prompt_v", "gen_k",
                                      "gen_v", "cross_k", "cross_v") else v)
            for k, v in chain.items()}
    want = tmk.decode_layer_plain(layers, tdims, li=0, kv_scales=ks, **step)
    for g, w in zip(got, want):
        assert _rel(g[first], w.numpy()) <= F32_REL


def _recording_jax(sample, logits):
    def recorded(cfg, dcfg, lg, step, *a, **k):
        jax.debug.callback(
            lambda s, v: logits.__setitem__(int(s), np.asarray(v, np.float32)),
            step, lg, ordered=True)
        return sample(cfg, dcfg, lg, step, *a, **k)
    return recorded


@pytest.fixture(scope="module")
def chain_runs(setup):
    """Per chain configuration (weights, cache): the port's sequential
    trace, its speculative runs with the MTP draft and with an oracle draft
    replaying that trace (per-step logits recorded), and the JAX
    speculative engine's run with the same oracle draft."""
    fused = jt5.fuse_for_decode(jax.tree_util.tree_map(jnp.asarray,
                                                       setup["params"]))
    out = {}
    for bits in (8, 4):
        jq = jquant.quantize_params_for_decode(fused, streaming_tiled=True,
                                               weight_bits=bits)
        tq = bridge.params_from_jax(_np(jq), "cpu")
        for kv in ("paged", "paged_i8"):
            seq = _port_seq(setup, tq, kv)
            draft = seq.tokens
            tlog = {}
            with pytest.MonkeyPatch.context() as mp:
                sample = teng._candidate_sample

                def recorded(cfg, dcfg, lg, step, *a, **k):
                    tlog[int(step)] = lg.float().numpy().copy()
                    return sample(cfg, dcfg, lg, step, *a, **k)

                mp.setattr(teng, "_candidate_sample", recorded)
                oracle = _port_spec(setup, tq, kv,
                                    tspec.trace_draft_fn(draft, K))
            mtp = _port_spec(setup, tq, kv,
                             tspec.mtp_draft_fn(setup["theads"]))
            jlog = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jeng, "_candidate_sample",
                           _recording_jax(jeng._candidate_sample, jlog))
                mp.setenv("T5G_FUSED_ATTN", "3")
                mp.setenv("T5G_MK_STACKED", "0")
                want = jspec.decode_tokens_speculative(
                    jq, setup["jcfg"], _jdcfg(kv),
                    draft_fn=jspec.trace_draft_fn(
                        jnp.asarray(draft.numpy()), K),
                    k=K, **_jax_inputs(setup))
                jax.effects_barrier()
            out[(bits, kv)] = dict(oracle=oracle, mtp=mtp, tlog=tlog,
                                   want=want, jlog=jlog, tq=tq)
    return out


CHAIN_CASES = [(8, "paged"), (8, "paged_i8"), (4, "paged"), (4, "paged_i8")]


@pytest.mark.parametrize("bits,kv", CHAIN_CASES)
def test_chain_traces_part_from_jax_only_after_a_rounding_flip(
        chain_runs, bits, kv):
    r = chain_runs[(bits, kv)]
    got, want = r["oracle"], r["want"]
    tokens, lens = got.tokens.numpy(), got.gen_lens.numpy()
    wtok, wlens = np.asarray(want.tokens), np.asarray(want.gen_lens)
    first = []
    for row in range(len(wlens)):
        n = max(lens[row], wlens[row])
        parted = np.nonzero(tokens[row, :n] != wtok[row, :n])[0]
        if not len(parted):
            assert lens[row] == wlens[row], row
        end = parted[0] + 1 if len(parted) else n
        rel = np.asarray([
            np.linalg.norm(r["tlog"][t][row] - r["jlog"][t][row])
            / np.linalg.norm(r["jlog"][t][row]) for t in range(end)])
        jump = np.nonzero(rel > F32_REL)[0]
        first.append(rel[0])
        assert rel.max() <= CASCADE_REL, (row, rel.max())
        if len(jump):
            assert rel[jump[0]] >= FLIP_REL, (row, rel[jump[0]])
        if len(parted):
            assert len(jump) and jump[0] <= parted[0], row
    assert min(first) <= F32_REL, first


@pytest.mark.parametrize("bits,kv", CHAIN_CASES)
def test_chain_stream_barely_depends_on_the_draft(chain_runs, bits, kv):
    r = chain_runs[(bits, kv)]
    agree = (r["oracle"].tokens == r["mtp"].tokens).float().mean().item()
    assert agree > 0.85, agree
    assert r["oracle"].steps / r["oracle"].passes > 2.0
    assert r["mtp"].gen_lens.min() > 0 and r["mtp"].gen_lens.max() <= 48


def test_chain_pass_takes_decode_stack(setup, chain_runs, monkeypatch):
    """The verify pass with quantized weights is one decode_stack call at
    chain k + 1, and never the one-segment kernel's path."""
    calls = []
    stack = tmk.decode_stack

    def spy(*a, **k):
        calls.append(k["chain"])
        return stack(*a, **k)

    monkeypatch.setattr(tmk, "decode_stack", spy)
    monkeypatch.setattr(tpa, "paged_flash_parts", None)
    out = _port_spec(setup, chain_runs[(4, "paged")]["tq"], "paged",
                     tspec.mtp_draft_fn(setup["theads"]))
    assert calls.count(K + 1) == out.passes


def test_spec_paged_i8_requires_quantized_weights(setup):
    with pytest.raises(ValueError, match="megakernel"):
        _port_spec(setup, setup["tparams"], "paged_i8",
                   tspec.trace_draft_fn(
                       torch.zeros((2, 48), dtype=torch.int32), K))


def test_mtp_heads_round_trip_byte_equal(setup):
    heads = setup["heads"]
    back = bridge.params_to_numpy(setup["theads"])
    assert isinstance(back, list) and len(back) == K
    for h, g in zip(heads, back):
        for name in ("w1", "w2"):
            assert g[name].dtype == h[name].dtype
            assert g[name].tobytes() == h[name].tobytes()
    # and the port's draft equals the JAX draft on the same hidden rows
    hid = np.random.default_rng(2).standard_normal(
        (3, 1, setup["jcfg"].backbone.decoder.hidden_size)).astype(np.float32)
    want = jspec.mtp_draft_fn(jax.tree_util.tree_map(jnp.asarray, heads))(
        jnp.asarray(hid), None, 0)
    got = tspec.mtp_draft_fn(setup["theads"])(torch.from_numpy(hid), None, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mtp_case(setup, k=2):
    """JAX-seeded f32 heads and a batch with masked positions, both
    packages' copies."""
    jcfg = setup["jcfg"]
    heads = _np(jspec.init_mtp_heads(jax.random.PRNGKey(1), jcfg, k,
                                     dtype=jnp.float32))
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 12, jcfg.backbone.decoder.hidden_size)
                        ).astype(np.float32)
    targets = rng.integers(0, jcfg.audio_vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    mask[0, 4] = False
    theads = [{n: torch.from_numpy(np.array(h[n])).requires_grad_()
               for n in ("w1", "w2")} for h in heads]
    return heads, theads, hidden, targets, mask


def test_mtp_loss_and_gradient_equal_jax(setup):
    heads, theads, hidden, targets, mask = _mtp_case(setup)
    want, jgrad = jax.value_and_grad(lambda h: jspec.mtp_loss(
        h, jnp.asarray(hidden), jnp.asarray(targets), jnp.asarray(mask)))(
        jax.tree_util.tree_map(jnp.asarray, heads))
    got = tspec.mtp_loss(theads, torch.from_numpy(hidden),
                         torch.from_numpy(targets), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got.backward()
    for h, jh in zip(theads, jgrad):
        for n in ("w1", "w2"):
            w = np.asarray(jh[n])
            np.testing.assert_allclose(h[n].grad.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_mtp_loss_trains_heads(setup):
    """Ten plain gradient steps lower the port's mtp_loss, as in the JAX
    suite's test."""
    _, theads, hidden, targets, mask = _mtp_case(setup)
    args = (torch.from_numpy(hidden), torch.from_numpy(targets),
            torch.from_numpy(mask))
    l0 = float(tspec.mtp_loss(theads, *args))
    for _ in range(10):
        loss = tspec.mtp_loss(theads, *args)
        grads = torch.autograd.grad(loss, [h[n] for h in theads
                                           for n in ("w1", "w2")])
        with torch.no_grad():
            for p, g in zip([h[n] for h in theads for n in ("w1", "w2")],
                            grads):
                p -= 0.5 * g
    assert float(tspec.mtp_loss(theads, *args)) < l0


def test_chip_smoke_holds_every_product_of_the_spec_path(monkeypatch):
    """chip_smoke.py's phase 4d holds the W8A8 and W4A8 kernels at exactly
    the (kernel, M, N) the speculative int4 path sends them (the head at
    M = 1 for the current token and M = k + 1 for the chain; here on the
    CPU, at the tiny config)."""
    import importlib.util
    import os
    from collections import Counter

    from t5gemma_tts_tpu_torch.codec import model as tcodec
    from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
    from t5gemma_tts_tpu_torch.ops import quant as tquant

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bb = tconfig.backbone_preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=1024)
    cfg = tconfig.tiny_voice_config(backbone=dataclasses.replace(
        bb, encoder=dims, decoder=dims), extra_cutoff=0.5)
    pipe = smoke.build_pipeline(cfg, tcodec.tiny_codec_config(), "cpu",
                                seed=0, int4=True)
    sent = Counter()
    for name in ("w4a8_matmul", "w8a8_matmul"):
        def counted(x, w, *a, _fn=getattr(tquant, name), _name=name, **k):
            sent[_name, x.reshape(-1, x.shape[-1]).shape[0], w.n] += 1
            return _fn(x, w, *a, **k)
        monkeypatch.setattr(tquant, name, counted)
    reqs = [tpipe.Request(target_text=smoke.TEXTS[-1],
                          target_duration=smoke.DURATIONS[-1], lang="en")]
    inputs, max_frames = smoke.planned_inputs(pipe, reqs)
    trace = teng.decode_tokens(
        pipe.params, cfg, tconfig.DecodeConfig(kv_cache="paged", top_k=1,
                                               max_frames=max_frames),
        *inputs, 0).tokens
    sent.clear()
    tspec.decode_tokens_speculative(
        pipe.params, cfg, tconfig.DecodeConfig(kv_cache="paged", top_k=1,
                                               max_frames=max_frames),
        *inputs, 0, tspec.trace_draft_fn(trace, K), K)
    tx, p_max, _ = pipe.widths([pipe.plan_request(r) for r in reqs])
    run = {"pipe": pipe, "batch": 1, "head_rows": [1, K + 1],
           "prefill_rows": p_max + 1, "cross_rows": tx}
    named = {("w4a8_matmul" if isinstance(w, tquant.Int4Weight)
              else "w8a8_matmul", m, w.n)
             for _, m, w in smoke.run_products(run)}
    assert named == set(sent)

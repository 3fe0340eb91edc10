"""The port's continuous batching (decode/continuous.py) on the CPU.

- the per-row-clock paged step (``paged_decode_step`` with ``gen_lengths``
  / ``flush_positions``) against JAX's, bf16 and int8 pages: hidden states
  within 1e-5, the flushed pages and scales equal;
- ``sampling.row_uniform`` row r is ``step_uniform(seeds[r], steps[r], 1,
  ...)`` row 0, and ``engine.sample_step_token_rows`` row r is a batch-1
  ``sample_step_token`` at that seed and step, on the candidate path and on
  the full-vocabulary path (exact);
- the stream contract: a request's tokens are the same in any slot,
  whenever it joins and whatever shares the batch, and equal a batch-1
  ``engine.decode_tokens`` at its seed, sampled and greedy, over bf16 and
  int8 pages and the dense cache, when it joins mid-flight and when its slot
  is reused (exact); greedy streams also equal JAX's continuous engine on
  the schedules of tests/test_continuous.py;
- an empty state's segment is a no-op, and an idle slot's NaN does not
  reach the live rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, tiny_voice_config
from t5gemma_tts_tpu.decode import continuous as jcont
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import rope as jrope
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import continuous as tcont
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.ops import rope as trope
from t5gemma_tts_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
TX, PMAX, B, MAX_FRAMES = 12, 6, 4, 48
SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)


def _paged_cfg(tiny):
    """tests/test_continuous.py's ``_paged_cfg``: the test preset with the
    whole paged cache inside the sliding window, no duration tail."""
    cfg = tiny(extra_cutoff=0.0)
    dims = dataclasses.replace(cfg.backbone.decoder, sliding_window=4096)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, decoder=dims))


@pytest.fixture(scope="module")
def setup():
    jcfg = _paged_cfg(tiny_voice_config)
    tcfg = _paged_cfg(tconfig.tiny_voice_config)
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams)


def _request(seed):
    """tests/test_continuous.py's ``_request``: (x, x_len, prompt,
    prompt_len, target, seed) with the seed 1000 + seed."""
    rng = np.random.default_rng(seed)
    cfg = tiny_voice_config()
    x = np.zeros((TX,), np.int32)
    xl = int(rng.integers(6, TX + 1))
    x[:xl] = rng.integers(3, cfg.text_vocab_size, xl)
    p = np.zeros((PMAX,), np.int32)
    pl = int(rng.integers(0, PMAX + 1))
    p[:pl] = rng.integers(0, cfg.audio_vocab_size, pl)
    tgt = pl + int(rng.integers(15, 35))
    return x, xl, p, pl, tgt, 1000 + seed


def _dcfg(decode_config, kv, mode):
    """A DecodeConfig of either package (``decode_config`` its class)."""
    kw = SAMPLED if mode == "sampled" else dict(top_k=1)
    return decode_config(max_frames=MAX_FRAMES, kv_cache=kv, **kw)


# --- the schedules of tests/test_continuous.py:54 and :84 -------------------


def _port_alone(s, dcfg, req, slot=0):
    fns = tcont.make_fns(s["tcfg"], dcfg)
    state = tcont.init_slots(s["tcfg"], dcfg, B, TX, PMAX, "cpu")
    fns.admit(s["tparams"], state, slot, *req)
    for _ in range(10):
        fns.segment(s["tparams"], state, 16)
        _, outs = tcont.harvest(state)
        if outs:
            return outs[0][1]
    raise AssertionError("request did not finish")


def _join_mid_flight(admit, segment, harvest, reqs):
    """a joins at slot 0, b (slot 2) after segments of 7 and 5, c (slot 1)
    after one of 9 -> {name: tokens}."""
    ra, rb, rc = reqs
    admit(0, ra)
    segment(7)
    segment(5)
    admit(2, rb)
    segment(9)
    admit(1, rc)
    got = {}
    for _ in range(12):
        segment(16)
        for slot, toks in harvest():
            got[{0: "a", 2: "b", 1: "c"}[slot]] = np.asarray(toks)
        if len(got) == 3:
            return got
    raise AssertionError(f"only {sorted(got)} finished")


def _slot_reuse(admit, segment, harvest, reqs):
    """a runs to its end in slot 3, then b reuses slot 3 -> {name:
    tokens}."""
    ra, rb = reqs
    got = {}
    for name, req in (("a", ra), ("b", rb)):
        admit(3, req)
        for _ in range(10):
            segment(16)
            outs = harvest()
            if outs:
                got[name] = np.asarray(outs[0][1])
                break
    assert set(got) == {"a", "b"}
    return got


def _port_schedule(s, dcfg, schedule, reqs):
    fns = tcont.make_fns(s["tcfg"], dcfg)
    state = tcont.init_slots(s["tcfg"], dcfg, B, TX, PMAX, "cpu")
    return schedule(
        lambda slot, r: fns.admit(s["tparams"], state, slot, *r),
        lambda n: fns.segment(s["tparams"], state, n),
        lambda: tcont.harvest(state)[1], reqs)


def _jax_schedule(s, dcfg, schedule, reqs):
    fns = jcont.make_fns(s["jcfg"], dcfg)
    box = [jcont.init_slots(s["jcfg"], dcfg, B, TX, PMAX)]

    def admit(slot, r):
        x, xl, p, pl, tgt, seed = r
        box[0] = fns.admit(s["params"], box[0], jnp.int32(slot),
                           jnp.asarray(x), jnp.int32(xl), jnp.asarray(p),
                           jnp.int32(pl), jnp.int32(tgt),
                           jax.random.PRNGKey(seed))

    def segment(n):
        box[0] = fns.segment(s["params"], box[0], jnp.int32(n))

    def harvest():
        box[0], outs = jcont.harvest(box[0])
        return outs

    return schedule(admit, segment, harvest, reqs)


def _batch1(s, dcfg, req):
    """The request alone through the eager batch-1 engine at its seed."""
    x, xl, p, pl, tgt, seed = req
    out = teng.decode_tokens(
        s["tparams"], s["tcfg"], dcfg, torch.from_numpy(x)[None],
        torch.tensor([xl], dtype=torch.int32), torch.from_numpy(p)[None],
        torch.tensor([pl], dtype=torch.int32),
        torch.tensor([tgt], dtype=torch.int32), seed)
    return out.tokens[0, :int(out.gen_lens[0])].numpy()


SCHEDULES = {"join": (_join_mid_flight, (1, 2, 3), "abc"),
             "reuse": (_slot_reuse, (4, 5), "ab")}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("kv", ["paged", "paged_i8", "dense"])
@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_stream_contract(setup, schedule, kv, mode):
    """Every request's tokens on the schedule equal the same request alone
    in slot 0 and a batch-1 decode_tokens at its seed."""
    fn, seeds, names = SCHEDULES[schedule]
    reqs = [_request(i) for i in seeds]
    dcfg = _dcfg(tconfig.DecodeConfig, kv, mode)
    got = _port_schedule(setup, dcfg, fn, reqs)
    for name, req in zip(names, reqs):
        alone = _port_alone(setup, dcfg, req)
        np.testing.assert_array_equal(got[name], alone, err_msg=name)
        np.testing.assert_array_equal(alone, _batch1(setup, dcfg, req),
                                      err_msg=name)
        assert alone[-1] == setup["tcfg"].eog_inference


@pytest.mark.parametrize("kv", ["paged", "paged_i8"])
def test_greedy_streams_match_jax_continuous(setup, kv):
    """Greedy: the port's streams on both schedules equal JAX's continuous
    engine's (JAX's int8 pages run the batch kernel in interpret mode)."""
    for name in sorted(SCHEDULES):
        fn, seeds, _ = SCHEDULES[name]
        reqs = [_request(i) for i in seeds]
        want = _jax_schedule(setup, _dcfg(DecodeConfig, kv, "greedy"), fn,
                             reqs)
        got = _port_schedule(setup, _dcfg(tconfig.DecodeConfig, kv,
                                          "greedy"), fn, reqs)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {k}")


def test_empty_state_segment_is_noop(setup):
    dcfg = _dcfg(tconfig.DecodeConfig, "paged", "sampled")
    fns = tcont.make_fns(setup["tcfg"], dcfg)
    state = tcont.init_slots(setup["tcfg"], dcfg, B, TX, PMAX, "cpu")
    before = {n: t.clone() for n, t in teng._tensors(state)}
    fns.segment(setup["tparams"], state, 8)
    assert tcont.stats(state).bodies == 0
    assert not bool(state.active.any())
    for n, t in teng._tensors(state):
        assert torch.equal(t, before[n]), n
    assert tcont.harvest(state)[1] == []


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_idle_slot_nan_stays_in_its_row(setup, kv):
    """NaN in an idle slot's hidden state, KV rows and encoder length does
    not reach the live rows: their tokens equal the request alone."""
    dcfg = _dcfg(tconfig.DecodeConfig, kv, "sampled")
    reqs = [_request(1), _request(2)]
    fns = tcont.make_fns(setup["tcfg"], dcfg)
    state = tcont.init_slots(setup["tcfg"], dcfg, B, TX, PMAX, "cpu")
    cache = state.cache
    with torch.inference_mode():          # the state's tensors are
        state.last_hidden[1] = float("nan")   # inference tensors
        if kv == "dense":
            cache.self_k[:, 1] = float("nan")
            cache.cross_v[:, 1] = float("nan")
        else:
            layers = setup["tcfg"].backbone.decoder.num_layers
            rows = torch.arange(layers) * B + 1
            cache.gen_k[:, rows] = float("nan")
            cache.cross_v[:, rows] = float("nan")
            cache.pending_k[:, 1] = float("nan")
    fns.admit(setup["tparams"], state, 0, *reqs[0])
    fns.admit(setup["tparams"], state, 3, *reqs[1])
    got = {}
    for _ in range(10):
        fns.segment(setup["tparams"], state, 16)
        got.update(dict(tcont.harvest(state)[1]))
        if len(got) == 2:
            break
    for slot, req in ((0, reqs[0]), (3, reqs[1])):
        np.testing.assert_array_equal(got[slot],
                                      _port_alone(setup, dcfg, req))
    assert torch.isnan(state.last_hidden[1]).all()


def test_resolve_cache_mode(setup):
    cfg = setup["tcfg"]
    auto = tconfig.DecodeConfig(max_frames=512)
    assert tcont.resolve_cache_mode(cfg, auto, 64) == "paged"
    small = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dataclasses.replace(
            cfg.backbone.decoder, sliding_window=512)))
    assert tcont.resolve_cache_mode(small, auto, 64) == "dense"
    for mode in ("paged", "paged_i8", "paged_f8"):
        d = dataclasses.replace(auto, kv_cache=mode)
        assert tcont.resolve_cache_mode(cfg, d, 64) == mode
        with pytest.raises(ValueError):
            tcont.resolve_cache_mode(small, d, 64)


# --- per-request draws -----------------------------------------------------


def test_row_uniform_is_step_uniform_row_0():
    seeds = torch.tensor([0, 1, -5, 2 ** 40 + 3, -(2 ** 63), 2 ** 63 - 1])
    steps = torch.tensor([0, 3, 9, 100, 7, 2 ** 31 - 1], dtype=torch.int32)
    got = tsampling.row_uniform(seeds, steps, 37)
    for r in range(len(seeds)):
        want = tsampling.step_uniform(int(seeds[r]), int(steps[r]), 1, 37)
        assert torch.equal(got[r], want[0]), r
    # the server's per-request seeds are distinct and reproducible
    folded = [tsampling.fold_seed(1, n) for n in range(64)]
    assert len(set(folded)) == 64
    assert folded == [tsampling.fold_seed(1, n) for n in range(64)]


@pytest.mark.parametrize("path", ["candidate", "top_k 0", "min_p"])
def test_sample_step_token_rows_is_batch_1(setup, path):
    """Row r of the per-row sampler is a batch-1 sample_step_token at
    (seeds[r], steps[r]): EOG floors at steps 0 and <= sr // 5, the
    silence penalty on one row, a tie-free random logit row each."""
    cfg = setup["tcfg"]
    kw = {"candidate": dict(top_k=8, top_p=0.9),
          "top_k 0": dict(top_k=0, top_p=0.9),
          "min_p": dict(top_k=8, min_p=0.05)}[path]
    dcfg = tconfig.DecodeConfig(temperature=0.8, stop_repetition=2,
                                silence_tokens=(5, 7), **kw)
    silence = teng.silence_tensor(dcfg, "cpu")
    rng = np.random.default_rng(3)
    b, v = 5, cfg.audio_embedding_vocab
    logits = torch.from_numpy(
        rng.standard_normal((b, v)).astype(np.float32) * 3)
    steps = torch.tensor([0, 4, 10, 11, 40], dtype=torch.int32)
    prev = torch.tensor([5, 3, cfg.eog_inference, 7, 9], dtype=torch.int32)
    consec = torch.tensor([4, 0, 1, 3, 0], dtype=torch.int32)
    seeds = torch.tensor([11, -3, 2 ** 40, 7, 11])
    tok, am = teng.sample_step_token_rows(cfg, dcfg, logits, steps, prev,
                                          consec, seeds, silence)
    for r in range(b):
        t1, a1 = teng.sample_step_token(
            cfg, dcfg, logits[r:r + 1], int(steps[r]), prev[r:r + 1],
            consec[r:r + 1], int(seeds[r]), silence)
        assert int(tok[r]) == int(t1[0]) and int(am[r]) == int(a1[0]), r
    # the draws depend on the row's own seed and step, not its neighbours
    tok2, _ = teng.sample_step_token_rows(
        cfg, dcfg, logits.flip(0), steps.flip(0), prev.flip(0),
        consec.flip(0), seeds.flip(0), silence)
    assert torch.equal(tok2.flip(0), tok)


# --- the per-row-clock paged step --------------------------------------------


@pytest.mark.parametrize("kv", ["paged", "paged_i8"])
def test_paged_step_per_row_clocks_matches_jax(setup, kv):
    """Random generation pages (levels and scales for int8) and a random
    pending block; rows at generation lengths 0, 5 and 3 flush at slots 0,
    4 and 2 and attend over their own lengths."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    dims = jcfg.backbone.decoder
    rng = np.random.default_rng(11)
    b = 3
    x = rng.integers(3, 500, (b, TX)).astype(np.int32)
    x_lens = np.asarray([5, 12, 9], np.int32)
    prompt = np.full((b, PMAX), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 4, 6], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + 30
    jd = DecodeConfig(kv_cache=kv, max_frames=MAX_FRAMES)
    js = jeng.prefill(setup["params"], jcfg, jd, *(jnp.asarray(a) for a in (
        x, x_lens, prompt, plens, targets)))
    jcache = js.cache
    gen_shape = jcache.gen_k.shape
    if kv == "paged":
        rand = {n: (rng.standard_normal(gen_shape) * 0.5).astype(np.float32)
                for n in ("gen_k", "gen_v")}
        jcache = jcache._replace(**{n: jnp.asarray(a, jcache.gen_k.dtype)
                                    for n, a in rand.items()})
    else:
        lev = {n: rng.integers(-127, 128, gen_shape).astype(np.int8)
               for n in ("gen_k", "gen_v")}
        sc = {n + "_scale": rng.uniform(0.002, 0.01, gen_shape[:3]).astype(
                  np.float32) for n in ("gen_k", "gen_v")}
        jcache = jcache._replace(**{n: jnp.asarray(a) for n, a in
                                    {**lev, **sc}.items()})
    pend = {n: (rng.standard_normal(jcache.pending_k.shape) * 0.5).astype(
                np.float32) for n in ("pending_k", "pending_v")}
    jcache = jcache._replace(**{n: jnp.asarray(a, jnp.bfloat16)
                                for n, a in pend.items()})
    tcache = tt5.init_paged_cache(
        tcfg.backbone.decoder, b, PMAX + 1, MAX_FRAMES, TX,
        store_dtype=torch.int8 if kv == "paged_i8" else torch.bfloat16)
    for name in jcache._fields:
        value = getattr(jcache, name)
        if value is not None and name != "page_indices":
            setattr(tcache, name,
                    bridge.params_from_jax(np.asarray(value), "cpu"))

    gen = np.asarray([0, 5, 3], np.int32)
    flush = np.maximum(gen - 1, 0)
    cur = plens + 1 + gen
    token = rng.integers(0, 128, b).astype(np.int32)
    est, _, _ = jeng.decode_budgets(jcfg, *(jnp.asarray(a) for a in (
        x_lens, plens, targets)))
    jpos = jrope.decode_step_position(jnp.asarray(cur), est, 2000.0)[:, None]
    jh, jc = jt5.paged_decode_step(
        setup["params"]["decoder"], dims,
        inputs_embeds=jvoice.embed_audio(setup["params"],
                                         jnp.asarray(token)[:, None]),
        position_ids=jpos, pm_decoder_positions=jpos, cache=jcache,
        step=jnp.int32(0), prompt_lengths=jnp.asarray(plens + 1),
        enc_lengths=jnp.asarray(x_lens), gen_lengths=jnp.asarray(gen),
        flush_positions=jnp.asarray(flush))
    t_est, _, _ = teng.decode_budgets(tcfg, *(torch.from_numpy(a) for a in (
        x_lens, plens, targets)))
    tpos = trope.decode_step_position(torch.from_numpy(cur), t_est,
                                      2000.0)[:, None]
    th, tc = tt5.paged_decode_step(
        setup["tparams"]["decoder"], tcfg.backbone.decoder,
        inputs_embeds=tvoice.embed_audio(setup["tparams"],
                                         torch.from_numpy(token)[:, None]),
        position_ids=tpos, pm_decoder_positions=tpos, cache=tcache, step=0,
        prompt_lengths=torch.from_numpy(plens + 1),
        enc_lengths=torch.from_numpy(x_lens),
        gen_lengths=torch.from_numpy(gen),
        flush_positions=torch.from_numpy(flush))
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(jh, np.float32), rtol=1e-5,
                               atol=1e-5)
    names = ["gen_k", "gen_v"] + (["gen_k_scale", "gen_v_scale"]
                                  if kv == "paged_i8" else [])
    for name in names:
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name)).astype(np.float32)
        np.testing.assert_array_equal(got, want, err_msg=name)
        # only each row's own slot changed, in any layer
        before = np.asarray(getattr(jcache, name)).astype(np.float32)
        changed = (got != before).reshape(
            got.shape[0], dims.num_layers, b, got.shape[2], -1)
        moved = np.argwhere(changed.any(axis=(0, 1, 4)))
        assert {(int(r), int(t)) for r, t in moved} <= {
            (r, int(flush[r])) for r in range(b)}, name

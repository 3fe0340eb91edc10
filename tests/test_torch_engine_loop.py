"""The port's device-resident decode loop (decode/engine.py) on the CPU.

- ``run_segment`` slices (5, 11, 20) equal the port's one-shot
  ``decode_tokens`` (sampled, top-k 4) and, greedy, the JAX ``run_segment``
  slices (the JAX suite's ``test_segmented_decode_matches_full`` setup);
- the predicated body: run past all-done, and at the buffer's end, it
  leaves ``tokens``, ``gen_lens``, ``done`` and ``step`` unchanged;
- the segment fns (prefill + slices over the device step counter) are
  token-equal to the JAX engine, greedy, over the dense, paged and paged_i8
  caches;
- the step-indexed draws: a function of (seed, step) alone, in (0, 1), bit
  equal to a numpy recomputation of the hash in uint32 arithmetic.

The graphed loop itself (the captured step on a card) is held to the eager
loop by tests/test_torch_graph_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.ops import sampling as tsampling

from test_torch_decode import MAX_FRAMES, _torch_cfg
from test_torch_decode import setup as decode_setup  # noqa: F401

torch.set_num_threads(1)
SLICES = (5, 11, 20)


@pytest.fixture(scope="module")
def seg_setup():
    """The JAX suite's run_segment setup (tests/test_decode_engine.py):
    seed 9, two rows, targets 10 and 7 frames past the prompt."""
    jcfg = tiny_voice_config(extra_cutoff=0.0)
    params = jvoice.init_params(jax.random.PRNGKey(9), jcfg)
    rng = np.random.default_rng(9)
    b, tx, p_max = 2, 6, 4
    x = rng.integers(3, jcfg.text_vocab_size, (b, tx)).astype(np.int32)
    x_lens = np.array([tx, tx - 2], np.int32)
    prompt = rng.integers(0, jcfg.audio_vocab_size, (b, p_max)).astype(
        np.int32)
    prompt_lens = np.array([3, 1], np.int32)
    for i in range(b):
        prompt[i, prompt_lens[i]:] = jcfg.special.pad
    target_totals = prompt_lens + np.array([10, 7], np.int32)
    return dict(jcfg=jcfg, params=params,
                tcfg=tconfig.tiny_voice_config(extra_cutoff=0.0),
                tparams=bridge.params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), "cpu"),
                inputs=(x, x_lens, prompt, prompt_lens, target_totals))


def _port_segments(params, cfg, dcfg, inputs, seed, slices):
    """prefill + run_segment over ``slices`` through graphed_segment_fns
    (the eager body on the CPU) -> (tokens, gen_lens, step)."""
    x, x_lens, prompt, prompt_lens, targets = inputs
    prefill_fn, segment_fn = teng.graphed_segment_fns(cfg, dcfg)
    state = prefill_fn(params, x, x_lens, prompt, prompt_lens, targets)
    for until in slices:
        state = segment_fn(params, state, x_lens, prompt_lens, targets, seed,
                           until)
    gen_lens = torch.where(state.done, state.gen_lens, state.step)
    return state.tokens, gen_lens, int(state.step)


@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_run_segment_slices_equal_one_shot_and_jax(seg_setup, mode):
    kw = (dict(top_k=4, top_p=0.9, temperature=0.8) if mode == "sampled"
          else dict(top_k=1))
    tdcfg = tconfig.DecodeConfig(max_frames=20, **kw)
    tin = tuple(torch.from_numpy(a) for a in seg_setup["inputs"])
    full = teng.decode_tokens(seg_setup["tparams"], seg_setup["tcfg"], tdcfg,
                              *tin, 5)
    tokens, gen_lens, steps = _port_segments(
        seg_setup["tparams"], seg_setup["tcfg"], tdcfg, tin, 5, SLICES)
    np.testing.assert_array_equal(tokens.numpy(), full.tokens.numpy())
    np.testing.assert_array_equal(gen_lens.numpy(), full.gen_lens.numpy())
    assert steps == full.steps
    if mode == "sampled":
        return
    # greedy: the JAX segments, the same slices
    jdcfg = DecodeConfig(max_frames=20, top_k=1)
    x, x_lens, prompt, prompt_lens, targets = map(jnp.asarray,
                                                  seg_setup["inputs"])
    jcfg = seg_setup["jcfg"]
    state = jeng.prefill(seg_setup["params"], jcfg, jdcfg, x, x_lens, prompt,
                         prompt_lens, targets)
    segment = jax.jit(lambda st, until: jeng.run_segment(
        seg_setup["params"], jcfg, jdcfg, st, x_lens, prompt_lens, targets,
        jax.random.PRNGKey(5), until))
    for until in SLICES:
        state = segment(state, jnp.int32(until))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(state.tokens))
    assert steps == int(state.step)


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
@pytest.mark.parametrize("past", ["all_done", "max_frames"])
def test_predicated_body_leaves_outputs_unchanged(seg_setup, kv_cache,
                                                  past):
    """The body run after the loop's condition failed changes none of the
    outputs: once every row is done, and at step == max_frames (rows
    marked active again, so that only the step bound holds the body)."""
    cfg = seg_setup["tcfg"]
    if kv_cache == "paged":
        bb = cfg.backbone
        dims = dataclasses.replace(bb.decoder, sliding_window=512)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            bb, encoder=dims, decoder=dims))
    max_frames = 20 if past == "all_done" else 4
    dcfg = tconfig.DecodeConfig(max_frames=max_frames, kv_cache=kv_cache,
                                top_k=4, top_p=0.9, temperature=0.8)
    x, x_lens, prompt, prompt_lens, targets = (
        torch.from_numpy(a) for a in seg_setup["inputs"])
    params = seg_setup["tparams"]
    with torch.inference_mode():
        state = teng.prefill(params, cfg, dcfg, x, x_lens, prompt,
                             prompt_lens, targets)
        body = teng._make_body(params, cfg, dcfg, teng.step_inputs(
            cfg, x_lens, prompt_lens, targets, 3))
        while int(state.step) < max_frames and not bool(state.done.all()):
            state = body(state)
        assert bool(state.done.all())
        if past == "max_frames":
            assert int(state.step) == max_frames
            state.done.zero_()
        want = {k: getattr(state, k).clone()
                for k in ("tokens", "gen_lens", "done", "step")}
        for _ in range(2 if past == "all_done" else 1):
            state = body(state)
    for k, v in want.items():
        assert torch.equal(getattr(state, k), v), k


@pytest.fixture(scope="module")
def jax_traces(decode_setup):  # noqa: F811
    """The JAX engine's greedy traces over each cache, compiled once."""
    out = {}
    for kv in ("dense", "paged", "paged_i8"):
        jd = DecodeConfig(top_k=1, kv_cache=kv, max_frames=MAX_FRAMES)
        want = jeng.jitted_decoder(decode_setup["jcfg"], jd)(
            decode_setup["params"],
            *(jnp.asarray(a) for a in decode_setup["inputs"]),
            jax.random.PRNGKey(0))
        out[kv] = (np.asarray(want.tokens), np.asarray(want.gen_lens),
                   int(want.steps))
    return out


@pytest.mark.parametrize("kv_cache", ["dense", "paged", "paged_i8"])
def test_device_step_segments_equal_jax(decode_setup, jax_traces,  # noqa: F811
                                        kv_cache):
    """The step counter lives on the device: prefill + segments (7, 19,
    end) through graphed_segment_fns, greedy, token-equal to the JAX
    engine's one-shot decode."""
    td = tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache,
                              max_frames=MAX_FRAMES)
    tokens, gen_lens, steps = _port_segments(
        decode_setup["tparams"], _torch_cfg(), td,
        tuple(torch.from_numpy(a) for a in decode_setup["inputs"]), 0,
        (7, 19, MAX_FRAMES))
    want_tokens, want_lens, want_steps = jax_traces[kv_cache]
    assert len(set(want_lens.tolist())) == 3
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_array_equal(gen_lens.numpy(), want_lens)
    assert steps == want_steps


# ---------------------------------------------------------------------------
# the step-indexed draws
# ---------------------------------------------------------------------------


def _np_uniform(seed: int, step: int, rows: int, cols: int) -> np.ndarray:
    """The draws' hash recomputed in numpy uint32 arithmetic (products wrap
    modulo 2**32), the value formed in float64."""
    u32 = np.uint32

    def fmix(x):
        x = x ^ (x >> u32(16))
        x = x * u32(0x7FEB352D)
        x = x ^ (x >> u32(15))
        x = x * u32(0x31848BAB)
        return x ^ (x >> u32(16))

    def absorb(h, v):
        return fmix(h ^ fmix(v + u32(0x9E3779B9)))

    s = seed % 2 ** 64
    word = (lambda v: np.array([v], np.uint32))  # noqa: E731
    h = absorb(absorb(fmix(word(s & 0xFFFFFFFF)), word(s >> 32)),
               word(step & 0xFFFFFFFF))
    r = absorb(h, np.arange(rows, dtype=np.uint32))
    c = fmix(np.arange(cols, dtype=np.uint32) + u32(0x632BE5AB))
    x = fmix(r[:, None] ^ c[None, :])
    return ((x >> u32(9)).astype(np.float64) * 2 + 1) * 2.0 ** -24


@pytest.mark.parametrize("seed,step", [
    (0, 0), (7, 12), (2 ** 40 + 3, 5), (-1, 2047), (2 ** 64 - 5, 1)])
def test_step_uniform_bit_equal_to_numpy(seed, step):
    got = tsampling.step_uniform(seed, step, 5, 70)
    want = _np_uniform(seed, step, 5, 70)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    # device tensors for the seed and the step give the same bits
    signed = (seed + 2 ** 63) % 2 ** 64 - 2 ** 63
    as_tensors = tsampling.step_uniform(torch.tensor(signed),
                                        torch.tensor(step, dtype=torch.int32),
                                        5, 70)
    assert torch.equal(as_tensors, got)


def test_step_uniform_depends_on_seed_and_step_only():
    x = tsampling.step_uniform(7, 12, 4, 64)
    assert torch.equal(x, tsampling.step_uniform(7, 12, 4, 64))
    # a row's draws do not depend on how many rows or columns are drawn
    assert torch.equal(x[:2, :10], tsampling.step_uniform(7, 12, 2, 10))
    for other in (tsampling.step_uniform(7, 13, 4, 64),
                  tsampling.step_uniform(8, 12, 4, 64),
                  tsampling.step_uniform(7 + 2 ** 32, 12, 4, 64)):
        assert float((other == x).float().mean()) < 0.01
    assert len(set(x.flatten().tolist())) > 0.99 * x.numel()


def test_step_uniform_lies_in_the_open_interval_and_is_flat():
    u = torch.cat([tsampling.step_uniform(3, s, 64, 1024)
                   for s in range(4)]).double()
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    deciles = torch.histc(u, bins=10, min=0.0, max=1.0) / u.numel()
    assert float((deciles - 0.1).abs().max()) < 0.005, deciles
    assert abs(float(u.mean()) - 0.5) < 0.002

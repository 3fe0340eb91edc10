"""The graphed decode loop on a card against the eager loop on the same
card: ``engine.graphed_decoder`` (the step captured as a CUDA graph and
replayed, the all-done flag read a few replays late) token-equal to
``engine.decode_tokens``, greedy and sampled, over every KV cache and every
``T5G_FUSED_ATTN`` mode; a second request into a session; the segment fns;
and a capture that fails raises. This module imports no JAX; run it on the
card with

    python -m pytest -o addopts= --noconftest tests/test_torch_graph_cuda.py

Without a card every test skips.
"""

import dataclasses
import os

import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import engine
from t5gemma_tts_tpu_torch.device import tree_to
from t5gemma_tts_tpu_torch.models import voice
from t5gemma_tts_tpu_torch.models.t5gemma import fuse_for_decode
from t5gemma_tts_tpu_torch.ops.quant import quantize_params_for_decode

SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)
MAX_FRAMES = 48


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg():
    bb = tconfig.backbone_preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    return tconfig.tiny_voice_config(
        backbone=dataclasses.replace(bb, encoder=dims, decoder=dims),
        extra_cutoff=0.3)


def _params(cfg, weights, dev):
    """Seeded tiny weights made on the CPU, then on the card: bf16 fused,
    or int8 / int4 decode weights."""
    params = fuse_for_decode(tree_to(voice.init_params(0, cfg, device="cpu"),
                                     dev))
    if weights != "f32":
        params = quantize_params_for_decode(
            params, weight_bits=4 if weights == "int4" else 8)
    return params


def _inputs(cfg, dev, seed=5, lens=((4, 0, 10), (19, 12, 30), (32, 30, 20))):
    """Three rows: (text length, prompt length, frames past the prompt)."""
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    x = torch.randint(3, 500, (b, 32), generator=g, dtype=torch.int32)
    prompt = torch.full((b, 64), cfg.special.pad, dtype=torch.int32)
    for i, (_, p, _) in enumerate(lens):
        prompt[i, :p] = torch.randint(0, 128, (p,), generator=g,
                                      dtype=torch.int32)
    x_lens = torch.tensor([t for t, _, _ in lens], dtype=torch.int32)
    plens = torch.tensor([p for _, p, _ in lens], dtype=torch.int32)
    targets = plens + torch.tensor([f for _, _, f in lens], dtype=torch.int32)
    return tuple(t.to(dev) for t in (x, x_lens, prompt, plens, targets))


def _same(got, want):
    assert torch.equal(got.tokens, want.tokens), (got.tokens, want.tokens)
    assert torch.equal(got.gen_lens, want.gen_lens)
    assert got.steps == want.steps
    assert want.steps <= got.launched_steps <= (
        want.steps + 1 + engine.LOOKAHEAD)


CASES = [("f32", "dense", None), ("f32", "paged", "0"), ("f32", "paged", "1"),
         ("f32", "paged", "2"), ("f32", "paged_f8", "1"),
         ("f32", "paged_f8", "2"), ("int8", "paged_i8", "3"),
         ("int8", "paged", "3"), ("int4", "paged_i8", "3"),
         ("int8", "paged_i8", "2")]


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("weights,kv_cache,mode", CASES,
                         ids=[f"{w}-{k}-mode{m}" for w, k, m in CASES])
def test_graphed_equals_eager(monkeypatch, weights, kv_cache, mode,
                              sampling):
    dev = _card()
    if mode is not None:
        monkeypatch.setenv("T5G_FUSED_ATTN", mode)
    cfg = _cfg()
    params = _params(cfg, weights, dev)
    kw = SAMPLED if sampling == "sampled" else dict(top_k=1)
    dcfg = tconfig.DecodeConfig(kv_cache=kv_cache, max_frames=MAX_FRAMES,
                                **kw)
    inputs = _inputs(cfg, dev)
    engine.release_sessions()
    want = engine.decode_tokens(params, cfg, dcfg, *inputs, 11)
    got = engine.graphed_decoder(cfg, dcfg)(params, *inputs, 11)
    _same(got, want)
    assert got.tokens.data_ptr() != engine.sessions()[-1].state.tokens \
        .data_ptr()


@pytest.mark.cuda
def test_second_request_into_the_session_equals_a_fresh_eager_run():
    dev = _card()
    cfg = _cfg()
    params = _params(cfg, "f32", dev)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", max_frames=MAX_FRAMES,
                                **SAMPLED)
    run = engine.graphed_decoder(cfg, dcfg)
    engine.release_sessions()
    run(params, *_inputs(cfg, dev), 1)
    assert len(engine.sessions()) == 1
    session = engine.sessions()[0]
    other = _inputs(cfg, dev, seed=9,
                    lens=((9, 3, 25), (30, 0, 12), (2, 40, 18)))
    got = run(params, *other, 12345)
    assert engine.sessions() == [session] and session.launched <= (
        got.steps + engine.LOOKAHEAD)
    _same(got, engine.decode_tokens(params, cfg, dcfg, *other, 12345))


@pytest.mark.cuda
def test_graphed_segments_equal_one_shot():
    dev = _card()
    cfg = _cfg()
    params = _params(cfg, "f32", dev)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", max_frames=MAX_FRAMES,
                                **SAMPLED)
    x, x_lens, prompt, plens, targets = _inputs(cfg, dev)
    engine.release_sessions()
    want = engine.decode_tokens(params, cfg, dcfg, x, x_lens, prompt, plens,
                                targets, 4)
    prefill_fn, segment_fn = engine.graphed_segment_fns(cfg, dcfg)
    state = prefill_fn(params, x, x_lens, prompt, plens, targets)
    for until in (5, 11, MAX_FRAMES):
        state = segment_fn(params, state, x_lens, plens, targets, 4, until)
        assert int(state.step) <= until
    assert torch.equal(state.tokens, want.tokens)
    assert int(state.step) == want.steps
    with pytest.raises(ValueError):
        engine.run_segment(params, cfg, dcfg, engine.prefill(
            params, cfg, dcfg, x, x_lens, prompt, plens, targets), x_lens,
            plens, targets, 4, 10)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(monkeypatch):
    """A host read injected into a copy of the body: the capture raises,
    no session is kept, and the next decode captures and runs."""
    dev = _card()
    cfg = _cfg()
    params = _params(cfg, "f32", dev)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", max_frames=MAX_FRAMES,
                                top_k=1)
    inputs = _inputs(cfg, dev)
    make_body = engine._make_body

    def reading_body(*args):
        body = make_body(*args)

        def read(st):
            int(st.step)               # a device-to-host read
            return body(st)

        return read

    engine.release_sessions()
    monkeypatch.setattr(engine, "_make_body", reading_body)
    with pytest.raises(RuntimeError):
        engine.graphed_decoder(cfg, dcfg)(params, *inputs, 0)
    assert engine.sessions() == []
    monkeypatch.setattr(engine, "_make_body", make_body)
    torch.cuda.synchronize()
    _same(engine.graphed_decoder(cfg, dcfg)(params, *inputs, 0),
          engine.decode_tokens(params, cfg, dcfg, *inputs, 0))


@pytest.mark.cuda
def test_replays_count_the_captured_launches(monkeypatch):
    """Each replay adds the launches its capture recorded: the attention
    kernel twice a layer a launched step."""
    from t5gemma_tts_tpu_torch.ops import fused_attn

    dev = _card()
    monkeypatch.setenv("T5G_FUSED_ATTN", "2")
    cfg = _cfg()
    params = _params(cfg, "f32", dev)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", max_frames=MAX_FRAMES,
                                top_k=1)
    inputs = _inputs(cfg, dev)
    engine.release_sessions()
    for _ in range(2):               # the capture's request, then a replay
        fused_attn.batch_paged_attention.launches = 0
        out = engine.graphed_decoder(cfg, dcfg)(params, *inputs, 0)
        layers = cfg.backbone.decoder.num_layers
        assert fused_attn.batch_paged_attention.launches == (
            2 * layers * out.launched_steps)
    assert os.environ["T5G_FUSED_ATTN"] == "2"

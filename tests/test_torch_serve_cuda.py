"""Serving on a card: the captured continuous segment against the eager
one, the stream contract within one resident state, continuous decode on
the card against the CPU, streaming synthesis and the continuous server.
This module imports no JAX; run it on the card with

    python -m pytest -o addopts= --noconftest tests/test_torch_serve_cuda.py

Without a card every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import continuous
from t5gemma_tts_tpu_torch.device import tree_to
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.inference.server import ContinuousServer
from t5gemma_tts_tpu_torch.models import voice
from t5gemma_tts_tpu_torch.models.t5gemma import fuse_for_decode
from t5gemma_tts_tpu_torch.ops import fused_attn, megakernel
from t5gemma_tts_tpu_torch.ops.quant import quantize_params_for_decode

pytestmark = pytest.mark.cuda
SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)
TX, PMAX, B, MAX_FRAMES = 12, 6, 4, 48


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg():
    cfg = tconfig.tiny_voice_config(extra_cutoff=0.0)
    dims = dataclasses.replace(cfg.backbone.decoder, sliding_window=4096)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))


def _params(cfg, weights, dev):
    """Seeded tiny weights made on the CPU, then on ``dev``: f32 fused or
    int8 decode weights."""
    params = fuse_for_decode(tree_to(voice.init_params(0, cfg, device="cpu"),
                                     dev))
    if weights == "int8":
        params = quantize_params_for_decode(params)
    return params


def _request(seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((TX,), np.int32)
    xl = int(rng.integers(6, TX + 1))
    x[:xl] = rng.integers(3, 512, xl)
    p = np.zeros((PMAX,), np.int32)
    pl = int(rng.integers(0, PMAX + 1))
    p[:pl] = rng.integers(0, 128, pl)
    return x, xl, p, pl, pl + int(rng.integers(15, 35)), 1000 + seed


def _join(fns, params, state, reqs):
    """Request 0 in slot 0, 1 in slot 2 after two segments, 2 in slot 1
    after a third -> {request index: tokens}."""
    fns.admit(params, state, 0, *reqs[0])
    fns.segment(params, state, 7)
    fns.segment(params, state, 5)
    fns.admit(params, state, 2, *reqs[1])
    fns.segment(params, state, 9)
    fns.admit(params, state, 1, *reqs[2])
    got = {}
    for _ in range(12):
        fns.segment(params, state, 16)
        for slot, toks in continuous.harvest(state)[1]:
            got[{0: 0, 2: 1, 1: 2}[slot]] = toks
        if len(got) == 3:
            return got
    raise AssertionError(f"only {sorted(got)} finished")


def _alone(fns, params, state, req):
    fns.admit(params, state, 0, *req)
    for _ in range(10):
        fns.segment(params, state, 16)
        outs = continuous.harvest(state)[1]
        if outs:
            return outs[0][1]
    raise AssertionError("request did not finish")


CASES = [("f32", "paged"), ("f32", "dense"), ("int8", "paged_i8"),
         ("int8", "paged")]


@pytest.mark.parametrize("weights,kv", CASES)
@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_graphed_segment_equals_eager_and_requests_alone(weights, kv, mode):
    """The captured segment gives the eager segment's tokens on the join
    schedule, each request's tokens equal it alone in slot 0 of the same
    resident state, and each replay adds its capture's launches."""
    dev = _card()
    cfg = _cfg()
    params = _params(cfg, weights, dev)
    dcfg = tconfig.DecodeConfig(max_frames=MAX_FRAMES, kv_cache=kv,
                                **(SAMPLED if mode == "sampled"
                                   else dict(top_k=1)))
    reqs = [_request(i) for i in (1, 2, 3)]
    layers = cfg.backbone.decoder.num_layers
    out = {}
    for graphed in (True, False):
        fns = continuous.make_fns(cfg, dcfg, graphed=graphed)
        state = continuous.init_slots(cfg, dcfg, B, TX, PMAX, dev)
        fused_attn.batch_paged_attention.launches = 0
        megakernel.decode_stack.launches = 0
        out[graphed] = _join(fns, params, state, reqs)
        bodies = continuous.stats(state).bodies
        want = {"int8": (0, bodies),
                "f32": (2 * layers * bodies if kv == "paged" else 0, 0)}
        assert (fused_attn.batch_paged_attention.launches,
                megakernel.decode_stack.launches) == want[weights], graphed
        assert (continuous.stats(state).captured is not None) == graphed
        if graphed:
            for i, req in enumerate(reqs):
                np.testing.assert_array_equal(
                    _alone(fns, params, state, req), out[True][i],
                    err_msg=f"request {i}")
    for i in range(3):
        np.testing.assert_array_equal(out[True][i], out[False][i])


def test_continuous_greedy_card_equals_cpu():
    dev = _card()
    cfg = _cfg()
    dcfg = tconfig.DecodeConfig(max_frames=MAX_FRAMES, kv_cache="paged",
                                top_k=1)
    reqs = [_request(i) for i in (1, 2, 3)]
    got = {}
    for d in ("cpu", dev):
        params = _params(cfg, "f32", torch.device(d))
        fns = continuous.make_fns(cfg, dcfg)
        state = continuous.init_slots(cfg, dcfg, B, TX, PMAX, d)
        got[str(d)] = _join(fns, params, state, reqs)
    for i in range(3):
        np.testing.assert_array_equal(got["cpu"][i], got["cuda"][i])


def _pipeline(dev):
    cfg = _cfg()
    ccfg = tcodec.tiny_codec_config()
    return tpipe.TTSPipeline(
        voice.init_params(0, cfg, device="cpu"), cfg,
        lambda t: [3 + (ord(c) % 100) for c in t],
        ttok.AudioTokenizer(tcodec.init_decoder_params(1, ccfg,
                                                       device="cpu"),
                            ccfg, device=dev), device=dev)


def test_streaming_on_the_card_equals_one_shot():
    """synthesize_streaming's tokens equal synthesize's at the same seed,
    alone and with a one-shot request of the same bucket between two of
    its segments; its waveform is the one-shot waveform's."""
    pipe = _pipeline(_card())
    req = tpipe.Request(target_text="stream me please", target_duration=1.2)
    other = tpipe.Request(target_text="in between", target_duration=1.0)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", top_k=4, temperature=1.0)
    res = pipe.synthesize(req, dcfg, seed=5, quiet=True)
    for interleave in (False, True):
        fed, pieces = [], []
        gen = pipe.synthesize_streaming(req, dcfg, seed=5, segment_frames=13,
                                        vocode_chunk=16,
                                        on_tokens=fed.append)
        for i, piece in enumerate(gen):
            pieces.append(piece)
            if interleave and i == 0:
                pipe.synthesize(other, dcfg, seed=6, quiet=True)
        np.testing.assert_array_equal(np.concatenate(fed), res.gen_frames)
        assert len(pieces) > 1
        np.testing.assert_allclose(np.concatenate(pieces), res.wav,
                                   rtol=1e-4, atol=1e-5)


def test_continuous_server_on_the_card():
    """The server captures before it serves; each result equals its
    request alone in a resident state of the same buckets at the exposed
    seed."""
    pipe = _pipeline(_card())
    dcfg = tconfig.DecodeConfig(max_frames=MAX_FRAMES, **SAMPLED)
    srv = ContinuousServer(pipe, dcfg, slots=B, text_bucket=32,
                           prompt_bucket=8, segment_frames=16)
    assert srv.capture_ms is not None and srv.capture_ms > 0
    reqs = [tpipe.Request(target_text=f"continuous {i}",
                          target_duration=0.3) for i in range(6)]
    try:
        results = [f.result(timeout=600) for f in
                   [srv.submit(r) for r in reqs]]
    finally:
        srv.close()
    fns = continuous.make_fns(pipe.cfg, dcfg)
    state = continuous.init_slots(pipe.cfg, dcfg, B, 32, 8, pipe.device)
    strip = [pipe.cfg.special.y_sep, pipe.cfg.eog_inference]
    for req, res in zip(reqs, results):
        planned = pipe.plan_request(req)
        x = np.zeros((32,), np.int32)
        x[:len(planned.text)] = planned.text
        p = np.full((8,), pipe.cfg.special.pad, np.int32)
        want = _alone(fns, pipe.params, state,
                      (x, len(planned.text), p, 0, planned.target, res.seed))
        np.testing.assert_array_equal(res.gen_frames,
                                      want[~np.isin(want, strip)])
        assert res.wav is not None and np.isfinite(res.wav).all()

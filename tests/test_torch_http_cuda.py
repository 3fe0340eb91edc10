"""Concurrent callers of the card's graph sessions (``engine.SESSION_LOCK``):
two threads whose requests share one shape bucket, as an HTTP server's
handler threads and its backend's decode thread do, each get the tokens
they get alone; one pair of one-shot requests, one a one-shot request
beside a segment stream. This module imports no JAX; run it on the card
with

    python -m pytest -o addopts= --noconftest tests/test_torch_http_cuda.py

Without a card every test skips.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine
from t5gemma_tts_tpu_torch.device import tree_to
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.inference.pipeline import Request
from t5gemma_tts_tpu_torch.models import voice

pytestmark = pytest.mark.cuda
DCFG = tconfig.DecodeConfig(top_k=8, top_p=0.9, temperature=0.8,
                            kv_cache="paged")
ROUNDS = 3
WAIT = 300.0


def _pipeline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cfg = tconfig.tiny_voice_config(extra_cutoff=0.0)
    dims = dataclasses.replace(cfg.backbone.decoder, sliding_window=4096)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    ccfg = tcodec.tiny_codec_config()
    return tpipe.TTSPipeline(
        tree_to(voice.init_params(0, cfg, device="cpu"), dev), cfg,
        lambda t: [3 + (ord(c) % 100) for c in t],
        ttok.AudioTokenizer(tcodec.init_decoder_params(1, ccfg,
                                                       device="cpu"),
                            ccfg, device=dev), device=dev)


REQS = [Request(target_text="the first request", target_duration=0.9),
        Request(target_text="and a second one", target_duration=0.9)]


def _one_shot(pipe, req, seed):
    return pipe.synthesize(req, DCFG, seed=seed, quiet=True,
                           decode_audio=False).gen_frames


def _streamed(pipe, req, seed):
    fed = []
    for _ in pipe.synthesize_streaming(req, DCFG, seed=seed,
                                       segment_frames=7, vocode_chunk=16,
                                       on_tokens=fed.append):
        pass
    return np.concatenate(fed)


def _together(jobs):
    """Run each job ROUNDS times on a thread of its own, all at once, the
    interpreter switching threads every 10 µs: {job index: [results]}."""
    got = {i: [] for i in range(len(jobs))}
    errors = []

    def run(i):
        try:
            for _ in range(ROUNDS):
                got[i].append(jobs[i]())
        except Exception as exc:    # reported by the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    assert not errors, errors
    return got


@pytest.mark.parametrize("second", ["one_shot", "stream"])
def test_two_threads_on_one_bucket_get_their_tokens_alone(second):
    pipe = _pipeline()
    engine.release_sessions()
    other = _one_shot if second == "one_shot" else _streamed
    alone = [_one_shot(pipe, REQS[0], 11), other(pipe, REQS[1], 22)]
    assert len(engine.sessions()) == 1      # one bucket for both requests
    assert len(alone[0]) > 0 and not np.array_equal(*alone)
    got = _together([lambda: _one_shot(pipe, REQS[0], 11),
                     lambda: other(pipe, REQS[1], 22)])
    for i in (0, 1):
        for tokens in got[i]:
            np.testing.assert_array_equal(tokens, alone[i])
    engine.release_sessions()

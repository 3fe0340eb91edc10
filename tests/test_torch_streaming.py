"""The port's streaming synthesis on the CPU: ``codec/streaming.py``
against the JAX package's and against the whole-utterance decode, and
``TTSPipeline.synthesize_streaming`` against ``synthesize`` (the same tokens
at the same seed, audio before the last token)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.codec import streaming as jstream
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.codec import streaming as tstream
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.models import voice as tvoice

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5      # tests/test_streaming.py's tolerance


@pytest.fixture(scope="module")
def codec():
    ccfg = jcodec.tiny_codec_config()
    params = jcodec.init_decoder_params(jax.random.PRNGKey(0), ccfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return ccfg, params, tcodec.tiny_codec_config(), tparams


def test_context_frames_match_jax(codec):
    ccfg, _, tcfg, _ = codec
    assert tstream.context_frames(tcfg) == jstream.context_frames(ccfg)
    assert tstream.context_frames(tcodec.XCodec2Config()) == (
        jstream.context_frames(jcodec.XCodec2Config()))


def test_streaming_vocoder_matches_jax(codec):
    """The same token chunks fed to both vocoders give pieces of the same
    lengths at the same calls, and the same audio."""
    ccfg, params, tcfg, tparams = codec
    rng = np.random.default_rng(0)
    codes = rng.integers(0, ccfg.fsq.codebook_size, 240)
    jsv = jstream.StreamingVocoder(params, ccfg, chunk=40)
    tsv = tstream.StreamingVocoder(tparams, tcfg, chunk=40)
    for i in range(0, 240, 17):
        want, got = jsv.feed(codes[i:i + 17]), tsv.feed(codes[i:i + 17])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(tsv.flush(), np.asarray(jsv.flush()),
                               rtol=RTOL, atol=ATOL)


def test_streaming_matches_full_decode(codec):
    _, _, tcfg, tparams = codec
    rng = np.random.default_rng(0)
    n = 240
    codes = rng.integers(0, tcfg.fsq.codebook_size, n)
    full = tcodec.decode_code(tparams, tcfg,
                              torch.from_numpy(codes[None])).numpy()[0]
    pieces = list(tstream.stream_decode(
        tparams, tcfg, [codes[i:i + 17] for i in range(0, n, 17)], chunk=40))
    streamed = np.concatenate(pieces)
    assert len(pieces) > 1 and streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, rtol=RTOL, atol=ATOL)


def test_streaming_emits_incrementally(codec):
    _, _, tcfg, tparams = codec
    sv = tstream.StreamingVocoder(tparams, tcfg, chunk=30)
    rng = np.random.default_rng(1)
    emitted, early = [], False
    total = 200
    for i in range(0, total, 25):
        piece = sv.feed(rng.integers(0, tcfg.fsq.codebook_size, 25))
        emitted.append(piece)
        early = early or (i < total - 25 and len(piece) > 0)
    emitted.append(sv.flush())
    assert early, "no audio before the last token"
    assert sum(len(p) for p in emitted) == total * tcfg.hop_length


@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_pipeline_streaming_matches_synthesize(codec, mode):
    """synthesize_streaming gives synthesize's tokens at the same seed, its
    first audio before the last token, and its waveform within the
    streaming tolerance."""
    _, _, tcfg_codec, tparams_codec = codec
    cfg = tconfig.tiny_voice_config(extra_cutoff=0.0)
    dims = dataclasses.replace(cfg.backbone.decoder, sliding_window=4096)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    pipe = tpipe.TTSPipeline(
        tvoice.init_params(0, cfg, device="cpu"), cfg,
        lambda t: [3 + (ord(c) % 500) for c in t],
        ttok.AudioTokenizer(tparams_codec, tcfg_codec, device="cpu"),
        device="cpu")
    req = tpipe.Request(target_text="stream me please", target_duration=1.2)
    kw = dict(top_k=4, temperature=1.0) if mode == "sampled" else dict(
        top_k=1)
    dcfg = tconfig.DecodeConfig(kv_cache="paged", **kw)
    res = pipe.synthesize(req, dcfg, seed=5, quiet=True)
    fed, firsts = [], []

    def on_tokens(toks):
        fed.append(toks)

    pieces = []
    for piece in pipe.synthesize_streaming(req, dcfg, seed=5,
                                           segment_frames=13,
                                           vocode_chunk=16,
                                           on_tokens=on_tokens):
        pieces.append(piece)
        firsts.append(sum(len(t) for t in fed))
    np.testing.assert_array_equal(np.concatenate(fed), res.gen_frames)
    assert len(pieces) > 1, "streaming produced a single blob"
    assert firsts[0] < len(res.gen_frames), "no audio before the last token"
    streamed = np.concatenate(pieces)
    assert streamed.shape == res.wav.shape
    np.testing.assert_allclose(streamed, res.wav, rtol=RTOL, atol=ATOL)

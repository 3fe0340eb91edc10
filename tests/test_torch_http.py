"""The port's front ends on the CPU: the HTTP server
(``inference/http_server.py``), ``TieredBackend`` and the Gradio callback.

- an in-process server on 127.0.0.1:0 over the tiny pipeline, in front of
  ``BatchingServer`` and ``ContinuousServer``: /synthesize bytes equal to
  ``wav_bytes`` of the backend's own result at the same seed (the
  continuous server's result at the seed it gave the request, ``X-Seed``,
  decoded alone); the chunked stream's header, PCM (equal to
  ``synthesize_streaming``'s pieces) and terminator, and no terminator
  after a failure mid-stream; 401 and 404 with the body read, then a
  request on the same connection that succeeds; /healthz without auth;
  the /metrics counters; tokens as JSON without audio;
- ``start`` (the server's command line) with ``--random_model test
  --random_codec --device cpu --port 0``;
- ``TieredBackend``: the fast tier first, the swap, the drain, a
  completed ``submit`` marking the tier served, no build after ``close``
  and a late build closed at once; a ``--fast_start`` server in front of
  an int8 full tier through HTTP;
- ``make_infer_fn`` with a stub Whisper loader on a blank transcript.

The CLI's transcription of a reference without its transcript is held in
tests/test_torch_pipeline.py, beside the CLI's other cloning cases and
their exported model.

Every wait is bounded.
"""

import dataclasses
import http.client
import json
import socket
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from test_torch_pipeline import _reference_wav

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine
from t5gemma_tts_tpu_torch.inference import gradio_app
from t5gemma_tts_tpu_torch.inference import http_server as hs
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.inference.pipeline import Request
from t5gemma_tts_tpu_torch.inference.server import (BatchingServer,
                                                    ContinuousServer,
                                                    ServerStats,
                                                    TieredBackend)
from t5gemma_tts_tpu_torch.models import voice

torch.set_num_threads(1)

WAIT = 120.0                   # seconds: the bound of every wait here
TOKEN = "s3cret"
BODY = {"target_text": "hello there", "target_duration": 0.3, "lang": "en"}


def _pipeline(encoder=False):
    cfg = tconfig.tiny_voice_config(extra_cutoff=0.0)
    dims = dataclasses.replace(cfg.backbone.decoder, sliding_window=4096)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    ccfg = tcodec.tiny_codec_config()
    cparams = tcodec.init_decoder_params(1, ccfg, device="cpu")
    if encoder:
        cparams.update(tcodec.init_encoder_params_for(2, ccfg, device="cpu"))
    return tpipe.TTSPipeline(
        voice.init_params(0, cfg, device="cpu"), cfg,
        lambda t: [3 + (ord(c) % 100) for c in t],
        ttok.AudioTokenizer(cparams, ccfg, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def pipe():
    return _pipeline()


DCFG = tconfig.DecodeConfig(top_k=4, temperature=1.0, max_frames=48)


class _Served:
    """An HTTP server on 127.0.0.1:0 in front of ``backend``."""

    def __init__(self, backend, sr, auth_token=None):
        self.backend = backend
        self.httpd = hs.serve(backend, "127.0.0.1", 0, sample_rate=sr,
                              block=False, auth_token=auth_token)
        self.port = self.httpd.server_address[1]

    def conn(self):
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=WAIT)

    def post(self, path, body, headers=None, conn=None):
        c = conn or self.conn()
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
        r = c.getresponse()
        return r, r.read()

    def raw(self, path, body, headers=""):
        """The raw response bytes to one POST (connection closed)."""
        data = json.dumps(body).encode()
        req = (f"POST {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
               f"Content-Length: {len(data)}\r\n{headers}\r\n").encode()
        with socket.create_connection(("127.0.0.1", self.port),
                                      timeout=WAIT) as s:
            s.sendall(req + data)
            out = b""
            while chunk := s.recv(65536):
                out += chunk
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.backend.close()


@pytest.fixture(scope="module")
def batching(pipe):
    srv = _Served(BatchingServer(pipe, DCFG, max_batch=4, max_wait_ms=20.0),
                  pipe.audio_tokenizer.sample_rate, auth_token=TOKEN)
    yield srv
    srv.close()


AUTH = {"Authorization": f"Bearer {TOKEN}"}


def _request(body=BODY):
    return Request(target_text=body["target_text"],
                   target_duration=body["target_duration"],
                   lang=body["lang"])


def test_synthesize_bytes_equal_the_backends_result(batching, pipe):
    r, body = batching.post("/synthesize", BODY, AUTH)
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    assert float(r.getheader("X-RTF")) > 0 and r.getheader("X-Seed") is None
    res = batching.backend.synthesize(_request(), timeout=WAIT)
    assert body == hs.wav_bytes(res.wav, pipe.audio_tokenizer.sample_rate)


def _chunks(raw: bytes):
    """(status line, headers, [chunk payloads], terminated) of a raw
    chunked response."""
    head, rest = raw.split(b"\r\n\r\n", 1)
    chunks = []
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            return head, chunks, rest == b"\r\n"
        chunks.append(rest[:n])
        assert rest[n:n + 2] == b"\r\n"
        rest = rest[n + 2:]
    return head, chunks, False


def test_streaming_is_chunked_and_equals_synthesize_streaming(batching,
                                                              pipe):
    sr = pipe.audio_tokenizer.sample_rate
    body = dict(BODY, target_duration=1.5)        # 75 frames: two segments
    head, chunks, terminated = _chunks(batching.raw(
        "/synthesize_streaming", body, f"Authorization: Bearer {TOKEN}\r\n"))
    assert head.startswith(b"HTTP/1.1 200") and terminated
    assert b"Transfer-Encoding: chunked" in head
    assert chunks[0] == hs.wav_stream_header(sr)
    want = [hs.pcm16(p)
            for p in pipe.synthesize_streaming(_request(body), DCFG)]
    assert len(chunks) == 1 + len(want) > 2
    assert b"".join(chunks[1:]) == b"".join(want)


def test_failed_stream_gets_no_terminator(batching, monkeypatch):
    def failing(req, dcfg=None, **kw):
        yield np.zeros(64, np.float32)
        raise RuntimeError("injected mid-stream failure")

    monkeypatch.setattr(batching.backend.pipeline, "synthesize_streaming",
                        failing)
    head, chunks, terminated = _chunks(batching.raw(
        "/synthesize_streaming", BODY, f"Authorization: Bearer {TOKEN}\r\n"))
    assert head.startswith(b"HTTP/1.1 200") and not terminated
    assert len(chunks) == 2          # the header and the one piece


def test_refusals_drain_the_body_and_keep_the_connection(batching):
    c = batching.conn()
    r, body = batching.post("/nope", BODY, AUTH, conn=c)
    assert r.status == 404 and json.loads(body) == {"error": "not found"}
    r, _ = batching.post("/synthesize", BODY, conn=c)
    assert r.status == 401
    r, _ = batching.post("/synthesize", BODY,
                         {"Authorization": "Bearer wrong"}, conn=c)
    assert r.status == 401
    r, _ = batching.post("/synthesize", {"lang": "en"}, AUTH, conn=c)
    assert r.status == 400
    r, body = batching.post("/synthesize", BODY, AUTH, conn=c)
    assert r.status == 200 and body[:4] == b"RIFF"
    c.close()


def test_healthz_is_open_and_metrics_count(batching):
    c = batching.conn()
    c.request("GET", "/healthz")
    r = c.getresponse()
    health = json.loads(r.read())
    assert r.status == 200 and health["ok"] and health["tier"] == "full"
    c.request("GET", "/metrics")
    r = c.getresponse()
    r.read()
    assert r.status == 401
    before = batching.backend.stats.requests
    batching.post("/synthesize", BODY, AUTH, conn=c)
    c.request("GET", "/metrics", headers=AUTH)
    r = c.getresponse()
    text = r.read().decode()
    metrics = dict(line.split() for line in text.splitlines()
                   if not line.startswith("#"))
    assert r.status == 200
    assert int(metrics["tts_requests_total"]) == before + 1
    assert float(metrics["tts_audio_seconds_total"]) > 0
    assert int(metrics["tts_batches_total"]) >= 1
    c.close()


def test_tokens_as_json_without_audio(pipe):
    srv = _Served(BatchingServer(pipe, DCFG, max_batch=2, max_wait_ms=5.0,
                                 decode_audio=False), 16000)
    try:
        r, body = srv.post("/synthesize", BODY)
        out = json.loads(body)
        res = srv.backend.synthesize(_request(), timeout=WAIT)
    finally:
        srv.close()
    assert r.status == 200 and r.getheader("Content-Type") == (
        "application/json")
    assert out["frames"] == res.gen_frames.tolist() and out["rtf"] > 0


def test_continuous_server_bytes_equal_the_request_alone(pipe):
    dcfg = dataclasses.replace(DCFG, top_p=0.9, temperature=0.8)
    srv = _Served(ContinuousServer(pipe, dcfg, slots=2, text_bucket=32,
                                   prompt_bucket=8, segment_frames=16),
                  pipe.audio_tokenizer.sample_rate)
    try:
        bodies = [dict(BODY, target_text=f"request {i}") for i in range(3)]
        out = [None] * 3

        def send(i):
            out[i] = srv.post("/synthesize", bodies[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.close()
    assert sorted(int(r.getheader("X-Seed")) for r, _ in out) == sorted(
        srv.backend.request_seed(n) for n in range(3))
    strip = [pipe.cfg.special.y_sep, pipe.cfg.eog_inference]
    alone = dataclasses.replace(dcfg, kv_cache="paged")
    for body, (r, got) in zip(bodies, out):
        planned = pipe.plan_request(_request(body))
        x = np.zeros((1, 32), np.int32)
        x[0, :len(planned.text)] = planned.text
        prompt = np.full((1, 8), pipe.cfg.special.pad, np.int32)
        dec = engine.decode_tokens(
            pipe.params, pipe.cfg, alone, torch.from_numpy(x),
            torch.tensor([len(planned.text)], dtype=torch.int32),
            torch.from_numpy(prompt), torch.zeros(1, dtype=torch.int32),
            torch.tensor([planned.target], dtype=torch.int32),
            int(r.getheader("X-Seed")))
        toks = dec.tokens[0, :int(dec.gen_lens[0])].numpy()
        toks = toks[~np.isin(toks, strip)]
        wav = pipe.audio_tokenizer.decode(toks[None, None, :])[0, 0]
        assert got == hs.wav_bytes(wav, pipe.audio_tokenizer.sample_rate)


def test_start_serves_a_random_model_on_the_cpu(monkeypatch, capsys):
    ccfg = tcodec.tiny_codec_config()
    monkeypatch.setattr(tcodec, "XCodec2Config", lambda: ccfg)
    httpd, backend = hs.start([
        "--random_model", "test", "--random_codec", "--device", "cpu",
        "--port", "0", "--host", "127.0.0.1", "--no_warmup",
        "--max_batch", "2"])
    srv = _Served.__new__(_Served)
    srv.httpd, srv.backend, srv.port = httpd, backend, httpd.server_address[1]
    body = dict(BODY, target_duration=0.1)
    try:
        assert f":{srv.port} (cpu)" in capsys.readouterr().out
        r, got = srv.post("/synthesize", body)
        res = backend.synthesize(_request(body), timeout=WAIT)
        head, chunks, terminated = _chunks(srv.raw("/synthesize_streaming",
                                                   body))
    finally:
        srv.close()
    assert r.status == 200 and got == hs.wav_bytes(res.wav, ccfg.sample_rate)
    assert terminated and chunks[0] == hs.wav_stream_header(ccfg.sample_rate)
    assert len(b"".join(chunks[1:])) == 2 * len(res.wav)


class _Stub:
    """A serving core that answers at once (``fail``: with an error)."""

    def __init__(self, name, fail=False):
        self.name, self.fail, self.closed = name, fail, threading.Event()
        self.stats, self.pipeline, self.dcfg = ServerStats(), name, name

    def submit(self, request):
        fut = Future()
        if self.fail:
            fut.set_exception(RuntimeError(f"{self.name} failed"))
        else:
            fut.set_result(self.name)
        return fut

    def close(self):
        self.closed.set()


def _wait(cond):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < WAIT, "timed out"
        time.sleep(0.01)


def test_tiered_backend_swaps_after_a_served_submit_and_drains():
    fast, full, built = _Stub("fast"), _Stub("full"), []
    backend = TieredBackend(fast, lambda: built.append(1) or full,
                            drain_sec=0.05, build_delay_sec=WAIT)
    try:
        assert backend.tier == "fast" and backend.pipeline == "fast"
        time.sleep(0.05)
        assert not built                        # waits until served
        assert backend.submit(Request("a")).result(WAIT) == "fast"
        _wait(lambda: backend.tier == "full")
        assert built == [1] and backend.build_s is not None
        assert backend.synthesize(Request("b"), WAIT) == "full"
        assert backend.dcfg == "full"
        assert fast.closed.wait(WAIT)           # drained
        assert not full.closed.is_set()
    finally:
        backend.close()
    assert full.closed.is_set()


def test_tiered_backend_failed_request_does_not_start_the_build():
    built = []
    backend = TieredBackend(_Stub("fast", fail=True),
                            lambda: built.append(1) or _Stub("full"),
                            build_delay_sec=WAIT)
    with pytest.raises(RuntimeError, match="fast failed"):
        backend.synthesize(Request("a"), WAIT)
    time.sleep(0.05)
    backend.close()
    backend._build_thread.join(WAIT)
    assert not backend._build_thread.is_alive() and not built


def test_tiered_backend_builds_nothing_after_close():
    fast, built = _Stub("fast"), []
    backend = TieredBackend(fast, lambda: built.append(1) or _Stub("full"),
                            build_delay_sec=WAIT)
    backend.close()
    backend._build_thread.join(WAIT)
    assert not backend._build_thread.is_alive()
    assert not built and fast.closed.is_set() and backend.tier == "fast"


def test_tiered_backend_closes_a_tier_built_after_close():
    fast, full, go, started = (_Stub("fast"), _Stub("full"),
                               threading.Event(), threading.Event())

    def slow_factory():
        started.set()
        assert go.wait(WAIT)
        return full

    backend = TieredBackend(fast, slow_factory, build_delay_sec=WAIT)
    backend.submit(Request("a")).result(WAIT)
    assert started.wait(WAIT)
    backend.close()
    go.set()
    backend._build_thread.join(WAIT)
    assert not backend._build_thread.is_alive()
    assert full.closed.is_set() and backend.tier == "fast"


def test_fast_start_swaps_to_the_int8_tier_over_http(pipe):
    backend = hs.tiered_backend(pipe, DCFG, "int8", max_batch=2,
                                drain_sec=0.05, build_delay_sec=WAIT)
    srv = _Served(backend, pipe.audio_tokenizer.sample_rate)
    try:
        def tier():
            c = srv.conn()
            c.request("GET", "/healthz")
            out = json.loads(c.getresponse().read())["tier"]
            c.close()
            return out

        assert tier() == "fast"
        r, first = srv.post("/synthesize", BODY)
        assert r.status == 200
        _wait(lambda: tier() == "full")
        r, second = srv.post("/synthesize", BODY)
        assert r.status == 200
        full_pipe = backend.pipeline
        assert full_pipe is not pipe and full_pipe.params["encoder"] is not (
            pipe.params["encoder"])
        res = backend.synthesize(_request(), WAIT)
        assert second == hs.wav_bytes(res.wav,
                                      pipe.audio_tokenizer.sample_rate)
    finally:
        srv.close()


class _StubWhisper:
    def __init__(self):
        self.paths = []

    def transcribe(self, path):
        self.paths.append(path)
        return {"text": "the reference words"}


def test_make_infer_fn_transcribes_a_blank_transcript(tmp_path,
                                                      monkeypatch):
    pipe = _pipeline(encoder=True)
    monkeypatch.setattr(gradio_app, "_load_resources", lambda *a: pipe)
    whisper = _StubWhisper()
    infer = gradio_app.make_infer_fn("unused", device="cpu",
                                     whisper_loader=lambda: whisper)
    ref = _reference_wav(str(tmp_path / "ref.wav"))
    (sr, wav), info = infer(ref, "", "hello world", 0.3, 7, 4, 0.9, 0.0, 0.8)
    assert whisper.paths == [ref] and "seed=7" in info
    want = pipe.synthesize(
        Request(target_text="hello world", audio_path=ref,
                prompt_transcript="the reference words",
                target_duration=0.3),
        tconfig.DecodeConfig(top_k=4, top_p=0.9, min_p=0.0,
                             temperature=0.8, seed=7), seed=7)
    assert sr == pipe.audio_tokenizer.sample_rate
    np.testing.assert_array_equal(wav, want.wav)
    infer(ref, "given words", "hello", 0.2, 3, 4, 0.9, 0.0, 0.8)
    assert whisper.paths == [ref]            # a transcript given: no Whisper
    with pytest.raises(ValueError, match="target text"):
        gradio_app.make_infer_fn("unused", device="cpu",
                                 error_cls=ValueError)(
            ref, "x", "", 0, 1, 4, 0.9, 0.0, 0.8)

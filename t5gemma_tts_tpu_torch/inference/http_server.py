"""HTTP front end of the port's serving cores (stdlib only).

Counterpart of ``t5gemma_tts_tpu/inference/http_server.py``:

POST /synthesize     JSON body -> 16-bit PCM wav bytes (audio/wav)
    {"target_text": "...", "target_duration": 5.0, "lang": "en",
     "audio_path": "/path/ref.wav", "prompt_transcript": "...",
     "repeat_prompt": 0, "concat": false}
    Headers: ``X-RTF``, and ``X-Seed`` when the server gives each request
    a seed of its own (``ContinuousServer``). A server built with
    ``decode_audio=False`` answers the tokens as JSON instead.
POST /synthesize_streaming   same body -> chunked audio/wav: a streaming
    RIFF header (sizes 0xFFFFFFFF) and then PCM16 pieces as decode
    segments finalize (``TTSPipeline.synthesize_streaming`` at batch 1, the
    backend's DecodeConfig). A stream that fails after its header gets no
    chunked terminator, so the client sees the truncation.
GET  /healthz        JSON server stats and the serving ``tier`` (never
                     authenticated: probes)
GET  /metrics        Prometheus text (request and batch counters, audio
                     seconds, uptime)

Optional bearer auth (``--auth_token`` or ``$T5G_AUTH_TOKEN``): /synthesize*
and /metrics then require ``Authorization: Bearer <token>``, compared in
constant time. Each connection has its own thread (ThreadingHTTPServer);
the graphed decode of concurrent callers is serialized by the engine's
session lock (``decode/engine.py``). Before it binds the port, ``start``
warms every graph session it will replay (the batch-1 streaming buckets
included), so no capture runs while the backend's threads work; a bucket
that was not warmed (any bucket of a ``--fast_start`` server's fast tier,
which warms nothing) is captured under the session lock at first use.

Run: python -m t5gemma_tts_tpu_torch.inference.http_server --model_dir DIR
     [--device cpu] ...   (or --random_model PRESET --random_codec)
"""

from __future__ import annotations

import dataclasses
import hmac
import io
import json
import logging
import os
import struct
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..config import DecodeConfig
from .pipeline import Request, TTSPipeline

log = logging.getLogger(__name__)

# the batch-1 buckets a stream of a short request decodes at (text, prompt
# and frame buckets of ``TTSPipeline.widths`` for one request)
STREAM_TEXT_BUCKETS = (32, 64)
STREAM_FRAME_BUCKETS = (256, 512)


def wav_stream_header(sample_rate: int) -> bytes:
    """RIFF/WAVE header with unknown (0xFFFFFFFF) sizes for live streams."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                    sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(np.asarray(wav, np.float32), -1, 1)
            * 32767).astype("<i2").tobytes()


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16(wav))
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    server_version = "t5gemma-tts-torch/1.0"
    protocol_version = "HTTP/1.1"       # chunked transfer for /…_streaming
    backend = None                      # a server of inference/server.py
    sample_rate: int = 44100
    request_timeout: float = 600.0
    auth_token: Optional[str] = None
    started_at: float = 0.0
    audio_seconds: list = None          # [total], shared by the handlers
    metrics_lock: threading.Lock = None

    def _add_audio_seconds(self, secs: float) -> None:
        with self.metrics_lock:
            self.audio_seconds[0] += secs

    def log_message(self, fmt, *args):  # to logging, not stderr
        log.debug("http: " + fmt, *args)

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self) -> bool:
        """Bearer-token check in constant time; /healthz is exempt."""
        if not self.auth_token:
            return True
        got = self.headers.get("Authorization", "")
        return got.startswith("Bearer ") and hmac.compare_digest(
            got[len("Bearer "):], self.auth_token)

    def do_GET(self):
        if self.path == "/healthz":
            st = self.backend.stats
            return self._json(200, {
                "ok": True,
                "requests": st.requests,
                "batches": st.batches,
                "batch_sizes": st.batch_sizes[-16:],
                # "fast" while a --fast_start server serves from its fast
                # tier, "full" once the full tier swapped in
                "tier": getattr(self.backend, "tier", "full"),
            })
        if self.path == "/metrics":
            if not self._authorized():
                return self._json(401, {"error": "unauthorized"})
            st = self.backend.stats
            sizes = st.batch_sizes
            lines = [
                "# TYPE tts_requests_total counter",
                f"tts_requests_total {st.requests}",
                "# TYPE tts_batches_total counter",
                f"tts_batches_total {st.batches}",
                "# TYPE tts_last_batch_size gauge",
                f"tts_last_batch_size {sizes[-1] if sizes else 0}",
                "# TYPE tts_audio_seconds_total counter",
                f"tts_audio_seconds_total {self.audio_seconds[0]:.3f}",
                "# TYPE tts_uptime_seconds gauge",
                f"tts_uptime_seconds {time.time() - self.started_at:.1f}",
            ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None
        return self._json(404, {"error": "not found"})

    def do_POST(self):
        # read the body first: a reply (404, 401) that leaves it unread
        # desynchronizes the keep-alive connection, whose next request
        # line would be the unread JSON
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True  # length unknown: cannot resync
            return self._json(400, {"error": "bad Content-Length"})
        raw = self.rfile.read(n) if n else b""
        if self.path not in ("/synthesize", "/synthesize_streaming"):
            return self._json(404, {"error": "not found"})
        if not self._authorized():
            return self._json(401, {"error": "unauthorized"})
        try:
            payload = json.loads(raw or b"{}")
            text = payload.get("target_text", "")
            if not text:
                return self._json(400, {"error": "target_text required"})
            req = Request(
                target_text=text,
                lang=payload.get("lang"),
                audio_path=payload.get("audio_path"),
                prompt_transcript=payload.get("prompt_transcript"),
                target_duration=payload.get("target_duration"),
                repeat_prompt=payload.get("repeat_prompt", 0),
                prompt_end_frame=payload.get("prompt_end_frame", -1),
            )
        except (ValueError, TypeError, AttributeError) as exc:
            return self._json(400, {"error": str(exc)})
        if self.path == "/synthesize_streaming":
            return self._stream(req)
        try:
            res = self.backend.synthesize(req, timeout=self.request_timeout)
        except Exception as exc:   # the request's own failure: report it
            log.exception("synthesis failed")
            return self._json(500, {"error": str(exc)})
        wav = res.concat_wav if payload.get("concat") else res.wav
        if wav is None:            # a decode_audio=False server: tokens
            return self._json(200, {
                "frames": np.asarray(res.gen_frames).tolist(),
                "rtf": res.rtf, "seed": res.seed})
        self._add_audio_seconds(len(np.asarray(wav)) / self.sample_rate)
        body = wav_bytes(wav, self.sample_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-RTF", f"{res.rtf:.3f}")
        if res.seed is not None:
            self.send_header("X-Seed", str(res.seed))
        self.end_headers()
        self.wfile.write(body)
        return None

    def _stream(self, req: Request) -> None:
        """Chunked streaming synthesis (batch 1). The first piece is made
        before the status line, so a request that fails before any audio
        gets a 500."""
        backend = self.backend
        try:
            pieces = iter(backend.pipeline.synthesize_streaming(
                req, backend.dcfg))
            first = next(pieces, None)
        except Exception as exc:   # the request's own failure: report it
            log.exception("streaming setup failed")
            return self._json(500, {"error": str(exc)})

        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(b: bytes) -> None:
            self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

        def send(piece) -> None:
            body = pcm16(piece)
            if body:
                self._add_audio_seconds(len(body) / 2 / self.sample_rate)
                chunk(body)

        try:
            chunk(wav_stream_header(self.sample_rate))
            if first is not None:
                send(first)
                for piece in pieces:
                    send(piece)
            self.wfile.write(b"0\r\n\r\n")   # chunked terminator
        except Exception:
            # no terminator: dropping the connection is how a chunked
            # client tells a truncated stream from a finished one
            log.exception("streaming synthesis failed mid-stream")
            self.close_connection = True
        return None


def serve(backend, host: str = "0.0.0.0", port: int = 8000,
          sample_rate: int = 44100, block: bool = True,
          auth_token: Optional[str] = None
          ) -> Optional[ThreadingHTTPServer]:
    """Start the HTTP server. With ``block=False`` it serves on a daemon
    thread and returns the server (the caller ends it with ``.shutdown()``
    and ``.server_close()``); the port bound is ``server.server_address[1]``
    (``port=0`` binds a free one)."""
    handler = type("Handler", (_Handler,), {
        "backend": backend, "sample_rate": sample_rate,
        "auth_token": auth_token, "started_at": time.time(),
        "audio_seconds": [0.0], "metrics_lock": threading.Lock(),
    })
    httpd = ThreadingHTTPServer((host, port), handler)
    if block:
        log.info("serving on %s:%d", *httpd.server_address)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return None
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="http-serve").start()
    return httpd


def warm_streaming(pipe: TTSPipeline, dcfg: DecodeConfig) -> list:
    """Capture the batch-1 sessions that streams of short requests replay
    (``STREAM_TEXT_BUCKETS`` x prompt 64 x ``STREAM_FRAME_BUCKETS``, with
    the backend's DecodeConfig): a stream and a one-shot request of one
    bucket share a session. Returns ``TTSPipeline.warmup``'s report."""
    return pipe.warmup(batch_sizes=(1,), text_buckets=STREAM_TEXT_BUCKETS,
                       prompt_buckets=(64,),
                       frame_buckets=STREAM_FRAME_BUCKETS, dcfg=dcfg)


def make_backend(pipe: TTSPipeline, dcfg: DecodeConfig, *,
                 continuous: bool = False, slots: int = 8,
                 max_batch: int = 32, max_wait_ms: float = 50.0,
                 warmup: bool = True):
    """The serving core: a ``ContinuousServer`` (it captures its segment in
    its constructor) or a ``BatchingServer`` (warmed with ``warmup``),
    then, with ``warmup``, the streaming sessions (:func:`warm_streaming`)."""
    from .server import BatchingServer, ContinuousServer

    if continuous:
        backend = ContinuousServer(pipe, dcfg, slots=slots)
    else:
        backend = BatchingServer(pipe, dcfg, max_batch=max_batch,
                                 max_wait_ms=max_wait_ms, warmup=warmup)
    if warmup:
        try:
            warm_streaming(pipe, backend.dcfg)
        except Exception:
            backend.close()
            raise
    return backend


def quantized_pipeline(pipe: TTSPipeline, quantize: str) -> TTSPipeline:
    """A pipeline on ``pipe``'s fused bf16 params quantized for decode
    (``quantize`` "int8" or "int4"; "none" returns ``pipe``): the full tier
    of a ``--fast_start`` server reuses the fast tier's weights rather than
    loading a second copy."""
    if quantize == "none":
        return pipe
    from ..ops.quant import quantize_params_for_decode

    params = quantize_params_for_decode(
        pipe.params, weight_bits=4 if quantize == "int4" else 8)
    return TTSPipeline(params, pipe.cfg, pipe.encode_text,
                       pipe.audio_tokenizer, fuse_matmuls=False,
                       device=pipe.device,
                       audio_max_length=pipe.audio_max_length)


def tiered_backend(fast_pipe: TTSPipeline, dcfg: DecodeConfig,
                   quantize: str = "none", max_batch: int = 32,
                   drain_sec: float = 60.0, build_delay_sec: float = 120.0,
                   **full_kw):
    """``--fast_start``: a ``TieredBackend`` whose fast tier is a bf16
    ``BatchingServer`` on ``fast_pipe`` without warm-up, its KV cache
    "auto" (on the card the paged cache, so kernel 1, for every request
    that fits the sliding window), and whose full tier is
    :func:`quantized_pipeline` served by :func:`make_backend` (``dcfg``,
    ``full_kw``), warmed on the build thread."""
    from .server import BatchingServer, TieredBackend

    fast = BatchingServer(fast_pipe, dataclasses.replace(dcfg,
                                                         kv_cache="auto"),
                          max_batch=min(8, max_batch), warmup=False)

    def full_factory():
        return make_backend(quantized_pipeline(fast_pipe, quantize), dcfg,
                            max_batch=max_batch, **full_kw)

    return TieredBackend(fast, full_factory, drain_sec=drain_sec,
                         build_delay_sec=build_delay_sec)


def _random_model_pipeline(preset: str, codec_dir: Optional[str],
                           quantize: str, device) -> TTSPipeline:
    """Seeded random weights of a backbone preset, random codec decoder
    weights (or ``codec_dir``'s) and a character tokenizer: a server to
    probe and test with, since serving speed does not depend on the
    weights' values."""
    from argparse import Namespace

    from ..config import VoiceConfig, backbone_preset
    from ..models import voice
    from .cli import _load_codec

    cfg = VoiceConfig(backbone=backbone_preset(preset))
    params = voice.init_params(0, cfg, device=device)
    audio_tok = _load_codec(Namespace(codec_dir=codec_dir,
                                      random_codec=codec_dir is None,
                                      xcodec2_model_name=None), None, device)

    def text_tok(s: str):
        return [max(3, ord(c) % 255) for c in s]

    return TTSPipeline(params, cfg, text_tok, audio_tok, device=device,
                       int8=quantize == "int8", int4=quantize == "int4")


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="T5Gemma-TTS (PyTorch/CUDA port) HTTP server")
    ap.add_argument("--model_dir", default=None)
    ap.add_argument("--random_model", default=None, metavar="PRESET",
                    help="serve seeded random weights of this backbone "
                         "preset instead of --model_dir (probing, testing)")
    ap.add_argument("--codec_dir", default=None)
    ap.add_argument("--random_codec", action="store_true",
                    help="random codec decoder weights (testing only)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=32)
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a resident batch "
                         "(ContinuousServer) instead of collection windows")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4"],
                    help="decode-weight quantization (int8: serving; int4: "
                         "batch-1 latency)")
    ap.add_argument("--kv_cache", default="auto",
                    choices=["auto", "dense", "paged", "paged_f8",
                             "paged_i8"],
                    help="decode KV-cache strategy (DecodeConfig.kv_cache)")
    ap.add_argument("--auth_token", default=None,
                    help="require 'Authorization: Bearer <token>' on "
                         "/synthesize* and /metrics (default: "
                         "$T5G_AUTH_TOKEN if set; /healthz stays open)")
    ap.add_argument("--fast_start", action="store_true",
                    help="answer the first requests from a bf16 tier "
                         "without warm-up while the --quantize tier builds "
                         "and warms in the background, then switch "
                         "(TieredBackend)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    return ap


def start(argv=None):
    """Parse the command line, load the pipeline, build and warm the
    backend, and serve on a daemon thread: (http server, backend). The
    caller shuts both down."""
    from ..device import resolve_device
    from .gradio_app import _load_resources

    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.model_dir and not args.random_model:
        ap.error("--model_dir or --random_model required")
    auth_token = args.auth_token or os.environ.get("T5G_AUTH_TOKEN") or None
    device = resolve_device(args.device)

    def load_pipe(quantize: str) -> TTSPipeline:
        if args.random_model:
            return _random_model_pipeline(args.random_model, args.codec_dir,
                                          quantize, device)
        return _load_resources(args.model_dir, args.codec_dir,
                               args.random_codec, quantize, str(device))

    dcfg = DecodeConfig(kv_cache=args.kv_cache)
    serving = dict(continuous=args.continuous, slots=args.slots,
                   max_wait_ms=args.max_wait_ms, warmup=not args.no_warmup)
    if args.fast_start:
        pipe = load_pipe("none")
        backend = tiered_backend(pipe, dcfg, args.quantize,
                                 max_batch=args.max_batch, **serving)
    else:
        pipe = load_pipe(args.quantize)
        backend = make_backend(pipe, dcfg, max_batch=args.max_batch,
                               **serving)
    sr = (pipe.audio_tokenizer.sample_rate
          if pipe.audio_tokenizer is not None else 44100)
    try:
        httpd = serve(backend, args.host, args.port, sample_rate=sr,
                      block=False, auth_token=auth_token)
    except OSError:
        backend.close()
        raise
    print(f"[Info] serving on http://{args.host}:"
          f"{httpd.server_address[1]} ({device})", flush=True)
    return httpd, backend


def main(argv=None) -> None:
    """CLI: serve until interrupted."""
    logging.basicConfig(level=logging.INFO)
    httpd, backend = start(argv)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


if __name__ == "__main__":
    main()

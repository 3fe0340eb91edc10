"""Serving cores: a batching server and a continuous-batching server.

Counterpart of ``t5gemma_tts_tpu/inference/server.py`` (``ServerStats``,
``BatchingServer``, ``ContinuousServer``), dependency-free (threads, no
asyncio):

    submit(request) -> Future        # from any thread

- :class:`BatchingServer`: a collector thread gathers up to ``max_batch``
  requests, waiting at most ``max_wait_ms`` after the first, plans them
  (duration estimate, prompt tokenization), groups them by frame bucket and
  runs each group through ``TTSPipeline.synthesize_planned``, shortest
  bucket first, so the cheap futures resolve earliest.
- :class:`ContinuousServer`: a fixed batch of ``slots`` decodes in segments
  (``decode/continuous.py``); between segments the finished requests are
  harvested and queued ones prefill into the free slots, so a request that
  arrives mid-batch does not wait for the batch. Request n's seed is
  ``sampling.fold_seed(dcfg.seed, n)`` (:meth:`ContinuousServer.
  request_seed`, also in its result's ``seed``), and a request's tokens are
  those it would get alone at that seed. Vocoding runs on a finisher pool,
  not on the scheduler thread. The segment is captured before the
  scheduler starts, so no capture runs while the finisher threads use the
  card.
- :class:`TieredBackend`: serves from a fast tier while the full serving
  tier builds on a thread of its own, then swaps to it and drains the fast
  tier.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import DecodeConfig
from ..ops import sampling
from .pipeline import Request, SynthesisResult, TTSPipeline

log = logging.getLogger(__name__)


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0             # decode groups, or harvests that freed rows
    batch_sizes: List[int] = field(default_factory=list)
    admit_ms: List[float] = field(default_factory=list)   # host ms an admit


def _strip(pipeline: TTSPipeline, prompt, gen_tokens):
    """(generated tokens, prompt + generated) without y_sep and EOG."""
    cfg = pipeline.cfg
    strip = [cfg.special.y_sep, cfg.eog_inference]
    gen = np.asarray(gen_tokens, np.int64)
    gen = gen[~np.isin(gen, strip)]
    concat = np.concatenate([
        np.asarray([t for t in prompt if t not in strip], np.int64), gen])
    return gen, concat


class ContinuousServer:
    """Continuous batching over a resident decode batch (see the module
    docstring). Fixed buckets: text, prompt and generation buffers are set
    at construction (``dcfg.max_frames`` is the frame bucket); a request
    that does not fit fails its own future."""

    def __init__(self, pipeline: TTSPipeline,
                 dcfg: Optional[DecodeConfig] = None, slots: int = 8,
                 text_bucket: int = 64, prompt_bucket: int = 64,
                 segment_frames: int = 50, decode_audio: bool = True):
        from ..decode import continuous

        self.pipeline = pipeline
        self.dcfg = dcfg or DecodeConfig()
        self.slots = slots
        self.text_bucket = text_bucket
        self.prompt_bucket = prompt_bucket
        self.segment_frames = segment_frames
        self.decode_audio = decode_audio
        self.stats = ServerStats()
        self._continuous = continuous
        self._fns = continuous.make_fns(pipeline.cfg, self.dcfg)
        self.state = continuous.init_slots(pipeline.cfg, self.dcfg, slots,
                                           text_bucket, prompt_bucket,
                                           pipeline.device)
        self.capture_ms = self._fns.capture(pipeline.params, self.state)
        self._slot_futures: list = [None] * slots
        self._admitted = 0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._finisher = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="ContinuousServer-finish")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def request_seed(self, n: int) -> int:
        """The seed of the n-th admitted request (0-based)."""
        return sampling.fold_seed(self.dcfg.seed, n)

    def submit(self, request: Request) -> "Future[SynthesisResult]":
        fut: "Future[SynthesisResult]" = Future()
        self._q.put((request, fut))
        return fut

    def synthesize(self, request: Request,
                   timeout: Optional[float] = None) -> SynthesisResult:
        return self.submit(request).result(timeout)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        self._finisher.shutdown(wait=True)

    # ------------------------------------------------------------------

    def _try_admit(self, req: Request, fut) -> bool:
        free = [i for i, f in enumerate(self._slot_futures) if f is None]
        if not free:
            return False
        pipe = self.pipeline
        try:
            planned = pipe.plan_request(req)
            need = pipe._need_frames(planned.target, len(planned.prompt))
            if (len(planned.text) > self.text_bucket
                    or len(planned.prompt) > self.prompt_bucket
                    or need > self.dcfg.max_frames):
                raise ValueError(
                    f"request exceeds resident buckets (text "
                    f"{len(planned.text)}/{self.text_bucket}, prompt "
                    f"{len(planned.prompt)}/{self.prompt_bucket}, frames "
                    f"{need}/{self.dcfg.max_frames})")
        except Exception as exc:
            fut.set_exception(exc)
            return True
        slot = free[0]
        x = np.zeros((self.text_bucket,), np.int32)
        x[:len(planned.text)] = planned.text
        p = np.full((self.prompt_bucket,), pipe.cfg.special.pad, np.int32)
        p[:len(planned.prompt)] = planned.prompt
        seed = self.request_seed(self._admitted)
        self._admitted += 1
        t0 = time.perf_counter()
        self._fns.admit(pipe.params, self.state, slot, x, len(planned.text),
                        p, len(planned.prompt), planned.target, seed)
        self.stats.admit_ms.append(1e3 * (time.perf_counter() - t0))
        self._slot_futures[slot] = (fut, planned, seed, time.time())
        self.stats.requests += 1
        return True

    def _finish(self, slot: int, gen_tokens) -> None:
        """Free the slot now; the finisher pool vocodes, so the segment loop
        keeps generating."""
        entry = self._slot_futures[slot]
        self._slot_futures[slot] = None
        self._finisher.submit(self._finish_work, gen_tokens, *entry)

    def _finish_work(self, gen_tokens, fut, planned, seed, t0) -> None:
        try:
            pipe = self.pipeline
            gen, concat = _strip(pipe, planned.prompt, gen_tokens)
            wav = concat_wav = None
            if (self.decode_audio and pipe.audio_tokenizer is not None
                    and len(gen)):
                wav = pipe.audio_tokenizer.decode(gen[None, None, :])[0, 0]
                if len(concat) > len(gen):
                    concat_wav = pipe.audio_tokenizer.decode(
                        concat[None, None, :])[0, 0]
            wall = time.time() - t0
            sr = int(pipe.cfg.encodec_sr)
            fut.set_result(SynthesisResult(
                wav=wav,
                concat_wav=concat_wav if concat_wav is not None else wav,
                gen_frames=gen, concat_frames=concat,
                tokens_per_sec=len(gen) / wall if wall else 0.0,
                rtf=len(gen) / sr / wall if wall else 0.0,
                inference_time=wall, seed=seed))
        except Exception as exc:      # the slot is already free
            log.exception("finishing a request failed")
            if not fut.done():
                fut.set_exception(exc)

    def _fail_all(self, exc: BaseException, pending: list) -> None:
        for i, entry in enumerate(self._slot_futures):
            if entry is not None and not entry[0].done():
                entry[0].set_exception(exc)
            self._slot_futures[i] = None
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(exc)
        pending.clear()

    def _loop(self) -> None:
        pending: list = []   # overflow, FIFO ahead of the queue
        while not self._stop.is_set():
            try:
                while True:
                    pending.append(self._q.get_nowait())
            except queue.Empty:
                pass
            try:
                while pending and self._try_admit(*pending[0]):
                    pending.pop(0)
                if not any(f is not None for f in self._slot_futures):
                    try:
                        pending.append(self._q.get(timeout=0.1))
                    except queue.Empty:
                        continue
                    if self._try_admit(*pending[0]):
                        pending.pop(0)
                    if not any(f is not None for f in self._slot_futures):
                        continue
                self._fns.segment(self.pipeline.params, self.state,
                                  self.segment_frames)
                _, outs = self._continuous.harvest(self.state)
            except Exception as exc:  # the resident state is lost
                log.exception("continuous decode failed")
                self._fail_all(exc, pending)
                self._stop.set()
                break
            if outs:
                self.stats.batches += 1
                self.stats.batch_sizes.append(len(outs))
            for slot, toks in outs:
                self._finish(slot, toks)


class BatchingServer:
    """Collection-window batching (see the module docstring). With
    ``warmup`` the pipeline first warms the configured bucket grid
    (``TTSPipeline.warmup``: kernel builds, one captured session a bucket,
    the vocoder's length buckets; the report in ``warmup_report``). A group
    whose own shape is not warm runs on a covering warm shape, as in the
    JAX package (``synthesize_planned(route=True)``)."""

    def __init__(self, pipeline: TTSPipeline,
                 dcfg: Optional[DecodeConfig] = None, max_batch: int = 32,
                 max_wait_ms: float = 50.0, decode_audio: bool = True,
                 warmup: bool = False, group_by_bucket: bool = True,
                 warmup_batch_sizes: Optional[tuple] = None,
                 warmup_text_buckets: tuple = (64,),
                 warmup_prompt_buckets: tuple = (64,),
                 warmup_frame_buckets: tuple = (256, 512)):
        self.warmup_report = None
        if warmup:
            self.warmup_report = pipeline.warmup(
                batch_sizes=warmup_batch_sizes or (1, max_batch),
                text_buckets=warmup_text_buckets,
                prompt_buckets=warmup_prompt_buckets,
                frame_buckets=warmup_frame_buckets, dcfg=dcfg,
                vocoder=decode_audio)
        self.pipeline = pipeline
        self.dcfg = dcfg or DecodeConfig()
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.decode_audio = decode_audio
        self.group_by_bucket = group_by_bucket
        self.stats = ServerStats()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: Request) -> "Future[SynthesisResult]":
        fut: "Future[SynthesisResult]" = Future()
        self._q.put((request, fut))
        return fut

    def synthesize(self, request: Request,
                   timeout: Optional[float] = None) -> SynthesisResult:
        return self.submit(request).result(timeout)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    # ------------------------------------------------------------------

    def _collect(self) -> list:
        """Block for the first request, then fill the batch for max_wait."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.time() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            self.stats.requests += len(batch)
            # plan each request; a bad request fails only its own future
            groups: "dict[int, list]" = {}
            for req, fut in batch:
                try:
                    planned = self.pipeline.plan_request(req)
                except Exception as exc:
                    log.exception("request planning failed")
                    fut.set_exception(exc)
                    continue
                key = (self.pipeline.frame_bucket(planned)
                       if self.group_by_bucket else 0)
                groups.setdefault(key, []).append((planned, fut))
            # shortest bucket first: cheap futures resolve earliest
            for key in sorted(groups):
                items = groups[key]
                futures = [f for _, f in items]
                self.stats.batches += 1
                self.stats.batch_sizes.append(len(items))
                try:
                    results = self.pipeline.synthesize_planned(
                        [p for p, _ in items], self.dcfg, quiet=True,
                        decode_audio=self.decode_audio, route=True)
                    for fut, res in zip(futures, results):
                        fut.set_result(res)
                except Exception as exc:   # the group shares the error
                    log.exception("batch synthesis failed")
                    for fut in futures:
                        if not fut.done():
                            fut.set_exception(exc)


class TieredBackend:
    """Serve from a fast tier while the full serving tier builds.

    Counterpart of the JAX package's ``TieredBackend``, derived again for
    the card. There a cold start costs compile time; here it costs the
    first-use kernel builds, the quantization of the weights and the
    captures of the warm-up. The fast tier (``fast``, typically a
    bf16 ``BatchingServer`` without warm-up) answers at once; once it has
    answered a request, or after ``build_delay_sec`` with no traffic,
    ``full_factory()`` builds the full tier on the build thread (its
    warm-up included), requests route to it from then on (``tier`` turns
    "full"), and the fast tier is closed ``drain_sec`` later.

    Unlike the JAX class, a ``submit`` whose future completes marks the fast
    tier as served (not only ``synthesize``), ``close()`` before the build
    means no full tier is ever built, and a full tier that finishes
    building after ``close()`` is closed at once."""

    def __init__(self, fast, full_factory, drain_sec: float = 60.0,
                 build_delay_sec: float = 120.0):
        self._cur = fast
        self._old = None               # the fast tier while it drains
        self.tier = "fast"
        self.build_s: Optional[float] = None   # the full tier's build
        self._drain_sec = drain_sec
        self._build_delay = build_delay_sec
        self._lock = threading.Lock()
        self._closed = False
        self._wake = threading.Event()       # served, or closing
        self._closing = threading.Event()
        self._drainer: Optional[threading.Thread] = None
        self._build_thread = threading.Thread(
            target=self._build, args=(full_factory,), daemon=True,
            name="TieredBackend-build")
        self._build_thread.start()

    def _build(self, factory) -> None:
        # the fast tier answers first: the full tier's build (kernel builds,
        # quantization, captures) would otherwise queue ahead of it on the
        # card
        self._wake.wait(self._build_delay)
        if self._closed:
            return
        t0 = time.perf_counter()
        try:
            full = factory()
        except Exception:
            log.exception("full-tier build failed; staying on the fast tier")
            return
        with self._lock:
            late = self._closed
            if not late:
                self._old, self._cur = self._cur, full
                self.tier = "full"
                self.build_s = time.perf_counter() - t0
        if late:
            full.close()
            return
        log.info("switched to the full serving tier")
        self._drainer = threading.Thread(target=self._drain, daemon=True,
                                         name="TieredBackend-drain")
        self._drainer.start()

    def _drain(self) -> None:
        self._closing.wait(self._drain_sec)
        old, self._old = self._old, None
        if old is not None:
            old.close()

    def _served(self, fut: Future) -> None:
        if not fut.cancelled() and fut.exception() is None:
            self._wake.set()

    @property
    def stats(self):
        return self._cur.stats

    @property
    def pipeline(self):
        return self._cur.pipeline

    @property
    def dcfg(self):
        return self._cur.dcfg

    def submit(self, request: Request) -> "Future[SynthesisResult]":
        fut = self._cur.submit(request)
        fut.add_done_callback(self._served)
        return fut

    def synthesize(self, request: Request,
                   timeout: Optional[float] = None) -> SynthesisResult:
        return self.submit(request).result(timeout)

    def close(self, timeout: float = 60.0) -> None:
        """Close the current tier and the draining one; a build under way
        closes its tier when it ends."""
        with self._lock:
            self._closed = True
            cur = self._cur
        self._wake.set()
        self._closing.set()
        cur.close()
        if self._drainer is not None:
            self._drainer.join(timeout)

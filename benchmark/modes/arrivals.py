"""Open-loop arrivals through ``ContinuousServer.submit``: each request is
sent when it is due, whether or not earlier ones have finished, and timed
from when it was due to when its future resolved with a waveform. Every
request due in the window (``--seconds``) counts; the harness waits up to
``wait_s`` past the window's close for the last of them, and one that fails
or never resolves counts as missing every limit. ``latency_p90_s`` and
``latency_p95_s`` are the 90th and 95th percentiles by nearest rank over
all of them; a cell reports the 90th (the highest with ten requests beyond
it at the cell's rate), and the 95th is printed as a note.

Traffic parameters: ``precision``, ``kv_cache``, ``server`` (``slots``,
``text_bucket``, ``prompt_bucket``, ``segment_frames``, ``max_frames``,
``warm_requests``), ``rate_per_s``, ``schedule_seed`` (the Poisson
schedule's own seed), ``duration_s`` (``median``, ``sigma``, ``low``,
``high``: log-normal, clipped), ``chars_per_s``, ``check_requests`` (a
number, or ``"all"``), ``trace_start_s`` and ``trace_seconds`` (the
stretch of the window a traced run profiles, from one segment boundary to
another), ``wait_s`` and ``control``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

from benchmark.harness import model_config, stats, traffic
from benchmark.harness.record import RunRecord
from benchmark.harness.serving import (TimedVocoder, build_pipeline,
                                       free_program, with_control)
from benchmark.harness.trace import Tracer
from benchmark.reference import check


class SegmentProbe:
    """The traced run's wrappers of the server's admission and segment
    (synchronized before and after, so their walls are the device's work),
    the rows each segment advanced, and the profiler's start and stop at
    segment boundaries."""

    def __init__(self, fns, tracer: Tracer, t0: float, start_s: float,
                 trace_s: float):
        self.fns = fns
        self.tracer = tracer
        self.t0, self.start_s, self.trace_s = t0, start_s, trace_s
        self.admits: List[tuple] = []      # (start, end) host seconds
        self.segments: List[dict] = []
        self._trace_t = None

    def admit(self, *a, **k):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.tracer.span("admission: batch-1 prefill + install",
                               self.fns.admit, *a, **k)
        torch.cuda.synchronize()
        self.admits.append((t, time.perf_counter()))
        return out

    def segment(self, params, state, n_steps):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        if not self.tracer.started and t - self.t0 >= self.start_s:
            self.tracer.start()
            self._trace_t = time.perf_counter()
            t = self._trace_t
        traced = self.tracer.started and not self.tracer.stopped
        steps0 = state.steps.cpu().tolist()
        live = (state.active & ~state.done).cpu().tolist()
        plens = state.prompt_lens.cpu().tolist()
        xlens = state.x_lens.cpu().tolist()
        out = self.tracer.span("segment: captured body replays",
                               self.fns.segment, params, state, n_steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps1 = state.steps.cpu().tolist()
        rows = [(plens[r] + 1, steps0[r], steps1[r] - steps0[r], xlens[r])
                for r in range(len(live)) if live[r]
                and steps1[r] > steps0[r]]
        self.segments.append(dict(start=t, end=t1, bodies=int(n_steps),
                                  rows=rows, traced=traced))
        if traced and t1 - self._trace_t >= self.trace_s:
            self.tracer.stop()
        return out


def _median_third(latencies: List[float], k: int):
    """The median latency of the k-th third of the requests in order of
    their due times: a backlog that grows shows as a later third slower
    than the first."""
    n = len(latencies) // 3
    part = latencies[k * n:(k + 1) * n] if n else []
    return stats.nearest_rank(part, 0.5) if part else None


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t_origin: float = None) -> RunRecord:
    import numpy as np
    import torch
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.inference.pipeline import Request
    from t5gemma_tts_tpu_torch.inference.server import ContinuousServer

    t_origin = time.perf_counter() if t_origin is None else t_origin
    p = with_control(cell.traffic, control)
    cfg = model_config.voice_config(cell.config)
    sr = int(cfg.encodec_sr)
    srv = p["server"]
    tracer = Tracer()
    if device == "cuda":
        from t5gemma_tts_tpu_torch.ops import cuda_build
        cuda_build.build()
    phases = {"before_s": time.perf_counter() - t_origin}
    pipe, tok = build_pipeline(cell, seed, device, p["precision"], phases)
    t_built = time.perf_counter()
    vocoder = TimedVocoder(tok, tracer)
    dcfg = DecodeConfig(top_k=1, kv_cache=p["kv_cache"],
                        max_frames=int(srv["max_frames"]), seed=1)
    server = ContinuousServer(
        pipe, dcfg, slots=int(srv["slots"]),
        text_bucket=int(srv["text_bucket"]),
        prompt_bucket=int(srv["prompt_bucket"]),
        segment_frames=int(srv["segment_frames"]), decode_audio=True)
    # warm-up: the vocoder at its length buckets, then requests through
    # the server (the admission's prefill at the state's buckets)
    from t5gemma_tts_tpu_torch.codec.audio_tokenizer import _BUCKETS
    for vb in [b for b in _BUCKETS if b <= int(srv["max_frames"])]:
        tok.decode(np.zeros((1, vb), np.int64),
                   lengths=np.full((1,), vb, np.int64))
    warm = [server.submit(Request(target_text=traffic.text_of(
                traffic.rng_for(seed, "warm"), 20), lang="en",
                target_duration=float(d))) for d in srv["warm_requests"]]
    for f in warm:
        f.result(timeout=600)
    if device == "cuda":
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t_built

    items = traffic.arrivals(p, seed, seconds)
    probe = None
    if trace:
        probe = SegmentProbe(server._fns, tracer, 0.0,
                             min(float(p["trace_start_s"]), 0.4 * seconds),
                             float(p["trace_seconds"]))
        server._fns = server._fns._replace(admit=probe.admit,
                                           segment=probe.segment)
    setup_s = time.perf_counter() - t_origin

    t0 = time.perf_counter()
    if probe is not None:
        probe.t0 = t0
    resolved: Dict[int, float] = {}
    futs: List = [None] * len(items)
    late: List[float] = []

    def on_done(i):
        def cb(_f):
            resolved[i] = time.perf_counter()
        return cb

    def sender():
        for i, it in enumerate(items):
            due = t0 + it.due_s
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - due)
            f = server.submit(Request(target_text=it.text, lang="en",
                                      target_duration=it.duration_s))
            f.add_done_callback(on_done(i))
            futs[i] = f

    th = threading.Thread(target=sender, name="bench-arrivals")
    th.start()
    th.join()
    t_close = t0 + seconds
    deadline = t_close + float(p["wait_s"])
    for f in futs:
        try:
            f.result(timeout=max(deadline - time.perf_counter(), 0.0))
        except Exception:
            pass
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    latencies, served, failed = [], [], 0
    encode = model_config.char_tokenizer(cfg.text_vocab_size)
    for i, (it, f) in enumerate(zip(items, futs)):
        res = None
        if f.done() and not f.cancelled() and f.exception() is None:
            res = f.result()
        if res is None or res.wav is None or i not in resolved:
            failed += 1
            latencies.append(math.inf)
            continue
        latencies.append(resolved[i] - (t0 + it.due_s))
        served.append(check.Served(
            ids=encode(it.text), target=int(sr * it.duration_s),
            tokens=[int(t) for t in res.gen_frames], wav=res.wav))

    def tail(q: float) -> float:
        # a request that never resolved waited at least until the deadline
        v = stats.nearest_rank(latencies, q) if latencies else math.inf
        return v if math.isfinite(v) else deadline - t0

    facts: Dict = {"config": cell.config, "precision": p["precision"],
                   "window_s": seconds}
    if probe is not None:
        in_window = [s for s in probe.segments
                     if s["start"] >= t0 and s["end"] <= t_close]
        facts["segments"] = in_window
        facts["traced_segments"] = [s for s in probe.segments if s["traced"]]
        facts["admit_walls_s"] = [b - a for a, b in probe.admits
                                  if a >= t0 and b <= t_close]
        facts["kv_elem"] = 1 if p["kv_cache"] == "paged_i8" else 2
        facts["kv_scales"] = p["kv_cache"] == "paged_i8"
    free_program(server)
    server._fns = None
    del server, pipe, tok, vocoder
    free_program()
    picked = check.sample(served, seed, p["check_requests"])
    checks = check.served_checks(cell.config, seed, device, picked,
                                 control=control)
    return RunRecord(
        attempted=len(items), failed=failed,
        end_to_end={"latency_p90_s": tail(0.90), "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, facts=facts,
        trace=tracer.read(),
        notes={"setup_phases_s": phases,
               "due": len(items), "served": len(served),
               "latency_p95_s": tail(0.95),
               "latency_median_s": stats.nearest_rank(latencies, 0.5)
               if latencies else None,
               "latency_max_s": max(latencies) if latencies else None,
               "sender_late_max_s": max(late) if late else None,
               "latency_median_first_third_s": _median_third(latencies, 0),
               "latency_median_last_third_s": _median_third(latencies, 2),
               "checked_tokens": sum(len(s.tokens) for s in picked)})

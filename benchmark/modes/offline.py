"""Offline batches through ``BatchingServer.submit``: a closed loop that keeps
two batches of ``per_batch`` requests queued, so the server always has the
next batch. The window opens at the first submission and closes when the
first batch that ends at or after ``--seconds`` ends: it runs whole
batches, and ``audio_s_per_s`` is the audio of every request of those
batches over the window's wall.

Traffic parameters (the traffic file): ``precision`` (``bf16``, ``int8``,
``int4``), ``kv_cache``, ``server`` (``max_batch``, ``max_wait_ms``,
``warm``: the bucket grid warmed in set-up), ``per_batch``,
``duration_s`` (``low``, ``high``: stratified uniform), ``chars_per_s``,
``check_requests`` (how many finished requests the reference runs),
``trace_batch`` (which batch of the window a traced run profiles) and
``control`` (the parameters that the control run takes instead).
"""

from __future__ import annotations

import time
from typing import List

from benchmark.harness import costs, model_config, stats, traffic, weights
from benchmark.harness.record import RunRecord
from benchmark.harness.serving import (TimedVocoder, build_pipeline,
                                       free_program, with_control)
from benchmark.harness.trace import Tracer
from benchmark.reference import check


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t_origin: float = None) -> RunRecord:
    import torch
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine
    from t5gemma_tts_tpu_torch.inference.pipeline import Request
    from t5gemma_tts_tpu_torch.inference.server import BatchingServer

    t_origin = time.perf_counter() if t_origin is None else t_origin
    p = with_control(cell.traffic, control)
    cfg = model_config.voice_config(cell.config)
    sr = int(cfg.encodec_sr)
    tracer = Tracer()
    phases = {"before_s": time.perf_counter() - t_origin}
    pipe, tok = build_pipeline(cell, seed, device, p["precision"], phases)
    t_built = time.perf_counter()
    vocoder = TimedVocoder(tok, tracer)
    srv = p["server"]
    warm = srv["warm"]
    dcfg = DecodeConfig(top_k=1, kv_cache=p["kv_cache"], seed=1)
    server = BatchingServer(
        pipe, dcfg, max_batch=int(srv["max_batch"]),
        max_wait_ms=float(srv["max_wait_ms"]), decode_audio=True,
        warmup=True, group_by_bucket=True,
        warmup_batch_sizes=tuple(warm["batch"]),
        warmup_text_buckets=tuple(warm["text"]),
        warmup_prompt_buckets=tuple(warm["prompt"]),
        warmup_frame_buckets=tuple(warm["frames"]))
    if device == "cuda":
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t_built

    # traced runs: profile one whole batch, name host spans
    calls = {"n": 0}
    orig_synth = pipe.synthesize_planned
    orig_decoder = engine.graphed_decoder
    traced = {}

    def synth(planned, *a, **k):
        i = calls["n"]
        calls["n"] += 1
        if not (trace and i == int(p["trace_batch"])):
            return orig_synth(planned, *a, **k)
        tracer.start()
        t0 = time.perf_counter()
        out = orig_synth(planned, *a, **k)
        t1 = time.perf_counter()
        tracer.stop()        # reading the profiler's buffers takes seconds
        traced.update(t0=t0, t1=t1, planned=planned, results=out)
        return out

    def decoder(cfg_, dcfg_):
        run_ = orig_decoder(cfg_, dcfg_)
        return lambda *a, **k: tracer.span("decode: prefill + steps", run_,
                                           *a, **k)

    pipe.synthesize_planned = synth
    if trace:
        engine.graphed_decoder = decoder

    per = int(p["per_batch"])
    batches = traffic.offline_batches(p, seed)
    setup_s = time.perf_counter() - t_origin

    def submit():
        return [(item, server.submit(Request(
            target_text=item.text, lang="en",
            target_duration=item.duration_s))) for item in next(batches)]

    t0 = time.perf_counter()
    queued = [submit(), submit()]
    done: List[list] = []
    t_end = t0
    try:
        while True:
            futs = queued.pop(0)
            for _, f in futs:
                try:
                    f.result()
                except Exception:
                    pass
            t_end = time.perf_counter()
            done.append(futs)
            if t_end - t0 >= seconds:
                break
            queued.append(submit())
        for futs in queued:       # in flight: finished, not counted
            for _, f in futs:
                try:
                    f.result(timeout=600)
                except Exception:
                    pass
    finally:
        engine.graphed_decoder = orig_decoder
    window_s = t_end - t0

    served, audio_s, failed = [], 0.0, 0
    w = costs.widths_of(cell.config)
    enc_l, dec_l = int(cell.config["num_layers"]), int(
        cell.config["num_decoder_layers"])
    va = int(cell.config["tts"]["audio_vocab_size"]) + weights.N_SPECIAL
    encode = model_config.char_tokenizer(cfg.text_vocab_size)

    def flops(text_len: int, generated: int) -> int:
        return costs.request_flops(w, enc_l, dec_l, text_len, 0, generated,
                                   va)

    all_futs = [x for futs in done + queued for x in futs]
    for k, (item, f) in enumerate(all_futs):
        try:
            res = f.result(timeout=0)
        except Exception:
            failed += 1
            continue
        if res.wav is None:
            failed += 1
            continue
        ids = encode(item.text)
        if k < len(done) * per:
            audio_s += len(res.wav) / float(cfg.codec_audio_sr)
        served.append(check.Served(ids=ids, target=int(sr * item.duration_s),
                                   tokens=[int(t) for t in res.gen_frames],
                                   wav=res.wav))
    attempted = len(all_futs)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    facts = {"batch_sizes": list(server.stats.batch_sizes),
             "precision": p["precision"], "config": cell.config}
    if traced:
        # one whole batch of the steady loop, from its start to its return
        # (the profiler's reading after it is left out)
        pairs = list(zip(traced["planned"], traced["results"]))
        facts["traced_batch"] = {
            "rows": [(1, len(r.gen_frames) + 1, len(pl.text))
                     for pl, r in pairs],
            "steps": int(traced["results"][0].steps),
            "wall_s": traced["t1"] - traced["t0"],
            "vocode_s": vocoder.seconds_within(traced["t0"], traced["t1"]),
            "model_flops": sum(flops(len(pl.text), len(r.gen_frames) + 1)
                               for pl, r in pairs),
            "kv_elem": 1, "kv_scales": p["kv_cache"] == "paged_i8",
            "w_bytes": 0.5 if p["precision"] == "int4" else 1.0}
    free_program(server)
    pipe.__dict__.pop("synthesize_planned", None)
    del server, pipe, tok, vocoder, orig_synth
    free_program()
    picked = check.sample(served, seed, p["check_requests"])
    checks = check.served_checks(cell.config, seed, device, picked,
                                 control=control)
    return RunRecord(
        attempted=attempted, failed=failed,
        end_to_end={"audio_s_per_s": stats.rate(audio_s, window_s),
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, facts=facts,
        trace=tracer.read(),
        notes={"setup_phases_s": phases,
               "window_s": window_s, "batches": len(done),
               "audio_s": audio_s, "checked_tokens": sum(
                   len(s.tokens) for s in picked)})

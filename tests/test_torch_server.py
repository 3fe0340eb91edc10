"""The port's serving cores on the CPU (inference/server.py) and the
pipeline's warm-up and warm-shape routing.

- ``BatchingServer`` on the cases of tests/test_server.py: concurrent
  requests batch together, a lone request is served within the collection
  window, a late one forms the next batch, mixed durations split into
  per-frame-bucket groups;
- ``ContinuousServer`` end to end: more requests than slots resolve with
  audio, an oversized request fails only its own future, and each result
  equals its request decoded alone (batch-1 ``engine.decode_tokens``) at
  the seed the server exposes;
- ``TTSPipeline.warmup`` / warm-shape routing: warm shapes are keyed by the
  DecodeConfig, a failing run registers no shape, and padding rows count in
  neither the results nor the ``[Speed]`` line.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.inference.pipeline import Request
from t5gemma_tts_tpu_torch.inference.server import (BatchingServer,
                                                    ContinuousServer)
from t5gemma_tts_tpu_torch.models import voice

torch.set_num_threads(1)


def _pipeline(sliding_window=None):
    cfg = tconfig.tiny_voice_config(extra_cutoff=0.0)
    if sliding_window:
        dims = dataclasses.replace(cfg.backbone.decoder,
                                   sliding_window=sliding_window)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, decoder=dims))
    ccfg = tcodec.tiny_codec_config()
    return tpipe.TTSPipeline(
        voice.init_params(0, cfg, device="cpu"), cfg,
        lambda t: [3 + (ord(c) % 100) for c in t],
        ttok.AudioTokenizer(tcodec.init_decoder_params(1, ccfg,
                                                       device="cpu"),
                            ccfg, device="cpu"),
        device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = BatchingServer(
        _pipeline(), tconfig.DecodeConfig(top_k=4, temperature=1.0,
                                          max_frames=32),
        max_batch=8, max_wait_ms=200.0, decode_audio=False)
    yield srv
    srv.close()


def test_concurrent_requests_batch_together(server):
    futs = [server.submit(Request(target_text=f"request number {i}",
                                  target_duration=0.3)) for i in range(6)]
    results = [f.result(timeout=300) for f in futs]
    assert all(len(r.gen_frames) > 0 for r in results)
    assert server.stats.batches < 6
    assert max(server.stats.batch_sizes) > 1


def test_sequential_request(server):
    res = server.synthesize(Request(target_text="single",
                                    target_duration=0.2), timeout=300)
    assert len(res.gen_frames) > 0


def test_single_request_served_within_max_wait(server):
    t0 = time.time()
    res = server.synthesize(Request(target_text="solo", target_duration=0.2),
                            timeout=60)
    assert res.gen_frames is not None
    assert time.time() - t0 < 30.0
    assert server.stats.batch_sizes[-1] == 1


def test_late_request_goes_to_next_batch(server):
    before = server.stats.batches
    server.submit(Request(target_text="first",
                          target_duration=0.2)).result(timeout=60)
    server.submit(Request(target_text="second",
                          target_duration=0.2)).result(timeout=60)
    assert server.stats.batches >= before + 2


def test_cross_bucket_packing(server):
    """Two short and two long requests in one window decode as two groups
    of two, the short bucket first; the long ones run further."""
    before = server.stats.batches
    futs = [server.submit(Request(target_text=f"short {i}",
                                  target_duration=0.3)) for i in range(2)]
    futs += [server.submit(Request(target_text=f"long {i}",
                                   target_duration=8.0)) for i in range(2)]
    results = [f.result(timeout=600) for f in futs]
    assert server.stats.batches >= before + 2
    assert 2 in server.stats.batch_sizes[before:]
    assert (max(len(r.gen_frames) for r in results[2:])
            > max(len(r.gen_frames) for r in results[:2]))


def test_continuous_server_results_equal_requests_alone():
    pipe = _pipeline(sliding_window=4096)
    dcfg = tconfig.DecodeConfig(top_k=8, top_p=0.9, temperature=0.8,
                                max_frames=48)
    srv = ContinuousServer(pipe, dcfg, slots=4, text_bucket=32,
                           prompt_bucket=8, segment_frames=16)
    assert srv.capture_ms is None           # nothing is captured on the CPU
    reqs = [Request(target_text=f"continuous {i}", target_duration=0.3)
            for i in range(6)]               # more requests than slots
    try:
        futs = [srv.submit(r) for r in reqs]
        bad = srv.submit(Request(target_text="x" * 400, target_duration=0.3))
        results = [f.result(timeout=600) for f in futs]
        with pytest.raises(ValueError, match="exceeds resident buckets"):
            bad.result(timeout=600)
    finally:
        srv.close()
    assert srv.stats.requests == 6 and len(srv.stats.admit_ms) == 6
    assert sorted(r.seed for r in results) == sorted(
        srv.request_seed(n) for n in range(6))
    strip = [pipe.cfg.special.y_sep, pipe.cfg.eog_inference]
    alone = dataclasses.replace(dcfg, kv_cache="paged")
    for req, res in zip(reqs, results):
        assert res.wav is not None and len(res.wav) == (
            len(res.gen_frames) * pipe.audio_tokenizer.cfg.hop_length)
        planned = pipe.plan_request(req)
        x = np.zeros((1, 32), np.int32)
        x[0, :len(planned.text)] = planned.text
        prompt = np.full((1, 8), pipe.cfg.special.pad, np.int32)
        out = engine.decode_tokens(
            pipe.params, pipe.cfg, alone, torch.from_numpy(x),
            torch.tensor([len(planned.text)], dtype=torch.int32),
            torch.from_numpy(prompt), torch.zeros(1, dtype=torch.int32),
            torch.tensor([planned.target], dtype=torch.int32), res.seed)
        want = out.tokens[0, :int(out.gen_lens[0])].numpy()
        np.testing.assert_array_equal(res.gen_frames,
                                      want[~np.isin(want, strip)])


def _planned(pipe, n, duration=0.3):
    return [pipe.plan_request(Request(target_text=f"warm {i}",
                                      target_duration=duration))
            for i in range(n)]


def test_warmup_keys_by_decode_config_and_routes(capsys):
    pipe = _pipeline()
    a = tconfig.DecodeConfig(top_k=4, temperature=1.0)
    b = dataclasses.replace(a, temperature=0.7)
    report = pipe.warmup(batch_sizes=(2,), text_buckets=(32,),
                         prompt_buckets=(64,), frame_buckets=(256,),
                         dcfg=a, vocoder=True)
    sessions = [r for r in report if r["kind"] == "session"]
    assert [(r["batch"], r["text"], r["prompt"], r["frames"])
            for r in sessions] == [(2, 32, 64, 256)]
    assert sessions[0]["capture_ms"] is None         # the CPU captures nothing
    assert [r["length"] for r in report if r["kind"] == "vocoder"] == [
        64, 128, 256]
    planned = _planned(pipe, 1)
    assert pipe._route(a, 1, len(planned[0].text), 0, 23) == (2, 32, 64, 256)
    assert pipe._route(b, 1, len(planned[0].text), 0, 23) == (1, 32, 64, 256)
    # routed, a's batch of one runs with a padding row that counts nowhere
    routed = pipe.synthesize_planned(planned, a, seed=3, route=True)
    line_routed = capsys.readouterr().out
    plain = pipe.synthesize_planned(planned, a, seed=3)
    line_plain = capsys.readouterr().out
    assert "1 padding rows" in line_routed and "padding" not in line_plain
    assert len(routed) == 1
    np.testing.assert_array_equal(routed[0].gen_frames, plain[0].gen_frames)

    def generated(line):
        return int(line.split("Generated ")[1].split()[0])

    assert generated(line_routed) == generated(line_plain) > 0


def test_failed_run_registers_no_warm_shape(monkeypatch):
    pipe = _pipeline()
    dcfg = tconfig.DecodeConfig(top_k=4)

    def broken(cfg, d):
        def run(*args):
            raise RuntimeError("injected decode failure")
        return run

    monkeypatch.setattr(engine, "graphed_decoder", broken)
    with pytest.raises(RuntimeError, match="injected"):
        pipe.synthesize_planned(_planned(pipe, 2), dcfg, quiet=True)
    assert pipe._warm_shapes == set()
    monkeypatch.undo()
    pipe.synthesize_planned(_planned(pipe, 2), dcfg, quiet=True)
    assert pipe._warm_shapes == {(dataclasses.replace(dcfg, max_frames=0),
                                  2, 32, 64, 256)}


def test_batching_server_warms_its_grid():
    pipe = _pipeline()
    dcfg = tconfig.DecodeConfig(top_k=4, temperature=1.0)
    srv = BatchingServer(pipe, dcfg, max_batch=2, max_wait_ms=50.0,
                         decode_audio=False, warmup=True,
                         warmup_text_buckets=(32,),
                         warmup_frame_buckets=(256,))
    try:
        kinds = [r["kind"] for r in srv.warmup_report]
        assert kinds == ["session", "session"]         # batch 1 and 2
        res = srv.synthesize(Request(target_text="after warm-up",
                                     target_duration=0.3), timeout=120)
        assert len(res.gen_frames) > 0
    finally:
        srv.close()

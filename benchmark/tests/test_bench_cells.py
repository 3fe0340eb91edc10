"""A cell added as files only (a configuration, two traffic mixes, their
limits, and entries of BENCHMARK.json) is found and run by the harness on
the CPU at a tiny size, and each fault of the timed path that a serving
cell can have turns ``correct`` false. The driver's look for a card is the
one step left out."""

import math

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec
import tiny

SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("checkout"))


def run_cell(checkout, name, seconds=1.0):
    cell = spec.load_cell(name, checkout, checkout / "benchmark")
    rec = spec.mode_module(cell).run(cell, seed=SEED, seconds=seconds,
                                     trace=False, device="cpu")
    ok = bench_run.judge(rec.checks, cell.limits) and rec.failed == 0
    return cell, rec, ok


def test_files_only_cell_is_found(checkout):
    cell = spec.load_cell("tiny-offline", checkout, checkout / "benchmark")
    assert cell.config["d_model"] == 64
    assert cell.traffic["kind"] == "offline"
    assert cell.limits == tiny.LIMITS["tiny-offline"]
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "batch_rows.offline", "vocode_share.offline", "mfu.offline",
        "k2_roofline.offline", "idle_share.offline"}
    for m in cell.per_layer:
        assert spec.metric_reader(cell, m["name"]) is not None
    arr = spec.load_cell("tiny-arrivals", checkout, checkout / "benchmark")
    assert {m["name"] for m in arr.end_to_end} == {"latency_p90_s",
                                                   "setup_s"}
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", checkout, checkout / "benchmark")


@pytest.mark.parametrize("name,metric", [("tiny-offline", "audio_s_per_s"),
                                         ("tiny-arrivals", "latency_p90_s")])
def test_cell_runs_correct(checkout, name, metric):
    cell, rec, ok = run_cell(checkout, name)
    assert ok, rec.checks
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.end_to_end[metric] > 0 and rec.end_to_end["setup_s"] > 0
    line = bench_run.result_line(cell, rec, False, "cpu", ok, cell.limits)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {metric, "setup_s"}


def _altered_token(monkeypatch):
    from t5gemma_tts_tpu_torch.decode import engine

    for name in ("sample_step_token", "sample_step_token_rows"):
        orig = getattr(engine, name)

        def wrapped(*a, _orig=orig, **k):
            token, argmax = _orig(*a, **k)
            return (token + 1) % 64, argmax
        monkeypatch.setattr(engine, name, wrapped)


def _few_tokens_altered(monkeypatch):
    # every row's token altered at one sampling call in 25: a few of the
    # run's tokens, the rest served as produced
    from t5gemma_tts_tpu_torch.decode import engine

    calls = {"n": 0}
    for name in ("sample_step_token", "sample_step_token_rows"):
        orig = getattr(engine, name)

        def wrapped(*a, _orig=orig, **k):
            token, argmax = _orig(*a, **k)
            calls["n"] += 1
            if calls["n"] % 25 == 0:
                token = (token + 1) % 64
            return token, argmax
        monkeypatch.setattr(engine, name, wrapped)


def _state_unchanged(monkeypatch):
    from t5gemma_tts_tpu_torch.models import t5gemma

    orig = t5gemma.paged_decode_step
    held = {}

    def wrapped(*a, **k):
        hidden, cache = orig(*a, **k)
        key = hidden.shape
        if key not in held:
            held[key] = hidden.clone()
        return held[key].clone(), cache      # the step's hidden never moves
    monkeypatch.setattr(t5gemma, "paged_decode_step", wrapped)


def _half_batch(monkeypatch):
    from t5gemma_tts_tpu_torch.inference.pipeline import TTSPipeline

    orig = TTSPipeline.synthesize_planned

    def wrapped(self, planned, *a, **k):
        half = max(len(planned) // 2, 1)
        out = orig(self, planned[:half], *a, **k)
        return [out[i % half] for i in range(len(planned))]
    monkeypatch.setattr(TTSPipeline, "synthesize_planned", wrapped)


@pytest.mark.parametrize("name,fault", [
    ("tiny-offline", _altered_token), ("tiny-arrivals", _altered_token),
    ("tiny-arrivals", _few_tokens_altered),
    ("tiny-offline", _state_unchanged), ("tiny-arrivals", _state_unchanged),
    ("tiny-offline", _half_batch)])
def test_fault_turns_correct_false(checkout, monkeypatch, name, fault):
    fault(monkeypatch)
    _, rec, ok = run_cell(checkout, name)
    assert not ok, rec.checks
    limits = tiny.LIMITS[name]
    assert any(not math.isfinite(rec.checks[k]) or rec.checks[k] > v
               for k, v in limits.items())
    if fault is _few_tokens_altered:
        # the widest gap catches what the mean over the run can miss
        assert rec.checks["logit_gap"] > limits["logit_gap"]

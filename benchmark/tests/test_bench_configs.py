"""Both configuration files load into the port's ``VoiceConfig`` at their
published widths and pass the checks of what the kernels take."""

import json
from pathlib import Path

import pytest

from benchmark.harness import model_config

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PUBLISHED = {"flan-t5-xxl-tts": (4096, 10240, 64, 64),
             "flan-t5-xl-tts": (2048, 5120, 32, 64)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_loads_at_published_widths(name):
    from t5gemma_tts_tpu_torch.ops import megakernel

    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    d, f, h, hd = PUBLISHED[name]
    assert (c["d_model"], c["d_ff"], c["num_heads"], c["d_kv"]) == (d, f, h, hd)
    assert c["num_layers"] == c["num_decoder_layers"] == 24
    assert c["vocab_size"] == 32128 and c["reduced"] == []
    cfg = model_config.voice_config(c)
    for dims in (cfg.backbone.encoder, cfg.backbone.decoder):
        assert (dims.hidden_size, dims.intermediate_size, dims.num_heads,
                dims.num_kv_heads, dims.head_dim) == (d, f, h, h, hd)
        assert dims.num_layers == 24
        assert set(dims.layer_types) == {"full_attention"}
        assert dims.attn_logit_softcap is None
        # kernels 1 and 2 take these widths
        assert megakernel.widths_fit(d, h * hd, f)
        assert hd % 8 == 0 and hd <= 256 and h % dims.num_kv_heads == 0
    assert cfg.audio_embedding_vocab == 65541
    assert cfg.extra_cutoff == 0.0 and cfg.dtype == "bfloat16"
    codec = model_config.codec_config(c)
    assert codec.vocos.hop_length == 882 and codec.sample_rate == 44100


def test_benchmark_names_each_config_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        assert entry["source"] == c["source"]
        assert entry["reduced"] == c["reduced"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {e["name"] for e in bench["configs"]}
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()

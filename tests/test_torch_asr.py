"""The port's Whisper (``asr/``) and transcriber (``inference/
transcribe.py``) against the JAX package on the CPU, on tiny configs.

- the Slaney filter bank against transformers' to 1e-6, and ``log_mel``
  against the JAX log-mel to 1e-5 (an f32 FFT against the JAX DFT written
  as matmuls);
- ``encode`` and ``decoder_logits`` on the JAX log-mel to 1e-5, on the JAX
  weights carried across by ``bridge.params_from_jax``;
- ``decode_with_stats`` greedy: ids and length equal to JAX's,
  sum_logprob to 1e-5 relative; a sampled rung keeps the forced prefix and
  repeats at a fixed seed;
- the converter: key-exhaustive, and equal to the JAX converter on one
  synthetic state dict;
- the ladder and the gates, as cases shared with the JAX functions;
- the transcriber end to end against ``jax_transcriber`` with a stub
  tokenizer (same text; and the no-speech gate);
- ``load_transcriber`` on a tiny ``WhisperForConditionalGeneration`` saved
  under ``tmp_path`` (as a directory and as a Hugging Face cache snapshot),
  and its ``RuntimeError`` naming ``--reference_text`` when nothing loads.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.asr import convert as jconvert
from t5gemma_tts_tpu.asr import mel as jmel
from t5gemma_tts_tpu.asr import model as jmodel
from t5gemma_tts_tpu.inference import transcribe as jtranscribe
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.asr import convert as tconvert
from t5gemma_tts_tpu_torch.asr import mel as tmel
from t5gemma_tts_tpu_torch.asr import model as tmodel
from t5gemma_tts_tpu_torch.inference import audio_io
from t5gemma_tts_tpu_torch.inference import transcribe as ttranscribe

torch.set_num_threads(1)

TOL = 1e-5
# the tiny config at the frontend's real geometry: log_mel always gives
# 3000 frames, which the encoder's stride-2 conv turns into 1500
TINY = dict(max_source_positions=1500)


def _pair(seed=0, **overrides):
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    kw = dict(TINY, **overrides)
    jcfg = jmodel.tiny_whisper_config(**kw)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jcfg, jp, tmodel.tiny_whisper_config(**kw), tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_mel():
    """A JAX log-mel of 1.5 s of noise, the input both models share."""
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=24000) * 0.1).astype(np.float32)
    return wav, np.asarray(jmel.log_mel(jnp.asarray(wav), 16))


@pytest.fixture(scope="module")
def encoded(pair, jax_mel):
    jcfg, jp, tcfg, tp = pair
    mel = jax_mel[1]
    enc_j = np.asarray(jmodel.encode(jp, jcfg, jnp.asarray(mel)))
    enc_t = tmodel.encode(tp, tcfg, torch.from_numpy(mel.copy()))
    return enc_j, enc_t


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filter_bank_matches_transformers(n_mels):
    from transformers.audio_utils import mel_filter_bank

    want = mel_filter_bank(
        num_frequency_bins=201, num_mel_filters=n_mels, min_frequency=0.0,
        max_frequency=8000.0, sampling_rate=16000, norm="slaney",
        mel_scale="slaney").astype(np.float32)
    np.testing.assert_allclose(tmel.mel_filters(n_mels), want, atol=1e-6,
                               rtol=0)


def test_log_mel_matches_jax(jax_mel):
    wav, want = jax_mel
    got = tmel.log_mel(wav, 16).numpy()
    assert got.shape == want.shape == (16, 3000)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_encode_and_decoder_logits_match_jax(pair, encoded):
    jcfg, jp, tcfg, tp = pair
    enc_j, enc_t = encoded
    np.testing.assert_allclose(enc_t.numpy(), enc_j, atol=TOL, rtol=TOL)
    ids = np.array([3, 17, 99, 5, 150, 42], np.int32)
    want = np.asarray(jmodel.decoder_logits(jp, jcfg, jnp.asarray(ids),
                                            jnp.asarray(enc_j)))
    got = tmodel.decoder_logits(tp, tcfg, torch.from_numpy(ids),
                                torch.from_numpy(enc_j.copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_with_stats_greedy_matches_jax(pair, encoded):
    jcfg, jp, tcfg, tp = pair
    enc_j = encoded[0]
    forced, max_new = [3, 5, 6], 12
    ids_j, n_j, lp_j = jmodel.decode_with_stats(
        jp, jcfg, jnp.asarray(enc_j), jnp.asarray(forced, jnp.int32),
        jnp.int32(len(forced)), max_new, jnp.float32(0.0),
        jax.random.PRNGKey(0))
    ids_t, n_t, lp_t = tmodel.decode_with_stats(
        tp, tcfg, torch.from_numpy(enc_j.copy()), forced, max_new)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert n_t == int(n_j)
    np.testing.assert_allclose(lp_t, float(lp_j), rtol=TOL)
    greedy, n_g = tmodel.greedy_decode(
        tp, tcfg, torch.from_numpy(enc_j.copy()), forced, max_new)
    np.testing.assert_array_equal(greedy.numpy(), ids_t.numpy())
    assert n_g == n_t


def test_sampled_rung_keeps_prefix_and_repeats(pair, encoded):
    _, _, tcfg, tp = pair
    enc = torch.from_numpy(encoded[0].copy())
    forced = [tcfg.decoder_start_token_id, 5, 6]
    runs = [tmodel.decode_with_stats(tp, tcfg, enc, forced, 10, 0.8, seed)
            for seed in (4, 4, 5)]
    (ids, n, lp), (ids2, n2, lp2), (ids3, _, _) = runs
    ids = ids.numpy()
    assert list(ids[:3]) == forced
    assert ((ids >= 0) & (ids < tcfg.vocab_size)).all()
    assert (ids[n:] == tcfg.eos_token_id).all() and lp <= 0.0
    np.testing.assert_array_equal(ids, ids2.numpy())   # a fixed seed repeats
    assert n == n2 and lp == lp2
    assert not np.array_equal(ids, ids3.numpy())       # another seed draws


def state_dict(cfg, seed=0):
    """A synthetic ``WhisperForConditionalGeneration`` state dict (its key
    names and torch layouts: linears [out, in], convolutions [out, in, k],
    the ``model.`` prefix and the tied ``proj_out.weight``), numpy f32."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def w(*shape):
        return (rng.normal(size=shape) * 0.02).astype(np.float32)

    sd = {}

    def put(prefix, **arrays):
        sd.update({f"{prefix}.{k}": v for k, v in arrays.items()})

    def attn(p):
        for name in ("q_proj", "v_proj", "out_proj"):
            put(f"{p}.{name}", weight=w(d, d), bias=w(d))
        put(f"{p}.k_proj", weight=w(d, d))

    def layer(p, cross, ffn):
        attn(p + ".self_attn")
        put(p + ".self_attn_layer_norm", weight=1 + w(d), bias=w(d))
        if cross:
            attn(p + ".encoder_attn")
            put(p + ".encoder_attn_layer_norm", weight=1 + w(d), bias=w(d))
        put(p + ".fc1", weight=w(ffn, d), bias=w(ffn))
        put(p + ".fc2", weight=w(d, ffn), bias=w(d))
        put(p + ".final_layer_norm", weight=1 + w(d), bias=w(d))

    put("model.encoder.conv1", weight=w(d, cfg.num_mel_bins, 3), bias=w(d))
    put("model.encoder.conv2", weight=w(d, d, 3), bias=w(d))
    put("model.encoder.embed_positions",
        weight=w(cfg.max_source_positions, d))
    for i in range(cfg.encoder_layers):
        layer(f"model.encoder.layers.{i}", False, cfg.encoder_ffn_dim)
    put("model.encoder.layer_norm", weight=1 + w(d), bias=w(d))
    put("model.decoder.embed_tokens", weight=w(cfg.vocab_size, d))
    put("model.decoder.embed_positions",
        weight=w(cfg.max_target_positions, d))
    for i in range(cfg.decoder_layers):
        layer(f"model.decoder.layers.{i}", True, cfg.decoder_ffn_dim)
    put("model.decoder.layer_norm", weight=1 + w(d), bias=w(d))
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def test_converter_matches_jax_and_is_key_exhaustive():
    cfg = tmodel.tiny_whisper_config()
    sd = state_dict(cfg)
    got = dict(_leaves(_tree_np(tconvert.whisper_state_dict_to_params(
        sd, cfg, device="cpu"))))
    want = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jconvert.whisper_state_dict_to_params(
            sd, jmodel.tiny_whisper_config()))))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the port's init has the converter's tree
    init = dict(_leaves(_tree_np(tmodel.init_params(0, cfg, device="cpu"))))
    assert {p: v.shape for p, v in init.items()} == {
        p: v.shape for p, v in want.items()}
    renamed = dict(sd)
    renamed["model.encoder.layers.0.fc1_RENAMED.weight"] = renamed.pop(
        "model.encoder.layers.0.fc1.weight")
    with pytest.raises(KeyError, match="fc1.weight"):
        tconvert.whisper_state_dict_to_params(renamed, cfg, device="cpu")
    extra = dict(sd, **{"model.decoder.extra.weight": np.zeros(3)})
    with pytest.raises(ValueError, match="decoder.extra.weight"):
        tconvert.whisper_state_dict_to_params(extra, cfg, device="cpu")


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.numpy()


LADDER_CASES = [
    ("ratio", ("ha " * 30,)), ("ratio", ("The quick brown fox.",)),
    ("ratio", ("",)),
    ("fallback", ("a fine sentence here", -0.5)),
    ("fallback", ("a fine sentence here", -1.5)),
    ("fallback", ("la " * 40, -0.1)),
    ("no_speech", (0.9, -1.5)), ("no_speech", (0.9, -0.5)),
    ("no_speech", (0.3, -2.0)), ("no_speech", (0.6, -3.0)),
    ("ladder", ([("la " * 40, -0.1), ("ok text", -2.0),
                 ("good text", -0.2)],)),
    ("ladder", ([("x", -3.0)] * 6,)),
    ("ladder", ([("first try", -0.3)],)),
]


@pytest.mark.parametrize("kind,args", LADDER_CASES)
def test_ladder_and_gates_match_jax(kind, args):
    def run(mod):
        if kind == "ratio":
            return mod.compression_ratio(*args)
        if kind == "fallback":
            return mod.needs_fallback(*args)
        if kind == "no_speech":
            return mod.is_no_speech(*args)
        calls = []

        def decode(temp):
            calls.append(temp)
            return args[0][min(len(calls), len(args[0])) - 1]

        return mod.decode_with_fallback(decode), calls

    assert run(ttranscribe) == run(jtranscribe)
    for name in ("FALLBACK_TEMPERATURES", "COMPRESSION_RATIO_THRESHOLD",
                 "LOGPROB_THRESHOLD", "NO_SPEECH_THRESHOLD", "WHISPER_SR"):
        assert getattr(ttranscribe, name) == getattr(jtranscribe, name)


NOSPEECH = 11


class StubTokenizer:
    unk_token_id = 0

    def convert_tokens_to_ids(self, t):
        table = {"<|transcribe|>": 7, "<|notimestamps|>": 8, "<|en|>": 9,
                 "<|ja|>": 10, "<|nospeech|>": NOSPEECH}
        return table.get(t, 0)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if int(i) > NOSPEECH)


@pytest.mark.parametrize("case", ["speech", "silence"])
def test_transcriber_matches_jax_transcriber(tmp_path, monkeypatch, case):
    """Speech: a confident model (the final layer norm's gain raised so the
    greedy rung passes the gate) gives the same text through both. Silence:
    the sot step's logits pushed onto <|nospeech|> in both packages, and an
    unconfident model: both gate the clip to ""."""
    jcfg, jp, tcfg, tp = _pair(seed=3)
    if case == "speech":
        gain = 200.0
        jp["decoder"]["ln_post"]["g"] = jp["decoder"]["ln_post"]["g"] * gain
        tp["decoder"]["ln_post"]["g"] = tp["decoder"]["ln_post"]["g"] * gain
    else:
        j_logits, t_logits = jmodel.decoder_logits, tmodel.decoder_logits
        monkeypatch.setattr(jmodel, "decoder_logits", lambda *a: j_logits(
            *a).at[:, NOSPEECH].add(50.0))
        monkeypatch.setattr(tmodel, "decoder_logits", lambda *a: t_logits(
            *a).index_add(1, torch.tensor([NOSPEECH]),
                          torch.full((1, 1), 50.0)))
    rng = np.random.default_rng(6)
    path = str(tmp_path / "ref.wav")
    audio_io.write_wav(path, (rng.normal(size=16000) * 0.05).astype(
        np.float32), 16000)
    want = jtranscribe.jax_transcriber(jp, jcfg, StubTokenizer(),
                                       max_new=6)(path)
    got = ttranscribe.transcriber(tp, tcfg, StubTokenizer(), max_new=6)(path)
    assert got == want
    assert (got == "") == (case == "silence")


def whisper_dir(path, seed=0):
    """A tiny WhisperForConditionalGeneration checkpoint (80 mels, 1500
    source positions; ``config.json`` and ``model.safetensors`` as
    ``save_pretrained`` writes them, the tied ``proj_out.weight`` left out)
    and a WhisperTokenizer with the special tokens, saved under ``path``;
    returns the port's WhisperConfig."""
    from safetensors.numpy import save_file
    from transformers import WhisperTokenizer
    from transformers.models.whisper.tokenization_whisper import (
        bytes_to_unicode)

    path.mkdir(parents=True, exist_ok=True)
    tokens = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>",
              "<|transcribe|>", "<|notimestamps|>"]
    vocab = {t: i for i, t in enumerate(tokens)}
    for c in bytes_to_unicode().values():        # byte-level: any id decodes
        vocab.setdefault(c, len(vocab))
    with open(path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    tok = WhisperTokenizer(str(path / "vocab.json"), str(path / "merges.txt"),
                           unk_token="<|endoftext|>",
                           bos_token="<|endoftext|>",
                           eos_token="<|endoftext|>",
                           additional_special_tokens=tokens[1:])
    cfg = tmodel.tiny_whisper_config(
        vocab_size=len(vocab), num_mel_bins=80, encoder_layers=1,
        decoder_layers=1, max_source_positions=1500,
        max_target_positions=32, decoder_start_token_id=1, eos_token_id=0)
    tok.save_pretrained(str(path))
    save_file({k: v for k, v in state_dict(cfg, seed).items()
               if k != "proj_out.weight"}, str(path / "model.safetensors"))
    hf = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "eps"}
    with open(path / "config.json", "w") as f:
        json.dump(dict(hf, model_type="whisper",
                       architectures=["WhisperForConditionalGeneration"]), f)
    return cfg


def test_load_transcriber_from_a_local_directory(tmp_path, monkeypatch):
    cfg = whisper_dir(tmp_path / "whisper")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    rng = np.random.default_rng(2)
    wav = str(tmp_path / "ref.wav")
    audio_io.write_wav(wav, (rng.normal(size=8000) * 0.1).astype(
        np.float32), 16000)
    got = ttranscribe.load_transcriber(str(tmp_path / "whisper"),
                                       device="cpu")(wav)
    assert isinstance(got, str)
    # the same directory as the default model's cache snapshot
    snap = (tmp_path / "hub" / "models--openai--whisper-large-v3-turbo"
            / "snapshots" / "abc")
    snap.parent.mkdir(parents=True)
    (tmp_path / "whisper").rename(snap)
    (snap.parents[1] / "refs").mkdir()
    (snap.parents[1] / "refs" / "main").write_text("abc")
    assert ttranscribe.local_model_dir(ttranscribe.DEFAULT_MODEL) == str(snap)
    assert ttranscribe.load_transcriber(device="cpu")(wav) == got
    with open(snap / "config.json") as f:
        assert ttranscribe.whisper_config(json.load(f)) == cfg


def test_load_transcriber_raises_naming_reference_text(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="--reference_text"):
        ttranscribe.load_transcriber(device="cpu")
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "config.json").write_text("{}")
    with pytest.raises(RuntimeError, match="--reference_text"):
        ttranscribe.load_transcriber(str(tmp_path / "broken"), device="cpu")

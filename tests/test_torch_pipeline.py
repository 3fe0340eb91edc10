"""The port's pipeline and CLI end to end on the CPU.

``TTSPipeline.synthesize_batch`` gives the JAX pipeline's generated frames
(greedy, paged cache) and its waveforms within 1e-4; the port's CLI runs on
a directory that the JAX package's ``export_hf`` wrote, with an offline
tokenizer and random codec weights, as tests/test_cli_e2e.py runs the JAX
CLI."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import audio_tokenizer as jtok
from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.config import DecodeConfig, backbone_preset, tiny_voice_config
from t5gemma_tts_tpu.export import hf_export
from t5gemma_tts_tpu.inference import pipeline as jpipe
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe

torch.set_num_threads(1)
TOL = 1e-4   # f32 waveforms: matmul and FFT sums in another order


def _char_tokenizer(text):
    return [3 + (ord(c) % 500) for c in text]


def _cfg(preset, tiny):
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, extra_cutoff=0.5)


def test_synthesize_batch_matches_jax():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    tcfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)
    params = jvoice.init_params(jax.random.PRNGKey(7), jcfg)
    ccfg = jcodec.tiny_codec_config()
    cparams = jcodec.init_decoder_params(jax.random.PRNGKey(8), ccfg)
    # bridge first: the JAX pipeline donates its parameters
    tparams, tcparams = (
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, t), "cpu")
        for t in (params, cparams))
    tp = tpipe.TTSPipeline(
        tparams, tcfg, _char_tokenizer,
        ttok.AudioTokenizer(tcparams, tcodec.tiny_codec_config(),
                            device="cpu"),
        device="cpu")
    jp = jpipe.TTSPipeline(params, jcfg, _char_tokenizer,
                           jtok.AudioTokenizer(cparams, ccfg))
    texts = [("hello world", 0.3), ("a longer test of the port", 0.6),
             ("speech", 0.2)]
    jreqs = [jpipe.Request(target_text=t, target_duration=d, lang="en")
             for t, d in texts]
    treqs = [tpipe.Request(target_text=t, target_duration=d, lang="en")
             for t, d in texts]
    want = jp.synthesize_batch(
        jreqs, DecodeConfig(top_k=1, kv_cache="paged"), seed=0, quiet=True)
    got = tp.synthesize_batch(
        treqs, tconfig.DecodeConfig(top_k=1, kv_cache="paged"), seed=0,
        quiet=True)
    assert [tp.plan_request(r) for r in treqs] == [
        tpipe.PlannedRequest(**dataclasses.asdict(jp.plan_request(r)))
        for r in jreqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.gen_frames, w.gen_frames)
        assert len(g.gen_frames) > 0
        assert g.wav.shape == w.wav.shape == (
            len(w.gen_frames) * ccfg.hop_length,)
        np.testing.assert_allclose(g.wav, w.wav, rtol=TOL, atol=TOL)
        assert g.steps == max(len(r.gen_frames) for r in want) + 1


def _offline_tokenizer(path, vocab_size):
    """A word-level tokenizer directory that transformers loads offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2}
    vocab.update({f"tok{i}": i for i in range(3, vocab_size)})
    for i, w in enumerate(["hello", "world", "this", "is", "a", "test"]):
        vocab[w] = 100 + i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "<pad>", "eos_token": "<eos>",
                   "unk_token": "<unk>"}, f)


def test_cli_end_to_end(tmp_path):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    cfg = tiny_voice_config()
    params = jvoice.init_params(jax.random.PRNGKey(0), cfg)
    model_dir, tok_dir = str(tmp_path / "model"), str(tmp_path / "tok")
    _offline_tokenizer(tok_dir, cfg.text_vocab_size)
    hf_export.export_hf(params, cfg, model_dir, dtype="float32",
                        text_tokenizer_name=tok_dir)

    from t5gemma_tts_tpu_torch.inference import audio_io, cli

    out_dir = str(tmp_path / "out")
    cli.main(["--model_dir", model_dir,
              "--target_text", "hello world this is a test",
              "--target_duration", "0.4", "--output_dir", out_dir,
              "--random_codec", "--top_k", "4", "--lang", "en",
              "--dump_tokens", "--device", "cpu"])
    wav, sr = audio_io.read_wav(os.path.join(out_dir, "generated.wav"))
    frames = np.load(os.path.join(out_dir, "generated_frames.npy"))
    assert sr == 44100
    assert frames.ndim == 1 and len(frames) > 0
    assert len(wav) == len(frames) * 882 and np.isfinite(wav).all()


def _wide_window_cfg():
    bb = tiny_voice_config().backbone
    bb = dataclasses.replace(
        bb, encoder=dataclasses.replace(bb.encoder, sliding_window=1024),
        decoder=dataclasses.replace(bb.decoder, sliding_window=1024))
    return tiny_voice_config(backbone=bb)


@pytest.fixture(scope="module")
def exported_model(tmp_path_factory):
    """A tiny exported model directory with an offline tokenizer, its
    sliding window wide enough for the paged caches."""
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    root = tmp_path_factory.mktemp("cli_modes")
    cfg = _wide_window_cfg()
    params = jvoice.init_params(jax.random.PRNGKey(0), cfg)
    model_dir, tok_dir = str(root / "model"), str(root / "tok")
    _offline_tokenizer(tok_dir, cfg.text_vocab_size)
    hf_export.export_hf(params, cfg, model_dir, dtype="float32",
                        text_tokenizer_name=tok_dir)
    return model_dir


@pytest.mark.parametrize("flags,refusal", [
    (["--reference_speech", "prompt.wav"],
     "--reference_speech needs the codec encoder"),
    (["--quantize", "int4"], None),
    (["--kv_cache", "paged_f8"], None)])
def test_cli_refuses_unported_modes(exported_model, tmp_path, flags, refusal):
    """Each case runs on a loadable model: an unported mode fails on its own
    refusal, and the ported ones (int4 weights, float8 pages) are served."""
    from t5gemma_tts_tpu_torch.inference import audio_io, cli

    argv = ["--model_dir", exported_model, "--target_text", "hello world",
            "--target_duration", "0.4", "--output_dir", str(tmp_path),
            "--random_codec", "--top_k", "4", "--lang", "en",
            "--device", "cpu", *flags]
    if refusal is not None:
        with pytest.raises(NotImplementedError, match=refusal):
            cli.main(argv)
        return
    cli.main(argv)
    wav, sr = audio_io.read_wav(os.path.join(str(tmp_path), "generated.wav"))
    assert sr == 44100 and len(wav) > 0 and np.isfinite(wav).all()

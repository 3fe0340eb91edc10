"""The port's pipeline and CLI end to end on the CPU.

``TTSPipeline.synthesize_batch`` gives the JAX pipeline's generated frames
(greedy, paged cache) and its waveforms within 1e-4, and with a reference
recording (voice cloning: the codec encoder, ``repeat_prompt`` 0, 2 and
"max", a ``prompt_end_frame`` cut) its prompt tokens, generated frames and
concat frames; the port's CLI runs on a directory that the JAX package's
``export_hf`` wrote, with an offline tokenizer and random codec weights, as
tests/test_cli_e2e.py runs the JAX CLI, and clones a voice with codec
weights converted from a fabricated ``model.safetensors``."""

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
from t5gemma_tts_tpu_torch.inference import audio_io
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


def _reference_wav(path, rate=300, seconds=30.0, seed=3):
    """A seeded tone plus noise, written as 16-bit PCM."""
    rng = np.random.default_rng(seed)
    n = np.arange(int(rate * seconds))
    wav = 0.3 * np.sin(2 * np.pi * 0.07 * n) + 0.05 * rng.normal(size=n.size)
    audio_io.write_wav(path, wav.astype(np.float32), rate)
    return path


def test_voice_clone_matches_jax(tmp_path):
    """Greedy voice cloning on the tiny model and codec (encoder params
    seeded in JAX, carried across): the planned prompts (codes, repeats,
    y_sep), the generated frames and the concat frames equal JAX's, for
    repeat_prompt 0, 2 and "max" and a prompt_end_frame cut, in one
    batch."""
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    tcfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)
    params = jvoice.init_params(jax.random.PRNGKey(7), jcfg)
    ccfg = jcodec.tiny_codec_config()
    cparams = jcodec.init_decoder_params(jax.random.PRNGKey(8), ccfg)
    cparams.update(jcodec.init_encoder_params_for(jax.random.PRNGKey(9),
                                                  ccfg))
    tparams, tcparams = (
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, t), "cpu")
        for t in (params, cparams))
    tp = tpipe.TTSPipeline(
        tparams, tcfg, _char_tokenizer,
        ttok.AudioTokenizer(tcparams, tcodec.tiny_codec_config(),
                            device="cpu"),
        device="cpu", audio_max_length=2.5)
    jp = jpipe.TTSPipeline(params, jcfg, _char_tokenizer,
                           jtok.AudioTokenizer(cparams, ccfg),
                           audio_max_length=2.5)
    ref = _reference_wav(str(tmp_path / "ref.wav"))
    cases = [dict(repeat_prompt=0), dict(repeat_prompt=2),
             dict(repeat_prompt="max"), dict(prompt_end_frame=4500)]
    kw = [dict(target_text=f"clone number {i}", target_duration=0.3,
               lang="en", audio_path=ref,
               prompt_transcript="the reference words", **c)
          for i, c in enumerate(cases)]
    jreqs = [jpipe.Request(**k) for k in kw]
    treqs = [tpipe.Request(**k) for k in kw]
    planned = [tp.plan_request(r) for r in treqs]
    assert planned == [
        tpipe.PlannedRequest(**dataclasses.asdict(jp.plan_request(r)))
        for r in jreqs]
    base = len(planned[0].prompt) - 1
    assert base > 10 and planned[0].prompt[-1] == tcfg.special.y_sep
    assert len(planned[1].prompt) == 3 * base + 1
    assert len(planned[2].prompt) > len(planned[1].prompt)
    assert len(planned[3].prompt) < len(planned[0].prompt)
    assert planned[0].text[:len("the reference words")] == _char_tokenizer(
        "the reference words")
    assert tcfg.x_sep_token in planned[0].text
    want = jp.synthesize_batch(
        jreqs, DecodeConfig(top_k=1, kv_cache="paged"), seed=0, quiet=True,
        decode_audio=False)
    got = tp.synthesize_batch(
        treqs, tconfig.DecodeConfig(top_k=1, kv_cache="paged"), seed=0,
        quiet=True, decode_audio=False)
    for g, w, p in zip(got, want, planned):
        np.testing.assert_array_equal(g.gen_frames, w.gen_frames)
        np.testing.assert_array_equal(g.concat_frames, w.concat_frames)
        assert len(g.gen_frames) > 0
        assert len(g.concat_frames) == len(p.prompt) - 1 + len(g.gen_frames)


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
    (["--reference_speech", "REF"],
     (NotImplementedError, "Queue 1 item 13")),
    (["--reference_speech", "REF", "--reference_text", "hello"],
     (ValueError, "--random_codec gives random codec decoder weights")),
    (["--quantize", "int4"], None),
    (["--kv_cache", "paged_f8"], None)])
def test_cli_refuses_unported_modes(exported_model, tmp_path, flags, refusal):
    """Each case runs on a loadable model: an unported mode fails on its own
    refusal (a reference without its transcript needs Whisper; random codec
    weights have no encoder), and the ported ones (int4 weights, float8
    pages) are served."""
    from t5gemma_tts_tpu_torch.inference import cli

    ref = _reference_wav(str(tmp_path / "ref.wav"))
    argv = ["--model_dir", exported_model, "--target_text", "hello world",
            "--target_duration", "0.4", "--output_dir", str(tmp_path),
            "--random_codec", "--top_k", "4", "--lang", "en",
            "--device", "cpu", *[ref if f == "REF" else f for f in flags]]
    if refusal is not None:
        with pytest.raises(refusal[0], match=refusal[1]):
            cli.main(argv)
        return
    cli.main(argv)
    wav, sr = audio_io.read_wav(os.path.join(str(tmp_path), "generated.wav"))
    assert sr == 44100 and len(wav) > 0 and np.isfinite(wav).all()


def test_cli_clones_a_voice_from_codec_dir(exported_model, tmp_path,
                                           monkeypatch):
    """--codec_dir with a fabricated tiny model.safetensors (converted by the
    port's converter, the codec config patched to the tiny one with the
    checkpoint's layout), --reference_speech, --reference_text and
    --repeat_prompt: the prompt's codes lead the concat frames."""
    from safetensors.numpy import save_file
    from test_torch_codec_convert import full_checkpoint

    from t5gemma_tts_tpu_torch.inference import cli

    sd, _, ccfg = full_checkpoint()
    codec_dir = tmp_path / "codec"
    codec_dir.mkdir()
    save_file(sd, str(codec_dir / "model.safetensors"))
    monkeypatch.setattr(tcodec, "XCodec2Config", lambda: ccfg)
    ref = _reference_wav(str(tmp_path / "ref.wav"))
    out_dir = str(tmp_path / "out")
    cli.main(["--model_dir", exported_model, "--target_text", "hello world",
              "--target_duration", "0.4", "--output_dir", out_dir,
              "--codec_dir", str(codec_dir), "--reference_speech", ref,
              "--reference_text", "this is a test", "--repeat_prompt", "1",
              "--cut_off_sec", "20", "--top_k", "4", "--lang", "en",
              "--dump_tokens", "--device", "cpu"])
    wav, sr = audio_io.read_wav(os.path.join(out_dir, "generated.wav"))
    gen = np.load(os.path.join(out_dir, "generated_frames.npy"))
    concat = np.load(os.path.join(out_dir, "concat_frames.npy"))
    tok = ttok.AudioTokenizer(
        cli._load_codec(
            cli.build_parser().parse_args(["--codec_dir", str(codec_dir)]),
            None, "cpu").params, ccfg, device="cpu")
    base = ttok.tokenize_audio(tok, ref, num_frames=20 * 300)[0, :, 0]
    assert sr == ccfg.sample_rate and np.isfinite(wav).all()
    assert len(base) > 0 and len(gen) > 0
    np.testing.assert_array_equal(concat, np.concatenate([base, base, gen]))

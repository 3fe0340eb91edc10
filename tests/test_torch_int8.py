"""The int8-weight serving path of the port end to end on the CPU.

Greedy (top_k=1) decoding with W8A8 weights is token-equal to the JAX
engine with its megakernel (``T5G_FUSED_ATTN=3``, layer scan) for the
``paged`` and ``paged_i8`` caches, and to its q_matmul path for the dense
cache; the JAX weights come from ``quantize_params_for_decode(
streaming_tiled=True)`` and reach the port through the bridge. A
``TTSPipeline(int8=True)`` run gives finite waveforms, and the CLI serves
``--quantize int8`` while it still refuses the ``paged_f8`` cache.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, backbone_preset, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops.quant import quantize_params_for_decode
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.inference import pipeline as tpipe
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
MAX_FRAMES = 48


def _cfg(preset, tiny):
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, extra_cutoff=0.3)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    params = jt5.fuse_for_decode(jvoice.init_params(jax.random.PRNGKey(3),
                                                    jcfg))
    qparams = quantize_params_for_decode(params, streaming_tiled=True)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, qparams), "cpu")
    rng = np.random.default_rng(5)
    b = 3
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([4, 19, 32], np.int32)
    prompt = np.full((b, 64), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 12, 30], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([8, 20, 14], np.int32)
    return dict(jcfg=jcfg, tcfg=_cfg(tconfig.backbone_preset,
                                     tconfig.tiny_voice_config),
                qparams=qparams, tparams=tparams,
                inputs=(x, x_lens, prompt, plens, targets))


@pytest.mark.parametrize("kv_cache", ["paged", "paged_i8", "dense"])
def test_int8_greedy_token_traces_equal(setup, kv_cache):
    jd = DecodeConfig(top_k=1, kv_cache=kv_cache, max_frames=MAX_FRAMES)
    td = tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache,
                              max_frames=MAX_FRAMES)
    os.environ["T5G_FUSED_ATTN"] = "3"
    os.environ["T5G_MK_STACKED"] = "0"
    try:
        want = jeng.decode_tokens(
            setup["qparams"], setup["jcfg"], jd,
            *(jnp.asarray(a) for a in setup["inputs"]),
            jax.random.PRNGKey(0))
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
        os.environ.pop("T5G_MK_STACKED", None)
    before = tmk.decode_stack.launches, tquant.w8a8_matmul.launches
    got = teng.decode_tokens(
        setup["tparams"], setup["tcfg"], td,
        *(torch.from_numpy(a) for a in setup["inputs"]),
        0)
    # the CPU runs the plain versions: no kernel was launched
    assert (tmk.decode_stack.launches, tquant.w8a8_matmul.launches) == before
    want_lens = np.asarray(want.gen_lens)
    assert len(set(want_lens.tolist())) == 3 and want_lens.max() < MAX_FRAMES
    np.testing.assert_array_equal(got.gen_lens.numpy(), want_lens)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)


def test_int8_step_takes_the_decode_layer_path(setup, monkeypatch):
    """With W8A8 decoder weights each paged step is one decode_stack call
    and no batch_paged_attention call; the dense cache takes neither."""
    from t5gemma_tts_tpu_torch.ops import fused_attn

    calls = {"stack": 0, "attn": 0}
    stack, attn = tmk.decode_stack, fused_attn.batch_paged_attention

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tmk, "decode_stack", count("stack", stack))
    monkeypatch.setattr(fused_attn, "batch_paged_attention",
                        count("attn", attn))
    for kv_cache in ("paged_i8", "dense"):
        calls.update(stack=0, attn=0)
        out = teng.decode_tokens(
            setup["tparams"], setup["tcfg"],
            tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache, max_frames=8),
            *(torch.from_numpy(a) for a in setup["inputs"]),
            0)
        want = out.steps if kv_cache == "paged_i8" else 0
        assert calls == {"stack": want, "attn": 0}, (kv_cache, calls)


def _char_tokenizer(text):
    return [3 + (ord(c) % 500) for c in text]


def test_int8_pipeline_gives_finite_waveforms():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    tcfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)
    params = jvoice.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    ccfg = tcodec.tiny_codec_config()
    tok = ttok.AudioTokenizer(tcodec.init_decoder_params(0, ccfg, "cpu"),
                              ccfg, device="cpu")
    pipe = tpipe.TTSPipeline(tparams, tcfg, _char_tokenizer, tok,
                             device="cpu", int8=True)
    dec = pipe.params["decoder"]["layers"]
    assert isinstance(dec["self_attn"]["qkv"], tquant.QuantWeight)
    assert isinstance(pipe.params["head"]["w2"], tquant.QuantWeight)
    assert not isinstance(pipe.params["encoder"]["layers"]["self_attn"]["qkv"],
                          tquant.QuantWeight)
    reqs = [tpipe.Request(target_text=t, target_duration=d, lang="en")
            for t, d in (("hello world", 0.3), ("int8 weights", 0.4))]
    for kv_cache in ("paged", "paged_i8"):
        res = pipe.synthesize_batch(
            reqs, tconfig.DecodeConfig(top_k=4, kv_cache=kv_cache), seed=0,
            quiet=True)
        for r in res:
            assert len(r.gen_frames) > 0
            assert r.wav.shape == (len(r.gen_frames) * ccfg.hop_length,)
            assert np.isfinite(r.wav).all()
    # voice cloning needs the codec encoder, which is not ported yet
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pipe.synthesize(tpipe.Request(target_text="hi", audio_path="ref.wav",
                                      target_duration=0.3),
                        quiet=True)


def test_cli_serves_int8(tmp_path):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from t5gemma_tts_tpu.export import hf_export
    from t5gemma_tts_tpu_torch.inference import audio_io, cli

    from test_torch_pipeline import _offline_tokenizer

    from test_torch_pipeline import _wide_window_cfg

    cfg = _wide_window_cfg()       # the paged caches fit its window
    params = jvoice.init_params(jax.random.PRNGKey(0), cfg)
    model_dir, tok_dir = str(tmp_path / "model"), str(tmp_path / "tok")
    _offline_tokenizer(tok_dir, cfg.text_vocab_size)
    hf_export.export_hf(params, cfg, model_dir, dtype="float32",
                        text_tokenizer_name=tok_dir)
    out_dir = str(tmp_path / "out")
    cli.main(["--model_dir", model_dir,
              "--target_text", "hello world this is a test",
              "--target_duration", "0.4", "--output_dir", out_dir,
              "--random_codec", "--top_k", "4", "--lang", "en",
              "--dump_tokens", "--device", "cpu", "--quantize", "int8"])
    wav, sr = audio_io.read_wav(os.path.join(out_dir, "generated.wav"))
    frames = np.load(os.path.join(out_dir, "generated_frames.npy"))
    assert sr == 44100 and len(frames) > 0
    assert len(wav) == len(frames) * 882 and np.isfinite(wav).all()
    # float8 pages are served too: int8 weights over paged_f8 take the
    # paged attention kernel's e4m3 variant (the decode layer takes no f8)
    f8_dir = str(tmp_path / "out_f8")
    cli.main(["--model_dir", model_dir,
              "--target_text", "hello world this is a test",
              "--target_duration", "0.4", "--output_dir", f8_dir,
              "--random_codec", "--top_k", "4", "--lang", "en",
              "--device", "cpu", "--quantize", "int8", "--kv_cache",
              "paged_f8"])
    wav, sr = audio_io.read_wav(os.path.join(f8_dir, "generated.wav"))
    assert sr == 44100 and len(wav) > 0 and np.isfinite(wav).all()

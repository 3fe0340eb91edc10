"""The port's XCodec2 encode side against the JAX package at the tiny
configs: the Kaldi log-mel frontend, normalization and stacking, the
w2v-BERT conformer with a pad mask, the acoustic encoder (with and without
an LSTM, padded with ``wav_lens`` and pad-invariant), the fusion and
``fc_prior``, the codes of ``encode_waveform`` and of ``AudioTokenizer``
on a written wav, and the bridge carrying the encoder tree across.

Each stage is held to JAX given equal inputs. The two packages' f32 FFTs
differ by up to a few 1e-4 in log-mel at low-energy bins (each is as far
from a float64 reference), so the stages after the frontend take the JAX
frontend's output where a tolerance tighter than the frontend's is held.
Codes are equal except where a frame's pre-quantization value (the bounded
value FSQ rounds) lies within ``FLIP_MARGIN`` of a rounding boundary in
either package: there f32 sums in another order may round to the next
code."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import audio_tokenizer as jtok
from t5gemma_tts_tpu.codec import encoder as jenc
from t5gemma_tts_tpu.codec import features as jfeat
from t5gemma_tts_tpu.codec import fsq as jfsq
from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.codec import semantic as jsem
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import encoder as tenc
from t5gemma_tts_tpu_torch.codec import features as tfeat
from t5gemma_tts_tpu_torch.codec import fsq as tfsq
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.codec import semantic as tsem
from t5gemma_tts_tpu_torch.inference import audio_io

torch.set_num_threads(1)
FLIP_MARGIN = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return bridge.params_from_jax(_np(tree), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _wav(seed, b, s, scale=0.3):
    """Seeded tones plus noise, [b, s]."""
    rng = np.random.default_rng(seed)
    n = np.arange(s)[None, :]
    tone = np.sin(2 * np.pi * rng.uniform(0.01, 0.2, (b, 1)) * n)
    return (scale * tone + 0.05 * rng.normal(size=(b, s))).astype(np.float32)


def test_log_mel_matches_jax():
    wav = _wav(0, 2, 2000)
    want = np.asarray(jfeat.log_mel_frames(jnp.asarray(wav)))
    got = tfeat.log_mel_frames(_t(wav)).numpy()
    assert got.shape == want.shape == (2, 1 + (2000 - 400) // 160, 80)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tfeat.kaldi_mel_filters(),
                                  jfeat.kaldi_mel_filters())
    np.testing.assert_array_equal(tfeat.povey_window(), jfeat.povey_window())
    assert tfeat.log_mel_frames(torch.zeros(1, 300)).shape == \
        jfeat.log_mel_frames(jnp.zeros((1, 300))).shape == (1, 0, 80)


@pytest.mark.parametrize("lengths", [None, (13, 8)])
def test_normalize_and_stack_matches_jax(lengths):
    feats = np.random.default_rng(1).normal(size=(2, 13, 80)).astype(
        np.float32) * 3 + 5
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want, want_lens = jfeat.normalize_and_stack(
        jnp.asarray(feats), None if lens is None else jnp.asarray(lens))
    got, got_lens = tfeat.normalize_and_stack(
        _t(feats), None if lens is None else _t(lens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.fixture
def jax_log_mel(monkeypatch):
    """The port's frontend fed the JAX log-mel (the FFT's f32 difference
    taken out), so what follows it is held at its own tolerance."""
    monkeypatch.setattr(tfeat, "log_mel_frames", lambda wav, sr=16000: _t(
        np.asarray(jfeat.log_mel_frames(jnp.asarray(wav.numpy()), sr))))


def test_extract_features_lengths_match_jax(jax_log_mel):
    wav = _wav(2, 2, 2400)
    wav_lens = np.asarray([2400, 1250], np.int32)
    want, want_lens = jfeat.extract_features(jnp.asarray(wav),
                                             jnp.asarray(wav_lens))
    got, got_lens = tfeat.extract_features(_t(wav), _t(wav_lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_conformer_matches_jax_with_pad_mask():
    cfg = jsem.tiny_conformer_config()
    jp = jsem.init_params(jax.random.PRNGKey(3), cfg)
    feats = np.random.default_rng(3).normal(size=(2, 21, 160)).astype(
        np.float32)
    lens = np.asarray([21, 12], np.int32)
    want = np.asarray(jax.jit(lambda p, f, n: jsem.forward(p, cfg, f, n))(
        jp, jnp.asarray(feats), jnp.asarray(lens)))
    tcfg = tsem.tiny_conformer_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    got = tsem.forward(_port(jp), tcfg, _t(feats), _t(lens).long()).numpy()
    valid = np.arange(21)[None] < lens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rnn_layers", [0, 2])
def test_acoustic_encoder_matches_jax(rnn_layers):
    """Padded with ``wav_lens`` (each conv masked), and unpadded."""
    acfg = dataclasses.replace(jenc.tiny_encoder_configs()[0],
                               rnn_layers=rnn_layers)
    tcfg = dataclasses.replace(tenc.tiny_encoder_configs()[0],
                               rnn_layers=rnn_layers)
    jp = jenc.init_acoustic_params(jax.random.PRNGKey(4), acfg)
    tp = _port(jp)
    wav = _wav(4, 2, 96)
    lens = np.asarray([96, 53], np.int32)
    for wav_lens in (None, lens):
        want = np.asarray(jenc.acoustic_forward(
            jp, acfg, jnp.asarray(wav),
            None if wav_lens is None else jnp.asarray(wav_lens)))
        got = tenc.acoustic_forward(
            tp, tcfg, _t(wav), None if wav_lens is None else _t(wav_lens))
        assert got.shape == want.shape == (2, 96 // 4, acfg.out_dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rnn_layers", [0, 2])
def test_acoustic_encoder_pad_invariant(rnn_layers):
    """A bucket-padded encode with ``wav_lens`` equals the unpadded one (as
    tests/test_codec_encoder.py holds the JAX encoder)."""
    acfg = dataclasses.replace(tenc.tiny_encoder_configs()[0],
                               rnn_layers=rnn_layers)
    tp = tenc.init_acoustic_params(torch.Generator().manual_seed(0), acfg)
    s_valid = 52
    wav = _wav(3, 1, s_valid)
    want = tenc.acoustic_forward(tp, acfg, _t(wav)).numpy()
    for pad_to in (64, 96):
        padded = np.zeros((1, pad_to), np.float32)
        padded[:, :s_valid] = wav
        got = tenc.acoustic_forward(tp, acfg, _t(padded),
                                    torch.tensor([s_valid])).numpy()
        np.testing.assert_allclose(got[:, :want.shape[1]], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"pad_to={pad_to}")


def test_lstm_loop_matches_torch_lstm():
    """The loop's gate order and biases are PyTorch's (nn.LSTM as the
    reference, its weights transposed into the JAX layout)."""
    torch.manual_seed(0)
    ref = torch.nn.LSTM(6, 6, batch_first=True)
    p = {"w_ih": ref.weight_ih_l0.detach().T, "w_hh": ref.weight_hh_l0.detach().T,
         "b_ih": ref.bias_ih_l0.detach(), "b_hh": ref.bias_hh_l0.detach()}
    x = torch.randn(2, 9, 6)
    with torch.no_grad():
        want, _ = ref(x)
    np.testing.assert_allclose(tenc.lstm_forward(p, x).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def codec():
    """Tiny codec, decoder + encoder params (LSTM on), both packages."""
    jcfg = dataclasses.replace(
        jcodec.tiny_codec_config(),
        acoustic_cfg=dataclasses.replace(jcodec.tiny_codec_config()
                                         .acoustic_cfg, rnn_layers=2))
    tcfg = dataclasses.replace(
        tcodec.tiny_codec_config(),
        acoustic_cfg=dataclasses.replace(tcodec.tiny_codec_config()
                                         .acoustic_cfg, rnn_layers=2))
    jp = jcodec.init_decoder_params(jax.random.PRNGKey(5), jcfg)
    jp.update(jcodec.init_encoder_params_for(jax.random.PRNGKey(6), jcfg))
    return jcfg, tcfg, jp, _port(jp)


def test_bridge_carries_the_encoder_tree(codec):
    """params_from_jax maps the encoder tree leaf for leaf: the blocks' and
    units' lists, the LSTM layers, the stacked conformer layers."""
    _, _, jp, tp = codec
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jp))
    tleaves = jax.tree_util.tree_leaves_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [k for k, _ in jleaves] == [k for k, _ in tleaves]
    for (key, j), (_, t) in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(key))
    assert len(tp["acoustic"]["rnn"]) == 2
    assert tp["semantic_model"]["layers"]["attn"]["q"]["w"].shape[0] == \
        jcodec.tiny_codec_config().conformer_cfg.num_layers


def test_fuse_features_and_fc_prior_match_jax(codec, jax_log_mel):
    jcfg, tcfg, jp, tp = codec
    wav = _wav(7, 2, 3000)
    lens = np.asarray([3000, 2100], np.int32)
    # eager, so that its log-mel is the one jax_log_mel hands the port
    want = np.asarray(jenc.fuse_features(jp, jcfg, jnp.asarray(wav),
                                         jnp.asarray(lens)))
    got = tenc.fuse_features(tp, tcfg, _t(wav), _t(lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    prior = want @ np.asarray(jp["fc_prior"]["w"]) + np.asarray(
        jp["fc_prior"]["b"])
    np.testing.assert_allclose(
        tcodec.encode_prior(tp, tcfg, _t(wav), _t(lens)).numpy(), prior,
        rtol=1e-5, atol=1e-5)


def _flips_allowed(got, want, margins):
    """Codes equal but at frames whose rounding margin is under
    FLIP_MARGIN; returns the count of such frames."""
    near = np.minimum(*margins) < FLIP_MARGIN
    assert got.shape == want.shape
    assert np.all((got == want) | near), np.argwhere((got != want) & ~near)
    return int(near.sum())


def _margins(jp, tp, jcfg, tcfg, wav, lens):
    """Each package's rounding margin of every frame (the JAX one from
    its bounded values)."""
    def jax_margin(p, wav, lens):
        z = (jenc.fuse_features(p, jcfg, wav, lens) @ p["fc_prior"]["w"]
             + p["fc_prior"]["b"]) @ p["fsq"]["project_in"]["w"] \
            + p["fsq"]["project_in"]["b"]
        b = jfsq.bound(jcfg.fsq, z)
        return (0.5 - jnp.abs(b - jnp.round(b))).min(-1)

    jmargin = np.asarray(jax.jit(jax_margin)(jp, wav, lens))
    tz = tcodec.encode_prior(tp, tcfg, _t(wav), _t(lens)) \
        @ tp["fsq"]["project_in"]["w"] + tp["fsq"]["project_in"]["b"]
    return jmargin, tfsq.rounding_margin(tcfg.fsq, tz).numpy()


def test_encode_waveform_matches_jax(codec):
    jcfg, tcfg, jp, tp = codec
    wav = _wav(8, 2, 8192)
    lens = np.asarray([8192, 6000], np.int32)
    want = np.asarray(jax.jit(lambda p, w, n: jcodec.encode_waveform(
        p, jcfg, w, n))(jp, jnp.asarray(wav), jnp.asarray(lens)))
    got = tcodec.encode_waveform(tp, tcfg, _t(wav), _t(lens)).numpy()
    assert want.shape[1] > 20
    _flips_allowed(got, want, _margins(jp, tp, jcfg, tcfg, jnp.asarray(wav),
                                       jnp.asarray(lens)))
    q, idx = tfsq.encode(tp["fsq"], tcfg.fsq, torch.zeros(3, tcfg.fsq.dim))
    jq, jidx = jfsq.encode(jp["fsq"], jcfg.fsq, jnp.zeros((3, jcfg.fsq.dim)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6)


def test_audio_tokenizer_encode_matches_jax(codec, tmp_path):
    """tokenize_audio on a written wav (read, resampled, bucket-padded,
    trimmed to S // prod(ratios)): codes [1, T, 1] int64 equal JAX's."""
    jcfg, tcfg, jp, tp = codec
    path = str(tmp_path / "ref.wav")
    audio_io.write_wav(path, _wav(9, 1, 9000)[0], 300)
    jt = jtok.AudioTokenizer(jp, jcfg)
    tt = ttok.AudioTokenizer(tp, tcfg, device="cpu")
    for num_frames in (-1, 4500):
        want = jtok.tokenize_audio(jt, path, num_frames=num_frames)
        got = ttok.tokenize_audio(tt, path, num_frames=num_frames)
        assert got.dtype == np.int64 and got.shape[2] == 1
        wav = audio_io.load_for_encode(
            path, tcfg.encode_sample_rate,
            num_frames=None if num_frames == -1 else num_frames)[None]
        s = wav.shape[1]
        assert got.shape[:2] == (1, min(s // 4, got.shape[1])) and \
            got.shape[1] > 10
        padded = np.pad(wav, ((0, 0), (0, ttok._bucket(s) - s)))
        jm, tm = _margins(jp, tp, jcfg, tcfg, jnp.asarray(padded),
                          jnp.asarray([s], jnp.int32))
        t = got.shape[1]
        _flips_allowed(got[..., 0], want[..., 0], (jm[:, :t], tm[:, :t]))

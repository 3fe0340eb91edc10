"""The port's XCodec2 checkpoint converter against the JAX package's, on a
state dict fabricated in the reference key layout (the layout of
tests/test_codec_convert_full.py, rebuilt here at the tiny codec's shapes,
so that the converted tree also encodes and decodes): the trees are equal
leaf for leaf, the inferred acoustic layout matches, and the contracts
hold (an unknown key raises naming it, a missing section raises,
``decode_only``, ``strict=False``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import convert as jconv
from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu_torch.codec import convert as tconv
from t5gemma_tts_tpu_torch.codec import model as tcodec

torch.set_num_threads(1)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32) * 0.1


def _semantic_keys(rng, n_layers, hidden=32, inter=64, conv_k=7, in_dim=160,
                   pos=12):
    """A Wav2Vec2Bert-layout state dict at the tiny conformer's shapes."""
    sd = {
        "semantic_model.masked_spec_embed": _rand(rng, hidden),
        "semantic_model.feature_projection.layer_norm.weight": _rand(rng, in_dim),
        "semantic_model.feature_projection.layer_norm.bias": _rand(rng, in_dim),
        "semantic_model.feature_projection.projection.weight": _rand(
            rng, hidden, in_dim),
        "semantic_model.feature_projection.projection.bias": _rand(rng, hidden),
    }
    for i in range(n_layers):
        b = f"semantic_model.encoder.layers.{i}."
        for base, shape_w, shape_b in (
            ("ffn1_layer_norm", (hidden,), (hidden,)),
            ("ffn1.intermediate_dense", (inter, hidden), (inter,)),
            ("ffn1.output_dense", (hidden, inter), (hidden,)),
            ("self_attn_layer_norm", (hidden,), (hidden,)),
            ("self_attn.linear_q", (hidden, hidden), (hidden,)),
            ("self_attn.linear_k", (hidden, hidden), (hidden,)),
            ("self_attn.linear_v", (hidden, hidden), (hidden,)),
            ("self_attn.linear_out", (hidden, hidden), (hidden,)),
            ("conv_module.layer_norm", (hidden,), (hidden,)),
            ("conv_module.depthwise_layer_norm", (hidden,), (hidden,)),
            ("ffn2_layer_norm", (hidden,), (hidden,)),
            ("ffn2.intermediate_dense", (inter, hidden), (inter,)),
            ("ffn2.output_dense", (hidden, inter), (hidden,)),
            ("final_layer_norm", (hidden,), (hidden,)),
        ):
            sd[b + base + ".weight"] = _rand(rng, *shape_w)
            sd[b + base + ".bias"] = _rand(rng, *shape_b)
        sd[b + "self_attn.distance_embedding.weight"] = _rand(
            rng, pos, hidden // 4)
        sd[b + "conv_module.pointwise_conv1.weight"] = _rand(
            rng, 2 * hidden, hidden, 1)
        sd[b + "conv_module.depthwise_conv.weight"] = _rand(
            rng, hidden, 1, conv_k)
        sd[b + "conv_module.pointwise_conv2.weight"] = _rand(
            rng, hidden, hidden, 1)
    return sd


def _decode_keys(rng, fsq_dim=32, codebook_dim=3, voc_in=16, dim=24,
                 inter=48, n_blocks=2, n_fft=32):
    """Quantizer, fc_post_a and Vocos, the head's bias as ``.beta``."""
    sd = {
        "generator.quantizer.project_in.weight": _rand(rng, codebook_dim,
                                                       fsq_dim),
        "generator.quantizer.project_in.bias": _rand(rng, codebook_dim),
        "generator.quantizer.project_out.weight": _rand(rng, fsq_dim,
                                                        codebook_dim),
        "generator.quantizer.project_out.bias": _rand(rng, fsq_dim),
        "fc_post_a.weight": _rand(rng, voc_in, fsq_dim),
        "fc_post_a.bias": _rand(rng, voc_in),
        "generator.backbone.embed.weight": _rand(rng, dim, voc_in, 7),
        "generator.backbone.embed.bias": _rand(rng, dim),
        "generator.backbone.norm.weight": _rand(rng, dim),
        "generator.backbone.norm.beta": _rand(rng, dim),
        "generator.backbone.final_layer_norm.weight": _rand(rng, dim),
        "generator.backbone.final_layer_norm.bias": _rand(rng, dim),
        "generator.head.out.weight": _rand(rng, n_fft + 2, dim),
        "generator.head.out.bias": _rand(rng, n_fft + 2),
    }
    for i in range(n_blocks):
        b = f"generator.backbone.convnext.{i}."
        sd[b + "dwconv.weight"] = _rand(rng, dim, 1, 7)
        sd[b + "dwconv.bias"] = _rand(rng, dim)
        sd[b + "norm.weight"] = _rand(rng, dim)
        sd[b + "norm.bias"] = _rand(rng, dim)
        sd[b + "pwconv1.weight"] = _rand(rng, inter, dim)
        sd[b + "pwconv1.bias"] = _rand(rng, inter)
        sd[b + "pwconv2.weight"] = _rand(rng, dim, inter)
        sd[b + "pwconv2.bias"] = _rand(rng, dim)
        sd[b + "gamma"] = _rand(rng, dim)
    return sd


def _encode_extra_keys(rng):
    return {
        "fc_prior.weight": _rand(rng, 32, 32),
        "fc_prior.bias": _rand(rng, 32),
        "SemanticEncoder_module.initial_conv.weight": _rand(rng, 24, 32, 3),
        "SemanticEncoder_module.residual_blocks.1.weight": _rand(rng, 24, 24, 3),
        "SemanticEncoder_module.residual_blocks.1.bias": _rand(rng, 24),
        "SemanticEncoder_module.residual_blocks.3.weight": _rand(rng, 24, 24, 3),
        "SemanticEncoder_module.residual_blocks.3.bias": _rand(rng, 24),
        "SemanticEncoder_module.final_conv.weight": _rand(rng, 16, 24, 3),
    }


ACOUSTIC = dict(ngf=6, ratios=(2, 5), dilations=(1, 3), out_dim=16, kernel=7,
                rnn_layers=2)


def _acoustic_keys():
    """A weight-normed BigCodec-style stack with a 2-layer LSTM (both
    weight-norm spellings)."""
    import torch.nn as nn
    from torch.nn.utils import weight_norm
    from torch.nn.utils.parametrizations import weight_norm as param_norm

    a = ACOUSTIC
    torch.manual_seed(0)
    mods = [weight_norm(nn.Conv1d(1, a["ngf"], 7, padding=3))]
    ch = a["ngf"]
    for r in a["ratios"]:
        for d in a["dilations"]:
            mods.append(param_norm(nn.Conv1d(ch, ch, 7, dilation=d,
                                             padding=3 * d)))
            mods.append(weight_norm(nn.Conv1d(ch, ch, 1)))
        mods.append(weight_norm(nn.Conv1d(ch, ch * 2, 2 * r, stride=r,
                                          padding=-(-r // 2))))
        ch *= 2
    stack = nn.Sequential(*mods)
    rnn = nn.LSTM(ch, ch, num_layers=a["rnn_layers"], batch_first=True)
    out = weight_norm(nn.Conv1d(ch, a["out_dim"], 3, padding=1))
    sd = {}
    for name, mod in (("block", stack), ("rnn", rnn), ("out", out)):
        for k, v in mod.state_dict().items():
            sd[f"CodecEnc.{name}.{k}"] = v.detach().numpy()
    return sd


def full_checkpoint(extra_sem_layers=1):
    """(state dict, the JAX codec config, the port's): the tiny codec with
    the checkpoint's acoustic layout, a conformer layer past the tapped
    one, ``masked_spec_embed`` and a ``.beta`` key."""
    rng = np.random.default_rng(0)
    jcfg = dataclasses.replace(
        jcodec.tiny_codec_config(),
        acoustic_cfg=jcodec.AcousticEncoderConfig(**ACOUSTIC))
    tcfg = dataclasses.replace(
        tcodec.tiny_codec_config(),
        acoustic_cfg=tcodec.AcousticEncoderConfig(**ACOUSTIC))
    sd = {}
    sd.update(_decode_keys(rng))
    sd.update(_encode_extra_keys(rng))
    sd.update(_semantic_keys(
        rng, tcfg.conformer_cfg.num_layers + extra_sem_layers))
    sd.update(_acoustic_keys())
    return sd, jcfg, tcfg


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _assert_same_tree(got, want):
    jl = _leaves(jax.tree_util.tree_map(np.asarray, want))
    tl = _leaves(got)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, t), (_, j) in zip(tl, jl):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(key))


@pytest.mark.parametrize("decode_only", [False, True])
def test_full_checkpoint_converts_as_jax(decode_only):
    sd, jcfg, tcfg = full_checkpoint()
    want = jconv.xcodec2_state_dict_to_params(sd, jcfg,
                                              decode_only=decode_only)
    got = tconv.xcodec2_state_dict_to_params(sd, tcfg,
                                             decode_only=decode_only,
                                             device="cpu")
    assert set(got) == {"fsq", "vocos", "fc_post_a", "fc_prior",
                        "semantic_model", "semantic_encoder", "acoustic"}
    _assert_same_tree(got, want)


def test_inferred_acoustic_layout_matches_jax():
    sd = _acoustic_keys()
    jp, jacfg, jkeys = jconv.acoustic_state_dict_to_params(sd)
    tp, tacfg, tkeys = tconv.acoustic_state_dict_to_params(sd, device="cpu")
    assert dataclasses.asdict(tacfg) == dataclasses.asdict(jacfg) == dict(
        ACOUSTIC, rnn_residual=True)
    assert tkeys == jkeys
    _assert_same_tree(tp, jp)


def test_weight_norm_and_beta_rename_match_jax():
    sd = _acoustic_keys()
    want = jconv.merge_weight_norm(sd)
    got = tconv.merge_weight_norm(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    beta = {"a.beta": np.ones(2, np.float32), "b.weight": np.zeros(2)}
    assert tconv.rename_beta_keys(beta).keys() == \
        jconv.rename_beta_keys(beta).keys() == {"a.bias", "b.weight"}


def test_unknown_key_raises_naming_it():
    sd, _, tcfg = full_checkpoint()
    sd["generator.quantizer.mystery.weight"] = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="mystery"):
        tconv.xcodec2_state_dict_to_params(sd, tcfg, device="cpu")
    sd, _, _ = full_checkpoint()
    sd["CodecEnc.mystery.scale"] = np.ones((4,), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        tconv.xcodec2_state_dict_to_params(sd, tcfg, device="cpu")


def test_missing_section_raises():
    sd, _, tcfg = full_checkpoint()
    sd = {k.replace("generator.quantizer.", "generator.quantizerX."): v
          for k, v in sd.items()}
    with pytest.raises(ValueError, match="fsq"):
        tconv.xcodec2_state_dict_to_params(sd, tcfg, device="cpu")


def test_decode_only_contract():
    sd = _decode_keys(np.random.default_rng(1))
    tcfg = tcodec.tiny_codec_config()
    want = jconv.xcodec2_state_dict_to_params(
        sd, jcodec.tiny_codec_config(), decode_only=True)
    got = tconv.xcodec2_state_dict_to_params(sd, tcfg, decode_only=True,
                                             device="cpu")
    assert set(got) == {"fsq", "vocos", "fc_post_a"}
    _assert_same_tree(got, want)
    with pytest.raises(ValueError, match="required sections missing"):
        tconv.xcodec2_state_dict_to_params(sd, tcfg, device="cpu")


def test_acoustic_layout_mismatch_raises():
    sd, _, _ = full_checkpoint()
    with pytest.raises(ValueError, match="acoustic-encoder layout"):
        tconv.xcodec2_state_dict_to_params(sd, tcodec.tiny_codec_config(),
                                           device="cpu")


def test_non_strict_downgrades_to_warning(caplog):
    sd, _, tcfg = full_checkpoint()
    sd["generator.quantizer.mystery.weight"] = np.ones((4, 4), np.float32)
    params = tconv.xcodec2_state_dict_to_params(sd, tcfg, strict=False,
                                                device="cpu")
    assert "fsq" in params
    assert "mystery" in caplog.text


def test_converted_checkpoint_encodes_and_decodes():
    """The converted tiny checkpoint runs the port's encode and decode."""
    from t5gemma_tts_tpu_torch.codec.audio_tokenizer import AudioTokenizer

    sd, _, tcfg = full_checkpoint()
    tok = AudioTokenizer(
        tconv.xcodec2_state_dict_to_params(sd, tcfg, device="cpu"), tcfg,
        device="cpu")
    wav = np.random.default_rng(2).normal(size=3000).astype(np.float32) * 0.1
    codes = tok.encode(wav)
    assert codes.shape[0] == 1 and codes.shape[1] > 0
    assert 0 <= codes.min() and codes.max() < tcfg.fsq.codebook_size
    out = tok.decode(codes[:, :, 0][:, None])
    assert out.shape == (1, 1, codes.shape[1] * tcfg.hop_length)
    assert np.isfinite(out).all()

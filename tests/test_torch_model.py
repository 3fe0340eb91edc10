"""Port model modules against the JAX package at the ``test`` preset (f32):
encoder, dense decoder, paged prefill + decode steps, prediction head, codec
decode. Same numpy-seeded weights and inputs on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.config import DecodeConfig, backbone_preset, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import masks as jmasks
from t5gemma_tts_tpu.ops import rope as jrope
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.ops import masks as tmasks
from t5gemma_tts_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
TOL = 1e-4   # f32 hidden states/logits/waveforms: matmul sums in another order


def _cfgs(sliding_window=512):
    """The same tiny config on both sides (paged runs need the whole
    cache inside the sliding window)."""
    out = []
    for mod in (None, tconfig):
        bb = backbone_preset("test") if mod is None else mod.backbone_preset("test")
        dims = dataclasses.replace(bb.decoder, sliding_window=sliding_window)
        bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
        make = tiny_voice_config if mod is None else mod.tiny_voice_config
        out.append(make(backbone=bb))
    return out


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                     "cpu")
    rng = np.random.default_rng(0)
    b = 3
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([5, 17, 32], np.int32)
    prompt = np.full((b, 64), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 9, 40], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([20, 30, 25], np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams, x=x,
                x_lens=x_lens, prompt=prompt, plens=plens, targets=targets,
                rng=rng)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_encoder_forward(model):
    want, _ = jvoice.encode_text(model["params"], model["jcfg"],
                                 *_j(model["x"], model["x_lens"]))
    got, _ = tvoice.encode_text(model["tparams"], model["tcfg"],
                                *_t(model["x"], model["x_lens"]))
    _close(got, want)


def test_predict_head(model):
    h = model["rng"].standard_normal((3, 1, 64)).astype(np.float32)
    want = jvoice.predict_head(model["params"]["head"], jnp.asarray(h))
    got = tvoice.predict_head(model["tparams"]["head"], torch.from_numpy(h))
    _close(got, want)


def test_decoder_forward_full_sequence(model):
    """Training-shape forward (no cache): causal + sliding biases, PM-RoPE
    self and cross positions, stacked cross K/V."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    dims = jcfg.backbone.decoder
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((3, 12, 64)).astype(np.float32) * 0.1
    lens = np.asarray([12, 7, 3], np.int32)
    mem, enc_pos = jvoice.encode_text(model["params"], jcfg,
                                      *_j(model["x"], model["x_lens"]))
    jk, jv = jt5.build_cross_kv(model["params"]["decoder"], dims, mem, enc_pos)
    dec_pos = jrope.progress_position_ids(jnp.asarray(lens), 12, 2000.0)
    want, _ = jt5.decoder_forward(
        model["params"]["decoder"], dims, inputs_embeds=jnp.asarray(emb),
        self_full_bias=jmasks.decoder_self_bias(jnp.asarray(lens), 12),
        self_sliding_bias=jmasks.decoder_sliding_bias(jnp.asarray(lens), 12, 4),
        cross_bias=jmasks.cross_bias(jnp.asarray(model["x_lens"]), 12, 32),
        position_ids=dec_pos, pm_decoder_positions=dec_pos,
        cross_k=jk, cross_v=jv)
    tmem, tenc = tvoice.encode_text(model["tparams"], tcfg,
                                    *_t(model["x"], model["x_lens"]))
    tk, tv = tt5.build_cross_kv(model["tparams"]["decoder"],
                                tcfg.backbone.decoder, tmem, tenc)
    _close(tk, jk)
    tl = torch.from_numpy(lens)
    tpos = trope.progress_position_ids(tl, 12, 2000.0)
    got, _ = tt5.decoder_forward(
        model["tparams"]["decoder"], tcfg.backbone.decoder,
        inputs_embeds=torch.from_numpy(emb),
        self_full_bias=tmasks.decoder_self_bias(tl, 12),
        self_sliding_bias=tmasks.decoder_sliding_bias(tl, 12, 4),
        cross_bias=tmasks.cross_bias(torch.from_numpy(model["x_lens"]), 12, 32),
        position_ids=tpos, pm_decoder_positions=tpos, cross_k=tk, cross_v=tv)
    _close(got, want)


def _prefill_both(model, kv_cache):
    jd = DecodeConfig(kv_cache=kv_cache, max_frames=256)
    td = tconfig.DecodeConfig(kv_cache=kv_cache, max_frames=256)
    args = (model["x"], model["x_lens"], model["prompt"], model["plens"],
            model["targets"])
    js = jeng.prefill(model["params"], model["jcfg"], jd, *_j(*args))
    ts = teng.prefill(model["tparams"], model["tcfg"], td, *_t(*args))
    return js, ts


def _step_inputs(model, lib, cur_len, token):
    """(embeddings, PM positions) of one step, on either side."""
    if lib == "jax":
        est, _, _ = jeng.decode_budgets(model["jcfg"], *_j(
            model["x_lens"], model["plens"], model["targets"]))
        emb = jvoice.embed_audio(model["params"], jnp.asarray(token)[:, None])
        return emb, jrope.decode_step_position(jnp.asarray(cur_len), est,
                                               2000.0)[:, None]
    est, _, _ = teng.decode_budgets(model["tcfg"], *_t(
        model["x_lens"], model["plens"], model["targets"]))
    emb = tvoice.embed_audio(model["tparams"], torch.from_numpy(token)[:, None])
    return emb, trope.decode_step_position(torch.from_numpy(cur_len), est,
                                           2000.0)[:, None]


def test_dense_prefill_and_decode_steps(model):
    """Dense-cache prefill and three cached steps (per-row write slots)."""
    js, ts = _prefill_both(model, "dense")
    _close(ts.last_hidden, js.last_hidden)
    jcache, tcache = js.cache, ts.cache
    cur = model["plens"] + 1
    dims, tdims = model["jcfg"].backbone.decoder, model["tcfg"].backbone.decoder
    for step in range(3):
        token = model["rng"].integers(0, 128, 3).astype(np.int32)
        jemb, jpos = _step_inputs(model, "jax", cur, token)
        temb, tpos = _step_inputs(model, "torch", cur, token)
        t_max = jcache.self_k.shape[3]
        jh, jcache = jt5.decoder_forward(
            model["params"]["decoder"], dims, inputs_embeds=jemb,
            self_full_bias=jmasks.step_self_bias(jnp.asarray(cur), t_max),
            self_sliding_bias=jmasks.step_self_bias(jnp.asarray(cur), t_max,
                                                    window=512),
            cross_bias=jmasks.cross_bias(jnp.asarray(model["x_lens"]), 1, 32),
            position_ids=jpos, pm_decoder_positions=jpos,
            cross_k=jcache.cross_k, cross_v=jcache.cross_v, cache=jcache,
            cache_pos=jnp.asarray(cur))
        tc = torch.from_numpy(cur)
        th, tcache = tt5.decoder_forward(
            model["tparams"]["decoder"], tdims, inputs_embeds=temb,
            self_full_bias=tmasks.step_self_bias(tc, t_max),
            self_sliding_bias=tmasks.step_self_bias(tc, t_max, window=512),
            cross_bias=tmasks.cross_bias(torch.from_numpy(model["x_lens"]), 1,
                                         32),
            position_ids=tpos, pm_decoder_positions=tpos,
            cross_k=tcache.cross_k, cross_v=tcache.cross_v, cache=tcache,
            cache_pos=tc.long())
        _close(th, jh)
        cur = cur + 1


def _copy_paged_cache(tcache, jcache):
    """Load the JAX cache's slabs, scales and pending block into the port's
    cache, so that each step below starts from identical state (a value
    within f32 noise of a bf16 or int8 rounding edge would otherwise round
    differently on the two sides and carry into later steps)."""
    for name in jcache._fields:
        value = getattr(jcache, name)
        if value is not None:
            setattr(tcache, name,
                    bridge.params_from_jax(np.asarray(value), "cpu"))


@pytest.mark.parametrize("kv_cache", ["paged", "paged_i8"])
def test_paged_prefill_and_decode_steps(model, kv_cache):
    """Paged prefill, then three steps: the pending K/V flush one step
    late into the step-indexed slab, bf16 (or int8) pages and the
    unrounded in-flight token. JAX's paged_i8 step runs the Pallas kernel
    in interpret mode; its bf16 step runs the paged reference."""
    js, ts = _prefill_both(model, kv_cache)
    _close(ts.last_hidden, js.last_hidden)
    jcache, tcache = js.cache, ts.cache
    # the prefill wrote the same pages, up to rounding edges: <= 1 bf16
    # ulp (2**-7 relative, 1e-6 near zero) on bf16 pages, <= 1 level on
    # int8 pages
    for name in ("prompt_k", "prompt_v", "cross_k", "cross_v"):
        got = getattr(tcache, name).float().numpy()
        want = np.asarray(getattr(jcache, name)).astype(np.float32)
        if kv_cache == "paged":
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
        else:
            assert np.abs(got - want).max() <= 1.0, name
    cur = model["plens"] + 1
    offset = model["plens"] + 1
    dims, tdims = model["jcfg"].backbone.decoder, model["tcfg"].backbone.decoder
    for step in range(3):
        _copy_paged_cache(tcache, jcache)
        token = model["rng"].integers(0, 128, 3).astype(np.int32)
        jemb, jpos = _step_inputs(model, "jax", cur, token)
        temb, tpos = _step_inputs(model, "torch", cur, token)
        jh, jcache = jt5.paged_decode_step(
            model["params"]["decoder"], dims, inputs_embeds=jemb,
            position_ids=jpos, pm_decoder_positions=jpos, cache=jcache,
            step=jnp.int32(step), prompt_lengths=jnp.asarray(offset),
            enc_lengths=jnp.asarray(model["x_lens"]))
        th, tcache = tt5.paged_decode_step(
            model["tparams"]["decoder"], tdims, inputs_embeds=temb,
            position_ids=tpos, pm_decoder_positions=tpos, cache=tcache,
            step=step, prompt_lengths=torch.from_numpy(offset),
            enc_lengths=torch.from_numpy(model["x_lens"]))
        _close(th, jh)
        # the new pending K/V is rounded to bf16: <= 1 bf16 ulp
        for name in ("pending_k", "pending_v"):
            np.testing.assert_allclose(
                getattr(tcache, name).float().numpy(),
                np.asarray(getattr(jcache, name)).astype(np.float32),
                rtol=2 ** -7, atol=1e-6)
        # the flush wrote the previous pending block into slot step - 1
        np.testing.assert_array_equal(
            tcache.gen_k.float().numpy(),
            np.asarray(jcache.gen_k).astype(np.float32))
        cur = cur + 1


def test_codec_decode_code():
    cfg = jcodec.tiny_codec_config()
    params = jcodec.init_decoder_params(jax.random.PRNGKey(1), cfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                     "cpu")
    rng = np.random.default_rng(4)
    codes = rng.integers(0, cfg.fsq.codebook_size, (2, 40)).astype(np.int32)
    lens = np.asarray([40, 23], np.int32)
    want = jcodec.decode_code(params, cfg, jnp.asarray(codes), jnp.asarray(lens))
    got = tcodec.decode_code(tparams, tcodec.tiny_codec_config(),
                             torch.from_numpy(codes), torch.from_numpy(lens))
    assert got.shape == want.shape == (2, 40 * cfg.hop_length)
    valid = np.arange(40 * cfg.hop_length)[None] < (lens * cfg.hop_length)[:, None]
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0.0),
                               np.where(valid, np.asarray(want), 0.0),
                               rtol=TOL, atol=TOL)

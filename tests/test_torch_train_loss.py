"""The port's training loss against the JAX package, at the ``test`` preset
in f32: ``prepare_decoder_io`` (exact), ``token_loss`` / ``loss_from_nll``
(loss and mean CE to 1e-5 relative, top-10 hits and counted tokens
exact), ``ops/chunked_ce.head_nll_top10`` forward and backward (nll to
1e-5 relative, hits exact, each gradient within 1e-5 of its leaf's largest
magnitude) and against the port's dense head, and ``voice.forward``'s loss
and gradients against ``jax.grad`` (PM-RoPE on; each leaf within 1e-4 of
its largest gradient), with layer rematerialization changing no gradient.
Same numpy-seeded weights and inputs on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import chunked_ce as jce
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.ops import chunked_ce as tce
from t5gemma_tts_tpu_torch.utils.tree import flatten, keystr, unflatten

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(**kw):
    return jtiny(**kw), ttiny(**kw)


def _batch(rng, cfg, b=3, tx=16, ty=24):
    """x / y with ragged lengths, a y_sep target in row 1 and prefix cuts."""
    batch = dict(
        x=rng.integers(3, 500, (b, tx)).astype(np.int32),
        x_lens=np.asarray([5, tx, 9][:b], np.int32),
        y=rng.integers(0, cfg.audio_vocab_size, (b, ty)).astype(np.int32),
        y_lens=np.asarray([10, ty, 17][:b], np.int32),
        y_sep_position=np.asarray([0, 5, 3][:b], np.int32))
    batch["y"][1, 4] = cfg.special.y_sep
    return batch


def test_prepare_decoder_io_exact():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    y = rng.integers(0, 128, (3, 9)).astype(np.int32)
    y_lens = np.asarray([0, 4, 9], np.int32)
    want = jvoice.prepare_decoder_io(jcfg, jnp.asarray(y), jnp.asarray(y_lens))
    got = tvoice.prepare_decoder_io(tcfg, _t(y), _t(y_lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _loss_inputs(cfg, seed, va, b=3, t=11):
    rng = np.random.default_rng(seed)
    s = cfg.special
    targets = rng.integers(0, cfg.audio_vocab_size, (b, t)).astype(np.int32)
    targets[0, 2] = s.y_sep
    targets[1, 5] = s.eog
    targets[2, 3] = s.eog
    new_y_lens = np.asarray([6, t, 9], np.int32)
    sep = np.asarray([0, 3, 2], np.int32)
    logits = rng.normal(size=(b, t, va)).astype(np.float32) * 3
    nll = rng.random((b, t)).astype(np.float32) * 5
    hit = rng.random((b, t)) < 0.5
    return targets, new_y_lens, sep, logits, nll, hit


@pytest.mark.parametrize("no_loss_on_prefix", [True, False])
@pytest.mark.parametrize("eog_weight", [1.0, 2.5])
def test_token_loss_and_loss_from_nll(no_loss_on_prefix, eog_weight):
    jcfg, tcfg = _cfgs(no_loss_on_prefix=no_loss_on_prefix,
                       eog_weight=eog_weight)
    targets, lens, sep, logits, nll, hit = _loss_inputs(
        jcfg, 1, jcfg.audio_embedding_vocab)
    for sep_in in (sep, None):
        pairs = [
            (jvoice.token_loss(jcfg, jnp.asarray(logits), jnp.asarray(targets),
                               jnp.asarray(lens), None if sep_in is None
                               else jnp.asarray(sep_in)),
             tvoice.token_loss(tcfg, _t(logits), _t(targets), _t(lens),
                               None if sep_in is None else _t(sep_in))),
            (jvoice.loss_from_nll(jcfg, jnp.asarray(nll), jnp.asarray(hit),
                                  jnp.asarray(targets), jnp.asarray(lens),
                                  None if sep_in is None
                                  else jnp.asarray(sep_in)),
             tvoice.loss_from_nll(tcfg, _t(nll), _t(hit), _t(targets),
                                  _t(lens), None if sep_in is None
                                  else _t(sep_in))),
        ]
        for want, got in pairs:
            for f in ("loss", "mean_ce", "perplexity"):
                np.testing.assert_allclose(float(getattr(got, f)),
                                           float(getattr(want, f)),
                                           rtol=1e-5, err_msg=f)
            assert int(got.top10acc) == int(want.top10acc)
            assert int(got.effective_ntokens) == int(want.effective_ntokens)


def _head(rng, d, va):
    return {"w1": rng.normal(size=(d, d)).astype(np.float32) * 0.2,
            "b1": rng.normal(size=(d,)).astype(np.float32) * 0.1,
            "w2": rng.normal(size=(d, va)).astype(np.float32) * 0.2,
            "b2": rng.normal(size=(va,)).astype(np.float32) * 0.1}


def _port_nll_grads(fn, head, hidden, targets, cot):
    th = {k: _t(v).requires_grad_(True) for k, v in head.items()}
    hid = _t(hidden).requires_grad_(True)
    nll, hit = fn(th, hid, _t(targets))
    grads = torch.autograd.grad((nll * _t(cot)).sum(),
                                [th[k] for k in sorted(th)] + [hid])
    return nll, hit, dict(zip(sorted(th) + ["hidden"], grads))


def test_chunked_ce_matches_jax_forward_and_grad():
    rng = np.random.default_rng(2)
    d, va, chunk = 32, 133, 50          # 50 does not divide 133
    head = _head(rng, d, va)
    hidden = rng.normal(size=(2, 7, d)).astype(np.float32)
    targets = rng.integers(0, va, (2, 7)).astype(np.int32)
    cot = rng.random((2, 7)).astype(np.float32)

    def jloss(h, x):
        nll, _ = jce.head_nll_top10(chunk, h, x, jnp.asarray(targets))
        return (nll * jnp.asarray(cot)).sum()

    jh = {k: jnp.asarray(v) for k, v in head.items()}
    jnll, jhit = jax.jit(lambda h, x: jce.head_nll_top10(
        chunk, h, x, jnp.asarray(targets)))(jh, jnp.asarray(hidden))
    jgh, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jh, jnp.asarray(hidden))
    want = dict(jgh, hidden=jgx)

    nll, hit, got = _port_nll_grads(
        lambda h, x, t: tce.head_nll_top10(chunk, h, x, t), head, hidden,
        targets, cot)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=1e-5)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    for k, g in got.items():
        w = np.asarray(want[k])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_chunked_ce_matches_dense_head_in_port():
    """The chunked form against the port's dense head + log-softmax, with
    a chunk that does not divide the vocab."""
    rng = np.random.default_rng(3)
    d, va, chunk = 24, 101, 32
    head = _head(rng, d, va)
    hidden = rng.normal(size=(3, 5, d)).astype(np.float32)
    targets = rng.integers(0, va, (3, 5)).astype(np.int32)
    cot = rng.random((3, 5)).astype(np.float32)

    def dense(h, x, t):
        logits = tvoice.predict_head(h, x).float()
        nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                            t.long()[..., None])[..., 0]
        top = torch.topk(logits, 10, dim=-1).indices
        return nll, (top == t.long()[..., None]).any(-1)

    nll_c, hit_c, g_c = _port_nll_grads(
        lambda h, x, t: tce.head_nll_top10(chunk, h, x, t), head, hidden,
        targets, cot)
    nll_d, hit_d, g_d = _port_nll_grads(dense, head, hidden, targets, cot)
    np.testing.assert_allclose(nll_c.detach().numpy(),
                               nll_d.detach().numpy(), rtol=1e-5)
    np.testing.assert_array_equal(hit_c.numpy(), hit_d.numpy())
    for k in g_c:
        w = g_d[k].numpy()
        assert np.abs(g_c[k].numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs(ce_vocab_chunk=50, no_loss_on_prefix=True,
                       eog_weight=2.0)
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    batch = _batch(np.random.default_rng(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, np_params=np_params,
                batch=batch)


def _port_forward_grads(model, cfg):
    tp = bridge.params_from_jax(model["np_params"], "cpu")
    paths, leaves = flatten(tp)
    live = [t.detach().requires_grad_(True) for t in leaves]
    out = tvoice.forward(unflatten(tp, live), cfg,
                         {k: _t(v) for k, v in model["batch"].items()})
    grads = torch.autograd.grad(out.loss, live)
    return out, {keystr(p): g for p, g in zip(paths, grads)}


@pytest.mark.parametrize("chunked", [True, False])
def test_forward_loss_and_grads_match_jax(model, chunked):
    jcfg = model["jcfg"]
    tcfg = model["tcfg"]
    if not chunked:
        jcfg = dataclasses.replace(jcfg, ce_vocab_chunk=0)
        tcfg = dataclasses.replace(tcfg, ce_vocab_chunk=0)
    assert jcfg.use_pm_rope and tcfg.use_pm_rope
    jb = {k: jnp.asarray(v) for k, v in model["batch"].items()}

    def loss_fn(p):
        out = jvoice.forward(p, jcfg, jb)
        return out.loss, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        model["params"])
    out, grads = _port_forward_grads(model, tcfg)
    for f in ("loss", "mean_ce"):
        np.testing.assert_allclose(float(getattr(out, f).detach()),
                                   float(getattr(jout, f)), rtol=1e-5)
    assert int(out.top10acc) == int(jout.top10acc)
    assert int(out.effective_ntokens) == int(jout.effective_ntokens)
    want = {keystr(tuple(k.key for k in p)): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k]
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                         1e-30), k


def test_gradient_checkpointing_changes_no_gradient(model):
    out0, g0 = _port_forward_grads(model, model["tcfg"])
    out1, g1 = _port_forward_grads(
        model, dataclasses.replace(model["tcfg"], gradient_checkpointing=True))
    assert float(out0.loss.detach()) == float(out1.loss.detach())
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)

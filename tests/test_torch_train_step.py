"""The port's LoRA and train steps against the JAX package's, at the
``test`` preset in f32, from the same weights (and adapters) through
``bridge``: LoRA's target selection, zero-init forward, ``wrap`` against
``apply`` and ``merge``; three LoRA steps and three full steps of two
micro-batches each against ``make_lora_train_step`` / ``make_train_step``
(ScaledAdam, clipping refreshed every 4 steps); a step with one non-finite
micro-batch skipped by both.

Tolerances. Metrics each step to 1e-5 relative. Adapters and parameters
to 1e-5 relative in each leaf's Frobenius norm: Adam-type updates
normalize each element by its own gradient's magnitude, so an element
whose token-weighted gradient sums to within f32 rounding of zero moves by
up to a step in either direction, and elementwise-relative bounds would
measure those few elements' rounding, not the port."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.train import lora as jlora
from t5gemma_tts_tpu.train import optim as jopt
from t5gemma_tts_tpu.train import train_step as jts
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.train import lora as tlora
from t5gemma_tts_tpu_torch.train import optim as topt
from t5gemma_tts_tpu_torch.train import train_step as tts
from t5gemma_tts_tpu_torch.utils.tree import keystr, leaves_with_path

torch.set_num_threads(1)
LR = 0.01


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, n_micro=2, b=2, tx=12, ty=20):
    return dict(
        x=rng.integers(3, 500, (n_micro, b, tx)).astype(np.int32),
        x_lens=rng.integers(4, tx + 1, (n_micro, b)).astype(np.int32),
        y=rng.integers(0, 128, (n_micro, b, ty)).astype(np.int32),
        y_lens=rng.integers(5, ty + 1, (n_micro, b)).astype(np.int32),
        y_sep_position=np.zeros((n_micro, b), np.int32))


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _frobenius_close(want, got, rtol=1e-5):
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = list(leaves_with_path(got))
    assert len(jl) == len(tl)
    for (_, a), (path, b) in zip(jl, tl):
        a = np.asarray(a, np.float64)
        b = b.detach().numpy().astype(np.float64)
        assert np.linalg.norm(a - b) <= rtol * max(np.linalg.norm(a), 1e-30), \
            keystr(path)


def _metrics_close(jm, tm):
    for f in ("loss", "mean_ce", "perplexity", "top10acc", "ntokens",
              "grad_norm"):
        np.testing.assert_allclose(float(getattr(tm, f)),
                                   float(getattr(jm, f)), rtol=1e-5,
                                   err_msg=f)
    assert int(tm.nan_step) == int(jm.nan_step)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jtiny(), ttiny()
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    ocj = jopt.ScaledAdamConfig(clipping_update_period=4)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, np_params=_np(params),
                batches=[_batch(rng) for _ in range(3)], ocj=ocj,
                oct=topt.ScaledAdamConfig(clipping_update_period=4),
                jstep=jax.jit(jts.make_train_step(jcfg, ocj)))


def _tparams(model):
    return bridge.params_from_jax(model["np_params"], "cpu")


def test_param_count_breakdown_matches_jax(model):
    from t5gemma_tts_tpu.utils.profiling import param_count_breakdown as jpc
    from t5gemma_tts_tpu_torch.utils.profiling import param_count_breakdown

    assert param_count_breakdown(_tparams(model)) == jpc(model["params"])


def test_is_target_selects_the_same_leaves(model):
    jc, tc = jlora.LoraConfig(), tlora.LoraConfig()
    want = [keystr(tuple(k.key for k in p))
            for p, _ in jax.tree_util.tree_flatten_with_path(model["params"])[0]
            if jlora._is_target(p, jc)]
    got = [keystr(p) for p, _ in leaves_with_path(_tparams(model))
           if tlora._is_target(p, tc)]
    assert got == want and len(got) == 18


def test_zero_init_forward_equals_base_and_wrap_equals_apply(model):
    tcfg = model["tcfg"]
    tp = _tparams(model)
    lc = tlora.LoraConfig(r=4, alpha=8)
    ads = tlora.init_adapters(torch.Generator().manual_seed(0), tp, lc)
    mb = {k: v[0] for k, v in _t(model["batches"][0]).items()}
    base = tvoice.forward(tp, tcfg, mb)
    zero = tvoice.forward(tlora.wrap(tp, ads, lc), tcfg, mb)
    assert float(zero.loss) == float(base.loss)
    moved = tlora._combine_trees(tp, ads, lambda p, a: None if a is None else
                                 {"a": a["a"], "b": a["b"] + 0.05})
    wrapped = tvoice.forward(tlora.wrap(tp, moved, lc), tcfg, mb)
    applied = tvoice.forward(tlora.apply(tp, moved, lc), tcfg, mb)
    assert float(wrapped.loss) != float(base.loss)
    np.testing.assert_allclose(float(wrapped.loss), float(applied.loss),
                               rtol=1e-5)


def _adapters(model):
    jc = jlora.LoraConfig(r=4, alpha=8)
    ads = jlora.init_adapters(jax.random.PRNGKey(3), model["params"], jc)
    # B != 0, so the adapters take part in the forward from the start
    return jc, jax.tree_util.tree_map(lambda x: x + 0.01, ads)


def test_merge_matches_jax(model):
    jc, ads = _adapters(model)
    want = jlora.merge(model["params"], ads, jc)
    got = tlora.merge(_tparams(model), bridge.params_from_jax(_np(ads), "cpu"),
                      tlora.LoraConfig(r=4, alpha=8))
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                              leaves_with_path(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_lora_train_steps_match_jax(model):
    jc, ads = _adapters(model)
    tc = tlora.LoraConfig(r=4, alpha=8)
    ocj = jopt.ScaledAdamConfig(clipping_update_period=4)
    oct_ = topt.ScaledAdamConfig(clipping_update_period=4)
    jstep = jax.jit(jts.make_lora_train_step(model["jcfg"], ocj, jc))
    tstep = tts.make_lora_train_step(model["tcfg"], oct_, tc)
    jads, jo = ads, jopt.init(ads, ocj)
    tp = _tparams(model)
    base_before = [t.clone() for _, t in leaves_with_path(tp)]
    tads = bridge.params_from_jax(_np(ads), "cpu")
    to_ = topt.init(tads, oct_)
    for batch in model["batches"]:
        jads, jo, jm = jstep(jads, jo, model["params"], _j(batch),
                             jnp.float32(LR))
        tads, to_, tm = tstep(tads, to_, tp, _t(batch), torch.tensor(LR))
        _metrics_close(jm, tm)
    _frobenius_close(jads, tads)
    assert int(to_.step) == 3
    # only the adapters moved: the base is bit-unchanged
    for before, (_, after) in zip(base_before, leaves_with_path(tp)):
        assert torch.equal(before, after)


def test_train_steps_match_jax(model):
    ocj, oct_, jstep = model["ocj"], model["oct"], model["jstep"]
    tstep = tts.make_train_step(model["tcfg"], oct_)
    js = jts.init_state(model["params"], ocj)
    ts = tts.init_state(_tparams(model), oct_)
    for batch in model["batches"]:
        js, jm = jstep(js, _j(batch), jnp.float32(LR))
        ts, tm = tstep(ts, _t(batch), torch.tensor(LR))
        _metrics_close(jm, tm)
    _frobenius_close(js.params, ts.params)
    assert int(ts.step) == 3 and int(ts.nan_skips) == 0


def test_non_finite_micro_batch_is_skipped_in_both(model):
    """A NaN in the audio embedding row of a token that only the second
    micro-batch reads: both steps skip, keep params and optimizer state,
    and count one skip."""
    batch = _batch(np.random.default_rng(7))
    batch["y"][0] = np.where(batch["y"][0] == 77, 78, batch["y"][0])
    batch["y"][1, 0, 0] = 77
    np_params = dict(model["np_params"])
    emb = np_params["audio_embed"].copy()
    emb[77] = np.nan
    np_params["audio_embed"] = emb
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    ocj, oct_ = model["ocj"], model["oct"]
    js0 = jts.init_state(params, ocj)
    js, jm = model["jstep"](js0, _j(batch), jnp.float32(LR))
    ts0 = tts.init_state(bridge.params_from_jax(np_params, "cpu"), oct_)
    ts, tm = tts.make_train_step(model["tcfg"], oct_)(ts0, _t(batch),
                                                      torch.tensor(LR))
    assert int(jm.nan_step) == int(tm.nan_step) == 1
    assert int(js.nan_skips) == int(ts.nan_skips) == 1
    assert not np.isfinite(float(tm.grad_norm))
    # params and optimizer state as they were (NaN where they held NaN)
    for a, b in zip(jax.tree_util.tree_leaves((js0.params, js0.opt)),
                    jax.tree_util.tree_leaves((js.params, js.opt))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for (_, a), (_, b) in zip(leaves_with_path((ts0.params, ts0.opt)),
                              leaves_with_path((ts.params, ts.opt))):
        np.testing.assert_array_equal(b.numpy(), a.numpy())

"""The port's optimizers against the JAX package's on the same gradients:
ScaledAdam over 12 updates with ``size_update_period`` 4 and
``clipping_update_period`` 4 (so the clip refresh, the rms / learned-scale
step and plain Adam on scalarish leaves all run), AdamW and Eve over 5
(the port taking over the JAX state after 2, through
``bridge.opt_state_from_jax``), params and every state leaf to 1e-5
relative (of the leaf's largest magnitude); the Eden and linear warmup-decay schedules at 20 steps; and
``dominant_parameter_report`` naming the same leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.train import optim as jo
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.train import optim as to
from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

torch.set_num_threads(1)


def _tree(rng):
    """Stacked leaves (under "layers"), a stacked scalarish leaf, plain
    leaves, a scalar, a leaf far above param_max_rms and one below
    param_min_rms."""
    return {
        "enc": {"layers": {
            "w": rng.normal(size=(3, 8, 6)).astype(np.float32),
            "norm": rng.normal(size=(3,)).astype(np.float32) * 0.1,
            "big": rng.normal(size=(3, 4, 5)).astype(np.float32) * 5}},
        "head": {"w1": rng.normal(size=(8, 8)).astype(np.float32) * 0.02,
                 "b1": np.zeros(8, np.float32),
                 "s": np.asarray(0.5, np.float32),
                 "tiny": rng.normal(size=(4,)).astype(np.float32) * 1e-7},
    }


def _grads(rng, tree, n):
    # step 6 carries a 6x gradient, so the refreshed clip threshold clips
    return [jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32)
        * (6.0 if i == 6 else 1.0), tree) for i in range(n)]


def _assert_trees_close(want, got, rtol=1e-5):
    jl = jax.tree_util.tree_leaves(want)
    tl = [leaf for _, leaf in leaves_with_path(got)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-30)


def _run(j_init, j_upd, t_init, t_upd, n, lr, handover=0):
    """``n`` updates on both sides; with ``handover`` the port starts from
    the JAX params and state after that many (``bridge``)."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = _grads(rng, tree, n)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = j_init(jp)
    tp = bridge.params_from_jax(tree, "cpu")
    ts = t_init(tp)
    for i, g in enumerate(grads):
        if handover and i == handover:
            tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                        "cpu")
            ts = bridge.opt_state_from_jax(
                jax.tree_util.tree_map(np.asarray, js), "cpu")
        jp, js = j_upd(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                       jnp.float32(lr))
        if not handover or i >= handover:
            tp, ts = t_upd(bridge.params_from_jax(g, "cpu"), ts, tp,
                           torch.tensor(lr))
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("handover", [0, 6])
def test_scaled_adam_trajectory(handover):
    """From the same params (handover 0), or from the JAX state after 6
    updates carried over by ``bridge.opt_state_from_jax``."""
    jc = jo.ScaledAdamConfig(size_update_period=4, clipping_update_period=4)
    tc = to.ScaledAdamConfig(size_update_period=4, clipping_update_period=4)
    want, got = _run(lambda p: jo.init(p, jc),
                     jax.jit(lambda g, s, p, lr: jo.update(g, s, p, lr, jc)),
                     lambda p: to.init(p, tc),
                     lambda g, s, p, lr: to.update(g, s, p, lr, tc), 12, 0.03,
                     handover)
    assert int(got[1].step) == 12
    assert float(got[1].norm_threshold) > 0      # the clip refresh ran
    _assert_trees_close(want, got)


@pytest.mark.parametrize("name", ["adamw", "eve"])
def test_adamw_and_eve_trajectories(name):
    if name == "adamw":
        jc, tc = jo.AdamWConfig(), to.AdamWConfig()
        fns = (jo.adamw_init, lambda g, s, p, lr: jo.adamw_update(g, s, p, lr,
                                                                  jc),
               to.adamw_init, lambda g, s, p, lr: to.adamw_update(g, s, p, lr,
                                                                  tc))
    else:
        jc, tc = jo.EveConfig(), to.EveConfig()
        fns = (jo.eve_init, lambda g, s, p, lr: jo.eve_update(g, s, p, lr, jc),
               to.eve_init, lambda g, s, p, lr: to.eve_update(g, s, p, lr, tc))
    want, got = _run(*fns, 5, 1e-2, handover=2)
    _assert_trees_close(want, got)


def test_schedules_match_jax():
    for step in range(20):
        for args in ((0.035, step, step // 7 + 1, 5.0, 2.0, 4.0),
                     (0.01, step, 1, 3000.0, 4.0, 0.0)):
            np.testing.assert_allclose(float(to.eden_lr(*args)),
                                       float(jo.eden_lr(*args)), rtol=1e-6)
        np.testing.assert_allclose(
            float(to.linear_warmup_decay_lr(1e-3, step, 20, 4.0)),
            float(jo.linear_warmup_decay_lr(1e-3, step, 20, 4.0)),
            rtol=1e-6, atol=1e-12)


def test_dominant_parameter_report_names_the_same_leaves():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    g = _grads(rng, tree, 1)[0]
    g["enc"]["layers"]["w"] *= 40.0
    cfg_j, cfg_t = jo.ScaledAdamConfig(), to.ScaledAdamConfig()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jo.dominant_parameter_report(
        jax.tree_util.tree_map(jnp.asarray, g), jo.init(jp, cfg_j), jp)
    tp = bridge.params_from_jax(tree, "cpu")
    got = to.dominant_parameter_report(bridge.params_from_jax(g, "cpu"),
                                       to.init(tp, cfg_t), tp)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert got[0]["name"] == "['enc']['layers']['w']"
    for r, w in zip(got, want):
        for k in ("proportion", "sumsq", "grad_sumsq", "rms_sq"):
            np.testing.assert_allclose(r[k], w[k], rtol=1e-5)

"""The port's decode engine against the JAX package's: greedy (top_k=1)
token traces and generated lengths are array-equal for the dense, paged and
paged_i8 caches. JAX's paged_i8 decode runs the Pallas batch kernel in
interpret mode; its paged decode runs the paged reference on the CPU; the
port runs the kernel's plain version on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, backbone_preset, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import engine as teng

torch.set_num_threads(1)
MAX_FRAMES = 64


def _cfg(preset, tiny):
    """The test preset with the whole paged cache inside the sliding window
    and a short duration tail, so that rows stop on their own budgets at
    different steps."""
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, extra_cutoff=0.3)


def _torch_cfg():
    return _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(backbone_preset, tiny_voice_config)
    tcfg = _torch_cfg()
    params = jvoice.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    b = 3
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([4, 19, 32], np.int32)
    prompt = np.full((b, 64), jcfg.special.pad, np.int32)
    plens = np.asarray([0, 12, 30], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([10, 30, 20], np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams,
                inputs=(x, x_lens, prompt, plens, targets))


@pytest.mark.parametrize("kv_cache", ["dense", "paged", "paged_i8"])
def test_greedy_token_traces_equal(setup, kv_cache):
    jd = DecodeConfig(top_k=1, kv_cache=kv_cache, max_frames=MAX_FRAMES)
    td = tconfig.DecodeConfig(top_k=1, kv_cache=kv_cache,
                              max_frames=MAX_FRAMES)
    want = jeng.decode_tokens(
        setup["params"], setup["jcfg"], jd,
        *(jnp.asarray(a) for a in setup["inputs"]), jax.random.PRNGKey(0))
    got = teng.decode_tokens(
        setup["tparams"], setup["tcfg"], td,
        *(torch.from_numpy(a) for a in setup["inputs"]),
        0)
    want_lens = np.asarray(want.gen_lens)
    # the rows stop at different steps, before the buffer's end
    assert len(set(want_lens.tolist())) == 3 and want_lens.max() < MAX_FRAMES
    np.testing.assert_array_equal(got.gen_lens.numpy(), want_lens)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)


def test_resolve_kv_mode():
    """auto takes the paged cache only on CUDA and only when it fits the
    sliding window; explicit paged modes (float8 pages among them) are
    kept when they fit and raise when they do not."""
    cfg = _torch_cfg()
    dc = tconfig.DecodeConfig()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert teng.resolve_kv_mode(cfg, dc, 65, 256, cpu) == "dense"
    assert teng.resolve_kv_mode(cfg, dc, 65, 256, cuda) == "paged"
    assert teng.resolve_kv_mode(cfg, dc, 65, 512, cuda) == "dense"
    for mode in ("paged", "paged_i8", "paged_f8"):
        d = tconfig.DecodeConfig(kv_cache=mode)
        assert teng.resolve_kv_mode(cfg, d, 65, 256, cpu) == mode
        with pytest.raises(ValueError):
            teng.resolve_kv_mode(cfg, d, 65, 512, cpu)

"""The port's v1 fused decode attention and attention-mode selector against
the JAX package.

- ``fused_decode_attention`` (on the CPU its plain version, the kernel's
  counterpart) against the JAX ``fused_decode_attention(interpret=True)``,
  the Pallas kernel in interpret mode, as tests/test_fused_attn.py runs it:
  bf16 and float8 e4m3 pages, soft cap on and off, rows with an empty
  prompt segment and an empty generation segment, page tables addressing
  other layers of a multi-layer buffer, G = 1, 2 and 8 (the JAX kernel's
  aligned branch). 1e-5 absolute on the f32 output (sums in another order).
- The selector (``T5G_FUSED_ATTN``): the paged decode step in modes 0, 1
  and 2 gives the same hidden states within 1e-5 over bf16 and float8
  pages, and greedy traces token-equal to the JAX engine (which runs mode
  0 on the CPU); int8 pages take mode 2 whatever mode 0 or 1 asks; the
  verify pass takes ``decode_stack`` only by the JAX rule
  ``(mode == 3 or int8 pages) and megakernel.supports``.

The hand-written kernel is held to the plain version on a card by
tests/test_torch_slice5_cuda.py, which imports no JAX, and by
``chip_smoke.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig, tiny_voice_config
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import fused_attn as jfa
from t5gemma_tts_tpu.ops import paged_attn as jpa
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.decode import speculative as tspec
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.ops import fused_attn as tfa
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import paged_attn as tpa
from t5gemma_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
PS = 128
ABS = 1e-5
MAX_FRAMES = 48
DTYPES = {"bf16": jnp.bfloat16, "f8": jnp.float8_e4m3fn}


def _t(x):
    return bridge.params_from_jax(np.asarray(x), "cpu")


def _case(seed, dtype, *, b=3, h=4, hkv=2, hd=16, ppp=2, ppg=2, layers=2,
          li=1, plens=(0, 100, 200), glens=(7, 0, 130)):
    """numpy inputs of one call; page tables address layer ``li`` of a
    buffer holding ``layers`` layers' pages."""
    rng = np.random.default_rng(seed)

    def pages(n):
        x = rng.standard_normal((hkv, n, PS, hd)).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(DTYPES[dtype]))

    def table(pp):
        return (np.asarray(jpa.identity_page_indices(b, pp))
                + li * b * pp).astype(np.int32)

    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, hd)).astype(np.float32),
            pages(layers * b * ppp), pages(layers * b * ppp),
            pages(layers * b * ppg), pages(layers * b * ppg),
            np.asarray(plens, np.int32), np.asarray(glens, np.int32),
            table(ppp), table(ppg))


CASES = {
    # G = 2 over hd 16, rows with plen 0 and with glen 0, layer 1 of 2
    "g2": {},
    # G = 1, both segments empty in one row (the in-flight token alone)
    "g1-empty": dict(h=2, hkv=2, plens=(0, 128, 1), glens=(0, 256, 129)),
    # G = 8: the JAX kernel's aligned branch, hd 128, layer 2 of 3
    "g8": dict(b=2, h=8, hkv=1, hd=128, layers=3, li=2, plens=(40, 0),
               glens=(0, 250)),
}


@pytest.mark.parametrize("dtype", ["bf16", "f8"])
@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_decode_attention_matches_jax(dtype, cap, name):
    args = _case(len(name), dtype, **CASES[name])
    want = jfa.fused_decode_attention(*map(jnp.asarray, args),
                                      attn_logits_soft_cap=cap,
                                      interpret=True)
    before = tfa.fused_decode_attention.launches
    got = tfa.fused_decode_attention(*map(_t, args),
                                     attn_logits_soft_cap=cap)
    assert tfa.fused_decode_attention.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ABS)


def test_no_clamp_of_an_empty_prompt_segment():
    """An empty prompt segment reads no page (the two-segment kernel clamps
    its segment A to one token): with both segments empty the output is
    the in-flight token's v, whatever the pages hold."""
    args = list(map(_t, _case(3, "bf16", plens=(0, 0, 0), glens=(0, 0, 0))))
    got = tfa.fused_decode_attention(*args, attn_logits_soft_cap=50.0)
    b, h, hd = got.shape
    hkv = args[1].shape[1]
    want = args[2][:, :, None].expand(b, hkv, h // hkv, hd).reshape(b, h, hd)
    assert torch.equal(got, want)
    clamped = tfa.batch_paged_attention(*args[:9], args[9], args[10],
                                        attn_logits_soft_cap=50.0,
                                        include_current=True)
    assert not torch.allclose(clamped, want)


def test_wrapper_refuses_int8_pages_and_other_devices():
    args = list(map(_t, _case(4, "bf16")))
    for i in (3, 4, 5, 6):
        bad = list(args)
        bad[i] = torch.zeros(args[i].shape, dtype=torch.int8)
        with pytest.raises(ValueError, match="int8"):
            tfa.fused_decode_attention(*bad)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        tfa.fused_decode_attention(*meta)


# ---------------------------------------------------------------------------
# the selector
# ---------------------------------------------------------------------------


def _cfg(tiny):
    bb = tiny().backbone
    bb = dataclasses.replace(
        bb, encoder=dataclasses.replace(bb.encoder, sliding_window=512),
        decoder=dataclasses.replace(bb.decoder, sliding_window=512))
    return dataclasses.replace(tiny(backbone=bb), extra_cutoff=0.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg(tiny_voice_config)
    params = jax.tree_util.tree_map(
        np.asarray, jvoice.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    b = 2
    inputs = (rng.integers(3, jcfg.text_vocab_size, (b, 12)).astype(np.int32),
              np.asarray([12, 9], np.int32),
              rng.integers(0, jcfg.audio_vocab_size, (b, 5)).astype(np.int32),
              np.asarray([5, 0], np.int32), np.asarray([40, 30], np.int32))
    return dict(jcfg=jcfg, params=params, tcfg=_cfg(tconfig.tiny_voice_config),
                tparams=bridge.params_from_jax(params, "cpu"), inputs=inputs)


@pytest.fixture(scope="module")
def jax_traces(setup):
    """The JAX engine's greedy traces per page type (T5G_FUSED_ATTN unset:
    mode 0 on the CPU)."""
    names = ("x", "x_lens", "prompt", "prompt_lens", "target_totals")
    inputs = dict(zip(names, map(jnp.asarray, setup["inputs"])))
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("T5G_FUSED_ATTN", raising=False)
        for kv in ("paged", "paged_f8"):
            jd = DecodeConfig(top_k=1, kv_cache=kv, max_frames=MAX_FRAMES)
            res = jax.jit(functools.partial(jeng.decode_tokens,
                                            cfg=setup["jcfg"], dcfg=jd))(
                params, rng=jax.random.PRNGKey(7), **inputs)
            out[kv] = (np.asarray(res.tokens), np.asarray(res.gen_lens))
    return out


def _decode(setup, params, kv, monkeypatch, mode, hidden=None,
            max_frames=MAX_FRAMES):
    """The port's greedy decode with T5G_FUSED_ATTN = ``mode``; with
    ``hidden`` each step's last hidden state is appended to it."""
    monkeypatch.setenv("T5G_FUSED_ATTN", mode)
    if hidden is not None:
        head = teng.voice.predict_head

        def recorded(h, x):
            hidden.append(x.float().clone())
            return head(h, x)

        monkeypatch.setattr(teng.voice, "predict_head", recorded)
    try:
        return teng.decode_tokens(
            params, setup["tcfg"],
            tconfig.DecodeConfig(top_k=1, kv_cache=kv, max_frames=max_frames),
            *(torch.from_numpy(a) for a in setup["inputs"]), 7)
    finally:
        monkeypatch.undo()


def _counting(monkeypatch):
    calls = {"batch": 0, "v1": 0, "parts": 0, "gqa": 0, "stack": 0}

    def count(key, mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    count("batch", tfa, "batch_paged_attention")
    count("v1", tfa, "fused_decode_attention")
    count("parts", tpa, "paged_flash_parts")
    count("gqa", tpa, "paged_gqa_attention")
    count("stack", tmk, "decode_stack")
    return calls


@pytest.mark.parametrize("kv", ["paged", "paged_f8"])
def test_modes_agree_and_equal_jax(setup, jax_traces, kv, monkeypatch):
    """Modes 0, 1 and 2 (and the default 3, which falls to 2 for bf16
    weights): hidden states within 1e-5 of each other at every step, and
    greedy traces token-equal to the JAX engine's mode 0."""
    want, want_lens = jax_traces[kv]
    hidden, traces = {}, {}
    for mode in ("0", "1", "2", "3"):
        hidden[mode] = []
        traces[mode] = _decode(setup, setup["tparams"], kv, monkeypatch,
                               mode, hidden[mode])
        np.testing.assert_array_equal(traces[mode].tokens.numpy(), want,
                                      err_msg=mode)
        np.testing.assert_array_equal(traces[mode].gen_lens.numpy(),
                                      want_lens, err_msg=mode)
    for mode in ("1", "2", "3"):
        assert len(hidden[mode]) == len(hidden["0"]) > 1
        for a, b in zip(hidden[mode], hidden["0"]):
            assert float((a - b).abs().max()) <= ABS * max(
                1.0, float(b.abs().max())), mode


@pytest.mark.parametrize("kv", ["paged", "paged_f8", "paged_i8"])
@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_modes_take_their_kernels(setup, kv, mode, monkeypatch):
    """Per step and layer: mode 0 runs two one-segment launches for self
    attention and one for cross attention, mode 1 the v1 kernel and the
    one-segment cross, mode 2 the two-segment kernel twice; int8 pages
    take mode 2 whatever mode 0 or 1 asks."""
    calls = _counting(monkeypatch)
    monkeypatch.setenv("T5G_FUSED_ATTN", mode)
    out = teng.decode_tokens(
        setup["tparams"], setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache=kv, max_frames=6),
        *(torch.from_numpy(a) for a in setup["inputs"]), 7)
    n = setup["tcfg"].backbone.decoder.num_layers * out.steps
    taken = "2" if kv == "paged_i8" else mode
    want = {"0": dict(batch=0, v1=0, parts=2 * n, gqa=n, stack=0),
            "1": dict(batch=0, v1=n, parts=0, gqa=n, stack=0),
            "2": dict(batch=2 * n, v1=0, parts=0, gqa=0, stack=0)}[taken]
    assert calls == want, (kv, mode, calls)


def test_selector_refuses_unknown_modes(setup, monkeypatch):
    cache = tt5.init_paged_cache(setup["tcfg"].backbone.decoder, 1, 1, 1, 1)
    monkeypatch.setenv("T5G_FUSED_ATTN", "4")
    with pytest.raises(ValueError, match="T5G_FUSED_ATTN"):
        tt5._fused_attn_mode(cache)
    monkeypatch.delenv("T5G_FUSED_ATTN")
    assert tt5._fused_attn_mode(cache) == 3


@pytest.mark.parametrize("kv,mode,stack", [
    ("paged", "3", True), ("paged", "2", False), ("paged", "1", False),
    ("paged", "0", False), ("paged_i8", "0", True), ("paged_i8", "3", True)])
def test_verify_pass_takes_decode_stack_by_the_jax_rule(setup, kv, mode,
                                                        stack, monkeypatch):
    """With W8A8 weights the verify pass is one decode_stack call when
    ``(mode == 3 or int8 pages) and supports``, else the unfused chain
    (two one-segment launches and one cross launch a layer). (The W8A8
    chain rounds otherwise than the W8A8 step, so the streams may part:
    speculative == sequential is held where both take the unfused path,
    tests/test_torch_speculative.py and tests/test_torch_w8a16.py.)"""
    params = tquant.quantize_params_for_decode(
        tt5.fuse_for_decode(setup["tparams"]))
    seq = _decode(setup, params, kv, monkeypatch, "3", max_frames=12)
    calls = _counting(monkeypatch)
    monkeypatch.setenv("T5G_FUSED_ATTN", mode)
    got = tspec.decode_tokens_speculative(
        params, setup["tcfg"],
        tconfig.DecodeConfig(top_k=1, kv_cache=kv, max_frames=12),
        *(torch.from_numpy(a) for a in setup["inputs"]), 7,
        tspec.trace_draft_fn(seq.tokens, 4), 4)
    assert got.passes < got.steps
    layers = setup["tcfg"].backbone.decoder.num_layers
    if stack:
        assert calls["stack"] == got.passes and calls["parts"] == 0
    else:
        assert calls["stack"] == 0
        assert calls["parts"] == 2 * layers * got.passes
        assert calls["gqa"] == layers * got.passes

"""The port's loaders against the JAX package's, on the CPU.

A tiny port ``Trainer`` runs two full-model steps and then two LoRA steps
over the full run's parameters. ``load_voice_model`` reads the full run's
experiment directory bit-equal to the trainer's parameters, and its
config equals the JAX ``voice_config_from_json`` of the same
``config.json``; a LoRA run's bundle and an orbax bundle are refused,
naming the export that reaches each; the export's ``--lora_bundle`` merge
equals the port's ``lora.merge`` and is byte-equal to the JAX export of the
JAX merge; greedy tokens of the loaded models equal the in-memory ones.
A reference ``.pth`` with and without peft LoRA keys loads as in JAX, a
leftover key raises under ``strict`` in both, and the reference-bundle
converter writes the JAX tool's bytes. ``copy_codebase`` copies the JAX
snapshot's file set, without the kernel build directory."""

import argparse
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.export import hf_export as jexport
from t5gemma_tts_tpu.inference import loading as jloading
from t5gemma_tts_tpu.models import convert as jconvert
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.train import lora as jlora
from t5gemma_tts_tpu.utils import snapshot as jsnapshot
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.config import DecodeConfig
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
from t5gemma_tts_tpu_torch.data.manifest import DataConfig
from t5gemma_tts_tpu_torch.decode import engine
from t5gemma_tts_tpu_torch.export import convert_reference_bundle
from t5gemma_tts_tpu_torch.export import hf_export
from t5gemma_tts_tpu_torch.inference import loading
from t5gemma_tts_tpu_torch.models import convert
from t5gemma_tts_tpu_torch.train import checkpoint as ckpt
from t5gemma_tts_tpu_torch.train import lora
from t5gemma_tts_tpu_torch.train import trainer as ttrainer
from t5gemma_tts_tpu_torch.utils import snapshot
from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path, tree_map

sys.path.insert(0, os.path.dirname(__file__))
from test_data_and_trainer import _tokenizer, _write_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(audio_min_length=0.1, audio_max_length=1.0, encodec_sr=50.0,
            neighbor_prompt_prob=1.0, min_prompt_len=0.05)
TRAIN = dict(lr=0.01, num_steps=2, val_every_n_steps=100, max_num_tokens=256,
             num_buckets=2, text_max_length=64, print_every_n_steps=1,
             early_stop_step=0, num_epochs=50)
LORA_R, LORA_ALPHA = 4, 8


def _np(tree):
    """A port tree as numpy arrays (the JAX functions' input)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().cpu().numpy()


def _assert_trees_equal(got, want):
    got, want = list(leaves_with_path(got)), list(leaves_with_path(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two full-model AdamW steps from JAX-initialized weights, then two
    LoRA ScaledAdam steps over the full run's result; each experiment
    directory with the ``config.json`` the train CLI writes."""
    root = _write_dataset(str(tmp_path_factory.mktemp("data") / "ds"))
    cfg = ttiny()
    tok = _tokenizer(cfg.text_vocab_size)
    dcfg = DataConfig(dataset_dir=root, **DATA)
    base = bridge.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jvoice.init_params(jax.random.PRNGKey(1), jtiny())),
        "cpu")
    exp = tmp_path_factory.mktemp("exp")

    def run(name, params, **kw):
        tcfg = ttrainer.TrainerConfig(exp_dir=str(exp / name),
                                      **dict(TRAIN, **kw))
        ds = VoiceDataset(dcfg, "train", tok, cfg.x_sep_token,
                          cfg.special.y_sep, seed=1)
        t = ttrainer.Trainer(cfg, tcfg, ds, params=params, device="cpu")
        t.train()
        ckpt.save_config(tcfg.exp_dir, cfg)
        return t

    full = run("full", base, optimizer_name="AdamW")
    lora_run = run("lora", full.state.params, optimizer_name="ScaledAdam",
                   use_lora=True, lora_r=LORA_R, lora_alpha=LORA_ALPHA)
    return dict(cfg=cfg, full=full, lora=lora_run, full_dir=str(exp / "full"),
                lora_dir=str(exp / "lora"))


def test_bundle_loads_bit_equal_with_the_jax_config(runs):
    params, cfg, raw = loading.load_voice_model(runs["full_dir"], "cpu")
    _assert_trees_equal(params, runs["full"].state.params)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(runs["cfg"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jloading.voice_config_from_json(raw))


def test_bundle_preference_best_then_bundle_then_prev(tmp_path, runs):
    cfg = runs["cfg"]
    ckpt.save_config(str(tmp_path), cfg)
    leaf = {"w": torch.zeros(2)}
    states = {n: ttrainer.train_step.TrainState(
        params={"w": torch.full((2,), float(i))}, opt=leaf,
        step=torch.tensor(0), nan_skips=torch.tensor(0))
        for i, n in enumerate((ckpt.BUNDLE_PREV, ckpt.BUNDLE,
                               ckpt.BEST_BUNDLE))}
    for name in (ckpt.BUNDLE_PREV, ckpt.BUNDLE, ckpt.BEST_BUNDLE):
        ckpt.save_bundle(str(tmp_path), states[name], {}, name=name,
                         rotate=False)
        got = loading.load_bundle_dir(str(tmp_path), "cpu")[0]
        assert torch.equal(got["w"], states[name].params["w"]), name


def test_lora_and_orbax_bundles_are_refused_naming_their_export(runs,
                                                                 tmp_path):
    with pytest.raises(ValueError, match="--lora_bundle"):
        loading.load_voice_model(runs["lora_dir"], "cpu")
    ckpt.save_config(str(tmp_path), runs["cfg"])
    os.makedirs(tmp_path / "bundle")
    (tmp_path / "bundle" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError,
                       match="t5gemma_tts_tpu.export.hf_export"):
        loading.load_voice_model(str(tmp_path), "cpu")


def _merged(runs):
    lcfg = lora.LoraConfig(r=LORA_R, alpha=LORA_ALPHA)
    return lora.merge(runs["full"].state.params, runs["lora"].state.params,
                      lcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_main_merges_the_lora_bundle_as_jax(runs, tmp_path, dtype):
    out, ads = str(tmp_path / "hf"), str(tmp_path / "adapter")
    assert hf_export.main([
        "--bundle", runs["full_dir"], "--lora_bundle",
        os.path.join(runs["lora_dir"], "bundle"), "--out", out, "--dtype",
        dtype, "--lora_r", str(LORA_R), "--lora_alpha", str(LORA_ALPHA),
        "--save_adapter_dir", ads, "--device", "cpu"]) == 0
    want = _merged(runs)
    if dtype == "bfloat16":
        want = tree_map(lambda t: t.to(torch.bfloat16), want)
        # an export loads in bf16 unless asked otherwise
        _assert_trees_equal(loading.load_voice_model(out, "cpu")[0], want)
    got = loading.load_hf_dir(out, "cpu", dtype=dtype)[0]
    _assert_trees_equal(got, want)

    with open(os.path.join(runs["full_dir"], "config.json")) as f:
        jcfg = jloading.voice_config_from_json(json.load(f))
    jlcfg = jlora.LoraConfig(r=LORA_R, alpha=LORA_ALPHA)
    jads = _np(runs["lora"].state.params)
    jmerged = jlora.merge(_np(runs["full"].state.params), jads, jlcfg)
    jout, jad = str(tmp_path / "jhf"), str(tmp_path / "jadapter")
    jexport.export_hf(jmerged, jcfg, jout, dtype=dtype)
    jexport.export_peft_adapter(jads, jlcfg, jad)
    for a, b in ((out, jout), (ads, jad)):
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for fn in os.listdir(a):
            with open(os.path.join(a, fn), "rb") as f, \
                    open(os.path.join(b, fn), "rb") as g:
                assert f.read() == g.read(), fn


def _greedy(params, cfg):
    rng = np.random.default_rng(5)
    x = rng.integers(3, 500, (2, 16)).astype(np.int32)
    x_lens = np.asarray([9, 16], np.int32)
    prompt = rng.integers(0, 128, (2, 8)).astype(np.int32)
    plens = np.asarray([3, 8], np.int32)
    out = engine.decode_tokens(
        params, cfg, DecodeConfig(top_k=1, kv_cache="dense", max_frames=24),
        *(torch.from_numpy(a) for a in (x, x_lens, prompt, plens,
                                        plens + 12)), 0)
    return out.tokens, out.gen_lens


def test_greedy_tokens_of_loaded_models_equal_in_memory(runs, tmp_path):
    cfg = runs["cfg"]
    loaded = loading.load_voice_model(runs["full_dir"], "cpu")[0]
    for got, want in zip(_greedy(loaded, cfg),
                         _greedy(runs["full"].state.params, cfg)):
        assert torch.equal(got, want)
    out = str(tmp_path / "hf")
    hf_export.main(["--bundle", runs["full_dir"], "--lora_bundle",
                    os.path.join(runs["lora_dir"], "bundle"), "--out", out,
                    "--dtype", "float32",
                    "--lora_r", str(LORA_R), "--lora_alpha",
                    str(LORA_ALPHA), "--device", "cpu"])
    exported, ecfg, _ = loading.load_hf_dir(out, "cpu", dtype="float32")
    toks, lens = _greedy(exported, ecfg)
    want_toks, want_lens = _greedy(_merged(runs), cfg)
    assert torch.equal(lens, want_lens) and torch.equal(toks, want_toks)
    assert int(lens.min()) > 0


# ---------------------------------------------------------------------------
# reference .pth bundles
# ---------------------------------------------------------------------------


def _tiny_dims_dict(cfg):
    d = cfg.backbone.decoder
    return dict(
        vocab_size=d.vocab_size, hidden_size=d.hidden_size,
        intermediate_size=d.intermediate_size, num_layers=d.num_layers,
        num_heads=d.num_heads, num_kv_heads=d.num_kv_heads,
        head_dim=d.head_dim, query_pre_attn_scalar=d.query_pre_attn_scalar,
        sliding_window=d.sliding_window,
    )


def _lora_keys(sd, rng, r=3):
    """Every linear of the layers wrapped as peft writes it: the base at
    ``base_layer`` and random adapters (``.default`` on the encoder)."""
    out = {}
    for k, v in sd.items():
        if "_proj.weight" not in k:
            out[k] = v
            continue
        stem = k[: -len(".weight")]
        tag = ".default" if ".encoder." in k else ""
        out[stem + ".base_layer.weight"] = v
        out[f"{stem}.lora_A{tag}.weight"] = torch.from_numpy(
            rng.normal(size=(r, v.shape[1])).astype(np.float32))
        out[f"{stem}.lora_B{tag}.weight"] = torch.from_numpy(
            rng.normal(size=(v.shape[0], r)).astype(np.float32) * 0.1)
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "lora"])
def pth(request, tmp_path_factory):
    """A bundle in the reference trainer's layout (backbone.model.* keys,
    pickled args), with or without peft LoRA keys."""
    cfg = jtiny()
    params = jvoice.init_params(jax.random.PRNGKey(0), cfg)
    sd = {("backbone." + k if k.startswith("model.") else k):
          torch.from_numpy(np.array(v))
          for k, v in jconvert.params_to_torch_state_dict(params).items()}
    if request.param:
        sd = _lora_keys(sd, np.random.default_rng(3))
    args = argparse.Namespace(
        t5gemma_model_name="tiny-test-backbone",
        backbone_dims=_tiny_dims_dict(cfg),
        audio_vocab_size=[cfg.audio_vocab_size], n_special=cfg.n_special,
        encodec_sr=int(cfg.encodec_sr), use_pm_rope=1,
        progress_scale=cfg.progress_scale, x_sep_token=cfg.x_sep_token)
    path = tmp_path_factory.mktemp("pth") / "bundle.pth"
    torch.save({"model": sd, "optimizer": {}, "scheduler": {}, "args": args},
               str(path))
    return str(path), request.param


def test_load_reference_pth_equals_jax(pth):
    path, with_lora = pth
    got, cfg, _ = loading.load_voice_model(path, "cpu")
    want, jcfg, _ = jloading.load_reference_pth(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = jax.tree_util.tree_leaves_with_path(want)
    got = list(leaves_with_path(got))
    assert len(got) == len(want)
    for (path_t, g), (path_j, w) in zip(got, want):
        w = np.asarray(w.astype(np.float32))
        g = g.float().numpy()
        if with_lora:   # summation order: one bf16 ulp of the leaf at most
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2 ** -7 * np.abs(w).max())
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path_t))
    if with_lora:
        sd, _ = loading.read_reference_pth(path)
        tm = convert._merge_lora(sd)
        jm = jconvert._merge_lora({k: v.numpy() for k, v in sd.items()})
        assert sorted(tm) == sorted(jm) and not any("lora" in k for k in tm)
        for k in jm:
            np.testing.assert_allclose(
                tm[k].numpy(), jm[k], rtol=0,
                atol=1e-6 * max(np.abs(jm[k]).max(), 1e-30), err_msg=k)


def test_leftover_key_raises_under_strict_in_both(pth):
    path, _ = pth
    sd, cfg = loading.read_reference_pth(path)
    extra = "backbone.model.decoder.layers.0.mlp.extra_proj.weight"
    sd[extra] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match=r"1 state-dict tensors.*extra_proj"):
        convert.torch_state_dict_to_params(sd, cfg, torch.float32,
                                           torch.device("cpu"), strict=True)
    with pytest.raises(ValueError, match=r"1 state-dict tensors.*extra_proj"):
        jconvert.torch_state_dict_to_params(
            {k: v.numpy() for k, v in sd.items()},
            jloading.load_reference_pth(path)[1], strict=True)
    convert.torch_state_dict_to_params(sd, cfg, torch.float32,
                                       torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_bundle_tool_writes_the_jax_tools_bytes(pth, tmp_path,
                                                          dtype):
    path, _ = pth
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import convert_reference_bundle as jtool
    finally:
        sys.path.pop(0)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_reference_bundle.main(
        ["--bundle", path, "--out", out, "--dtype", dtype]) == 0
    jtool.main(["--bundle", path, "--out", jout, "--dtype", dtype])
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for fn in os.listdir(out):
        with open(os.path.join(out, fn), "rb") as f, \
                open(os.path.join(jout, fn), "rb") as g:
            assert f.read() == g.read(), fn


def test_copy_codebase_copies_the_jax_file_set_without_build(tmp_path):
    src = tmp_path / "pkg"
    for rel in ("a.py", "sub/b.py", "sub/c.cu", "sub/d.pyc", "x.so",
                "__pycache__/e.pyc", "exp1/f.py", "_build/k.so",
                "_build/k.cu", "keep.txt", "ignored.log"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    (src / ".gitignore").write_text("# comment\n*.log\n")

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    got = snapshot.copy_codebase(str(src), str(tmp_path / "port"))
    want = jsnapshot.copy_codebase(str(src), str(tmp_path / "jax"))
    jax_set = [f for f in files(want) if not f.startswith("_build")]
    assert files(got) == jax_set
    assert "_build/k.cu" in files(want) and "sub/c.cu" in files(got)

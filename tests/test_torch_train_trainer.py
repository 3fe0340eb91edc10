"""The port's ``Trainer`` and train CLI on the CPU: three steps with AdamW
and with ScaledAdam against the JAX package's ``Trainer`` on the same
dataset and weights (losses and the step-3 validation loss to 1e-4
relative); save, resume and go on equal to an uninterrupted run, exactly
(full model and LoRA, two micro-batches a step, neighbor prompts); the CLI
in a subprocess with ``--device cpu`` and ``--resume`` (resumed with
``--tp 2 --zero_opt_sharding 1``, which one process ignores, as the JAX
CLI does at one device); what still refuses of the parallel options (a
paged state's data-parallel split, and under tensor parallelism ROADMAP
Queue 1 item 15 part D) while ZeRO-1 without a mesh builds; and the
refusal of an orbax bundle, naming the JAX
package's export. The parallel runs themselves are in
``tests/test_torch_parallel*.py``."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.data.dataset import VoiceDataset as JDataset
from t5gemma_tts_tpu.data.manifest import DataConfig as JDataConfig
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.train import trainer as jtrainer
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset as TDataset
from t5gemma_tts_tpu_torch.data.manifest import DataConfig as TDataConfig
from t5gemma_tts_tpu_torch.train import cli as tcli
from t5gemma_tts_tpu_torch.train import trainer as ttrainer
from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

sys.path.insert(0, os.path.dirname(__file__))
from test_cli_e2e import _make_offline_tokenizer  # noqa: E402
from test_data_and_trainer import _tokenizer, _write_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(audio_min_length=0.1, audio_max_length=1.0, encodec_sr=50.0,
            neighbor_prompt_prob=1.0, min_prompt_len=0.05)
TRAIN = dict(lr=0.01, num_steps=3, val_every_n_steps=3, max_num_tokens=256,
             val_max_num_tokens=256, num_buckets=2, text_max_length=64,
             print_every_n_steps=1, early_stop_step=0, num_epochs=50)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = _write_dataset(str(tmp_path_factory.mktemp("data") / "ds"))
    jcfg = jtiny()
    params = jvoice.init_params(jax.random.PRNGKey(1), jcfg)
    return dict(root=root, jcfg=jcfg, tcfg=ttiny(), params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params),
                tok=_tokenizer(jcfg.text_vocab_size))


def _port_datasets(s, seed=1):
    dcfg = TDataConfig(dataset_dir=s["root"], **DATA)
    args = (s["tok"], s["tcfg"].x_sep_token, s["tcfg"].special.y_sep)
    return (TDataset(dcfg, "train", *args, seed=seed),
            TDataset(dcfg, "valid", *args, seed=seed))


def _port_trainer(s, exp_dir, **kw):
    tcfg = ttrainer.TrainerConfig(exp_dir=str(exp_dir), **dict(TRAIN, **kw))
    train_ds, valid_ds = _port_datasets(s)
    return ttrainer.Trainer(s["tcfg"], tcfg, train_ds, valid_ds,
                            params=bridge.params_from_jax(s["np_params"],
                                                          "cpu"),
                            device="cpu")


@pytest.mark.parametrize("optimizer", ["AdamW", "ScaledAdam"])
def test_trainer_losses_match_jax(setup, tmp_path, optimizer):
    """ScaledAdam also validates at step 3 (AdamW skips it: one JAX eval
    compile fewer)."""
    s = setup
    train_kw = dict(TRAIN, val_every_n_steps=3 if optimizer == "ScaledAdam"
                    else 100)
    dcfg = JDataConfig(dataset_dir=s["root"], **DATA)
    args = (s["tok"], s["jcfg"].x_sep_token, s["jcfg"].special.y_sep)
    jt = jtrainer.Trainer(
        s["jcfg"],
        jtrainer.TrainerConfig(exp_dir=str(tmp_path / "jax"),
                               optimizer_name=optimizer, **train_kw),
        JDataset(dcfg, "train", *args, seed=1),
        JDataset(dcfg, "valid", *args, seed=1), params=s["params"])
    jlosses = []
    step_fn = jt._step_fn

    def recording(state, batch, lr):
        state, m = step_fn(state, batch, lr)
        jlosses.append(float(m.loss))
        return state, m

    jt._step_fn = recording
    jprog = jt.train()

    tt = _port_trainer(s, tmp_path / "port", optimizer_name=optimizer,
                       val_every_n_steps=train_kw["val_every_n_steps"])
    tprog = tt.train()
    assert tprog["step"] == jprog["step"] == 3
    np.testing.assert_allclose([h["loss"] for h in tt.history], jlosses,
                               rtol=1e-4)
    assert os.path.exists(tmp_path / "port" / "bundle")
    if optimizer == "ScaledAdam":
        assert np.isfinite(tprog["best_score"])
        np.testing.assert_allclose(tprog["best_score"], jprog["best_score"],
                                   rtol=1e-4)
        assert os.path.exists(tmp_path / "port" / "best_bundle")


def _state_leaves(trainer):
    return [t.clone() for _, t in leaves_with_path(
        (trainer.state.params, trainer.state.opt))]


@pytest.mark.parametrize("use_lora", [False, True])
def test_resume_equals_an_uninterrupted_run(setup, tmp_path, use_lora):
    kw = dict(optimizer_name="ScaledAdam", gradient_accumulation_steps=2,
              val_every_n_steps=100, use_lora=use_lora, lora_r=4,
              lora_alpha=8)
    whole = _port_trainer(setup, tmp_path / "whole", **dict(kw, num_steps=5))
    whole.train()
    first = _port_trainer(setup, tmp_path / "split", **dict(kw, num_steps=3))
    first.train()
    resumed = _port_trainer(setup, tmp_path / "split", **dict(kw, num_steps=5))
    assert resumed.progress["step"] == 3
    prog = resumed.train()
    assert prog["step"] == 5
    losses = [h["loss"] for h in first.history + resumed.history]
    assert losses == [h["loss"] for h in whole.history]
    for a, b in zip(_state_leaves(resumed), _state_leaves(whole)):
        assert torch.equal(a, b)


def test_skipped_step_names_the_dominant_parameters(setup, tmp_path,
                                                     caplog):
    tt = _port_trainer(setup, tmp_path, optimizer_name="ScaledAdam",
                       use_lora=True, lora_r=4, lora_alpha=8)
    bucket, rows = next(iter(tt.sampler))
    batch = tt._device_batch([tt._to_batch(
        [tt.train_ds[i] if i >= 0 else None for i in rows], bucket,
        tt.plan)])
    with caplog.at_level("WARNING"):
        tt._log_dominant_params(batch)
    named = [r.getMessage() for r in caplog.records
             if "dominant parameter" in r.getMessage()]
    assert len(named) == 3 and "['layers']" in named[0], named


def test_generation_hook_gets_the_merged_model_under_lora(setup, tmp_path,
                                                         caplog):
    """The validation hook synthesizes with plain parameters: under LoRA
    the trainer merges the adapters first."""
    from t5gemma_tts_tpu_torch.train.diagnostics import make_generation_hook
    from t5gemma_tts_tpu_torch.config import DecodeConfig

    hook = make_generation_hook(setup["tcfg"], setup["tok"], "hello world",
                                str(tmp_path), dcfg=DecodeConfig(
                                    max_frames=64, kv_cache="dense"),
                                target_duration=0.2, device="cpu")
    seen = []

    def recording(params, step):
        seen.append(params["decoder"]["layers"]["self_attn"]["q"])
        hook(params, step)

    tcfg = ttrainer.TrainerConfig(exp_dir=str(tmp_path / "exp"), **dict(
        TRAIN, num_steps=1, val_every_n_steps=1, use_lora=True, lora_r=4,
        lora_alpha=8))
    tcfg.inference_every_n_steps = 1
    train_ds, valid_ds = _port_datasets(setup)
    trainer = ttrainer.Trainer(
        setup["tcfg"], tcfg, train_ds, valid_ds,
        params=bridge.params_from_jax(setup["np_params"], "cpu"),
        generation_hook=recording, device="cpu")
    with caplog.at_level("INFO"):
        trainer.train()
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert any("val generation @ 1" in r.getMessage() for r in caplog.records)


def _run_cli(argv):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run(
        [sys.executable, "-m", "t5gemma_tts_tpu_torch.train.cli", *argv],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, (
        f"train CLI failed\nstdout:\n{proc.stdout[-4000:]}\n"
        f"stderr:\n{proc.stderr[-4000:]}")


def _cli_argv(root, tok_dir, exp):
    return [
        "--device", "cpu", "--dataset_dir", root, "--exp_dir", exp,
        "--backbone_preset", "test", "--precision", "float32",
        "--audio_vocab_size", "128", "--x_sep_token", "500",
        "--text_tokenizer_name", tok_dir, "--num_steps", "3",
        "--num_epochs", "50", "--max_num_tokens", "256",
        "--val_max_num_tokens", "256", "--num_buckets", "2",
        "--text_max_length", "64", "--audio_min_length", "0.1",
        "--audio_max_length", "1.0", "--val_every_n_steps", "100",
        "--early_stop_step", "0", "--optimizer_name", "AdamW", "--lr", "1e-3",
    ]


def test_text_tokenizer_of_a_local_directory_matches_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    tok_dir = str(tmp_path / "tok")
    _make_offline_tokenizer(tok_dir, 512)
    encode, eos, pad = tcli.load_text_tokenizer(tok_dir)
    ref = transformers.AutoTokenizer.from_pretrained(tok_dir)
    text = "hello world , this is a test . unknown words !"
    assert encode(text) == ref.encode(text, add_special_tokens=False)
    assert (eos, pad) == (ref.eos_token_id, ref.pad_token_id) == (2, 0)


def test_train_cli_runs_and_resumes_on_cpu(setup, tmp_path):
    pytest.importorskip("tokenizers")
    tok_dir = str(tmp_path / "tok")
    _make_offline_tokenizer(tok_dir, 512)
    exp = str(tmp_path / "exp")
    argv = _cli_argv(setup["root"], tok_dir, exp)
    _run_cli(argv)
    for name in ("args.json", "config.json", "bundle", "progress.json",
                 "codebase/train/cli.py"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert not os.path.exists(os.path.join(exp, "codebase", "_build"))
    with open(os.path.join(exp, "args.json")) as f:
        assert json.load(f)["device"] == "cpu"
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["dtype"] == "float32"
    with open(os.path.join(exp, "progress.json")) as f:
        assert json.load(f)["step"] == 3
    # one process: --tp and ZeRO-1 need torchrun's ranks and are ignored
    _run_cli(argv + ["--resume", "--num_steps", "5", "--tp", "2",
                     "--zero_opt_sharding", "1"])
    with open(os.path.join(exp, "progress.json")) as f:
        assert json.load(f)["step"] == 5
    assert os.path.isdir(os.path.join(exp, "bundle_prev"))


def test_parallel_options_raise_naming_item_15(setup, tmp_path):
    from types import SimpleNamespace

    from t5gemma_tts_tpu_torch import parallel
    from t5gemma_tts_tpu_torch.decode import speculative
    from t5gemma_tts_tpu_torch.parallel import tensor as tp

    # the serving half is ported: a paged state is refused by its own rule,
    # and what is left of it (part D) raises under tensor parallelism
    with pytest.raises(ValueError, match="dense-cache"):
        parallel.shard_slot_state(SimpleNamespace(cache=None),
                                  parallel.Mesh(dp=1, tp=1))
    with tp.model_parallel(parallel.Mesh(dp=1, tp=2)), pytest.raises(
            ValueError, match="Queue 1 item 15 part D"):
        speculative.decode_tokens_speculative(
            None, None, None, None, None, None, None, None, seed=0,
            draft_fn=None, k=1)
    # ZeRO-1 without a mesh: nothing to split, the one-device trainer
    train_ds, _ = _port_datasets(setup)
    trainer = ttrainer.Trainer(setup["tcfg"], ttrainer.TrainerConfig(
        exp_dir=str(tmp_path), zero_opt_sharding=True), train_ds,
        device="cpu")
    assert trainer.layout is None and trainer.mesh is None


def test_orbax_bundle_is_refused(setup, tmp_path):
    """A bundle directory without the port's state file (what the JAX
    trainer's orbax checkpoint leaves) is refused, naming the JAX
    package's export, which writes what the port loads."""
    os.makedirs(tmp_path / "bundle")
    (tmp_path / "bundle" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError,
                       match="python -m t5gemma_tts_tpu.export.hf_export"):
        _port_trainer(setup, tmp_path)

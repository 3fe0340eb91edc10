"""The port's train CLI and corpus preprocessing at world 2 (gloo) on the
CPU, against one process.

One two-rank launch (``tests/torch_parallel_worker.py cli``) runs
``train.cli.main`` for two steps (AdamW, ZeRO-1 on by default) at dp 2,
at tp 2 (``--tp 2``) and with LoRA at tp 2,
and then ``preprocess.prepare`` over a seeded wav folder with the tiny
codec, each rank encoding its rows of every batch. Meanwhile this process
runs the same CLI (full and LoRA) and ``prepare`` alone. Each world-2
run's losses and token counts equal the one-process run's (within 1e-5
relative: the same global batches, sums in another order; the trainer's
validation over a mesh is in ``tests/test_torch_parallel.py``); a full
run's bundle, written by rank 0, loads in one process
(``load_voice_model``) with parameters within 1e-5 relative Frobenius of
the one-process run's; every bundle resumes in one process for a third
step; rank 0 alone wrote ``args.json``, ``config.json`` and the code base
copy; and the preprocessed files are byte-identical to the one-process
run's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.data import preprocess as tpre
from t5gemma_tts_tpu_torch.inference.loading import load_voice_model
from t5gemma_tts_tpu_torch.train import cli as tcli
from t5gemma_tts_tpu_torch.train import trainer as ttrainer
from t5gemma_tts_tpu_torch.utils.tree import keystr, leaves_with_path

sys.path.insert(0, os.path.dirname(__file__))
from test_cli_e2e import _make_offline_tokenizer  # noqa: E402
from test_data_and_trainer import _write_dataset  # noqa: E402
from test_torch_parallel import launch, wait  # noqa: E402
from test_torch_preprocess import _tree, _write_folder  # noqa: E402
from test_torch_train_trainer import _cli_argv  # noqa: E402

torch.set_num_threads(1)
STEPS = 2
LORA = ["--use_lora", "1", "--lora_r", "4", "--lora_alpha", "8"]
# world-2 runs: (their own flags, the mesh (dp, tp), the one-process run)
RUNS = {"dp2": ([], [2, 1], "full"), "tp2": (["--tp", "2"], [1, 2], "full"),
        "lora_tp2": (["--tp", "2"] + LORA, [1, 2], "lora")}
ALONE = {"full": [], "lora": LORA}


def _prep_config(out):
    return tpre.PreprocessConfig(out_dir=out, encode_batch=3,
                                 valid_fraction=0.25)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("tokenizers")
    base = tmp_path_factory.mktemp("cli")
    out = str(base / "launch")
    os.makedirs(out)
    root = _write_dataset(str(base / "ds"))
    tok_dir = str(base / "tok")
    _make_offline_tokenizer(tok_dir, 512)
    sr = tcodec.tiny_codec_config().encode_sample_rate
    wavs = _write_folder(base / "wavs", 0, 3, 3, sr)
    prep_argv = ["--wav-folder", wavs, "--output-dir", str(base / "unused"),
                 "--tiny-random-codec", "--device", "cpu"]

    def argv(exp, flags):
        return _cli_argv(root, tok_dir, str(base / exp)) + [
            "--num_steps", str(STEPS)] + flags

    spec = dict(train_argv={name: argv(f"exp_{name}", flags)
                            for name, (flags, _, _) in RUNS.items()},
                prep_argv=prep_argv, prep_out=str(base / "prep2"), wavs=wavs)
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    procs = launch("cli", 2, out)
    made = []
    init = ttrainer.Trainer.__init__

    def recording(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    alone = {}
    try:            # the same work in this one process meanwhile
        ttrainer.Trainer.__init__ = recording
        for name, flags in ALONE.items():
            made.clear()
            tcli.main(argv(f"alone_{name}", flags))
            alone[name] = made[0]
        tok = tpre._cli_tokenizer(tpre.build_parser().parse_args(prep_argv),
                                  "cpu")
        tpre.prepare(tpre.iter_wav_folder(wavs, sr), tok,
                     _prep_config(str(base / "prep1")))
    finally:
        ttrainer.Trainer.__init__ = init
        wait(procs, out)
    with open(os.path.join(out, "cli.json")) as f:
        world2 = json.load(f)
    return dict(alone=alone, world2=world2, base=base,
                argv=spec["train_argv"])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_world_two_losses_equal_one_process(runs, run):
    one = runs["alone"][RUNS[run][2]]
    two = runs["world2"][run]
    assert two["mesh"] == RUNS[run][1]
    assert len(one.history) == len(two["history"]) == STEPS
    assert [h["ntokens"] for h in two["history"]] == \
        [h["ntokens"] for h in one.history]
    np.testing.assert_allclose([h["loss"] for h in two["history"]],
                               [h["loss"] for h in one.history], rtol=1e-5)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_world_two_bundle_loads_and_resumes_in_one_process(runs, run):
    """The full runs' bundles load as models (a LoRA bundle holds the
    adapters, which ``load_voice_model`` refuses); every bundle resumes
    in one process."""
    exp = str(runs["base"] / f"exp_{run}")
    if RUNS[run][2] == "full":
        params, _, _ = load_voice_model(exp, "cpu")
        want = dict(leaves_with_path(runs["alone"]["full"].state.params))
        got = dict(leaves_with_path(params))
        assert sorted(map(keystr, got)) == sorted(map(keystr, want))
        for path, w in want.items():
            g = got[path].double()
            assert float(torch.linalg.vector_norm(g - w.double())) <= \
                1e-5 * max(float(torch.linalg.vector_norm(w.double())),
                           1e-30), keystr(path)
    for name in ("args.json", "config.json", "codebase/parallel/mesh.py",
                 "bundle"):
        assert os.path.exists(os.path.join(exp, name)), name
    # one process: the launch's --tp is ignored there
    progress = tcli.main(runs["argv"][run]
                         + ["--resume", "--num_steps", str(STEPS + 1)])
    assert progress["step"] == STEPS + 1


def test_world_two_prepare_writes_the_one_process_files(runs):
    base = runs["base"]
    one, two = _tree(str(base / "prep1")), _tree(str(base / "prep2"))
    codes = [k for k in one if k.startswith("xcodec2_1cb")]
    assert len(codes) == 9
    assert sorted(two) == sorted(one)
    for k in one:
        assert two[k] == one[k], k

"""The port's data pipeline against the JAX package's, exactly (both are
numpy): manifests, the bucket plan, the sampler's order at a seed (and its
mid-epoch resume), ``pad_batch``, ``VoiceDataset`` examples with neighbor
prompts, and the WSOLA time stretch, on the synthetic dataset of
``tests/test_data_and_trainer.py``."""

import os
import sys

import numpy as np
import pytest

from t5gemma_tts_tpu.config import tiny_voice_config
from t5gemma_tts_tpu.data import batching as jbatching
from t5gemma_tts_tpu.data import manifest as jmanifest
from t5gemma_tts_tpu.data import stretch as jstretch
from t5gemma_tts_tpu.data.dataset import VoiceDataset as JDataset
from t5gemma_tts_tpu_torch.data import batching as tbatching
from t5gemma_tts_tpu_torch.data import manifest as tmanifest
from t5gemma_tts_tpu_torch.data import stretch as tstretch
from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset as TDataset

sys.path.insert(0, os.path.dirname(__file__))
from test_data_and_trainer import _tokenizer, _write_dataset  # noqa: E402


def _dcfgs(root, **kw):
    kw = dict(dataset_dir=root, audio_min_length=0.1, audio_max_length=1.0,
              encodec_sr=50.0, neighbor_prompt_prob=1.0, min_prompt_len=0.05,
              **kw)
    return jmanifest.DataConfig(**kw), tmanifest.DataConfig(**kw)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("data") / "ds"))


@pytest.mark.parametrize("split", ["train", "valid"])
def test_manifest_matches(dataset_root, split):
    jd, td = _dcfgs(dataset_root, validation_sample_cap=2)
    je, jr = jmanifest.load_manifest(jd, split)
    te, tr = tmanifest.load_manifest(td, split)
    assert jr == tr
    assert [(e.utt_id, e.length, e.root_idx) for e in je] == \
        [(e.utt_id, e.length, e.root_idx) for e in te]
    path = os.path.join(dataset_root, "xcodec2_1cb", je[0].utt_id + ".txt")
    np.testing.assert_array_equal(tmanifest.read_codes(path),
                                  jmanifest.read_codes(path))
    nb = os.path.join(dataset_root, "neighbors", je[0].utt_id + ".txt")
    assert tmanifest.read_neighbors(nb) == jmanifest.read_neighbors(nb)
    for flag in ("/a/b", "['x','y']"):
        assert tmanifest.parse_list_flag(flag) == jmanifest.parse_list_flag(
            flag)


def test_plan_sampler_and_pad_batch_match():
    lengths = list(np.random.default_rng(0).integers(10, 500, 200))
    jp = jbatching.make_plan(lengths, 1000, 4, max_len=500)
    tp = tbatching.make_plan(lengths, 1000, 4, max_len=500)
    np.testing.assert_array_equal(tp.boundaries, jp.boundaries)
    assert (tp.batch_sizes, tp.pad_lens) == (jp.batch_sizes, jp.pad_lens)
    for epoch in (0, 1):
        js = jbatching.BucketBatchSampler(lengths, jp, seed=3, epoch=epoch)
        ts = tbatching.BucketBatchSampler(lengths, tp, seed=3, epoch=epoch)
        assert list(ts) == list(js)
        js.set_epoch_resume(epoch, 4)
        ts.set_epoch_resume(epoch, 4)
        assert list(ts) == list(js)

    class Ex:
        def __init__(self, n, m, sep):
            self.x = np.arange(3, 3 + n, dtype=np.int32)
            self.y = np.arange(m, dtype=np.int32) % 7
            self.y_sep_position = sep

    # a bucket of 7 rows: two examples (one cut to the bucket's length and
    # the text width), a dummy row, four padding rows
    jp = jbatching.make_plan(lengths, 4000, 4, max_len=500)
    tp = tbatching.make_plan(lengths, 4000, 4, max_len=500)
    examples = [Ex(5, 30, 0), None, Ex(70, 500, 9)]
    want = jbatching.pad_batch(examples, jp, 3, text_len=64, text_pad=0,
                               audio_pad=130)
    got = tbatching.pad_batch(examples, tp, 3, text_len=64, text_pad=0,
                              audio_pad=130)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_voice_dataset_examples_match(dataset_root):
    cfg = tiny_voice_config()
    jd, td = _dcfgs(dataset_root)
    tok = _tokenizer(cfg.text_vocab_size)
    args = (tok, cfg.x_sep_token, cfg.special.y_sep)
    jds = JDataset(jd, "train", *args, add_eos_to_text=2, seed=5)
    tds = TDataset(td, "train", *args, add_eos_to_text=2, seed=5)
    assert tds.lengths == jds.lengths
    seps = 0
    for i in list(range(len(jds))) * 2:      # the random state carries on
        je, te = jds[i], tds[i]
        assert (je is None) == (te is None)
        if je is None:
            continue
        np.testing.assert_array_equal(te.x, je.x)
        np.testing.assert_array_equal(te.y, je.y)
        assert (te.y_sep_position, te.x_sep_position) == \
            (je.y_sep_position, je.x_sep_position)
        seps += te.y_sep_position > 0
    assert seps > 0                          # neighbor prompts were taken


def test_time_stretch_matches():
    rng = np.random.default_rng(2)
    t = np.arange(16000) / 16000.0
    wav = (np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(size=t.shape))
    for rate in (0.9, 1.0, 1.15):
        np.testing.assert_array_equal(tstretch.time_stretch(wav, rate),
                                      jstretch.time_stretch(wav, rate))

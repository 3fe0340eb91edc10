"""The port's corpus preprocessing against the JAX package's, on the CPU.

The filters and the repetition detector give JAX's answers on a table of
cases. ``prepare`` over a seeded wav folder, with the same tiny codec weights
in both packages, writes the manifests, text files, neighbor lists and
md5-sharded layout byte-equal to JAX's, and codes equal to JAX's but at a
rounding flip (``fsq.rounding_margin`` under 1e-4 on either side, the
clause of ``tests/test_torch_codec_encoder.py``); a second run resumes and
writes nothing. The CLI, called in process, drops a blocklisted utterance,
resumes, and rebuilds the neighbor lists with ``--neighbors-only``.
``iter_hf_dataset`` reads a dataset that the test saved locally as JAX's
does, and refuses a name that is not a local path."""

import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.codec import audio_tokenizer as jtok
from t5gemma_tts_tpu.codec import model as jcodec
from t5gemma_tts_tpu.data import preprocess as jpre
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.codec import audio_tokenizer as ttok
from t5gemma_tts_tpu_torch.codec import model as tcodec
from t5gemma_tts_tpu_torch.data import preprocess as tpre
from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
from t5gemma_tts_tpu_torch.data.manifest import DataConfig
from t5gemma_tts_tpu_torch.inference import audio_io

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_codec_encoder import _flips_allowed, _margins  # noqa: E402

torch.set_num_threads(1)

SAMPLES = [
    dict(),
    dict(language="ja"),
    dict(language="EN"),
    dict(language=""),
    dict(utt_id="bad1"),
    dict(text=""),
    dict(text="   \t "),
    dict(text="see https://spam.com now"),
    dict(text="visit WWW.example.org"),
    dict(text="abcd" * 12),
    dict(text="  hello   there\tworld "),
    dict(dur=45.0),
    dict(dur=0.05),
    dict(dur=0.0, n=10),
    dict(dur=0.0, n=4000),
    dict(dur=30.0),
]


def _sample(mod, kw):
    return mod.Sample(
        utt_id=kw.get("utt_id", "u"), text=kw.get("text", "hello world"),
        wav=np.zeros(kw.get("n", 2000), np.float32),
        language=kw.get("language", "en"), duration_sec=kw.get("dur", 1.0))


@pytest.mark.parametrize("case", range(len(SAMPLES)))
def test_sample_filter_equals_jax(case):
    kw = SAMPLES[case]
    want = jpre.sample_filter(
        jpre.PreprocessConfig(languages=("en",), blocklist=("bad1",)),
        _sample(jpre, kw), 200)
    got = tpre.sample_filter(
        tpre.PreprocessConfig(languages=("en",), blocklist=("bad1",)),
        _sample(tpre, kw), 200)
    assert got == want
    text = kw.get("text", "hello world")
    assert tpre.normalize_text(text) == jpre.normalize_text(text)
    assert tpre.sanitize_utt_id(f"a b/{case}?é") == jpre.sanitize_utt_id(
        f"a b/{case}?é")


REPETITIONS = [("spam" * 12, 4, 10), ("spam" * 11, 4, 10),
               ("a perfectly normal sentence here", 4, 10), ("ab", 4, 10),
               ("", 4, 10), ("aaaaaaa", 1, 5), ("aaaaaa", 1, 5),
               ("xyzxyzxyz", 3, 2), ("xyzxyzxyz", 0, 2)]


@pytest.mark.parametrize("text,length,tol", REPETITIONS)
def test_repetition_found_equals_jax(text, length, tol):
    assert tpre.repetition_found(text, length, tol) == \
        jpre.repetition_found(text, length, tol)


def _write_folder(folder, seed, speakers, utts, sr):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for spk in range(speakers):
        for j in range(utts):
            utt = f"spk{spk}_{j:02d}"
            wav = (rng.normal(size=int(sr * (1.0 + j)))
                   * 0.1).astype(np.float32)
            audio_io.write_wav(str(folder / f"{utt}.wav"), wav, sr)
            (folder / f"{utt}.txt").write_text(f"utterance {spk} number {j}")
    return str(folder)


def _tree(root):
    out = {}
    for d, _, fs in os.walk(root):
        for fn in fs:
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def codec():
    """The tiny codec's weights, seeded in the port (the JAX package's
    seeded init takes about 20 s of op-by-op compiles here) and handed to
    JAX as numpy: the bridge's tree, leaf for leaf."""
    jcfg, tcfg = jcodec.tiny_codec_config(), tcodec.tiny_codec_config()
    tp = tcodec.init_decoder_params(0, tcfg, "cpu")
    tp.update(tcodec.init_encoder_params_for(1, tcfg, "cpu"))
    jp = _numpy(tp)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(bridge.params_from_jax(jp, "cpu")),
        jax.tree_util.tree_leaves(tp)))
    return jcfg, tcfg, jp, tp


def test_prepare_writes_the_jax_layout(codec, tmp_path):
    jcfg, tcfg, jp, tp = codec
    sr = tcfg.encode_sample_rate
    src = _write_folder(tmp_path / "raw", 0, 3, 4, sr)
    kw = dict(valid_fraction=0.3, encode_batch=4, max_neighbors_per_utt=2,
              seed=3)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jpre.prepare(jpre.iter_wav_folder(src, sr),
                        jtok.AudioTokenizer(jp, jcfg),
                        jpre.PreprocessConfig(out_dir=jout, **kw))
    port_tok = ttok.AudioTokenizer(tp, tcfg, device="cpu")
    got = tpre.prepare(tpre.iter_wav_folder(src, sr), port_tok,
                       tpre.PreprocessConfig(out_dir=tout, **kw))
    assert [(r.utt_id, r.speaker, r.duration_sec, r.split) for r in got] == \
        [(r.utt_id, r.speaker, r.duration_sec, r.split) for r in want]
    assert len(got) == 12 and {r.split for r in got} == {"train", "valid"}
    for r in got:
        utt = r.utt_id.split("/")[1]
        assert r.utt_id.split("/")[0] == hashlib.md5(
            utt.encode()).hexdigest()[:2]

    jfiles, tfiles = _tree(jout), _tree(tout)
    assert sorted(jfiles) == sorted(tfiles)
    codes = sorted(k for k in tfiles if k.startswith("xcodec2_1cb"))
    assert len(codes) == 12
    for k in tfiles:
        if k not in codes:
            assert tfiles[k] == jfiles[k], k
    # the codes: equal but at a flip, batch by batch as prepare encoded them
    samples = list(tpre.iter_wav_folder(src, sr))
    hop = int(np.prod(tcfg.acoustic_cfg.ratios))
    split_of = {r.utt_id.split("/")[1]: r for r in got}
    for i in range(0, len(samples), 4):
        batch = samples[i:i + 4]
        s = max(len(x.wav) for x in batch)
        wavs = np.zeros((len(batch), ttok._bucket(s)), np.float32)
        for row, x in enumerate(batch):
            wavs[row, :len(x.wav)] = x.wav
        lens = np.full((len(batch),), s, np.int32)
        margins = None
        for row, x in enumerate(batch):
            key = os.path.join("xcodec2_1cb", split_of[x.utt_id].utt_id
                               + ".txt")
            g = np.asarray(tfiles[key].split(), np.int64)
            w = np.asarray(jfiles[key].split(), np.int64)
            assert len(g) == len(w) and 1 <= len(g) <= max(
                len(x.wav) // hop, 1)
            if np.array_equal(g, w):
                continue
            if margins is None:
                margins = _margins(jp, tp, jcfg, tcfg, jnp.asarray(wavs),
                                   jnp.asarray(lens))
            t = len(g)
            _flips_allowed(g[None], w[None], (margins[0][row:row + 1, :t],
                                              margins[1][row:row + 1, :t]))

    # resume: nothing encoded or written again
    again = tpre.prepare(tpre.iter_wav_folder(src, sr), port_tok,
                         tpre.PreprocessConfig(out_dir=tout, **kw))
    assert again == [] and _tree(tout) == tfiles
    # the layout loads as a training set
    ds = VoiceDataset(DataConfig(dataset_dir=tout, audio_min_length=0.0,
                                 audio_max_length=100.0,
                                 encodec_sr=tcfg.frame_rate,
                                 neighbor_prompt_prob=1.0,
                                 min_prompt_len=0.0),
                      "train", lambda t: [ord(c) % 50 for c in t],
                      x_sep_token=None, y_sep_token=None)
    assert len(ds) == sum(r.split == "train" for r in got)
    assert ds[0] is not None and len(ds[0].y) > 0


def test_cli_blocklist_resume_and_neighbors_only(tmp_path):
    sr = tcodec.tiny_codec_config().encode_sample_rate
    src = tmp_path / "raw"
    _write_folder(src, 1, 2, 3, sr)
    audio_io.write_wav(str(src / "dropme_00.wav"), np.zeros(sr, np.float32),
                       sr)
    (src / "dropme_00.txt").write_text("should be dropped")
    (tmp_path / "block.txt").write_text("dropme_00\n")
    out = tmp_path / "prepared"
    argv = ["--wav-folder", str(src), "--output-dir", str(out),
            "--tiny-random-codec", "--encode-batch", "4",
            "--blocklist-file", str(tmp_path / "block.txt"), "--seed", "7",
            "--device", "cpu"]
    assert tpre.main(argv) == 0
    for sub in ("text", "xcodec2_1cb", "manifest_final", "neighbors"):
        assert (out / sub).is_dir()
    manifest = (out / "manifest_final" / "train.txt").read_text().splitlines()
    assert len(manifest) == 6 and all("\t" in ln for ln in manifest)
    assert not any("dropme" in ln for ln in manifest)
    utt0 = manifest[0].split("\t")[0]
    assert (out / "text" / (utt0 + ".txt")).is_file()
    codes = (out / "xcodec2_1cb" / (utt0 + ".txt")).read_text().split()
    assert codes and all(c.isdigit() for c in codes)
    assert int(manifest[0].split("\t")[1]) == len(codes)
    nb = (out / "neighbors" / (utt0 + ".txt")).read_text().splitlines()
    assert len(nb) == 2
    before = _tree(str(out))

    assert tpre.main(argv) == 0               # resume: nothing new
    assert _tree(str(out)) == before

    import shutil
    shutil.rmtree(out / "neighbors")
    assert tpre.main(argv + ["--neighbors-only"]) == 0
    assert _tree(str(out)) == before
    with pytest.raises(SystemExit):
        tpre.main(["--output-dir", str(out)])


def test_iter_hf_dataset_reads_a_local_dataset_as_jax(tmp_path):
    datasets = pytest.importorskip("datasets")
    rng = np.random.default_rng(4)
    rows = dict(id=["a1", "b2", "c3"], text=["one", "two", "three"],
                speaker=["s1", "s1", "s2"],
                audio=[{"array": rng.normal(size=n).astype(np.float32)
                        .tolist(), "sampling_rate": 400}
                       for n in (300, 500, 410)])
    folder = tmp_path / "ds"
    folder.mkdir()
    datasets.Dataset.from_dict(rows).to_parquet(str(folder / "train.parquet"))
    for streaming in (True, False):
        got = list(tpre.iter_hf_dataset(str(folder), 200,
                                        streaming=streaming))
        want = list(jpre.iter_hf_dataset(str(folder), 200,
                                         streaming=streaming))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert (g.utt_id, g.text, g.speaker, g.language,
                    g.duration_sec) == (w.utt_id, w.text, w.speaker,
                                        w.language, w.duration_sec)
            np.testing.assert_array_equal(g.wav, w.wav)
    assert [s.utt_id for s in got] == ["a1", "b2", "c3"]
    with pytest.raises(FileNotFoundError, match="local path"):
        next(tpre.iter_hf_dataset("someone/some-dataset", 200))

"""The port's export and its safetensors reader and writer, on the CPU.

The writer's bytes equal the ``safetensors`` library's for a mixed-dtype
dict (with and without metadata), and each reads the other's files. On
tiny JAX-initialized parameters bridged to the port, ``export_hf`` in
float32 and bfloat16 writes ``model.safetensors``, ``config.json`` and the
two template files byte-equal to the JAX package's export, the reverse
converter's tensors equal the JAX one's, and the port's ``load_hf_dir``
gives the parameters back; ``export_peft_adapter`` writes the JAX files
byte for byte."""

import os

import jax
import numpy as np
import pytest
import safetensors.torch as st
import torch

from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.export import hf_export as jexport
from t5gemma_tts_tpu.models import convert as jconvert
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.train import lora as jlora
from t5gemma_tts_tpu_torch import bridge
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.export import hf_export
from t5gemma_tts_tpu_torch.inference import loading
from t5gemma_tts_tpu_torch.models import convert
from t5gemma_tts_tpu_torch.train import lora
from t5gemma_tts_tpu_torch.utils import safetensors_io
from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path, tree_map

torch.set_num_threads(1)


def _mixed():
    g = torch.Generator().manual_seed(0)
    return {
        "b.w": torch.randn(3, 2, generator=g).t(),      # a transposed view
        "c": torch.randn(5, generator=g),
        "a.x": torch.randn(2, 3, generator=g).to(torch.bfloat16),
        "a.y": torch.tensor([1, -2, 3], dtype=torch.int8),
        "d": torch.tensor([1.5, -0.25], dtype=torch.float64),
        "e": torch.arange(4, dtype=torch.int64).reshape(2, 2),
        "f": torch.tensor([True, False]),
        "g": torch.ones(3, dtype=torch.float16),
        "h": torch.arange(3, dtype=torch.int32),
        "i": torch.arange(3, dtype=torch.int16),
        "j": torch.arange(3, dtype=torch.uint8),
        "k": torch.tensor(2.0),                          # 0-dim
        "z": torch.zeros(0, 4),                          # empty
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_writer_bytes_equal_the_library(metadata, tmp_path):
    t = _mixed()
    dense = {k: v.contiguous() for k, v in t.items()}
    assert safetensors_io.save(t, metadata) == st.save(dense, metadata)
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    safetensors_io.save_file(t, ours, metadata)
    st.save_file(dense, theirs, metadata)
    for got in (st.load_file(ours), safetensors_io.load_file(theirs)):
        assert sorted(got) == sorted(dense)
        for k, v in dense.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    small = {"b.w": torch.zeros(2), "c": torch.zeros(3),
             "a.x": torch.zeros(2, dtype=torch.bfloat16),
             "a.y": torch.zeros(2, dtype=torch.int8)}
    assert safetensors_io.save(small) == st.save(small)


@pytest.fixture(scope="module")
def tiny():
    jp = jvoice.init_params(jax.random.PRNGKey(0), jtiny())
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jtiny(), ttiny(), np_params, bridge.params_from_jax(np_params,
                                                               "cpu")


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for fn in os.listdir(a):
        with open(os.path.join(a, fn), "rb") as f, \
                open(os.path.join(b, fn), "rb") as g:
            assert f.read() == g.read(), fn


def test_reverse_converter_equals_jax(tiny):
    _, _, np_params, tp = tiny
    want = jconvert.params_to_torch_state_dict(np_params)
    got = convert.params_to_torch_state_dict(tp)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].is_contiguous() and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_hf_is_byte_equal_to_jax_and_loads_back(tiny, tmp_path, dtype):
    jcfg, tcfg, np_params, tp = tiny
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    hf_export.export_hf(tp, tcfg, out, dtype=dtype, text_tokenizer_name="t")
    jexport.export_hf(np_params, jcfg, jout, dtype=dtype,
                      text_tokenizer_name="t")
    _same_files(out, jout)
    assert set(os.listdir(out)) == {"model.safetensors", "config.json",
                                    *hf_export.TEMPLATE_FILES}
    got, cfg, hf_cfg = loading.load_hf_dir(out, "cpu", dtype=dtype)
    assert hf_cfg["text_tokenizer_name"] == "t"
    want = tree_map(lambda t: t.to(got["head"]["w1"].dtype), tp)
    for (path, g), (_, w) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        assert torch.equal(g, w), path


def test_peft_adapter_is_byte_equal_to_jax(tiny, tmp_path):
    _, _, np_params, tp = tiny
    jlcfg = jlora.LoraConfig(r=4, alpha=8)
    jads = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.01),
        jlora.init_adapters(jax.random.PRNGKey(7), np_params, jlcfg))
    tads = tree_map(lambda a: torch.from_numpy(np.array(a)), jads)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    hf_export.export_peft_adapter(tads, lora.LoraConfig(r=4, alpha=8), out)
    jexport.export_peft_adapter(jads, jlcfg, jout)
    _same_files(out, jout)
    with pytest.raises(ValueError, match="no adapters"):
        hf_export.export_peft_adapter({}, lora.LoraConfig(), str(tmp_path))

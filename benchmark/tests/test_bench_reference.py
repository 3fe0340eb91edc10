"""The plain reference agrees with the port at a tiny width on the CPU (this
test imports both; the reference imports nothing of the port)."""

import numpy as np
import torch

from benchmark.harness import model_config, weights
from benchmark.reference import check, model as ref_model, vocoder
import tiny


def test_reference_scores_the_ports_greedy_tokens_best():
    from t5gemma_tts_tpu_torch.config import DecodeConfig
    from t5gemma_tts_tpu_torch.decode import engine

    c = tiny.CONFIG
    cfg = model_config.voice_config(c)
    params = weights.voice_params(c, 5, "cpu")
    encode = model_config.char_tokenizer(cfg.text_vocab_size)
    texts = ["hello there", "abc"]
    targets = [13, 9]
    x = torch.zeros((2, 16), dtype=torch.int32)
    for i, t in enumerate(texts):
        x[i, :len(t)] = torch.tensor(encode(t))
    out = engine.decode_tokens(
        params, cfg, DecodeConfig(top_k=1, kv_cache="dense", max_frames=32),
        x, torch.tensor([len(t) for t in texts], dtype=torch.int32),
        torch.full((2, 4), cfg.special.pad, dtype=torch.int32),
        torch.zeros((2,), dtype=torch.int32),
        torch.tensor(targets, dtype=torch.int32), 3)
    ref = ref_model.Reference(c, params)
    for i, t in enumerate(texts):
        n = int(out.gen_lens[i]) - 1            # the last is the forced end
        assert n == targets[i]
        toks = out.tokens[i, :n].tolist()
        logits = ref.logits(encode(t), toks, targets[i])
        gaps = check.token_gaps(logits, toks, c)
        assert float(gaps.max()) < 1e-4
        assert check.guarded(logits, c).argmax(1).tolist() == toks
        # a changed token reads a wide gap
        wrong = [(v + 1) % 64 for v in toks]
        assert float(check.token_gaps(logits, wrong, c).max()) > 1e-2


def test_reference_vocoder_matches_the_port():
    from t5gemma_tts_tpu_torch.codec.model import decode_code

    c = tiny.CONFIG
    raw = weights.codec_params(c, 9, "cpu")
    ccfg = model_config.codec_config(c)
    codes = np.random.default_rng(0).integers(0, 64, 37)
    port = decode_code(raw, ccfg, torch.tensor(codes)[None])[0]
    want = vocoder.vocode(raw, c["codec"], codes.tolist())
    assert want.shape == port.shape == (37 * 10,)
    assert float((port - want).norm() / want.norm()) < 1e-5
    low = vocoder.vocode(raw, c["codec"], codes.tolist(), torch.bfloat16)
    assert check.wav_error(low.numpy(), want) > 1e-3


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_same_seed_same_weights():
    a = weights.voice_params(tiny.CONFIG, 2 ** 31 + 5, "cpu")
    b = weights.voice_params(tiny.CONFIG, 2 ** 31 + 5, "cpu")
    for (pa, ta), (pb, tb) in zip(_leaves(a), _leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
    assert float(a["head"]["b2"][-5:].max()) == weights.SPECIAL_BIAS
    c = weights.voice_params(tiny.CONFIG, 6, "cpu")
    assert not torch.equal(a["head"]["w2"], c["head"]["w2"])

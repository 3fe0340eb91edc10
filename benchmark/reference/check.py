"""What decides ``correct`` for a served cell, once the window has closed and
the program's state is freed: a sample of the finished requests, drawn from
the seed with the longest among them, is run through the plain reference
(the raw weights drawn again from the seed).

- ``logit_gap``: over every served token of the sample, the widest gap by
  which the reference's logit of the token the program chose lies below
  the reference's best, with the engine's EOG guards applied to both (the
  traffic decodes greedily, so the program's choice is its own best);
- ``logit_gap_mean``: that gap's mean over the served tokens (most read
  0): where the program's own logits are bfloat16, the widest gap is
  their rounding at the top logits' size and does not part the program
  from a lower precision, while the mean grows with the error's square.
- ``wav_rel_err``: over the sample, the largest relative L2 distance of the
  program's waveform from the reference vocoder's over the same codes;
- ``altered_gap_min`` and ``altered_gap_median``: the gap that each served
  token would read had it been altered to the next code where it was
  produced (a planted fault read in the reference), least and median over
  the sample: a limit on ``logit_gap`` under the least catches every such
  token.

A cell holds those in ``benchmark/limits/<cell>.json`` to their limits; the
others are printed as notes.
"""

from __future__ import annotations

import gc
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..harness import weights
from . import model as ref_model
from . import vocoder as ref_vocoder

@dataclass
class Served:
    ids: List[int]          # the text's ids, as the program got them
    target: int             # frames: int(frames_per_s * duration)
    tokens: List[int]       # the served codes, in order
    wav: np.ndarray         # the program's waveform


def sample(served: Sequence[Served], seed: int, n) -> List[Served]:
    """``n`` of the finished requests (``"all"``: every one), drawn from
    the seed, the longest first among them."""
    if not served:
        return []
    n = len(served) if n == "all" else int(n)
    order = sorted(range(len(served)), key=lambda i: -len(served[i].tokens))
    rest = order[1:]
    random.Random(f"{int(seed)}/check").shuffle(rest)
    return [served[i] for i in [order[0]] + rest[:max(n - 1, 0)]]


def guarded(logits: torch.Tensor, config: Dict) -> torch.Tensor:
    """The engine's EOG guards (``decode/engine.py``): at step 0 the end
    token is out (-1e9), up to ``frames_per_s // 5`` held at -10000."""
    t = config["tts"]
    eog = int(t["audio_vocab_size"]) + 3       # eos, the inference end token
    out = logits.clone()
    steps = torch.arange(out.shape[0], device=out.device)
    col = torch.where(steps <= int(t["frames_per_s"]) // 5,
                      torch.full_like(out[:, eog], -10000.0), out[:, eog])
    col[0] = -1e9
    out[:, eog] = col
    return out


def token_gaps(ref_logits: torch.Tensor, tokens: Sequence[int],
               config: Dict) -> torch.Tensor:
    """[n]: each served token's gap below the reference's best."""
    adj = guarded(ref_logits.float(), config)
    tok = torch.tensor(list(tokens), dtype=torch.long, device=adj.device)
    chosen = adj.gather(1, tok[:, None])[:, 0]
    return adj.max(dim=1).values - chosen


def wav_error(got: np.ndarray, want: torch.Tensor) -> float:
    want = want.float().cpu().numpy()
    n = min(len(got), len(want))
    if n == 0 or len(got) != len(want):
        return float("inf")
    return float(np.linalg.norm(got[:n] - want[:n])
                 / max(np.linalg.norm(want[:n]), 1e-30))


def served_checks(config: Dict, seed: int, device, picked: Sequence[Served],
                  control: bool = False) -> Dict[str, float]:
    """The two numbers over the picked requests (see the module
    docstring); call it with the program's state freed. With ``control``
    the vocoder's number is the reference's own in bfloat16 against it in
    float32 (the program has no lower-precision vocoder of its own; its
    decoder's lower-precision path is switched on by the caller)."""
    if not picked:
        return {"logit_gap": float("inf"), "logit_gap_mean": float("inf"),
                "wav_rel_err": float("inf")}
    raw = weights.voice_params(config, seed, device)
    ref = ref_model.Reference(config, raw)
    va = int(config["tts"]["audio_vocab_size"])
    gaps, altered = [], []
    for s in picked:
        logits = ref.logits(s.ids, s.tokens, s.target)
        gaps.append(token_gaps(logits, s.tokens, config))
        altered.append(token_gaps(logits, [(t + 1) % va for t in s.tokens],
                                  config))
    gaps, altered = torch.cat(gaps), torch.cat(altered)
    del ref, raw, logits
    gc.collect()
    craw = weights.codec_params(config, seed, device)
    with ref_model.exact_f32():
        def got(s):
            if not control:
                return s.wav
            return ref_vocoder.vocode(craw, config["codec"], s.tokens,
                                      torch.bfloat16).float().cpu().numpy()
        err = max(wav_error(got(s), ref_vocoder.vocode(
            craw, config["codec"], s.tokens)) for s in picked)
    del craw
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"logit_gap": float(gaps.max()),
            "logit_gap_mean": float(gaps.mean()), "wav_rel_err": err,
            "altered_gap_min": float(altered.min()),
            "altered_gap_median": float(altered.median())}

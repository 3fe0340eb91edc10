"""Speculative multi-token decoding: draft k tokens, verify them in one pass.

Counterpart of ``t5gemma_tts_tpu/decode/speculative.py``. Each pass samples
the current token as the sequential engine does, asks a draft source for k
more, runs the decoder once over the k + 1 tokens, and samples the targets
along the chain; the longest prefix of drafts that equal their targets is
accepted.

- Exactness by construction: every token is sampled with the engine's own
  ``sample_step_token`` at its absolute step, whose draws depend only on
  (seed, step) (``ops/sampling.step_uniform``). A token sampled at step s from
  the same logits is the same whether the sequential loop or a verify pass
  draws it, so the draft changes how many passes the stream takes, not the
  stream. The verify pass sums otherwise than the sequential step (the
  decode-layer kernels' chain variant with quantized weights; the
  one-segment kernel and the chain merge with bf16 weights), so the two
  agree exactly only where every rounding does (the unfused paths on the
  CPU in f32); elsewhere a near-tie may sample a different, equally
  valid, token, and the stream then depends on the draft.
- Scalar advance: all rows advance by the least acceptance over the rows
  still active (clamped at the buffer's end); targets drawn beyond it are
  discarded and drawn again, identically, by the next pass. At batch 1 the
  whole per-row acceptance is realized.
- Draft sources: :func:`mtp_draft_fn` (multi-token-prediction heads, one
  small MLP per lookahead position, greedy) and :func:`trace_draft_fn`
  (replays a token trace: the oracle for tests and for measuring the
  speedup at a chosen acceptance rate). :func:`mtp_loss` trains the
  heads.

Caches: the dense cache (an S-token block per row through
``t5gemma.decoder_forward``) and the paged caches through
``t5gemma.paged_decode_multi``: bf16 and float8 pages with bf16 weights
take the one-segment paged kernel and the chain merge; W8A8 or int4
weights over bf16 or int8 pages take ``megakernel.decode_stack(chain=k+1)``;
``paged_i8`` runs only there.

Over a mesh (a rank's shard inside ``parallel.tensor.model_parallel``) a
data-parallel rank decodes its own rows and draws its rows of the whole
batch's uniforms (``tensor.first_row``, as ``engine.StepInputs.row0``); a
tensor-parallel rank runs its own heads and columns, its chain block sized
with its own kv heads (``tensor.local_dims``). The hidden state after the
model group's sums is the same on every rank, so every rank drafts the
same tokens (the MTP heads are whole on every rank) and accepts the same
prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from ..config import DecodeConfig, VoiceConfig
from ..models import t5gemma, voice
from ..ops import masks as mask_ops
from ..ops import rope as rope_ops
from ..parallel import tensor as tp
from . import engine

PyTree = Any

# draft_fn(last_hidden [B, 1, D], cur_token [B], step) -> [B, k] int32
DraftFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


# ---------------------------------------------------------------------------
# draft sources
# ---------------------------------------------------------------------------


def init_mtp_heads(generator: torch.Generator, cfg: VoiceConfig, k: int,
                   dtype=None) -> List[Dict[str, torch.Tensor]]:
    """k lookahead heads on ``generator``'s device; head j guesses the
    token j + 1 steps ahead of the hidden state."""
    d = cfg.backbone.decoder.hidden_size
    v = cfg.audio_embedding_vocab
    dtype = dtype or voice.compute_dtype(cfg)
    dev = generator.device

    def normal(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * d ** -0.5).to(dtype)

    return [{"w1": normal(d, d), "w2": normal(d, v)} for _ in range(k)]


def mtp_logits(heads: List[Dict[str, torch.Tensor]],
               hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, D] -> [B, k, V] lookahead logits (tanh-GELU MLP per
    head), f32."""
    outs = [F.gelu(hidden @ h["w1"], approximate="tanh") @ h["w2"]
            for h in heads]
    return torch.stack(outs, dim=1).float()


def mtp_loss(heads: List[Dict[str, torch.Tensor]], hidden: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The draft heads' training objective: hidden [B, T, D] (decoder
    states; detach them to train the heads alone), targets [B, T] next-token
    labels, mask [B, T] valid positions. Head j predicts the target j + 1
    further ahead; the mean NLL over the positions valid at both ends, in
    f32. Autograd gives its gradient."""
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for j, head in enumerate(heads):
        sh = j + 1
        m = (mask[:, sh:] & mask[:, :-sh]).float()
        logits = F.gelu(hidden[:, :-sh] @ head["w1"],
                        approximate="tanh") @ head["w2"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[:, sh:, None].long())[..., 0]
        total = total + (nll * m).sum()
        count = count + m.sum()
    return total / count.clamp(min=1.0)


def mtp_draft_fn(heads: List[Dict[str, torch.Tensor]]) -> DraftFn:
    def draft(last_hidden, cur_token, step):
        logits = mtp_logits(heads, last_hidden[:, 0])
        return logits.argmax(dim=-1).to(torch.int32)

    return draft


def trace_draft_fn(trace: torch.Tensor, k: int) -> DraftFn:
    """Oracle draft replaying ``trace`` [B, T]: position step + 1 + j
    proposes trace[:, step + 1 + j] (0 past its end). Corrupt the trace
    beforehand to dial the acceptance rate. A trace of the whole batch
    drafts a data-parallel rank's rows from its own rows of it
    (``tensor.first_row``)."""
    b, t = trace.shape
    padded = F.pad(trace.to(torch.int32), (0, k + 1))

    def draft(last_hidden, cur_token, step):
        rows = padded
        if cur_token.shape[0] != b:
            r0 = tp.first_row(cur_token.shape[0])
            rows = padded[r0:r0 + cur_token.shape[0]]
        idx = (step + 1 + torch.arange(k, device=padded.device)).clamp_max(
            t + k)
        return rows[:, idx].to(cur_token.device)

    return draft


# ---------------------------------------------------------------------------
# speculative loop
# ---------------------------------------------------------------------------


class SpecOutputs(NamedTuple):
    tokens: torch.Tensor     # [B, max_frames]
    gen_lens: torch.Tensor   # [B]
    steps: int               # generated tokens when the loop exited
    passes: int              # decoder passes (speedup = steps / passes)


@torch.inference_mode()
def decode_tokens_speculative(params: PyTree, cfg: VoiceConfig,
                              dcfg: DecodeConfig, x, x_lens, prompt,
                              prompt_lens, target_totals, seed: int,
                              draft_fn: DraftFn, k: int) -> SpecOutputs:
    """Speculative counterpart of ``engine.decode_tokens`` (same inputs; the
    token stream is the sequential engine's, see the module notes). Over a
    mesh: a rank's shard inside ``parallel.tensor.model_parallel``."""
    dev = x.device
    kv_mode = engine.resolve_kv_mode(cfg, dcfg, prompt.shape[1] + 1,
                                     dcfg.max_frames + k, dev)
    dcfg = dataclasses.replace(dcfg, kv_cache=kv_mode)
    paged = kv_mode != "dense"
    s = cfg.special
    eog = cfg.eog_inference
    dims = cfg.backbone.decoder
    cdt = voice.compute_dtype(cfg)
    max_steps = dcfg.max_frames
    b = x.shape[0]
    x_lens = x_lens.to(torch.int32)
    row0 = tp.first_row(b)

    st = engine.prefill(params, cfg, dcfg, x, x_lens, prompt, prompt_lens,
                        target_totals, cache_slack=k)
    if paged:
        hkv = tp.local_dims(params["decoder"]["layers"], dims)[0].num_kv_heads
        chain_shape = (dims.num_layers, b, k + 1, hkv, dims.head_dim)
        pend_k = torch.zeros(chain_shape, dtype=torch.bfloat16, device=dev)
        pend_v = torch.zeros_like(pend_k)
        flush_start = 0
    prompt_offset = (prompt_lens + 1).to(torch.int32)
    est_total, time_budget, text_budget = engine.decode_budgets(
        cfg, x_lens, prompt_lens, target_totals)
    offs = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
    silence = engine.silence_tensor(dcfg, dev)

    def guarded_token(logits, step, prev, consec):
        """sample + the engine's force-stop rules at absolute ``step``."""
        token, argmax_tok = engine.sample_step_token(
            cfg, dcfg, logits, step, prev, consec, seed, silence, row0=row0)
        return engine.apply_stop_rules(cfg, token, argmax_tok, step,
                                       text_budget, time_budget, max_steps)

    def chain_update(token, prev, consec, done):
        """(prev token, silence counter, done) after emitting ``token``."""
        now_done = done | (~done & (token == eog))
        return (token, engine.silence_counter_update(silence, token, prev,
                                                     consec), now_done)

    tokens, step, passes = st.tokens, 0, 0
    cache, last_hidden, cur_len = st.cache, st.last_hidden, st.current_length
    prev, consec, done, gen_lens = (st.prev_token, st.consec_silence,
                                    st.done, st.gen_lens)
    while step < max_steps and not bool(done.all()):
        # ---- current token (as the sequential body) -----------------------
        logits = voice.predict_head(params["head"], last_hidden)[:, 0]
        token = guarded_token(logits, step, prev, consec)
        active = ~done
        tokens[:, step] = torch.where(active, token, s.pad)
        gen_lens = torch.where(active & (token == eog), step + 1, gen_lens)
        prev, consec, done = chain_update(token, prev, consec, done)
        done0 = done

        # ---- draft + one (k+1)-token verify pass ---------------------------
        drafts = draft_fn(last_hidden, token, step)              # [B, k]
        seq = torch.cat([token[:, None], drafts.to(token.dtype)], dim=1)
        emb = voice.embed_audio(params, seq).to(cdt)
        abs_pos = cur_len[:, None] + offs                        # [B, k+1]
        if cfg.use_pm_rope:
            pos = rope_ops.decode_step_position(
                abs_pos, est_total[:, None], cfg.progress_scale)
        else:
            pos = abs_pos.float()
        pm = pos if cfg.use_pm_rope else None
        if paged:
            hidden, cache, pend_k, pend_v = t5gemma.paged_decode_multi(
                params["decoder"], dims, inputs_embeds=emb, position_ids=pos,
                pm_decoder_positions=pm, cache=cache, pending_k=pend_k,
                pending_v=pend_v, flush_start=flush_start, step=step,
                prompt_lengths=prompt_offset, enc_lengths=x_lens)
            flush_start = step
        else:
            t_max = cache.self_k.shape[3]
            kk = torch.arange(t_max, device=dev)[None, None, :]
            ok_full = kk <= abs_pos[:, :, None]
            ok_slid = ok_full & (
                abs_pos[:, :, None] - dims.sliding_window < kk)
            hidden, cache = t5gemma.decoder_forward(
                params["decoder"], dims, inputs_embeds=emb,
                self_full_bias=torch.where(ok_full, 0.0,
                                           mask_ops.NEG_INF)[:, None],
                self_sliding_bias=torch.where(ok_slid, 0.0,
                                              mask_ops.NEG_INF)[:, None],
                cross_bias=mask_ops.cross_bias(x_lens, k + 1,
                                               cache.cross_k.shape[3]),
                position_ids=pos, pm_decoder_positions=pm,
                cross_k=cache.cross_k, cross_v=cache.cross_v, cache=cache,
                cache_pos=cur_len.long())

        # ---- targets along the draft chain ---------------------------------
        all_logits = voice.predict_head(params["head"], hidden)  # [B,k+1,V]
        emit = active            # row still producing at chain position i
        n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
        chain = []               # per position: (token, prev, consec, done)
        for i in range(k):
            t_i = guarded_token(all_logits[:, i], step + 1 + i, prev, consec)
            chain.append((t_i, prev, consec, done))
            match = (t_i == drafts[:, i]) & emit & ~done
            n_acc = n_acc + match.to(torch.int32)
            emit = match
            prev, consec, done = chain_update(t_i, prev, consec, done)

        # scalar advance: the least acceptance over still-active rows
        m = int(torch.where(done0, k, n_acc).min())
        m = max(min(m, max_steps - 2 - step), 0)

        # write the m accepted targets; roll the bookkeeping to position m
        prev, consec, done = chain[0][1], chain[0][2], chain[0][3]
        adv = torch.where(done0, 0, 1)
        run_done = done0
        for i in range(m):
            t_i, p_i, c_i, d_i = chain[i]
            write = ~d_i
            col = step + 1 + i
            tokens[:, col] = torch.where(write, t_i, tokens[:, col])
            gen_lens = torch.where(write & (t_i == eog), col + 1, gen_lens)
            prev, consec, done = chain_update(t_i, p_i, c_i, d_i)
            # current_length: +1 per processed position while the row was
            # active and the token was not EOG (sequential semantics)
            use = ~d_i & ~run_done
            adv = adv + (use & (t_i != eog)).to(adv.dtype)
            run_done = run_done | (use & (t_i == eog))
        cur_len = cur_len + adv.to(cur_len.dtype)
        last_hidden = hidden[:, m:m + 1].to(cdt)
        step += 1 + m
        passes += 1

    gen_lens = torch.where(done, gen_lens, step)
    return SpecOutputs(tokens=tokens[:, :max_steps], gen_lens=gen_lens,
                       steps=step, passes=passes)


def speculative_decoder(cfg: VoiceConfig, dcfg: DecodeConfig, k: int):
    """Entry point with the configuration bound (the port's counterpart of
    ``jitted_speculative_decoder``): ``run(params, x, x_lens, prompt,
    prompt_lens, target_totals, seed, draft_fn) -> SpecOutputs``."""
    def run(params, x, x_lens, prompt, prompt_lens, target_totals, seed,
            draft_fn):
        return decode_tokens_speculative(
            params, cfg, dcfg, x, x_lens, prompt, prompt_lens, target_totals,
            seed, draft_fn, k)

    return run

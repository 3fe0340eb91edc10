"""Autoregressive audio-token decode engine, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/decode/engine.py``: text encoding, the
cross K/V built once, prompt prefill into a dense or paged KV cache, and a
loop that per step runs the prediction head, the guarded sampling and the
stop rules, then the decoder on one token. Stop-rule semantics (guard order
and values) are those of the JAX engine:

  1. the first generated token can never be EOG (-1e9); steps up to
     sr // 5 suppress EOG at -10000;
  2. consecutive-silence logit penalty;
  3. forced stop when the sampled token or the argmax of the adjusted
     logits is EOG;
  4. text-guard and target-duration budgets, and the buffer's end.

The step body is the JAX body: every piece of loop state, the step counter
included, is a device tensor, and every step-dependent rule is a ``where``
on it, so the body reads nothing back to the host. It is predicated as
JAX's ``cond`` is: a body run once every row is done, or at the buffer's
end, leaves ``tokens``, ``gen_lens``, ``done`` and ``step`` as they were.

Two ways to run the loop:

- :func:`decode_tokens`, the eager loop (the counterpart of the un-jitted
  JAX ``decode_tokens``): the body's ops launched one by one, and the
  all-done flag read each step. Tests and A/B runs use it.
- :func:`graphed_decoder` (the counterpart of ``jitted_decoder``) and
  :func:`graphed_segment_fns` (of ``jitted_segment_fns``): on the card, the
  step is captured once per shape bucket as a CUDA graph (the counterpart
  of ``jax.jit`` + ``lax.while_loop``) and replayed; the host reads the
  all-done flag a few replays late, through pinned memory and events, and
  never waits on the step it just launched; the replays that it launches
  past the end are no-ops by the predication. On the CPU they run the
  eager loop, because the caller asked for the CPU. A capture or a replay
  that fails raises: there is no eager fallback on the card.

Draws are step-indexed: step s draws ``ops/sampling.step_uniform(seed, s,
...)``, a counter-based hash of (seed, step, row, column) alone (the
counterpart of the JAX engine's ``fold_in(rng, step)``), so any pass that
samples step s -- the eager loop, a graph replay or a speculative verify
pass (decode/speculative.py) -- draws the same numbers, on the CPU and on
the card. Greedy decoding (``top_k=1``) is token-equal to the JAX engine.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref
from typing import Any, NamedTuple, Optional, Union

import torch

from ..config import DecodeConfig, VoiceConfig
from ..models import t5gemma, voice
from ..ops import fused_attn, megakernel, paged_attn, quant
from ..ops import masks as mask_ops
from ..ops import rope as rope_ops
from ..ops import sampling

PyTree = Any
INT32_MAX = 2 ** 31 - 1
# Graph sessions kept, least recently used first out (the JAX engine keeps
# 32 compiled programs; a session also holds its bucket's KV cache).
MAX_SESSIONS = 8
# Replays that the host keeps in flight past the newest all-done flag it
# has read: the most no-op replays a finished decode can launch.
LOOKAHEAD = 2


def resolve_kv_mode(cfg: VoiceConfig, dcfg: DecodeConfig, prompt_len: int,
                    gen_len: int, device: torch.device) -> str:
    """Concrete KV-cache strategy: "auto" takes the paged cache on CUDA when
    prompt + generation fit the sliding window (so sliding == full and
    length-only masking is exact), the dense cache otherwise. The paged
    modes ("paged", "paged_f8", "paged_i8") raise when they do not fit."""
    dims = cfg.backbone.decoder
    ps = t5gemma.PAGE_SIZE
    total = t5gemma._pad_to(prompt_len, ps) + t5gemma._pad_to(gen_len, ps)
    mode = dcfg.kv_cache
    if mode == "auto":
        fits = total <= dims.sliding_window
        return "paged" if (device.type == "cuda" and fits) else "dense"
    if mode in ("paged", "paged_f8", "paged_i8"):
        if total > dims.sliding_window:
            raise ValueError(
                f"kv_cache={mode!r} needs prompt+gen ({total}) <= "
                f"sliding_window ({dims.sliding_window}); use dense")
        return mode
    if mode != "dense":
        raise ValueError(f"unknown kv_cache mode {mode!r}")
    return mode


def decode_budgets(cfg: VoiceConfig, x_lens, prompt_lens, target_totals):
    """Per-row (est_total, time_budget, text_budget); prompt_lens excludes
    BOS."""
    prompt_offset = prompt_lens + 1
    est_total = torch.maximum(target_totals + 1, prompt_offset)
    time_budget = (target_totals - prompt_offset
                   + int(int(cfg.encodec_sr) * cfg.extra_cutoff))
    if cfg.text_guard_frames_per_token > 0:
        text_budget = x_lens.clamp_min(1) * cfg.text_guard_frames_per_token
    else:
        text_budget = torch.full_like(x_lens, INT32_MAX // 2)
    return est_total, time_budget, text_budget


def silence_tensor(dcfg: DecodeConfig, device) -> Optional[torch.Tensor]:
    """The silence tokens as an int32 device tensor (None without any),
    built once per decode: a host-to-device copy has no place in a
    captured step."""
    if not dcfg.silence_tokens:
        return None
    return torch.tensor(dcfg.silence_tokens, dtype=torch.int32, device=device)


def apply_stop_rules(cfg: VoiceConfig, token, argmax_tok, step,
                     text_budget, time_budget, max_steps: int):
    """Force-stop guard: EOG sampled or argmax, text budget, duration
    budget, buffer exhaustion. ``step`` is an int or a 0-dim tensor."""
    eog = cfg.eog_inference
    force = (token == eog) | (argmax_tok == eog)
    force = force | (step > text_budget) | (step > time_budget)
    force = force | (step >= max_steps - 1)
    return torch.where(force, eog, token)


def silence_counter_update(silence: Optional[torch.Tensor], token,
                           prev_token, consec):
    """Consecutive-silence run-length bookkeeping (``silence`` from
    :func:`silence_tensor`)."""
    if silence is None:
        return torch.zeros_like(consec)
    is_sil = (token[:, None] == silence[None, :]).any(dim=1)
    return torch.where(is_sil & (token == prev_token), consec + 1, 0)


class DecodeOutputs(NamedTuple):
    tokens: torch.Tensor     # [B, max_steps] generated tokens (incl. EOG)
    gen_lens: torch.Tensor   # [B] generated tokens incl. EOG
    steps: int               # loop iterations that advanced the step
    # step bodies launched on the device for this decode: ``steps`` in the
    # eager loop; with the graph also a first session's eager warm-up step
    # and the no-op replays launched before the host read that every row
    # was done (at most LOOKAHEAD)
    launched_steps: int = 0


@dataclasses.dataclass(eq=False)       # hashed by identity: a stream's key
class LoopState:
    cache: Union[t5gemma.DecoderCache, t5gemma.PagedDecoderCache]
    last_hidden: torch.Tensor      # [B, 1, D]
    tokens: torch.Tensor           # [B, max_steps] int32
    step: torch.Tensor             # 0-dim int32 == generated count
    current_length: torch.Tensor   # [B] absolute length incl. BOS
    prev_token: torch.Tensor       # [B]
    consec_silence: torch.Tensor   # [B]
    done: torch.Tensor             # [B] bool
    gen_lens: torch.Tensor         # [B]


@dataclasses.dataclass
class StepInputs:
    """A request's per-row inputs to the step body, as device tensors: a
    graph session copies a new request's into its own."""

    x_lens: torch.Tensor          # [B] int32
    prompt_offset: torch.Tensor   # [B] int32, prompt length + BOS
    est_total: torch.Tensor       # [B]
    time_budget: torch.Tensor     # [B]
    text_budget: torch.Tensor     # [B]
    seed: torch.Tensor            # 0-dim int64


def step_inputs(cfg: VoiceConfig, x_lens, prompt_lens, target_totals,
                seed: Union[int, torch.Tensor]) -> StepInputs:
    """A request's StepInputs: its budgets (:func:`decode_budgets`) and
    its seed as a device tensor."""
    x_lens = x_lens.to(torch.int32)
    est_total, time_budget, text_budget = decode_budgets(
        cfg, x_lens, prompt_lens, target_totals)
    return StepInputs(
        x_lens=x_lens, prompt_offset=(prompt_lens + 1).to(torch.int32),
        est_total=est_total, time_budget=time_budget,
        text_budget=text_budget,
        seed=sampling.as_int64(seed, x_lens.device))


def _adjust_logits(cfg: VoiceConfig, dcfg: DecodeConfig, logits, step,
                   prev_token, consec_silence, silence):
    """EOG suppression + silence-repetition penalty on raw f32 logits
    (``step`` a 0-dim tensor)."""
    eog = cfg.eog_inference
    logits = logits.clone()
    col = torch.where(step <= int(cfg.encodec_sr) // 5, -10000.0,
                      logits[:, eog])
    logits[:, eog] = torch.where(step == 0, -1e9, col)
    if dcfg.stop_repetition > 0 and silence is not None:
        is_silence = (prev_token[:, None] == silence[None, :]).any(dim=1)
        active = is_silence & (consec_silence > dcfg.stop_repetition)
        factor = (consec_silence - (dcfg.stop_repetition - 1)).float()
        prev = prev_token.long().clamp_min(0)[:, None]
        prev_logit = torch.gather(logits, 1, prev)[:, 0]
        penalized = torch.where(prev_logit < 0, prev_logit * factor,
                                prev_logit / factor.clamp_min(1.0))
        new_prev = torch.where(active, penalized, prev_logit)
        logits.scatter_(1, prev, new_prev[:, None])
    return logits


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig, x, x_lens,
            prompt, prompt_lens, target_totals,
            cache_slack: int = 0) -> LoopState:
    """Encode the text, build the cross K/V, and prefill the prompt into the
    KV cache; returns the loop state at step 0. ``x`` [B, Tx], ``prompt``
    [B, P] and the [B] lengths/targets are int32 tensors on the device.
    ``cache_slack`` widens the cache and the token buffer by that many slots
    past ``max_frames`` (a speculative verify pass writes a (k+1)-token
    block whose tail may reach past it)."""
    s = cfg.special
    dims = cfg.backbone.decoder
    dev = x.device
    b, p_max = prompt.shape
    max_steps = dcfg.max_frames + cache_slack
    t_max = p_max + 1 + max_steps
    cdt = voice.compute_dtype(cfg)

    memory, enc_pos = voice.encode_text(params, cfg, x, x_lens)
    pm_enc = enc_pos if cfg.use_pm_rope else None
    cross_k, cross_v = t5gemma.build_cross_kv(params["decoder"], dims, memory,
                                              pm_enc)

    bos = torch.full((b, 1), s.empty, dtype=prompt.dtype, device=dev)
    cated = torch.cat([bos, prompt], dim=1)
    cated_lens = prompt_lens + 1
    est_total = torch.maximum(target_totals + 1, cated_lens)

    base = torch.arange(p_max + 1, dtype=torch.float32, device=dev)[None, :]
    if cfg.use_pm_rope:
        denom = (est_total - 1).clamp_min(1).float()[:, None]
        prefill_pos = base / denom * cfg.progress_scale
    else:
        prefill_pos = base.expand(b, p_max + 1)
    embedded = voice.embed_audio(params, cated).to(cdt)

    kv_mode = resolve_kv_mode(cfg, dcfg, p_max + 1, max_steps, dev)
    t_keys = t_max if kv_mode == "dense" else p_max + 1
    q_idx = torch.arange(p_max + 1, device=dev)[:, None]
    k_idx = torch.arange(t_keys, device=dev)[None, :]
    causal = (k_idx <= q_idx)[None, None]
    slid = causal & (q_idx - dims.sliding_window < k_idx)[None, None]
    full_bias = torch.where(causal, 0.0, mask_ops.NEG_INF).expand(
        b, 1, p_max + 1, t_keys)
    sliding_bias = torch.where(slid, 0.0, mask_ops.NEG_INF).expand(
        b, 1, p_max + 1, t_keys)
    cross_b = mask_ops.cross_bias(x_lens, p_max + 1, x.shape[1])
    pm_dec = prefill_pos if cfg.use_pm_rope else None

    if kv_mode == "dense":
        cache = t5gemma.init_cache(dims, b, t_max, x.shape[1], dtype=cdt,
                                   device=dev)
        hidden, cache = t5gemma.decoder_forward(
            params["decoder"], dims, inputs_embeds=embedded,
            self_full_bias=full_bias, self_sliding_bias=sliding_bias,
            cross_bias=cross_b, position_ids=prefill_pos,
            pm_decoder_positions=pm_dec, cross_k=cross_k, cross_v=cross_v,
            cache=cache)
    else:
        store = paged_attn.KV_STORE_DTYPES[
            {"paged_f8": "f8", "paged_i8": "i8"}.get(kv_mode, "bf16")]
        cache = t5gemma.init_paged_cache(dims, b, p_max + 1, max_steps,
                                         x.shape[1], store_dtype=store,
                                         device=dev)
        hidden, cache = t5gemma.paged_prefill(
            params["decoder"], dims, inputs_embeds=embedded,
            self_full_bias=full_bias, self_sliding_bias=sliding_bias,
            cross_bias=cross_b, position_ids=prefill_pos,
            pm_decoder_positions=pm_dec, cross_k=cross_k, cross_v=cross_v,
            cache=cache)
    last = (cated_lens - 1).long()[:, None, None].expand(-1, 1,
                                                         hidden.shape[-1])
    last_hidden = torch.gather(hidden, 1, last)
    return LoopState(
        cache=cache,
        last_hidden=last_hidden,
        tokens=torch.full((b, max_steps), s.pad, dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        current_length=cated_lens.to(torch.int32),
        prev_token=torch.full((b,), -1, dtype=torch.int32, device=dev),
        consec_silence=torch.zeros((b,), dtype=torch.int32, device=dev),
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
        gen_lens=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# the per-step body
# ---------------------------------------------------------------------------


def _candidate_sample(cfg: VoiceConfig, dcfg: DecodeConfig, logits, step,
                      prev_token, consec_silence, seed, silence):
    """Top-(k+2) candidate path: every adjustment lowers at most two tokens
    (EOG + the repeated silence token), so the adjusted top-k lies inside
    the raw top-(k+2) candidates."""
    eog = cfg.eog_inference
    kk = min(dcfg.top_k + 2, cfg.audio_embedding_vocab)
    vals, idx = torch.topk(logits, kk, dim=-1)
    vals = vals.float()
    is_eog = idx == eog
    vals = torch.where(is_eog & (step <= int(cfg.encodec_sr) // 5),
                       -10000.0, vals)
    vals = torch.where(is_eog & (step == 0), -1e9, vals)
    if dcfg.stop_repetition > 0 and silence is not None:
        prev_is_sil = (prev_token[:, None] == silence[None, :]).any(dim=1)
        active = prev_is_sil & (consec_silence > dcfg.stop_repetition)
        factor = (consec_silence - (dcfg.stop_repetition - 1)).float()
        at_prev = idx == prev_token[:, None]
        pen = torch.where(vals < 0, vals * factor[:, None],
                          vals / factor.clamp_min(1.0)[:, None])
        vals = torch.where(at_prev & active[:, None], pen, vals)
    argmax_tok = torch.gather(idx, 1, vals.argmax(dim=-1, keepdim=True))[:, 0]
    uniforms = sampling.step_uniform(seed, step, *vals.shape, logits.device)
    token = sampling.sample_from_candidates(
        uniforms, vals, idx, top_k=dcfg.top_k, top_p=dcfg.top_p,
        temperature=dcfg.temperature)
    return token, argmax_tok.to(torch.int32)


def sample_step_token(cfg: VoiceConfig, dcfg: DecodeConfig, logits, step,
                      prev_token, consec_silence, seed,
                      silence: Optional[torch.Tensor] = None):
    """One step's guarded sampling -> (token [B], argmax_tok [B]), drawn
    from ``sampling.step_uniform(seed, step, ...)``. ``step`` and ``seed``
    are ints or 0-dim device tensors; ``silence`` comes from
    :func:`silence_tensor`."""
    step = sampling.as_int64(step, logits.device)
    if dcfg.top_k and dcfg.top_k > 0 and not (0.0 < dcfg.min_p < 1.0):
        return _candidate_sample(cfg, dcfg, logits, step, prev_token,
                                 consec_silence, seed, silence)
    adjusted = _adjust_logits(cfg, dcfg, logits.float(), step, prev_token,
                              consec_silence, silence)
    uniforms = sampling.step_uniform(seed, step, *adjusted.shape,
                                     logits.device)
    token = sampling.sample(adjusted, uniforms, top_k=dcfg.top_k,
                            top_p=dcfg.top_p, min_p=dcfg.min_p,
                            temperature=dcfg.temperature)
    return token, sampling.greedy(adjusted)


def _make_body(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig,
               inp: StepInputs):
    """The loop body (JAX ``engine.py::_make_body``): LoopState -> the next
    LoopState, with the caches written in place. It reads no device value
    on the host, so a CUDA graph captures it; past the buffer's end or once
    every row is done it leaves ``tokens``, ``gen_lens``, ``done`` and
    ``step`` unchanged."""
    s = cfg.special
    eog = cfg.eog_inference
    dims = cfg.backbone.decoder
    cdt = voice.compute_dtype(cfg)
    max_steps = dcfg.max_frames
    silence = silence_tensor(dcfg, inp.x_lens.device)

    def body(st: LoopState) -> LoopState:
        step = st.step
        paged = isinstance(st.cache, t5gemma.PagedDecoderCache)
        go = (step < max_steps) & ~st.done.all()
        logits = voice.predict_head(params["head"], st.last_hidden)[:, 0]
        token, argmax_tok = sample_step_token(
            cfg, dcfg, logits, step, st.prev_token, st.consec_silence,
            inp.seed, silence)
        token = apply_stop_rules(cfg, token, argmax_tok, step,
                                 inp.text_budget, inp.time_budget, max_steps)

        newly_active = ~st.done & go
        col = step.clamp_max(st.tokens.shape[1] - 1).long().reshape(1)
        write = torch.where(~st.done, token, s.pad)
        kept = st.tokens.index_select(1, col)[:, 0]
        st.tokens.index_copy_(1, col, torch.where(go, write, kept)[:, None])
        stopped = newly_active & (token == eog)
        now_done = st.done | stopped
        gen_lens = torch.where(stopped, step + 1, st.gen_lens)
        consec = silence_counter_update(silence, token, st.prev_token,
                                        st.consec_silence)

        emb = voice.embed_audio(params, token[:, None]).to(cdt)
        if cfg.use_pm_rope:
            pos = rope_ops.decode_step_position(
                st.current_length, inp.est_total,
                cfg.progress_scale)[:, None]
        else:
            pos = st.current_length.float()[:, None]
        pm = pos if cfg.use_pm_rope else None
        if paged:
            hidden, cache = t5gemma.paged_decode_step(
                params["decoder"], dims, inputs_embeds=emb, position_ids=pos,
                pm_decoder_positions=pm, cache=st.cache, step=step,
                prompt_lengths=inp.prompt_offset, enc_lengths=inp.x_lens)
        else:
            t_max = st.cache.self_k.shape[3]
            t_enc = st.cache.cross_k.shape[3]
            hidden, cache = t5gemma.decoder_forward(
                params["decoder"], dims, inputs_embeds=emb,
                self_full_bias=mask_ops.step_self_bias(
                    st.current_length, t_max),
                self_sliding_bias=mask_ops.step_self_bias(
                    st.current_length, t_max, window=dims.sliding_window),
                cross_bias=mask_ops.cross_bias(inp.x_lens, 1, t_enc),
                position_ids=pos, pm_decoder_positions=pm,
                cross_k=st.cache.cross_k, cross_v=st.cache.cross_v,
                cache=st.cache, cache_pos=st.current_length.long())
        current_length = torch.where(now_done, st.current_length,
                                     st.current_length + 1)
        return LoopState(cache=cache, last_hidden=hidden, tokens=st.tokens,
                         step=step + go.to(step.dtype),
                         current_length=current_length, prev_token=token,
                         consec_silence=consec, done=now_done,
                         gen_lens=gen_lens)

    return body


def _outputs(state: LoopState, steps: int, launched: int) -> DecodeOutputs:
    gen_lens = torch.where(state.done, state.gen_lens, state.step)
    return DecodeOutputs(tokens=state.tokens, gen_lens=gen_lens, steps=steps,
                         launched_steps=launched)


# ---------------------------------------------------------------------------
# the eager loop
# ---------------------------------------------------------------------------


@torch.inference_mode()
def decode_tokens(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig, x,
                  x_lens, prompt, prompt_lens, target_totals,
                  seed: int) -> DecodeOutputs:
    """Full batched synthesis of audio tokens (all inputs int32 tensors on
    the device where the model runs), eagerly: the all-done flag is read
    each step. Step s draws ``sampling.step_uniform(seed, s, ...)``;
    :func:`graphed_decoder` is the served form."""
    state = prefill(params, cfg, dcfg, x, x_lens, prompt, prompt_lens,
                    target_totals)
    body = _make_body(params, cfg, dcfg, step_inputs(
        cfg, x_lens, prompt_lens, target_totals, seed))
    steps = 0
    while steps < dcfg.max_frames and not bool(state.done.all()):
        state = body(state)
        steps += 1
    return _outputs(state, steps, steps)


@torch.inference_mode()
def run_segment(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig,
                state: LoopState, x_lens, prompt_lens, target_totals, seed,
                until) -> LoopState:
    """Advance the decode loop while ``step < until`` (and the buffer has
    room and a row is active), with the semantics of the corresponding
    slice of :func:`decode_tokens` (JAX ``engine.py::run_segment``): the
    block that streaming synthesis is built on. On the CPU the body runs
    eagerly. On the card ``state`` must come from the prefill of
    :func:`graphed_segment_fns`, and the segment replays its bucket's
    captured step over the session's buffers: it loads the stream into
    them first if another stream or a one-shot request holds them, and
    captures a new session if its own was evicted. Returns ``state``,
    advanced: its loop tensors hold the progress, its KV cache is written
    back when the session lets the stream go."""
    until = int(until)
    if state.tokens.device.type == "cuda":
        stream = _STREAMS.get(state)
        if stream is None or stream.params is not params:
            raise ValueError(
                "on the card run_segment advances a state that the prefill "
                "of graphed_segment_fns returned, with the same params")
        inp = step_inputs(cfg, x_lens, prompt_lens, target_totals, seed)
        session, new = _bucket_session(stream.key, params, cfg, dcfg, state,
                                       inp)
        if session.holder is state:
            session.set_inputs(inp)
        else:
            session.load(state, inp, holder=state)
            session.launched += new      # the capture's warm-up step
        session.advance(until)
        session.write_back(cache=False)
        return state
    body = _make_body(params, cfg, dcfg, step_inputs(
        cfg, x_lens, prompt_lens, target_totals, seed))
    end = min(until, dcfg.max_frames)
    while int(state.step) < end and not bool(state.done.all()):
        state = body(state)
    return state


# ---------------------------------------------------------------------------
# the graphed loop: one captured step per shape bucket
# ---------------------------------------------------------------------------


def _counted_wrappers():
    """Every kernel wrapper that counts its launches in ``.launches``."""
    return (fused_attn.batch_paged_attention,
            fused_attn.fused_decode_attention, paged_attn.paged_flash_parts,
            megakernel.decode_layer, megakernel.decode_stack,
            quant.quantize_act, quant.w8a8_matmul, quant.w4a8_matmul,
            quant.w8a16_matmul)


def _tensors(obj):
    """(name, tensor) of a LoopState / StepInputs / cache, depth first."""
    if isinstance(obj, torch.Tensor):
        yield "", obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            for name, t in _tensors(obj[k]):
                yield f"{k}.{name}", t
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            for name, t in _tensors(getattr(obj, f.name)):
                yield f"{f.name}.{name}", t


def _copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the same-shaped tensor of ``dst``
    (a LoopState, StepInputs or cache)."""
    for (dn, d), (sn, s) in zip(_tensors(dst), _tensors(src), strict=True):
        if dn != sn or d.shape != s.shape:
            raise ValueError(f"session buffer {dn} {tuple(d.shape)} cannot "
                             f"take {sn} {tuple(s.shape)}")
        d.copy_(s)


def _clone(obj):
    """A copy of a LoopState / StepInputs with every tensor cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class _Stream:
    """Host record of a segment stream (a LoopState that the card's
    ``prefill_fn`` returned): its bucket's session key, its params, and
    its replay counters while no session holds it."""

    key: tuple
    params: PyTree
    issued: int = 0
    launched: int = 0
    ended: bool = False


class _Session:
    """One shape bucket's graphed decode loop: static state and input
    buffers (the KV cache, the LoopState, the request's StepInputs), the
    step captured over them as a CUDA graph, and the host's read of the
    all-done flag. A new request writes into the buffers with ``copy_``.
    The buffers hold one request at a time: a one-shot request of
    :func:`graphed_decoder`, or a segment stream (``holder``, the caller's
    LoopState), whose buffers and counters are written back to it before
    another request takes the session or the session is dropped."""

    def __init__(self, params, cfg: VoiceConfig, dcfg: DecodeConfig,
                 state: LoopState, inp: StepInputs):
        self.params, self.cfg, self.dcfg = params, cfg, dcfg
        self.state, self.inp = _clone(state), _clone(inp)
        dev = state.tokens.device
        self.finished = torch.zeros((), dtype=torch.bool, device=dev)
        self.flags = torch.zeros((LOOKAHEAD + 1,), dtype=torch.bool,
                                 pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(LOOKAHEAD + 1)]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launch_delta = ()
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.issued = 0          # replays since the request's prefill
        self.launched = 0        # step bodies launched for this request
        self.ended = False       # the host has read the all-done flag
        self.holder: Optional[LoopState] = None   # the stream held
        self.body = None

    @property
    def state_bytes(self) -> int:
        """Bytes of the session's buffers (the KV cache dominates)."""
        return sum(t.numel() * t.element_size()
                   for obj in (self.state, self.inp)
                   for _, t in _tensors(obj))

    def _step(self) -> None:
        new = self.body(self.state)
        st = self.state
        for name in ("last_hidden", "step", "current_length", "prev_token",
                     "consec_silence", "done", "gen_lens"):
            getattr(st, name).copy_(getattr(new, name))
        self.finished.copy_((st.step >= self.dcfg.max_frames)
                            | st.done.all())

    def capture(self) -> None:
        """One eager warm-up step (the kernels' first-call work: builds,
        attributes, workspaces), then the capture, both on a stream of the
        session's own, so that a capture that fails leaves no other stream
        in capture mode. The capture launches nothing: the wrappers' counts
        move by what it recorded only when a replay launches it."""
        self.body = _make_body(self.params, self.cfg, self.dcfg, self.inp)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._step()
        wrappers = _counted_wrappers()
        before = [w.launches for w in wrappers]
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    self._step()
                finally:
                    graph.capture_end()
        finally:
            delta = [w.launches - n for w, n in zip(wrappers, before)]
            for w, n in zip(wrappers, before):
                w.launches = n
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.launch_delta = tuple((w, d) for w, d in zip(wrappers, delta)
                                  if d)
        self.graph = graph

    def load(self, state: LoopState, inp: StepInputs,
             holder: Optional[LoopState] = None) -> None:
        """A request into the buffers: a one-shot request's prefilled state,
        or the stream ``holder`` (``state`` itself) with its counters. The
        stream held before is written back first."""
        self.release()
        _copy_into(self.state, state)
        self.set_inputs(inp)
        self.issued = self.launched = 0
        self.ended = False
        if holder is not None:
            rec = _STREAMS[holder]
            self.issued, self.launched, self.ended = (
                rec.issued, rec.launched, rec.ended)
        self.holder = holder

    @torch.inference_mode()      # the stream's tensors are inference tensors
    def write_back(self, cache: bool = True) -> None:
        """The held stream's buffers (without ``cache``, all but its KV
        cache) into its own tensors, and its counters into its record."""
        if self.holder is None:
            return
        for f in dataclasses.fields(LoopState):
            if cache or f.name != "cache":
                _copy_into(getattr(self.holder, f.name),
                           getattr(self.state, f.name))
        rec = _STREAMS.get(self.holder)
        if rec is not None:
            rec.issued, rec.launched, rec.ended = (
                self.issued, self.launched, self.ended)

    def release(self) -> None:
        """Let the held stream go, its state and counters written back."""
        self.write_back()
        self.holder = None

    def set_inputs(self, inp: StepInputs) -> None:
        _copy_into(self.inp, inp)

    def advance(self, until: int) -> None:
        """Replay the step until ``until`` replays since the prefill (the
        buffer's end at most), or until the host reads that the loop's
        condition failed; at most LOOKAHEAD replays are in flight past the
        newest flag read."""
        end = min(until, self.dcfg.max_frames)
        in_flight = collections.deque()
        slot = 0
        while not self.ended and self.issued < end:
            self.graph.replay()
            self.issued += 1
            self.launched += 1
            for wrapper, n in self.launch_delta:
                wrapper.launches += n
            self.flags[slot].copy_(self.finished, non_blocking=True)
            self.events[slot].record()
            in_flight.append(slot)
            slot = (slot + 1) % len(self.events)
            if len(in_flight) > LOOKAHEAD:
                oldest = in_flight.popleft()
                self.events[oldest].synchronize()
                self.ended = bool(self.flags[oldest])

    def outputs(self) -> DecodeOutputs:
        out = _outputs(self.state, int(self.state.step), self.launched)
        return out._replace(tokens=out.tokens.clone())


_SESSIONS: "collections.OrderedDict[tuple, _Session]" = (
    collections.OrderedDict())
# the segment streams alive, by their LoopState
_STREAMS: "weakref.WeakKeyDictionary[LoopState, _Stream]" = (
    weakref.WeakKeyDictionary())


def release_sessions() -> None:
    """Drop every graph session (their graphs, caches and the references
    to their params), each held stream written back first."""
    for session in _SESSIONS.values():
        session.release()
    _SESSIONS.clear()


def sessions() -> list:
    """The live graph sessions, least recently used first (for reports:
    ``capture_ms``, ``state_bytes``, ``pool_bytes``, ``launched``)."""
    return list(_SESSIONS.values())


def _session_key(params, cfg: VoiceConfig, dcfg: DecodeConfig, x,
                 prompt) -> tuple:
    # the capture bakes in the shapes (with cfg and dcfg they fix the KV
    # mode), the attention mode and the params' addresses; a session keeps
    # its params alive, so their id is not reused while it lives
    return (cfg, dcfg, *x.shape, prompt.shape[1],
            os.environ.get("T5G_FUSED_ATTN", "3"), id(params), x.device)


def _bucket_session(key: tuple, params, cfg: VoiceConfig, dcfg: DecodeConfig,
                    state: LoopState, inp: StepInputs):
    """(the bucket's session, whether it is new): made and captured over a
    copy of ``state`` and ``inp`` on first use; the least recently used
    sessions past MAX_SESSIONS are released and dropped."""
    session = _SESSIONS.get(key)
    if session is not None:
        _SESSIONS.move_to_end(key)
        return session, False
    session = _Session(params, cfg, dcfg, state, inp)
    session.capture()
    _SESSIONS[key] = session
    while len(_SESSIONS) > MAX_SESSIONS:
        _SESSIONS.popitem(last=False)[1].release()
    return session, True


def _prefilled_session(params, cfg: VoiceConfig, dcfg: DecodeConfig, x,
                       x_lens, prompt, prompt_lens, target_totals, seed,
                       stream: bool) -> tuple:
    """Prefill eagerly, then load the result into the bucket's session;
    with ``stream`` the prefilled state is a segment stream's, registered
    and returned to the caller as its own. Returns (session, state)."""
    state = prefill(params, cfg, dcfg, x, x_lens, prompt, prompt_lens,
                    target_totals)
    inp = step_inputs(cfg, x_lens, prompt_lens, target_totals, seed)
    key = _session_key(params, cfg, dcfg, x, prompt)
    if stream:
        _STREAMS[state] = _Stream(key, params)
    session, new = _bucket_session(key, params, cfg, dcfg, state, inp)
    session.load(state, inp, holder=state if stream else None)
    session.launched += new      # the capture's warm-up step ran this request
    return session, state


def graphed_decoder(cfg: VoiceConfig, dcfg: DecodeConfig):
    """The served entry point (JAX ``engine.py::jitted_decoder``):
    ``run(params, x, x_lens, prompt, prompt_lens, target_totals, seed) ->
    DecodeOutputs``. On the card: an eager prefill into the bucket's
    session, then replays of its captured step; on the CPU:
    :func:`decode_tokens`."""

    @torch.inference_mode()
    def run(params, x, x_lens, prompt, prompt_lens, target_totals, seed):
        if x.device.type != "cuda":
            return decode_tokens(params, cfg, dcfg, x, x_lens, prompt,
                                 prompt_lens, target_totals, seed)
        session, _ = _prefilled_session(params, cfg, dcfg, x, x_lens, prompt,
                                        prompt_lens, target_totals, seed,
                                        stream=False)
        session.advance(dcfg.max_frames)
        return session.outputs()

    return run


def graphed_segment_fns(cfg: VoiceConfig, dcfg: DecodeConfig):
    """(prefill_fn, segment_fn) for streaming decode (JAX
    ``engine.py::jitted_segment_fns``): ``prefill_fn(params, x, x_lens,
    prompt, prompt_lens, target_totals) -> LoopState`` and
    ``segment_fn(params, state, x_lens, prompt_lens, target_totals, seed,
    until) -> LoopState`` (:func:`run_segment`). The state is the caller's
    own, as JAX's is: on the card the bucket's session holds one stream at a
    time and advances it by replays of the captured step, so any number of
    streams of one bucket interleave, with one-shot requests and
    evictions between their segments."""

    @torch.inference_mode()
    def prefill_fn(params, x, x_lens, prompt, prompt_lens, target_totals):
        if x.device.type != "cuda":
            return prefill(params, cfg, dcfg, x, x_lens, prompt, prompt_lens,
                           target_totals)
        return _prefilled_session(params, cfg, dcfg, x, x_lens, prompt,
                                  prompt_lens, target_totals, 0,
                                  stream=True)[1]

    def segment_fn(params, state, x_lens, prompt_lens, target_totals, seed,
                   until):
        return run_segment(params, cfg, dcfg, state, x_lens, prompt_lens,
                           target_totals, seed, until)

    return prefill_fn, segment_fn

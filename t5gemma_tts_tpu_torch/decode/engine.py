"""Autoregressive audio-token decode engine, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/decode/engine.py``: text encoding, the
cross K/V built once, prompt prefill into a dense or paged KV cache, and a
loop that per step runs the prediction head, the guarded sampling and the
stop rules, then the decoder on one token. Every piece of loop state is a
[B] tensor on the device; the only host synchronisation per step is the
all-done check that ends the loop. Stop-rule semantics (guard order and
values) are those of the JAX engine:

  1. the first generated token can never be EOG (-1e9); steps up to
     sr // 5 suppress EOG at -10000;
  2. consecutive-silence logit penalty;
  3. forced stop when the sampled token or the argmax of the adjusted
     logits is EOG;
  4. text-guard and target-duration budgets, and the buffer's end.

Draws are step-indexed: the draws of step s come from a generator seeded
from (seed, s) alone (:func:`step_generator`, the counterpart of the JAX
engine's ``fold_in(rng, step)``), so any pass that samples step s -- the
sequential loop or a speculative verify pass (decode/speculative.py) --
draws the same numbers for each row. Greedy decoding (``top_k=1``) is
token-equal to the JAX engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import torch

from ..config import DecodeConfig, VoiceConfig
from ..models import t5gemma, voice
from ..ops import masks as mask_ops
from ..ops import paged_attn
from ..ops import rope as rope_ops
from ..ops import sampling

PyTree = Any
INT32_MAX = 2 ** 31 - 1
_U64 = 2 ** 64 - 1


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


def apply_stop_rules(cfg: VoiceConfig, token, argmax_tok, step: int,
                     text_budget, time_budget, max_steps: int):
    """Force-stop guard: EOG sampled or argmax, text budget, duration
    budget, buffer exhaustion."""
    eog = cfg.eog_inference
    force = (token == eog) | (argmax_tok == eog)
    force = force | (step > text_budget) | (step > time_budget)
    if step >= max_steps - 1:
        force = torch.ones_like(force)
    return torch.where(force, eog, token)


def silence_counter_update(dcfg: DecodeConfig, token, prev_token, consec):
    """Consecutive-silence run-length bookkeeping."""
    if dcfg.silence_tokens:
        silence = torch.tensor(dcfg.silence_tokens, dtype=token.dtype,
                               device=token.device)
        is_sil = (token[:, None] == silence[None, :]).any(dim=1)
        return torch.where(is_sil & (token == prev_token), consec + 1, 0)
    return torch.zeros_like(consec)


class DecodeOutputs(NamedTuple):
    tokens: torch.Tensor     # [B, max_steps] generated tokens (incl. EOG)
    gen_lens: torch.Tensor   # [B] generated tokens incl. EOG
    steps: int               # loop iterations executed


@dataclasses.dataclass
class LoopState:
    cache: Union[t5gemma.DecoderCache, t5gemma.PagedDecoderCache]
    last_hidden: torch.Tensor      # [B, 1, D]
    tokens: torch.Tensor           # [B, max_steps] int32
    step: int                      # == generated count (uniform clock)
    current_length: torch.Tensor   # [B] absolute length incl. BOS
    prev_token: torch.Tensor       # [B]
    consec_silence: torch.Tensor   # [B]
    done: torch.Tensor             # [B] bool
    gen_lens: torch.Tensor         # [B]


def _adjust_logits(cfg: VoiceConfig, dcfg: DecodeConfig, logits, step: int,
                   prev_token, consec_silence):
    """EOG suppression + silence-repetition penalty on raw f32 logits."""
    eog = cfg.eog_inference
    logits = logits.clone()
    if step == 0:
        logits[:, eog] = -1e9
    elif step <= int(cfg.encodec_sr) // 5:
        logits[:, eog] = -10000.0
    if dcfg.stop_repetition > 0 and dcfg.silence_tokens:
        silence = torch.tensor(dcfg.silence_tokens, device=logits.device)
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
        step=0,
        current_length=cated_lens.to(torch.int32),
        prev_token=torch.full((b,), -1, dtype=torch.int32, device=dev),
        consec_silence=torch.zeros((b,), dtype=torch.int32, device=dev),
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
        gen_lens=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# the per-step body
# ---------------------------------------------------------------------------


def _candidate_sample(cfg: VoiceConfig, dcfg: DecodeConfig, logits,
                      step: int, prev_token, consec_silence,
                      generator: Optional[torch.Generator]):
    """Top-(k+2) candidate path: every adjustment lowers at most two tokens
    (EOG + the repeated silence token), so the adjusted top-k lies inside
    the raw top-(k+2) candidates."""
    eog = cfg.eog_inference
    kk = min(dcfg.top_k + 2, cfg.audio_embedding_vocab)
    vals, idx = torch.topk(logits, kk, dim=-1)
    vals = vals.float()
    is_eog = idx == eog
    if step == 0:
        vals = torch.where(is_eog, -1e9, vals)
    elif step <= int(cfg.encodec_sr) // 5:
        vals = torch.where(is_eog, -10000.0, vals)
    if dcfg.stop_repetition > 0 and dcfg.silence_tokens:
        silence = torch.tensor(dcfg.silence_tokens, device=logits.device)
        prev_is_sil = (prev_token[:, None] == silence[None, :]).any(dim=1)
        active = prev_is_sil & (consec_silence > dcfg.stop_repetition)
        factor = (consec_silence - (dcfg.stop_repetition - 1)).float()
        at_prev = idx == prev_token[:, None]
        pen = torch.where(vals < 0, vals * factor[:, None],
                          vals / factor.clamp_min(1.0)[:, None])
        vals = torch.where(at_prev & active[:, None], pen, vals)
    argmax_tok = torch.gather(idx, 1, vals.argmax(dim=-1, keepdim=True))[:, 0]
    token = sampling.sample_from_candidates(
        generator, vals, idx, top_k=dcfg.top_k, top_p=dcfg.top_p,
        temperature=dcfg.temperature)
    return token, argmax_tok.to(torch.int32)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of decode step ``step``: seeded from (seed, step)
    alone, so its draws do not depend on which pass samples the step. The
    pair is mixed by splitmix64, so that every bit of the 64-bit seed (the
    CPU generator reads only the low 32) depends on both."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return torch.Generator(device=device).manual_seed(z ^ (z >> 31))


def sample_step_token(cfg: VoiceConfig, dcfg: DecodeConfig, logits, step: int,
                      prev_token, consec_silence, seed: int):
    """One step's guarded sampling -> (token [B], argmax_tok [B]), drawn
    from :func:`step_generator` (seed, step)."""
    generator = step_generator(seed, step, logits.device)
    if dcfg.top_k and dcfg.top_k > 0 and not (0.0 < dcfg.min_p < 1.0):
        return _candidate_sample(cfg, dcfg, logits, step, prev_token,
                                 consec_silence, generator)
    adjusted = _adjust_logits(cfg, dcfg, logits.float(), step, prev_token,
                              consec_silence)
    token = sampling.sample(adjusted, generator, top_k=dcfg.top_k,
                            top_p=dcfg.top_p, min_p=dcfg.min_p,
                            temperature=dcfg.temperature)
    return token, sampling.greedy(adjusted)


def _make_body(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig, x_lens,
               prompt_lens, target_totals, seed: int):
    s = cfg.special
    eog = cfg.eog_inference
    dims = cfg.backbone.decoder
    cdt = voice.compute_dtype(cfg)
    max_steps = dcfg.max_frames
    prompt_offset = (prompt_lens + 1).to(torch.int32)
    x_lens = x_lens.to(torch.int32)
    est_total, time_budget, text_budget = decode_budgets(
        cfg, x_lens, prompt_lens, target_totals)

    def body(st: LoopState) -> LoopState:
        paged = isinstance(st.cache, t5gemma.PagedDecoderCache)
        logits = voice.predict_head(params["head"], st.last_hidden)[:, 0]
        token, argmax_tok = sample_step_token(
            cfg, dcfg, logits, st.step, st.prev_token, st.consec_silence,
            seed)
        token = apply_stop_rules(cfg, token, argmax_tok, st.step,
                                 text_budget, time_budget, max_steps)

        newly_active = ~st.done
        st.tokens[:, st.step] = torch.where(newly_active, token, s.pad)
        stopped = newly_active & (token == eog)
        now_done = st.done | stopped
        gen_lens = torch.where(stopped, st.step + 1, st.gen_lens)
        consec = silence_counter_update(dcfg, token, st.prev_token,
                                        st.consec_silence)

        emb = voice.embed_audio(params, token[:, None]).to(cdt)
        if cfg.use_pm_rope:
            pos = rope_ops.decode_step_position(
                st.current_length, est_total, cfg.progress_scale)[:, None]
        else:
            pos = st.current_length.float()[:, None]
        pm = pos if cfg.use_pm_rope else None
        if paged:
            hidden, cache = t5gemma.paged_decode_step(
                params["decoder"], dims, inputs_embeds=emb, position_ids=pos,
                pm_decoder_positions=pm, cache=st.cache, step=st.step,
                prompt_lengths=prompt_offset, enc_lengths=x_lens)
        else:
            t_max = st.cache.self_k.shape[3]
            t_enc = st.cache.cross_k.shape[3]
            hidden, cache = t5gemma.decoder_forward(
                params["decoder"], dims, inputs_embeds=emb,
                self_full_bias=mask_ops.step_self_bias(
                    st.current_length, t_max),
                self_sliding_bias=mask_ops.step_self_bias(
                    st.current_length, t_max, window=dims.sliding_window),
                cross_bias=mask_ops.cross_bias(x_lens, 1, t_enc),
                position_ids=pos, pm_decoder_positions=pm,
                cross_k=st.cache.cross_k, cross_v=st.cache.cross_v,
                cache=st.cache, cache_pos=st.current_length.long())
        current_length = torch.where(now_done, st.current_length,
                                     st.current_length + 1)
        return LoopState(cache=cache, last_hidden=hidden, tokens=st.tokens,
                         step=st.step + 1, current_length=current_length,
                         prev_token=token, consec_silence=consec,
                         done=now_done, gen_lens=gen_lens)

    return body


# ---------------------------------------------------------------------------
# full decode
# ---------------------------------------------------------------------------


@torch.inference_mode()
def decode_tokens(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig, x,
                  x_lens, prompt, prompt_lens, target_totals,
                  seed: int) -> DecodeOutputs:
    """Full batched synthesis of audio tokens (all inputs int32 tensors on
    the device where the model runs); step s draws from
    :func:`step_generator` (``seed``, s)."""
    state = prefill(params, cfg, dcfg, x, x_lens, prompt, prompt_lens,
                    target_totals)
    body = _make_body(params, cfg, dcfg, x_lens, prompt_lens, target_totals,
                      seed)
    while state.step < dcfg.max_frames and not bool(state.done.all()):
        state = body(state)
    gen_lens = torch.where(state.done, state.gen_lens, state.step)
    return DecodeOutputs(tokens=state.tokens, gen_lens=gen_lens,
                         steps=state.step)

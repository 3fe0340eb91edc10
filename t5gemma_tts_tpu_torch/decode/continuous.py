"""Continuous batching: requests join a resident decode batch mid-flight.

Counterpart of ``t5gemma_tts_tpu/decode/continuous.py``. A fixed batch of
B slots decodes in bounded segments; between segments the finished rows are
harvested and new requests prefill into free slots, so the batch axis stays
full under streaming load (the batching server, ``inference/server.py``,
makes a request that arrives just after a batch started wait for the whole
batch).

- **Per-row clocks.** The synchronized engine's step counter becomes a [B]
  vector: stop budgets, token writes, RoPE positions and the paged cache's
  flush slot and generation length (``models/t5gemma.py::paged_decode_step``
  ``gen_lengths`` / ``flush_positions``) all run off each row's own clock.
- **Per-request draws.** Each slot holds its request's 64-bit seed; row r
  at its step s draws ``sampling.row_uniform``'s row r, which is bit for
  bit what the request draws alone at batch 1 (``step_uniform(seed, s, 1,
  ...)``). So a request's tokens do not depend on its slot, on when it
  joined or on what shares the batch: on the CPU they equal a batch-1
  ``engine.decode_tokens`` at its seed.
- **Admission = batch-1 prefill + row install.** ``engine.prefill`` runs on
  the new request alone, at the resident state's buckets, and
  :func:`install_row` copies its row into the slot with ``index_copy_`` on
  the device: the state's tensors are written in place, never rebound, so
  a captured segment stays valid.
- **The segment on the card** is one CUDA graph of the step body a state,
  captured on its first use (or by ``SegmentFns.capture`` before serving)
  and replayed ``n_steps`` times. The body is predicated per row on
  ``active & ~done``: once no row is live a replay changes nothing that a
  request reads. :func:`harvest` reads ``active & done`` with the finished
  rows' tokens, in one copy a segment: the only host read of the loop. On
  the CPU the segment runs the body eagerly and stops, as JAX's
  ``while_loop`` does, when no row is live.

Over a mesh (the JAX package's multi-device continuous decode): a
data-parallel rank holds its span of the slots of a dense state
(``parallel.shard_slot_state``; ``SlotState.slot0`` is its first global
slot), admits only the requests of its slots and harvests them under
their global slots; a tensor-parallel rank holds the whole state with its
own kv heads (:func:`init_slots` inside ``model_parallel``) and runs its
shard of every layer. At ``tp > 1`` the captured segment refuses (ROADMAP
Queue 1 item 15 part D) and ``make_fns(..., graphed=False)`` serves.

All shapes are fixed at :func:`init_slots` (text, prompt and frame
buckets). :func:`resolve_cache_mode` takes the paged cache whenever the
buckets fit the sliding window, on any device (the JAX rule "auto = dense
off the TPU" is the TPU's: the port's paged kernels have plain versions on
the CPU), and the dense cache otherwise.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import DecodeConfig, VoiceConfig
from ..models import t5gemma, voice
from ..ops import masks as mask_ops
from ..ops import paged_attn
from ..ops import rope as rope_ops
from ..ops import sampling
from ..parallel import tensor as tp
from . import engine

PyTree = Any
IntLike = Union[int, torch.Tensor]


@dataclasses.dataclass(eq=False)       # hashed by identity
class SlotState:
    """The resident decode batch, B slots, as device tensors that every
    admission and segment writes in place."""

    cache: Union[t5gemma.DecoderCache, t5gemma.PagedDecoderCache]
    last_hidden: torch.Tensor      # [B, 1, D]
    tokens: torch.Tensor           # [B, max_frames] int32
    steps: torch.Tensor            # [B] int32, each row's generated count
    current_length: torch.Tensor   # [B] absolute length incl. BOS
    prev_token: torch.Tensor       # [B]
    consec_silence: torch.Tensor   # [B]
    active: torch.Tensor           # [B] bool: the slot holds a request
    done: torch.Tensor             # [B] bool: finished, awaiting harvest
    gen_lens: torch.Tensor         # [B]
    seeds: torch.Tensor            # [B] int64, each request's own seed
    x_lens: torch.Tensor           # [B] encoder lengths
    prompt_lens: torch.Tensor      # [B] (excl. BOS)
    target_totals: torch.Tensor    # [B]
    slot0: int = 0                 # the first slot's global index (dp)


@dataclasses.dataclass
class SlotStats:
    """Host record of a resident state: step bodies launched, segments run,
    and on the card its captured segment."""

    bodies: int = 0
    segments: int = 0
    captured: Optional[engine.CapturedStep] = None
    capture_key: tuple = ()
    body: Optional[Callable] = None       # keeps the capture's inputs alive
    params: Optional[PyTree] = None       # the weights the capture reads


_STATS: "weakref.WeakKeyDictionary[SlotState, SlotStats]" = (
    weakref.WeakKeyDictionary())


def stats(state: SlotState) -> SlotStats:
    """The state's host record (bodies, segments, capture)."""
    rec = _STATS.get(state)
    if rec is None:
        rec = _STATS[state] = SlotStats()
    return rec


def state_bytes(state: SlotState) -> int:
    """Bytes of the state's device buffers (the KV cache dominates): what a
    server sizes its slots by."""
    return sum(t.numel() * t.element_size()
               for _, t in engine._tensors(state))


def resolve_cache_mode(cfg: VoiceConfig, dcfg: DecodeConfig,
                       prompt_len: int) -> str:
    """Continuous-mode cache: an explicit ``dcfg.kv_cache`` wins (a paged
    mode raises when the buckets do not fit the sliding window); "auto" is
    paged when prompt + generation fit the window, dense otherwise."""
    dims = cfg.backbone.decoder
    ps = t5gemma.PAGE_SIZE
    total = (t5gemma._pad_to(prompt_len + 1, ps)
             + t5gemma._pad_to(dcfg.max_frames, ps))
    fits = total <= dims.sliding_window
    mode = dcfg.kv_cache
    if mode in ("paged", "paged_f8", "paged_i8"):
        if not fits:
            raise ValueError(
                f"continuous kv_cache={mode!r} needs prompt+gen ({total}) "
                f"<= sliding_window ({dims.sliding_window}); use 'dense'")
        return mode
    if mode == "auto":
        return "paged" if fits else "dense"
    if mode != "dense":
        raise ValueError(f"unknown kv_cache mode {mode!r}")
    return mode


@torch.inference_mode()
def init_slots(cfg: VoiceConfig, dcfg: DecodeConfig, batch: int,
               text_len: int, prompt_len: int,
               device: Union[str, torch.device] = "cuda") -> SlotState:
    """An empty resident state at the given buckets (every slot idle); its
    cache has the kv heads of a rank of the enclosing
    ``parallel.tensor.model_parallel`` mesh (``parallel.serving_dims``)."""
    from ..parallel import mesh as mesh_mod

    dev = torch.device(device)
    dims = mesh_mod.serving_dims(cfg.backbone.decoder, tp.active())
    cdt = voice.compute_dtype(cfg)
    mode = resolve_cache_mode(cfg, dcfg, prompt_len)
    if mode == "dense":
        cache = t5gemma.init_cache(dims, batch,
                                   prompt_len + 1 + dcfg.max_frames,
                                   text_len, dtype=cdt, device=dev)
    else:
        store = paged_attn.KV_STORE_DTYPES[
            {"paged_f8": "f8", "paged_i8": "i8"}.get(mode, "bf16")]
        cache = t5gemma.init_paged_cache(dims, batch, prompt_len + 1,
                                         dcfg.max_frames, text_len,
                                         store_dtype=store, device=dev)

    def vec(value, dtype=torch.int32):
        return torch.full((batch,), value, dtype=dtype, device=dev)

    return SlotState(
        cache=cache,
        last_hidden=torch.zeros((batch, 1, dims.hidden_size), dtype=cdt,
                                device=dev),
        tokens=torch.full((batch, dcfg.max_frames), cfg.special.pad,
                          dtype=torch.int32, device=dev),
        steps=vec(0), current_length=vec(1), prev_token=vec(-1),
        consec_silence=vec(0), active=vec(False, torch.bool),
        done=vec(False, torch.bool), gen_lens=vec(0),
        seeds=vec(0, torch.int64), x_lens=vec(1), prompt_lens=vec(0),
        target_totals=vec(1))


def _admit_dcfg(state: SlotState, dcfg: DecodeConfig) -> DecodeConfig:
    """``dcfg`` pinned to the cache flavour and frame bucket of the state."""
    cache = state.cache
    if isinstance(cache, t5gemma.PagedDecoderCache):
        kv = {torch.int8: "paged_i8", torch.float8_e4m3fn: "paged_f8"}.get(
            cache.gen_k.dtype, "paged")
    else:
        kv = "dense"
    return dataclasses.replace(dcfg, kv_cache=kv,
                               max_frames=state.tokens.shape[1])


def _vector(v, dev, dtype=torch.int32) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype).to(dev)


@torch.inference_mode()
def admit(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig,
          state: SlotState, slot: int, x, x_len: int, prompt,
          prompt_len: int, target_total: int, seed: IntLike) -> SlotState:
    """Prefill ONE request (``x`` [tx] and ``prompt`` [p_max] padded to the
    state's buckets) with the plain batch-1 ``engine.prefill`` and install
    it into ``slot`` (a global slot: a data-parallel rank's state admits
    only its own slots and leaves the others' requests to their ranks);
    returns ``state``, written in place."""
    slot -= state.slot0
    if not 0 <= slot < state.tokens.shape[0]:
        return state
    dev = state.tokens.device
    st1 = engine.prefill(
        params, cfg, _admit_dcfg(state, dcfg), _vector(x, dev)[None],
        _vector([x_len], dev), _vector(prompt, dev)[None],
        _vector([prompt_len], dev), _vector([target_total], dev))
    return install_row(cfg, state, st1, slot, x_len, prompt_len,
                       target_total, seed)


@torch.inference_mode()
def install_row(cfg: VoiceConfig, state: SlotState, st1: engine.LoopState,
                slot: int, x_len: int, prompt_len: int, target_total: int,
                seed: IntLike) -> SlotState:
    """Copy a batch-1 prefill result into resident ``slot``: every write an
    ``index_copy_`` / ``index_fill_`` at the slot, on the device, into the
    state's own tensors. The slot's generation pages keep what the previous
    request left: a row reads only its own first ``steps`` of them."""
    dev = state.tokens.device
    b = state.tokens.shape[0]
    idx = torch.tensor([slot], device=dev)
    cache, one = state.cache, st1.cache
    bits = t5gemma._bits
    if isinstance(cache, t5gemma.PagedDecoderCache):
        rows = torch.arange(cfg.backbone.decoder.num_layers,
                            device=dev) * b + slot
        for name in ("prompt_k", "prompt_v", "cross_k", "cross_v",
                     "prompt_k_scale", "prompt_v_scale", "cross_k_scale",
                     "cross_v_scale"):
            res = getattr(cache, name)
            if res is not None:
                bits(res).index_copy_(
                    1, rows, bits(getattr(one, name).to(res.dtype)))
        cache.pending_k.index_copy_(1, idx, one.pending_k)
        cache.pending_v.index_copy_(1, idx, one.pending_v)
    else:
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            res = getattr(cache, name)
            res.index_copy_(1, idx, getattr(one, name).to(res.dtype))
    state.last_hidden.index_copy_(0, idx,
                                  st1.last_hidden.to(state.last_hidden.dtype))
    state.tokens.index_copy_(0, idx, st1.tokens)
    state.current_length.index_copy_(0, idx,
                                     st1.current_length.to(torch.int32))
    seed = sampling.as_int64(seed, "cpu").item()
    for name, value in (("steps", 0), ("prev_token", -1),
                        ("consec_silence", 0), ("gen_lens", 0),
                        ("done", False), ("active", True),
                        ("x_lens", int(x_len)),
                        ("prompt_lens", int(prompt_len)),
                        ("target_totals", int(target_total)),
                        ("seeds", seed)):
        getattr(state, name).index_fill_(0, idx, value)
    return state


def _make_body(params: PyTree, cfg: VoiceConfig, dcfg: DecodeConfig,
               device) -> Callable[[SlotState], None]:
    """The per-row-clock step body (JAX ``make_fns.body``): advances every
    live row (``active & ~done``) by one token, in place; a row that is not
    live keeps its tokens, clock, length and flags. It reads nothing on the
    host, so a CUDA graph captures it."""
    eog = cfg.eog_inference
    dims = cfg.backbone.decoder
    cdt = voice.compute_dtype(cfg)
    max_steps = dcfg.max_frames
    silence = engine.silence_tensor(dcfg, device)

    def body(st: SlotState) -> None:
        live = st.active & ~st.done
        est_total, time_budget, text_budget = engine.decode_budgets(
            cfg, st.x_lens, st.prompt_lens, st.target_totals)
        logits = voice.predict_head(params["head"], st.last_hidden)[:, 0]
        token, argmax_tok = engine.sample_step_token_rows(
            cfg, dcfg, logits, st.steps, st.prev_token, st.consec_silence,
            st.seeds, silence)
        token = engine.apply_stop_rules(cfg, token, argmax_tok, st.steps,
                                        text_budget, time_budget, max_steps)
        col = st.steps.clamp_max(max_steps - 1).long()[:, None]
        kept = torch.gather(st.tokens, 1, col)[:, 0]
        st.tokens.scatter_(1, col, torch.where(live, token, kept)[:, None])
        stopped = live & (token == eog)
        now_done = st.done | stopped
        gen_lens = torch.where(stopped, st.steps + 1, st.gen_lens)
        consec = engine.silence_counter_update(silence, token, st.prev_token,
                                               st.consec_silence)

        emb = voice.embed_audio(params, token[:, None],
                                cfg.audio_embedding_vocab).to(cdt)
        if cfg.use_pm_rope:
            pos = rope_ops.decode_step_position(
                st.current_length, est_total, cfg.progress_scale)[:, None]
        else:
            pos = st.current_length.float()[:, None]
        pm = pos if cfg.use_pm_rope else None
        if isinstance(st.cache, t5gemma.PagedDecoderCache):
            hidden, _ = t5gemma.paged_decode_step(
                params["decoder"], dims, inputs_embeds=emb, position_ids=pos,
                pm_decoder_positions=pm, cache=st.cache, step=0,
                prompt_lengths=st.prompt_lens + 1, enc_lengths=st.x_lens,
                gen_lengths=st.steps,
                flush_positions=(st.steps - 1).clamp_min(0))
        else:
            t_max = st.cache.self_k.shape[3]
            t_enc = st.cache.cross_k.shape[3]
            hidden, _ = t5gemma.decoder_forward(
                params["decoder"], dims, inputs_embeds=emb,
                self_full_bias=mask_ops.step_self_bias(
                    st.current_length, t_max),
                self_sliding_bias=mask_ops.step_self_bias(
                    st.current_length, t_max, window=dims.sliding_window),
                cross_bias=mask_ops.cross_bias(st.x_lens, 1, t_enc),
                position_ids=pos, pm_decoder_positions=pm,
                cross_k=st.cache.cross_k, cross_v=st.cache.cross_v,
                cache=st.cache, cache_pos=st.current_length.long())
        new = dict(
            last_hidden=hidden,
            steps=torch.where(live, st.steps + 1, st.steps),
            current_length=torch.where(live & ~now_done,
                                       st.current_length + 1,
                                       st.current_length),
            prev_token=torch.where(live, token, st.prev_token),
            consec_silence=torch.where(live, consec, st.consec_silence),
            done=now_done, gen_lens=gen_lens)
        for name, value in new.items():
            getattr(st, name).copy_(value)

    return body


class SegmentFns(NamedTuple):
    # (params, state, slot, x, x_len, prompt, prompt_len, target, seed)
    admit: Callable
    segment: Callable    # (params, state, n_steps) -> state
    capture: Callable    # (params, state) -> capture ms (None on the CPU)


def make_fns(cfg: VoiceConfig, dcfg: DecodeConfig,
             graphed: bool = True) -> SegmentFns:
    """Admit, segment and capture functions for states built with
    :func:`init_slots` at this ``dcfg``; ``graphed=False`` runs the segment
    eagerly on the card too (the reference the graph is held to)."""

    def key(params) -> tuple:
        # the capture bakes in the weights' addresses, the attention mode and
        # the body's configuration
        return (cfg, dcfg, id(params), os.environ.get("T5G_FUSED_ATTN", "3"))

    @torch.inference_mode()
    def capture(params, state: SlotState) -> Optional[float]:
        """On the card, capture the state's segment body if it has no
        capture for these weights yet (its eager warm-up body counts as
        one step of the live rows): call it before serving, so that no
        capture runs while other threads use the card. On the CPU: None."""
        if graphed:
            tp.refuse("the captured continuous segment (a captured NCCL "
                      "all-reduce); make_fns(..., graphed=False) serves it")
        dev = state.tokens.device
        if dev.type != "cuda" or not graphed:
            return None
        rec = stats(state)
        if rec.captured is None or rec.capture_key != key(params):
            rec.captured = None
            body = _make_body(params, cfg, dcfg, dev)
            rec.captured = engine.capture_step(lambda: body(state))
            rec.body, rec.params = body, params
            rec.capture_key = key(params)
            rec.bodies += 1
            return rec.captured.capture_ms
        return None

    @torch.inference_mode()
    def segment(params, state: SlotState, n_steps: int) -> SlotState:
        """Up to ``n_steps`` step bodies (JAX ``segment``): on the card
        ``n_steps`` replays of the captured body, past the last live row
        no-ops; on the CPU (or not ``graphed``) the eager body while a row
        is live."""
        rec = stats(state)
        rec.segments += 1
        n_steps = int(n_steps)
        if state.tokens.device.type != "cuda" or not graphed:
            body = _make_body(params, cfg, dcfg, state.tokens.device)
            for _ in range(n_steps):
                if not bool((state.active & ~state.done).any()):
                    break
                body(state)
                rec.bodies += 1
            return state
        if n_steps > 0 and capture(params, state) is not None:
            n_steps -= 1
        for _ in range(n_steps):
            engine.replay(rec.captured)
        rec.bodies += n_steps
        return state

    def admit_fn(params, state, slot, x, x_len, prompt, prompt_len, target,
                 seed):
        return admit(params, cfg, dcfg, state, slot, x, x_len, prompt,
                     prompt_len, target, seed)

    return SegmentFns(admit=admit_fn, segment=segment, capture=capture)


@torch.inference_mode()
def harvest(state: SlotState) -> Tuple[SlotState, List[Tuple[int, Any]]]:
    """Collect the finished rows -> [(global slot, tokens incl. EOG as int32
    numpy)] and free their slots. One copy to the host (``active & done``,
    the lengths and the token buffer together)."""
    packed = torch.cat([(state.active & state.done).to(torch.int32)[:, None],
                        state.gen_lens[:, None], state.tokens], dim=1)
    packed = packed.cpu().numpy()
    ready = np.nonzero(packed[:, 0])[0]
    out = [(state.slot0 + int(r), packed[r, 2:2 + packed[r, 1]].copy())
           for r in ready]
    if len(ready):
        state.active.index_fill_(
            0, torch.as_tensor(ready, device=state.active.device), False)
    return state, out

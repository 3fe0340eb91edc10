"""End-to-end TTS inference pipeline (text [+ reference audio] ->
waveform), in PyTorch.

Counterpart of ``t5gemma_tts_tpu/inference/pipeline.py``: reference-audio
tokenization (voice cloning: the XCodec2 encoder), ``repeat_prompt`` (an int
or ``"max"``), y_sep / x_sep assembly, target length (prompt + codec_sr *
target_secs), batched decode, sep/EOG stripping, codec decode and the
``[Speed]`` report; streaming synthesis (:meth:`TTSPipeline.
synthesize_streaming`) and warm-up (:meth:`TTSPipeline.warmup`). Text,
prompt and generation buffers are padded to the same buckets as the JAX
package, so a request decodes over the same shapes. The decode serves
through ``engine.graphed_decoder``: on the card one captured CUDA graph of
the step per shape bucket, replayed (the JAX pipeline serves through
``jitted_decoder``); on the CPU the eager loop. Warm-shape routing sends a
batch onto a covering shape that already has a session (a capture, and the
KV cache it holds, on the card) rather than capturing a new one: padded
text and prompt columns are masked by the lengths, padding rows decode a
1-frame target and are dropped, and they count in neither tokens/s nor RTF.
``int8=True`` serves with W8A8
decode weights (``ops/quant.quantize_params_for_decode``), whose paged decode
steps run through the decode-layer kernels; ``int4=True`` is the batch-1
latency mode: the six decode-layer products and the head's ``w2`` become
int4 (W4A8), everything else quantized stays int8.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..codec.audio_tokenizer import AudioTokenizer, tokenize_audio
from ..config import DecodeConfig, VoiceConfig
from ..decode import engine
from ..device import DeviceLike, resolve_device, tree_to
from .textnorm import normalize_text_with_lang

TEXT_BUCKETS = [32, 64, 128, 256, 512, 1024]
PROMPT_BUCKETS = [64, 128, 256, 512, 1024, 2048]
FRAME_BUCKETS = [256, 512, 1024, 2048, 4096, 8192]


def _bucket(n: int, buckets: Sequence[int]) -> int:
    i = bisect.bisect_left(buckets, max(n, 1))
    return buckets[min(i, len(buckets) - 1)] if n <= buckets[-1] else n


@dataclasses.dataclass
class SynthesisResult:
    wav: Optional[np.ndarray]         # generated waveform [S]
    concat_wav: Optional[np.ndarray]  # prompt + generated decode
    gen_frames: np.ndarray            # stripped generated codec tokens
    concat_frames: np.ndarray
    tokens_per_sec: float
    rtf: float                        # audio seconds per wall second
    inference_time: float
    steps: int = 0                    # decode-loop iterations of the batch
    launched_steps: int = 0           # step bodies the device ran for it
    seed: Optional[int] = None        # the request's own seed, if any


@dataclasses.dataclass
class Request:
    target_text: str
    lang: Optional[str] = None
    audio_path: Optional[str] = None
    prompt_transcript: Optional[str] = None
    target_duration: Optional[float] = None  # seconds
    repeat_prompt: Union[int, str] = 0
    prompt_end_frame: int = -1


@dataclasses.dataclass
class PlannedRequest:
    """A request after host-side assembly: token ids + target length."""

    text: List[int]
    prompt: List[int]
    target: int                    # prompt + sr * target_secs


class TTSPipeline:
    def __init__(self, params, cfg: VoiceConfig,
                 text_tokenizer: Callable[[str], List[int]],
                 audio_tokenizer: Optional[AudioTokenizer] = None,
                 fuse_matmuls: bool = True,
                 device: DeviceLike = "cuda",
                 int8: bool = False,
                 int4: bool = False,
                 audio_max_length: float = 120.0):
        self.device = resolve_device(device)
        params = tree_to(params, self.device)
        if fuse_matmuls or int8 or int4:
            from ..models.t5gemma import fuse_for_decode

            params = fuse_for_decode(params)
        if int8 or int4:
            from ..ops.quant import quantize_params_for_decode

            params = quantize_params_for_decode(
                params, weight_bits=4 if int4 else 8)
        self.params = params
        self.cfg = cfg
        self.encode_text = text_tokenizer
        self.audio_tokenizer = audio_tokenizer
        self.audio_max_length = audio_max_length
        # (DecodeConfig without max_frames, batch, text, prompt, frames) of
        # every shape that has run to its end; with ``route``,
        # synthesize_planned runs a batch on a covering one rather than
        # capture a new session. Not by default: on the card a capture
        # costs milliseconds once while padding rows cost every step, so
        # the server that warmed its grid (BatchingServer) asks for it.
        self._warm_shapes: set = set()

    # -- assembly -----------------------------------------------------------

    def _prompt_tokens(self, req: Request, codec_sr: int,
                       target_secs: float) -> List[int]:
        """The reference recording's codes (cut at ``prompt_end_frame``
        samples of the file), repeated ``repeat_prompt`` more times (or, with
        ``"max"``, while prompt + target + one more copy stay under
        ``audio_max_length`` seconds), then y_sep; [] without a
        recording."""
        if not req.audio_path or str(req.audio_path).lower() in {
                "", "none", "null"}:
            return []
        if self.audio_tokenizer is None:
            raise ValueError("voice cloning needs an audio tokenizer")
        frames = tokenize_audio(
            self.audio_tokenizer, req.audio_path,
            num_frames=req.prompt_end_frame if req.prompt_end_frame > 0
            else -1)                                        # [1, T, 1]
        base = frames[0, :, 0].tolist()
        tokens = list(base)
        if isinstance(req.repeat_prompt, int) and req.repeat_prompt > 0:
            tokens = tokens + base * req.repeat_prompt
        elif (isinstance(req.repeat_prompt, str)
              and req.repeat_prompt.lower() == "max"):
            while base and (len(tokens) + codec_sr * target_secs + len(base)
                            < self.audio_max_length * codec_sr):
                tokens += base
        if tokens:
            tokens.append(self.cfg.special.y_sep)
        return tokens

    def _text_tokens(self, req: Request) -> Tuple[List[int], str]:
        target_text, lang = normalize_text_with_lang(req.target_text, req.lang)
        prefix = req.prompt_transcript
        if prefix:
            prefix, _ = normalize_text_with_lang(prefix, lang)
        tokens = list(self.encode_text(target_text.strip()))
        if prefix:
            ptoks = list(self.encode_text(prefix.strip()))
            if self.cfg.x_sep_token is not None:
                tokens = ptoks + [self.cfg.x_sep_token] + tokens
            else:
                tokens = ptoks + tokens
        if self.cfg.add_eos_to_text:
            tokens.append(self.cfg.add_eos_to_text)
        if self.cfg.add_bos_to_text:
            tokens = [self.cfg.add_bos_to_text] + tokens
        return tokens, lang or "en"

    def plan_request(self, req: Request) -> PlannedRequest:
        """Host-side assembly of one request (no device work)."""
        from .duration import estimate_duration

        sr = int(self.cfg.encodec_sr)
        target_secs = req.target_duration
        if target_secs is None:
            target_secs = estimate_duration(
                req.target_text, req.audio_path, req.prompt_transcript,
                req.lang)
        prompt = self._prompt_tokens(req, sr, target_secs)
        text, _ = self._text_tokens(req)
        return PlannedRequest(text=text, prompt=prompt,
                              target=len(prompt) + int(sr * target_secs))

    def _need_frames(self, target: int, prompt_len: int) -> int:
        """Generation-buffer demand of one request."""
        sr = int(self.cfg.encodec_sr)
        return target - prompt_len + int(sr * self.cfg.extra_cutoff) + 8

    def frame_bucket(self, planned: PlannedRequest) -> int:
        """The generation-buffer bucket this request alone would use."""
        return _bucket(self._need_frames(planned.target, len(planned.prompt)),
                       FRAME_BUCKETS)

    def widths(self, planned: Sequence[PlannedRequest]
               ) -> Tuple[int, int, int]:
        """(text, prompt, frame) buckets of a batch: the encoder and cross
        K/V run over B x text rows, the prefill over B x (prompt + 1)."""
        tx = _bucket(max(len(p.text) for p in planned), TEXT_BUCKETS)
        p_max = _bucket(max((len(p.prompt) for p in planned), default=1),
                        PROMPT_BUCKETS)
        max_frames = _bucket(max(self._need_frames(p.target, len(p.prompt))
                                 for p in planned), FRAME_BUCKETS)
        return tx, p_max, max_frames

    # -- synthesis ----------------------------------------------------------

    def synthesize_batch(self, requests: Sequence[Request],
                         dcfg: Optional[DecodeConfig] = None,
                         seed: Optional[int] = None, quiet: bool = False,
                         decode_audio: bool = True) -> List[SynthesisResult]:
        """Batched synthesis: all requests decode together."""
        return self.synthesize_planned(
            [self.plan_request(r) for r in requests], dcfg, seed=seed,
            quiet=quiet, decode_audio=decode_audio)

    def _batch_inputs(self, planned: Sequence[PlannedRequest], tx: int,
                      p_max: int, rows: int):
        """Padded int32 device tensors (x, x_lens, prompt, prompt_lens,
        targets) of ``rows`` rows: the planned requests, then padding rows
        that decode a 1-frame target."""
        s = self.cfg.special
        x = np.zeros((rows, tx), np.int32)
        x_lens = np.zeros((rows,), np.int32)
        prm = np.full((rows, p_max), s.pad, np.int32)
        prm_lens = np.zeros((rows,), np.int32)
        targets = np.ones((rows,), np.int32)
        for i, p in enumerate(planned):
            t, q = p.text[:tx], p.prompt[:p_max]
            x[i, :len(t)] = t
            x_lens[i] = len(t)
            prm[i, :len(q)] = q
            prm_lens[i] = len(q)
            targets[i] = p.target
        for i in range(len(planned), rows):
            x[i, 0] = x[0, 0] if len(planned) else 3
            x_lens[i] = 1
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (x, x_lens, prm, prm_lens, targets))

    @staticmethod
    def _warm_key(dcfg: DecodeConfig) -> DecodeConfig:
        return dataclasses.replace(dcfg, max_frames=0)

    def _route(self, dcfg: DecodeConfig, b: int, tx_need: int,
               pm_need: int, need_frames: int) -> Tuple[int, int, int, int]:
        """(rows, text, prompt, frames) to run a batch at: its own buckets
        when they are warm or nothing warm covers them, else the smallest
        warm shape of the same DecodeConfig that covers every dimension
        (fewest frames first, then rows, text, prompt)."""
        tx = _bucket(tx_need, TEXT_BUCKETS)
        p_max = _bucket(pm_need, PROMPT_BUCKETS)
        max_frames = _bucket(need_frames, FRAME_BUCKETS)
        key = self._warm_key(dcfg)
        if (key, b, tx, p_max, max_frames) in self._warm_shapes:
            return b, tx, p_max, max_frames
        cand = [w[1:] for w in self._warm_shapes
                if w[0] == key and w[1] >= b and w[2] >= tx_need
                and w[3] >= pm_need and w[4] >= need_frames]
        if cand:
            return min(cand, key=lambda w: (w[3], w[0], w[1], w[2]))
        return b, tx, p_max, max_frames

    def synthesize_planned(self, planned: Sequence[PlannedRequest],
                           dcfg: Optional[DecodeConfig] = None,
                           seed: Optional[int] = None, quiet: bool = False,
                           decode_audio: bool = True, route: bool = False
                           ) -> List[SynthesisResult]:
        """Decode planned requests as one batch, at their own buckets or,
        with ``route``, on a covering warm shape (:meth:`_route`)."""
        dcfg = dcfg or DecodeConfig()
        cfg = self.cfg
        s = cfg.special
        sr = int(cfg.encodec_sr)
        prompts = [p.prompt for p in planned]
        b = len(planned)
        if route:
            rows, tx, p_max, max_frames = self._route(
                dcfg, b, max(len(p.text) for p in planned),
                max((len(p) for p in prompts), default=1),
                max(self._need_frames(p.target, len(p.prompt))
                    for p in planned))
        else:
            rows = b
            tx, p_max, max_frames = self.widths(planned)
        inputs = self._batch_inputs(planned, tx, p_max, rows)

        stime = time.time()
        decode = engine.graphed_decoder(
            cfg, dataclasses.replace(dcfg, max_frames=max_frames))
        out = decode(self.params, *inputs,
                     dcfg.seed if seed is None else seed)
        tokens = out.tokens.cpu().numpy()
        gen_lens = out.gen_lens.cpu().numpy()
        elapsed = time.time() - stime
        # registered only once its run has returned
        self._warm_shapes.add((self._warm_key(dcfg), rows, tx, p_max,
                               max_frames))

        results: List[SynthesisResult] = []
        strip = [s.y_sep, cfg.eog_inference]
        total_tokens = int(gen_lens[:b].sum())      # real rows only
        per_utt_time = elapsed / b
        for i in range(b):
            g = tokens[i, :gen_lens[i]]
            g = g[~np.isin(g, strip)]
            concat = np.concatenate([
                np.asarray([t for t in prompts[i] if t not in strip], np.int64),
                g])
            wav = concat_wav = None
            if decode_audio and self.audio_tokenizer is not None and len(g):
                wav = self.audio_tokenizer.decode(g[None, None, :])[0, 0]
                if len(concat) > len(g):
                    concat_wav = self.audio_tokenizer.decode(
                        concat[None, None, :])[0, 0]
            results.append(SynthesisResult(
                wav=wav,
                concat_wav=concat_wav if concat_wav is not None else wav,
                gen_frames=g, concat_frames=concat,
                tokens_per_sec=len(g) / per_utt_time if per_utt_time else 0.0,
                rtf=(len(g) / sr) / per_utt_time if per_utt_time else 0.0,
                inference_time=per_utt_time, steps=out.steps,
                launched_steps=out.launched_steps))
        if not quiet:
            pad = f", {rows - b} padding rows" if rows > b else ""
            print(f"[Speed] {total_tokens / elapsed:.2f} tokens/s | "
                  f"RTF: {total_tokens / sr / elapsed:.2f}x | Generated "
                  f"{total_tokens} tokens in {elapsed:.2f}s (batch={b}"
                  f"{pad}, device={self.device})")
        return results

    def synthesize(self, req: Request, dcfg: Optional[DecodeConfig] = None,
                   **kw) -> SynthesisResult:
        return self.synthesize_batch([req], dcfg, **kw)[0]

    # -- warm-up ------------------------------------------------------------

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               text_buckets: Sequence[int] = (64,),
               prompt_buckets: Sequence[int] = (64,),
               frame_buckets: Sequence[int] = (512,),
               dcfg: Optional[DecodeConfig] = None,
               vocoder: bool = False) -> List[dict]:
        """Front-load the serving path's start-up work for a bucket grid: on
        the card, build every kernel (``ops/cuda_build.build``), then for
        each (batch, text, prompt, frames) bucket run a request of 1-frame
        targets through ``engine.graphed_decoder``, which captures the
        bucket's session (the JAX package's ``warmup(execute=True)``
        compiles and runs a program instead); with ``vocoder``, decode
        once at every vocoder length bucket up to the largest frame
        bucket. Each bucket is registered as warm once its run has
        returned. Returns what it warmed, in order: ``{"kind": "kernels",
        "ms"}``, ``{"kind": "session", "batch", "text", "prompt",
        "frames", "capture_ms" (None when no capture ran: the CPU, or a
        session that already existed), "ms"}`` and ``{"kind": "vocoder",
        "length", "ms"}``."""
        dcfg = dcfg or DecodeConfig()
        report: List[dict] = []

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)

        if self.device.type == "cuda":
            from ..ops import cuda_build

            report.append(dict(kind="kernels", ms=timed(cuda_build.build)))
        for mf in frame_buckets:
            decode = engine.graphed_decoder(
                self.cfg, dataclasses.replace(dcfg, max_frames=mf))
            for b in batch_sizes:
                for tx in text_buckets:
                    for pm in prompt_buckets:
                        inputs = self._batch_inputs([], tx, pm, b)
                        before = {id(x) for x in engine.sessions()}

                        def run():
                            out = decode(self.params, *inputs, dcfg.seed)
                            out.gen_lens.cpu()

                        ms = timed(run)
                        new = [x for x in engine.sessions()
                               if id(x) not in before]
                        self._warm_shapes.add((self._warm_key(dcfg), b, tx,
                                               pm, mf))
                        report.append(dict(
                            kind="session", batch=b, text=tx, prompt=pm,
                            frames=mf, ms=ms,
                            capture_ms=new[0].capture_ms if new else None))
        if vocoder and self.audio_tokenizer is not None:
            from ..codec.audio_tokenizer import _BUCKETS

            top = max(frame_buckets)
            for vb in [v for v in _BUCKETS if v <= top] or _BUCKETS[:1]:
                ms = timed(lambda: self.audio_tokenizer.decode(
                    np.zeros((1, vb), np.int64),
                    lengths=np.full((1,), vb, np.int64)))
                report.append(dict(kind="vocoder", length=vb, ms=ms))
        return report

    # -- streaming synthesis ------------------------------------------------

    def synthesize_streaming(self, req: Request,
                             dcfg: Optional[DecodeConfig] = None,
                             seed: Optional[int] = None,
                             segment_frames: int = 50,
                             vocode_chunk: int = 50,
                             on_tokens: Optional[Callable[[np.ndarray], None]]
                             = None) -> Iterator[np.ndarray]:
        """Generator of waveform pieces (float32 at the codec's sample rate)
        while later tokens still generate: the decode loop advances in
        segments of ``segment_frames`` (``engine.graphed_segment_fns``: on
        the card replays of the bucket's captured step) and the final
        tokens stream through the windowed vocoder
        (``codec/streaming.StreamingVocoder``), so the first audio comes
        after about ``segment_frames + vocode_chunk + context`` frames of
        generation instead of the whole utterance. The tokens are those of
        :meth:`synthesize` at the same seed (without warm-shape routing);
        ``on_tokens`` is called with each segment's final tokens (y_sep and
        EOG stripped) before they are vocoded."""
        from ..codec.streaming import StreamingVocoder

        if self.audio_tokenizer is None:
            raise ValueError("streaming synthesis needs the codec (an "
                             "audio tokenizer)")
        dcfg = dcfg or DecodeConfig()
        cfg = self.cfg
        planned = self.plan_request(req)
        tx, p_max, max_frames = self.widths([planned])
        dcfg = dataclasses.replace(dcfg, max_frames=max_frames)
        x, x_lens, prm, prm_lens, targets = self._batch_inputs(
            [planned], tx, p_max, 1)
        seed = dcfg.seed if seed is None else seed
        prefill_fn, segment_fn = engine.graphed_segment_fns(cfg, dcfg)
        state = prefill_fn(self.params, x, x_lens, prm, prm_lens, targets)
        sv = StreamingVocoder(self.audio_tokenizer.params,
                              self.audio_tokenizer.cfg, chunk=vocode_chunk)
        strip = [cfg.special.y_sep, cfg.eog_inference]
        emitted = 0
        while True:
            until = min(int(state.step) + segment_frames, max_frames)
            state = segment_fn(self.params, state, x_lens, prm_lens, targets,
                               seed, until)
            step = int(state.step)
            done = bool(state.done[0])
            n_final = int(state.gen_lens[0]) if done else step
            new = state.tokens[0, emitted:n_final].cpu().numpy()
            emitted = n_final
            new = new[~np.isin(new, strip)]
            if len(new):
                if on_tokens is not None:
                    on_tokens(new)
                piece = sv.feed(new)
                if len(piece):
                    yield piece
            if done or step >= max_frames:
                break
        tail = sv.flush()
        if len(tail):
            yield tail

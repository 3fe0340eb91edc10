"""End-to-end TTS inference pipeline (text [+ reference audio] ->
waveform), in PyTorch.

Counterpart of ``t5gemma_tts_tpu/inference/pipeline.py``: reference-audio
tokenization (voice cloning: the XCodec2 encoder), ``repeat_prompt`` (an int
or ``"max"``), y_sep / x_sep assembly, target length (prompt + codec_sr * target_secs), batched decode, sep/EOG
stripping, codec decode and the ``[Speed]`` report. Text, prompt and
generation buffers are padded to the same buckets as the JAX package, so a
request decodes over the same shapes. PyTorch compiles nothing, so there is
no warm-shape routing and no padding rows. The decode serves through
``engine.graphed_decoder``: on the card one captured CUDA graph of the step
per shape bucket, replayed (the JAX pipeline serves through
``jitted_decoder``); on the CPU the eager loop. ``int8=True`` serves with W8A8
decode weights (``ops/quant.quantize_params_for_decode``), whose paged decode
steps run through the decode-layer kernels; ``int4=True`` is the batch-1
latency mode: the six decode-layer products and the head's ``w2`` become
int4 (W4A8), everything else quantized stays int8.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

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

    def synthesize_planned(self, planned: Sequence[PlannedRequest],
                           dcfg: Optional[DecodeConfig] = None,
                           seed: Optional[int] = None, quiet: bool = False,
                           decode_audio: bool = True
                           ) -> List[SynthesisResult]:
        dcfg = dcfg or DecodeConfig()
        cfg = self.cfg
        s = cfg.special
        sr = int(cfg.encodec_sr)
        dev = self.device
        texts = [p.text for p in planned]
        prompts = [p.prompt for p in planned]
        b = len(planned)
        tx, p_max, max_frames = self.widths(planned)

        x = np.zeros((b, tx), np.int32)
        x_lens = np.zeros((b,), np.int32)
        prm = np.full((b, p_max), s.pad, np.int32)
        prm_lens = np.zeros((b,), np.int32)
        for i, (t, p) in enumerate(zip(texts, prompts)):
            t, p = t[:tx], p[:p_max]
            x[i, :len(t)] = t
            x_lens[i] = len(t)
            prm[i, :len(p)] = p
            prm_lens[i] = len(p)
        targets = np.asarray([p.target for p in planned], np.int32)

        def dev_i32(a):
            return torch.from_numpy(a).to(dev)

        stime = time.time()
        decode = engine.graphed_decoder(
            cfg, dataclasses.replace(dcfg, max_frames=max_frames))
        out = decode(self.params, dev_i32(x), dev_i32(x_lens), dev_i32(prm),
                     dev_i32(prm_lens), dev_i32(targets),
                     dcfg.seed if seed is None else seed)
        tokens = out.tokens.cpu().numpy()
        gen_lens = out.gen_lens.cpu().numpy()
        elapsed = time.time() - stime

        results: List[SynthesisResult] = []
        strip = [s.y_sep, cfg.eog_inference]
        total_tokens = int(gen_lens.sum())
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
            print(f"[Speed] {total_tokens / elapsed:.2f} tokens/s | "
                  f"RTF: {total_tokens / sr / elapsed:.2f}x | Generated "
                  f"{total_tokens} tokens in {elapsed:.2f}s (batch={b}, "
                  f"device={dev})")
        return results

    def synthesize(self, req: Request, dcfg: Optional[DecodeConfig] = None,
                   **kw) -> SynthesisResult:
        return self.synthesize_batch([req], dcfg, **kw)[0]

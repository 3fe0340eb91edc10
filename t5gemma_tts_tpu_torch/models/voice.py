"""T5GemmaVoice: backbone + audio embedding + prediction head, in PyTorch.

Counterpart of ``t5gemma_tts_tpu/models/voice.py``: :func:`init_params`,
:func:`embed_audio`, :func:`encode_text` and :func:`predict_head` (a
2-layer head with exact erf GELU, unlike the backbone MLP's tanh GELU), and
the training forward: :func:`prepare_decoder_io` (the BOS shift and EOS
append as mask arithmetic), :func:`forward` (PM positions on both stacks,
dense causal + pad masks, layers rematerialized under
``cfg.gradient_checkpointing``) and its loss, :func:`token_loss` over dense
logits or :func:`loss_from_nll` over ``ops/chunked_ce``'s per-token nll
when ``0 < cfg.ce_vocab_chunk < cfg.audio_embedding_vocab``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import VoiceConfig
from ..device import DeviceLike, resolve_device
from ..ops import chunked_ce
from ..ops import masks as mask_ops
from ..ops import rope as rope_ops
from ..ops.quant import q_matmul
from ..parallel import tensor as tp
from . import t5gemma

PyTree = Any


class VoiceOutputs(NamedTuple):
    loss: torch.Tensor
    mean_ce: torch.Tensor
    perplexity: torch.Tensor
    top10acc: torch.Tensor
    effective_ntokens: torch.Tensor
    # the CE weights' sum, mean_ce's denominator before its clamp (the
    # data-parallel step weighs each rank's mean_ce by it)
    ce_weight: torch.Tensor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: VoiceConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def init_params(seed: int, cfg: VoiceConfig,
                device: DeviceLike = "cuda") -> PyTree:
    """Seeded random parameters, generated on ``device`` (a full-size model
    never passes through host memory)."""
    dev = resolve_device(device)
    # the meta device (shapes only, nothing allocated) has no generator
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if dev.type != "meta" else None)
    dtype = compute_dtype(cfg)
    d = cfg.backbone.hidden_size
    va = cfg.audio_embedding_vocab

    def normal(*shape):
        return t5gemma._normal(gen, shape, dtype, dev)

    return {
        "encoder": t5gemma.init_stack(
            gen, cfg.backbone.encoder, is_decoder=False, with_embed=True,
            dtype=dtype, device=dev),
        "decoder": t5gemma.init_stack(
            gen, cfg.backbone.decoder, is_decoder=True, with_embed=False,
            dtype=dtype, device=dev,
            cross_hidden=cfg.backbone.cross_attention_hidden_size),
        "audio_embed": normal(va, d),
        "head": {
            "w1": normal(d, d),
            "b1": torch.zeros((d,), dtype=dtype, device=dev),
            "w2": normal(d, va),
            "b2": torch.zeros((va,), dtype=dtype, device=dev),
        },
    }


def predict_head(head: Dict[str, torch.Tensor],
                 hidden: torch.Tensor) -> torch.Tensor:
    """2-layer head with exact (erf) GELU -> audio-token logits; ``w1`` and
    ``w2`` may be W8A8 ``QuantWeight`` leaves, ``w2`` an ``Int4Weight``.
    Under tensor parallelism ``w1`` / ``b1`` hold a column block and ``w2``
    the matching row block: the logits are summed over the model group
    before ``b2`` (``tp.row_product``: a quantized ``w2`` with the group's
    activation scales and int32 sums)."""
    split = tp.is_block(tp.out_width(head["w1"]), hidden.shape[-1],
                        "the head's w1")
    if split:
        hidden = tp.copy_to_model(hidden)
    h = F.gelu(q_matmul(hidden, head["w1"]) + head["b1"])
    if split:
        return tp.row_product(h, head["w2"]) + head["b2"]
    return q_matmul(h, head["w2"]) + head["b2"]


def embed_audio(params: PyTree, tokens: torch.Tensor,
                vocab: Optional[int] = None) -> torch.Tensor:
    """The audio embedding's rows for ``tokens``; ``vocab`` (the table's
    whole row count) lets a tensor-parallel block be looked up."""
    if vocab is not None:
        return tp.vocab_embedding(tokens, params["audio_embed"], vocab)
    return F.embedding(tokens.long(), params["audio_embed"])


def encode_text(params: PyTree, cfg: VoiceConfig, x: torch.Tensor,
                x_lens: torch.Tensor):
    """Run the text encoder -> (memory [B, Tx, D], encoder PM positions)."""
    dims = cfg.backbone.encoder
    tx = x.shape[1]
    if cfg.use_pm_rope:
        enc_pos = rope_ops.progress_position_ids(x_lens, tx, cfg.progress_scale)
    else:
        enc_pos = torch.arange(tx, dtype=torch.float32,
                               device=x.device)[None].expand(x.shape[0], tx)
    memory = t5gemma.encoder_forward(
        params["encoder"], dims, input_ids=x,
        full_bias=mask_ops.encoder_self_bias(x_lens, tx),
        sliding_bias=mask_ops.encoder_sliding_bias(x_lens, tx,
                                                   dims.sliding_window),
        position_ids=enc_pos, remat=cfg.gradient_checkpointing,
    )
    return memory, enc_pos


def prepare_decoder_io(cfg: VoiceConfig, y: torch.Tensor,
                       y_lens: torch.Tensor):
    """Batched BOS shift + EOS append. y: [B, T] codec tokens (right
    padded) -> targets [B, T+1] (y, EOS at y_lens[b], pad beyond),
    dec_input [B, T+1] (empty token, then targets shifted right; pad
    beyond each row's length) and new_y_lens = y_lens + 1."""
    s = cfg.special
    b, t = y.shape
    pos = torch.arange(t + 1, device=y.device)[None, :]
    y_ext = F.pad(y, (0, 1), value=s.pad)
    lens = y_lens[:, None]
    targets = torch.where(
        pos < lens, y_ext,
        torch.where(pos == lens, torch.full_like(y_ext, cfg.eog_inference),
                    torch.full_like(y_ext, s.pad)))
    shifted = torch.cat([torch.full((b, 1), s.empty, dtype=targets.dtype,
                                    device=y.device), targets[:, :-1]], dim=1)
    new_y_lens = y_lens + 1
    dec_input = torch.where(pos < new_y_lens[:, None], shifted,
                            torch.full_like(shifted, s.pad))
    return targets, dec_input, new_y_lens


def forward(params: PyTree, cfg: VoiceConfig,
            batch: Dict[str, torch.Tensor]) -> VoiceOutputs:
    """Training forward + loss. batch: x [B, Tx], x_lens [B], y [B, Ty],
    y_lens [B], y_sep_position [B] (optional)."""
    x, x_lens = batch["x"], batch["x_lens"]
    y, y_lens = batch["y"], batch["y_lens"]
    dims = cfg.backbone.decoder
    memory, enc_pos = encode_text(params, cfg, x, x_lens)
    targets, dec_input, new_y_lens = prepare_decoder_io(cfg, y, y_lens)
    t_dec = dec_input.shape[1]
    if cfg.use_pm_rope:
        dec_pos = rope_ops.progress_position_ids(new_y_lens, t_dec,
                                                 cfg.progress_scale)
        pm_dec, pm_enc = dec_pos, enc_pos
    else:
        dec_pos = torch.arange(t_dec, dtype=torch.float32,
                               device=y.device)[None].expand(y.shape[0], t_dec)
        pm_dec = pm_enc = None
    embedded = embed_audio(params, dec_input,
                           cfg.audio_embedding_vocab).to(memory.dtype)
    cross_k, cross_v = t5gemma.build_cross_kv(params["decoder"], dims, memory,
                                              pm_enc)
    hidden, _ = t5gemma.decoder_forward(
        params["decoder"], dims, inputs_embeds=embedded,
        self_full_bias=mask_ops.decoder_self_bias(new_y_lens, t_dec),
        self_sliding_bias=mask_ops.decoder_sliding_bias(
            new_y_lens, t_dec, dims.sliding_window),
        cross_bias=mask_ops.cross_bias(x_lens, t_dec, x.shape[1]),
        position_ids=dec_pos, pm_decoder_positions=pm_dec,
        cross_k=cross_k, cross_v=cross_v, remat=cfg.gradient_checkpointing)
    sep = batch.get("y_sep_position")
    if 0 < cfg.ce_vocab_chunk < cfg.audio_embedding_vocab:
        nll, hit = chunked_ce.head_nll_top10(cfg.ce_vocab_chunk,
                                             params["head"], hidden, targets)
        return loss_from_nll(cfg, nll, hit, targets, new_y_lens, sep)
    logits = predict_head(params["head"], hidden)
    return token_loss(cfg, logits, targets, new_y_lens, sep)


def _counted(cfg: VoiceConfig, t: int, new_y_lens: torch.Tensor,
             sep_positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Positions in the loss: pos < new_y_lens, and pos >= the prefix cut
    when ``no_loss_on_prefix``."""
    pos = torch.arange(t, device=new_y_lens.device)[None, :]
    counted = pos < new_y_lens[:, None]
    if cfg.no_loss_on_prefix and sep_positions is not None:
        counted = counted & (pos >= sep_positions[:, None])
    return counted


def token_loss(cfg: VoiceConfig, logits: torch.Tensor, targets: torch.Tensor,
               new_y_lens: torch.Tensor,
               sep_positions: Optional[torch.Tensor]) -> VoiceOutputs:
    """CE + metrics over dense logits [B, T, Va]: y_sep targets leave the
    CE but count in ``effective_ntokens`` and top-10 accuracy; loss =
    weighted-mean CE x counted tokens."""
    va = logits.shape[-1]
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=-1)
    tg = targets.long()
    nll = -torch.gather(logp, -1, tg[:, :, None])[..., 0]
    top10 = torch.topk(lf, min(10, va), dim=-1).indices
    hit = (top10 == tg[:, :, None]).any(dim=-1)
    counted = _counted(cfg, targets.shape[1], new_y_lens, sep_positions)
    return _assemble_outputs(cfg, nll, hit, targets, counted)


def loss_from_nll(cfg: VoiceConfig, nll: torch.Tensor, top10_hit: torch.Tensor,
                  targets: torch.Tensor, new_y_lens: torch.Tensor,
                  sep_positions: Optional[torch.Tensor]) -> VoiceOutputs:
    """:func:`token_loss`'s aggregation from per-token nll / top-10 hits
    (the chunked-CE path)."""
    counted = _counted(cfg, targets.shape[1], new_y_lens, sep_positions)
    return _assemble_outputs(cfg, nll, top10_hit, targets, counted)


def _assemble_outputs(cfg: VoiceConfig, nll, hit, targets,
                      counted) -> VoiceOutputs:
    s = cfg.special
    ce_mask = counted & (targets != s.y_sep)
    if cfg.eog_weight != 1.0:
        w = torch.where(targets == s.eog,
                        torch.full_like(nll, cfg.eog_weight),
                        torch.ones_like(nll))
    else:
        w = torch.ones_like(nll)
    w = w * ce_mask.float()
    weight = w.sum()
    wsum = torch.clamp(weight, min=1e-8)
    mean_ce = (nll * w).sum() / wsum
    ntokens = counted.sum()
    return VoiceOutputs(
        loss=mean_ce * ntokens.float(),
        mean_ce=mean_ce,
        perplexity=torch.exp(mean_ce),
        top10acc=(hit & counted).sum(),
        effective_ntokens=ntokens,
        ce_weight=weight.detach(),
    )

"""Training entry point of the port.

Counterpart of ``t5gemma_tts_tpu/train/cli.py``, with its flags and
``--device``: parses the flags, writes ``args.json`` and ``config.json``
into the experiment directory (``--resume`` merges the stored args back),
builds the datasets and runs :class:`~.trainer.Trainer` on one device,
``cuda`` unless ``--device cpu``. Under ``torchrun`` (``WORLD_SIZE`` above
1) every rank joins the process group (NCCL, one card a rank; gloo with
``--device cpu``) and trains on a ``(data, model)`` mesh of ``--tp``-wide
model groups, with the optimizer's moments split over the data group
under ``--zero_opt_sharding 1`` (the default); only rank 0 writes
``args.json`` / ``config.json``, copies the code base and logs. One
process builds no mesh and trains unsplit whatever ``--tp`` says, as the
JAX CLI does on one device.

Run: python -m t5gemma_tts_tpu_torch.train.cli --dataset_dir /data/emilia \
        --exp_dir ./exp --num_steps 143391 --optimizer_name ScaledAdam ...
     torchrun --nproc_per_node 8 -m t5gemma_tts_tpu_torch.train.cli \
        --tp 2 --zero_opt_sharding 1 ...
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    # general (reference config.py:50-74)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--precision", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tb_write_every_n_steps", type=int, default=100)
    p.add_argument("--print_every_n_steps", type=int, default=250)
    p.add_argument("--val_every_n_steps", type=int, default=500)
    p.add_argument("--inference_every_n_steps", type=int, default=3000)
    p.add_argument("--save_every_n_steps", type=int, default=10000000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_fraction", type=float, default=0.1)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--early_stop_step", type=int, default=3200)
    p.add_argument("--early_stop_threshold", type=float, default=-1.0)
    # paths
    p.add_argument("--exp_dir", default="./exp")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--manifest_name", default="manifest_final")
    p.add_argument("--encodec_folder_name", default="xcodec2_1cb")
    p.add_argument("--text_folder_name", default="text")
    p.add_argument("--neighbor_folder_name", default="neighbors")
    # model
    p.add_argument("--backbone_preset", default="2b-2b")
    p.add_argument("--load_model_from", default=None,
                   help="warm-start from a checkpoint load_voice_model "
                        "reads: an HF export directory, a training "
                        "exp_dir or a reference .pth")
    p.add_argument("--audio_vocab_size", type=int, default=65536)
    p.add_argument("--n_special", type=int, default=5)
    p.add_argument("--use_pm_rope", type=int, default=1)
    p.add_argument("--progress_scale", type=float, default=2000.0)
    p.add_argument("--eog_weight", type=float, default=1.0)
    p.add_argument("--no_loss_on_prefix", type=int, default=0)
    p.add_argument("--t5_gradient_checkpointing", type=int, default=0)
    p.add_argument("--x_sep_token", type=int, default=255999)
    p.add_argument("--ce_vocab_chunk", type=int, default=8192,
                   help="training CE in vocab blocks of this many columns "
                        "(never materializes the [B,T,V] logits; "
                        "ops/chunked_ce.py); 0 = dense loss path")
    p.add_argument("--text_tokenizer_name", default="google/t5gemma-2b-2b-ul2")
    # data (reference config.py:118-132, 177-184)
    p.add_argument("--max_num_tokens", type=int, default=18750)
    p.add_argument("--val_max_num_tokens", type=int, default=6000)
    p.add_argument("--num_buckets", type=int, default=10)
    p.add_argument("--audio_max_length", type=float, default=120)
    p.add_argument("--audio_min_length", type=float, default=2)
    p.add_argument("--text_max_length", type=int, default=1000)
    p.add_argument("--encodec_sr", type=float, default=50)
    p.add_argument("--neighbor_prompt_prob", type=float, default=0)
    p.add_argument("--min_prompt_len", type=float, default=0.5)
    p.add_argument("--neighbor_selection_method", default="maxdist_60")
    p.add_argument("--num_trial", type=int, default=5)
    p.add_argument("--validation_sample_cap", type=int, default=None)
    # time-stretch augmentation (reference config.py:173-174); re-encoding
    # stretched audio needs --codec_dir pointing at full (encoder) weights
    p.add_argument("--target_time_stretch_prob", type=float, default=0)
    p.add_argument("--target_time_stretch_bound", type=float, default=0.1)
    p.add_argument("--audio_folder_name", default="audio")
    # optimizer
    p.add_argument("--optimizer_name", default="AdamW",
                   choices=["AdamW", "ScaledAdam"])
    p.add_argument("--reduce_lr_start_step", type=int, default=3000)
    p.add_argument("--reduce_lr_start_epoch", type=int, default=4)
    p.add_argument("--clipping_update_period", type=int, default=600)
    p.add_argument("--pseudo_epoch_size", type=int, default=37901)
    # LoRA (reference config.py:99-108)
    p.add_argument("--use_lora", type=int, default=0)
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=32)
    # validation-generation diagnostics (reference trainer.py:668-890)
    p.add_argument("--val_generation_text", default=None,
                   help="synthesize this text every inference_every_n_steps "
                        "and dump stats/wav (audio decode needs --codec_dir)")
    p.add_argument("--codec_dir", default=None,
                   help="local XCodec2 safetensors dir for diagnostics decode")
    # parallelism (torchrun's ranks)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (model group width)")
    p.add_argument("--zero_opt_sharding", type=int, default=1,
                   help="ZeRO-1: split the optimizer's moments over the "
                        "data-parallel ranks (default on; 0 replicates "
                        "them on each rank)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back")
    return p


def load_text_tokenizer(name: str):
    """(encode, eos id, pad id) of a text tokenizer. A local directory with
    a ``tokenizer.json`` loads through ``tokenizers`` alone (the same ids
    as the fast tokenizer ``AutoTokenizer`` builds from it), a hub name
    through ``transformers``."""
    path = os.path.join(name, "tokenizer.json")
    if os.path.isfile(path):
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(path)
        special = {}
        conf = os.path.join(name, "tokenizer_config.json")
        if os.path.isfile(conf):
            with open(conf) as f:
                special = json.load(f)

        def token_id(key):
            value = special.get(key)
            if isinstance(value, dict):
                value = value.get("content")
            return (tok.token_to_id(value) if value else None) or 0

        return (lambda t: tok.encode(t, add_special_tokens=False).ids,
                token_id("eos_token"), token_id("pad_token"))
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name)
    return (lambda t: tok.encode(t, add_special_tokens=False),
            tok.eos_token_id or 0, tok.pad_token_id or 0)


def main(argv: Optional[list] = None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ..config import VoiceConfig, backbone_preset
    from ..data.dataset import VoiceDataset
    from ..data.manifest import DataConfig
    from ..device import resolve_device
    from ..parallel import mesh as mesh_mod
    from . import checkpoint as ckpt
    from .trainer import Trainer, TrainerConfig

    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh, joined = None, False
    if world > 1:
        import torch.distributed as dist

        joined = not dist.is_initialized()
        device = mesh_mod.init_distributed(args.device)
        mesh = mesh_mod.make_mesh(tp=args.tp)
        if not mesh.lead:
            logging.getLogger().setLevel(logging.WARNING)
        log.info("mesh: dp %d x tp %d", mesh.dp, mesh.tp)
    else:               # one process: no mesh, as the JAX CLI at one device
        device = resolve_device(args.device)
        if args.tp != 1:
            log.warning("--tp %d needs torchrun's ranks: one process "
                        "trains unsplit", args.tp)
    lead = mesh is None or mesh.lead
    # args snapshot + resume merge
    args_path = os.path.join(args.exp_dir, "args.json")
    if args.resume and os.path.isfile(args_path):
        with open(args_path) as f:
            old = json.load(f)
        # the launch's own: where it runs and how its ranks split the work
        # (a bundle restores at any world size and any (dp, tp))
        fresh = {"resume", "num_steps", "num_epochs", "exp_dir", "device",
                 "tp", "zero_opt_sharding"}
        for k, v in old.items():
            if k not in fresh and hasattr(args, k):
                setattr(args, k, v)
        log.info("resume: merged stored args from %s", args_path)
    mesh_mod.barrier(mesh)          # every rank has read args.json
    if lead:
        os.makedirs(args.exp_dir, exist_ok=True)
        with open(args_path, "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    cfg = VoiceConfig(
        backbone=backbone_preset(args.backbone_preset),
        audio_vocab_size=args.audio_vocab_size,
        n_special=args.n_special,
        encodec_sr=int(args.encodec_sr),
        use_pm_rope=bool(args.use_pm_rope),
        progress_scale=args.progress_scale,
        eog_weight=args.eog_weight,
        no_loss_on_prefix=bool(args.no_loss_on_prefix),
        x_sep_token=args.x_sep_token,
        dtype=args.precision,
        gradient_checkpointing=bool(args.t5_gradient_checkpointing),
        ce_vocab_chunk=args.ce_vocab_chunk,
    )
    if lead:
        ckpt.save_config(args.exp_dir, cfg)

    text_tokenizer, add_eos, text_pad = load_text_tokenizer(
        args.text_tokenizer_name)

    dcfg = DataConfig(
        dataset_dir=args.dataset_dir,
        manifest_name=args.manifest_name,
        encodec_folder_name=args.encodec_folder_name,
        text_folder_name=args.text_folder_name,
        neighbor_folder_name=args.neighbor_folder_name,
        encodec_sr=args.encodec_sr,
        audio_min_length=args.audio_min_length,
        audio_max_length=args.audio_max_length,
        text_max_length=args.text_max_length,
        validation_sample_cap=args.validation_sample_cap,
        neighbor_prompt_prob=args.neighbor_prompt_prob,
        neighbor_selection_method=args.neighbor_selection_method,
        num_trial=args.num_trial,
        min_prompt_len=args.min_prompt_len,
        seed=args.seed,
        target_time_stretch_prob=args.target_time_stretch_prob,
        target_time_stretch_bound=args.target_time_stretch_bound,
        audio_folder_name=args.audio_folder_name,
    )

    def load_codec():
        from ..inference.cli import _load_codec

        return _load_codec(argparse.Namespace(
            codec_dir=args.codec_dir, random_codec=False,
            xcodec2_model_name=None), {}, device)

    codec_encode = None
    encode_sr = 16000
    if args.target_time_stretch_prob > 0 and args.codec_dir:
        # re-encode of time-stretched audio
        stretch_tok = load_codec()
        codec_encode = lambda w: stretch_tok.encode(w)[0, :, 0]  # noqa: E731
        encode_sr = stretch_tok.encode_sample_rate
    train_ds = VoiceDataset(dcfg, "train", text_tokenizer, cfg.x_sep_token,
                            cfg.special.y_sep, add_eos_to_text=add_eos,
                            seed=args.seed, codec_encode=codec_encode,
                            encode_sample_rate=encode_sr)
    try:
        valid_ds = VoiceDataset(dcfg, "valid", text_tokenizer, cfg.x_sep_token,
                                cfg.special.y_sep, add_eos_to_text=add_eos,
                                seed=args.seed)
    except RuntimeError:
        valid_ds = None
        log.warning("no valid split found; skipping validation")

    params = None
    if args.load_model_from:
        from ..inference.loading import load_voice_model

        params, _, _ = load_voice_model(args.load_model_from, device)
        log.info("warm start from %s", args.load_model_from)

    tcfg = TrainerConfig(
        exp_dir=args.exp_dir,
        lr=args.lr,
        optimizer_name=args.optimizer_name,
        num_steps=args.num_steps or 10_000,
        warmup_fraction=args.warmup_fraction,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_num_tokens=args.max_num_tokens,
        val_max_num_tokens=args.val_max_num_tokens,
        num_buckets=args.num_buckets,
        tb_write_every_n_steps=args.tb_write_every_n_steps,
        print_every_n_steps=args.print_every_n_steps,
        val_every_n_steps=args.val_every_n_steps,
        save_every_n_steps=args.save_every_n_steps,
        early_stop_step=args.early_stop_step,
        early_stop_threshold=args.early_stop_threshold,
        reduce_lr_start_step=args.reduce_lr_start_step,
        reduce_lr_start_epoch=args.reduce_lr_start_epoch,
        pseudo_epoch_size=args.pseudo_epoch_size,
        clipping_update_period=args.clipping_update_period,
        num_epochs=args.num_epochs,
        seed=args.seed,
        text_pad_token=text_pad,
        text_max_length=args.text_max_length,
        inference_every_n_steps=args.inference_every_n_steps,
        use_lora=bool(args.use_lora),
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        zero_opt_sharding=bool(args.zero_opt_sharding),
    )

    from ..utils.snapshot import copy_codebase
    from .logging_utils import MultiLogger

    tb = None
    if lead:
        copy_codebase(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            args.exp_dir)
        tb = MultiLogger(args.exp_dir,
                         use_wandb=bool(os.environ.get("WANDB_MODE")),
                         config=vars(args))
    generation_hook = None
    if args.val_generation_text and lead:
        from .diagnostics import make_generation_hook

        generation_hook = make_generation_hook(
            cfg, text_tokenizer, args.val_generation_text, args.exp_dir,
            audio_tokenizer=load_codec() if args.codec_dir else None,
            tb_writer=tb, device=device)

    trainer = Trainer(cfg, tcfg, train_ds, valid_ds, params=params,
                      mesh=mesh, tb_writer=tb,
                      generation_hook=generation_hook, device=device)
    progress = trainer.train()
    if tb is not None:
        tb.close()
    log.info("training done: %s", progress)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return progress


if __name__ == "__main__":
    main()

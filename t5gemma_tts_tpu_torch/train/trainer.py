"""The training loop over bucketed fixed-shape batches.

Counterpart of ``t5gemma_tts_tpu/train/trainer.py``: per-step metrics, the
Eden (ScaledAdam) or linear warmup-decay (AdamW) schedule, gradient
accumulation over consecutive same-bucket batches, periodic validation
with best-bundle tracking and early stopping on a plateau, bundle rotation
and cadence snapshots, resume, divergence abort, TensorBoard / wandb
logging, the generation hook, and LoRA (adapters train over a frozen
base). It runs on one device (``cuda`` unless the caller passes ``cpu``)
or, given a ``parallel.Mesh``, as one rank of a data- and tensor-parallel
run: the parameters are this rank's blocks, the optimizer's moments its
ZeRO-1 slices when ``zero_opt_sharding`` is on, every rank's seeded
sampler builds the same global batch and keeps its rows, validation
metrics come out global, and only rank 0 logs, writes bundles and runs the
generation hook (on gathered parameters). A process group of more than one
rank needs a mesh.

Resume is exact: a bundle also records the loader's position (the
sampler batches the epoch has consumed, the batches waiting for their
accumulation group and the dataset's random state), so steps after a
resume equal the steps of an uninterrupted run. The JAX trainer counts
steps rather than batches there and restarts the epoch after its last
save, which this loop does not copy.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import VoiceConfig
from ..data import batching
from ..data.dataset import VoiceDataset
from ..device import DeviceLike, resolve_device, tree_to
from ..models import voice
from . import checkpoint as ckpt
from . import optim, train_step

log = logging.getLogger(__name__)



@dataclass
class TrainerConfig:
    """Training-loop knobs (the JAX TrainerConfig's)."""

    exp_dir: str = "exp"
    lr: float = 0.035
    optimizer_name: str = "ScaledAdam"  # or "AdamW"
    num_steps: int = 10000
    warmup_fraction: float = 0.1
    gradient_accumulation_steps: int = 1
    max_num_tokens: int = 18750
    val_max_num_tokens: int = 6000
    num_buckets: int = 10
    tb_write_every_n_steps: int = 100
    print_every_n_steps: int = 250
    val_every_n_steps: int = 500
    save_every_n_steps: int = 10_000_000
    early_stop_step: int = 3200
    early_stop_threshold: float = -1.0
    reduce_lr_start_step: int = 3000
    reduce_lr_start_epoch: int = 4
    pseudo_epoch_size: int = 37901
    clipping_update_period: int = 600
    num_epochs: int = 10
    seed: int = 1
    text_pad_token: int = 0
    text_max_length: int = 1000
    # ZeRO-1: the optimizer's moments split over the mesh's data group
    # (without a mesh there is nothing to split)
    zero_opt_sharding: bool = False
    inference_every_n_steps: int = 3000
    use_lora: bool = False
    lora_r: int = 16
    lora_alpha: int = 32


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class Trainer:
    def __init__(
        self,
        cfg: VoiceConfig,
        tcfg: TrainerConfig,
        train_ds: VoiceDataset,
        valid_ds: Optional[VoiceDataset] = None,
        params: Optional[Any] = None,
        mesh=None,
        tb_writer=None,
        generation_hook: Optional[Callable] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if mesh is None and _world_size() > 1:
            raise ValueError(
                f"a process group of {_world_size()} ranks needs a mesh: "
                "build one over all ranks (parallel.make_mesh) so that each "
                "rank takes its rows of the batch (parallel.shard_batch)")
        self.mesh = mesh
        self.lead = mesh is None or mesh.lead
        if mesh is not None:
            self.device = mesh.device
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_ds = train_ds
        self.valid_ds = valid_ds
        self.tb = tb_writer
        self.generation_hook = generation_hook

        if tcfg.optimizer_name == "ScaledAdam":
            self.ocfg = optim.ScaledAdamConfig(
                clipping_update_period=tcfg.clipping_update_period,
                clipping_scale=2.0)
        else:
            self.ocfg = optim.AdamWConfig()
        if params is None:
            params = voice.init_params(tcfg.seed, cfg, self.device)
        params = tree_to(params, self.device)
        self.param_specs = None
        if mesh is not None:
            from .. import parallel

            self.param_specs = parallel.param_specs(params, cfg, mesh.tp)

        self.lcfg = None
        self.layout = None
        if tcfg.use_lora:
            from . import lora

            self.lcfg = lora.LoraConfig(r=tcfg.lora_r, alpha=tcfg.lora_alpha)
            gen = torch.Generator(device=self.device).manual_seed(
                tcfg.seed + 1)
            # drawn from the whole leaves' shapes; the adapters stay whole
            adapters = lora.init_adapters(gen, params, self.lcfg)
            params = self._shard(params)
            self.base_params = params
            self.layout = self._layout(adapters, None)
            self.state = train_step.init_state(adapters, self.ocfg,
                                               self.layout)
            lora_step = train_step.make_lora_train_step(
                cfg, self.ocfg, self.lcfg, self.layout)

            def step_fn(state, batch, lr):
                ads, opt, metrics = lora_step(state.params, state.opt,
                                              self.base_params, batch, lr)
                return train_step.TrainState(
                    params=ads, opt=opt, step=state.step + 1,
                    nan_skips=state.nan_skips + metrics.nan_step), metrics

            self._step_fn = step_fn
        else:
            params = self._shard(params)
            self.layout = self._layout(params, self.param_specs)
            self.state = train_step.init_state(params, self.ocfg,
                                               self.layout)
            self._step_fn = train_step.make_train_step(cfg, self.ocfg,
                                                       self.layout)
        self._eval_fn = train_step.make_eval_step(cfg, mesh)
        self.state_specs = None
        # whether any rank has a generation hook (the gather before it is
        # collective)
        self._hooked = generation_hook is not None
        if mesh is not None:
            from ..parallel import mesh as mesh_mod

            self.state_specs = mesh_mod.state_specs(self.state, self.layout)
            flag = torch.tensor([float(self._hooked)], device=self.device)
            self._hooked = bool(mesh_mod.all_reduce(flag, None) > 0)

        dp = mesh.dp if mesh is not None else 1
        self.plan = batching.make_plan(
            train_ds.lengths, tcfg.max_num_tokens, tcfg.num_buckets,
            max_len=int(train_ds.cfg.audio_max_length
                        * train_ds.cfg.encodec_sr), batch_multiple=dp)
        self.sampler = batching.BucketBatchSampler(
            train_ds.lengths, self.plan, shuffle=True, seed=tcfg.seed)
        if valid_ds is not None:
            self.val_plan = batching.make_plan(
                valid_ds.lengths, tcfg.val_max_num_tokens, tcfg.num_buckets,
                max_len=int(valid_ds.cfg.audio_max_length
                            * valid_ds.cfg.encodec_sr), batch_multiple=dp)

        from ..utils.profiling import param_count_breakdown

        if self.lead:
            counts = param_count_breakdown(self.state.params)
            log.info("parameter counts%s: %s",
                     "" if mesh is None else " (rank 0's blocks)",
                     {k: f"{v / 1e6:.1f}M" for k, v in counts.items()})

        # cur_step: sampler batches the epoch has consumed
        self.progress: Dict[str, Any] = {
            "step": 0, "epoch": 0, "cur_step": 0,
            "best_step": 0, "best_score": float("inf"),
        }
        # (step, loss, ..., seconds) of every step this object ran
        self.history: List[Dict[str, float]] = []
        self._pending: Dict[int, List[Dict[str, np.ndarray]]] = \
            defaultdict(list)
        if ckpt.has_bundle(tcfg.exp_dir):
            self.state, progress, loader = ckpt.restore_bundle(
                tcfg.exp_dir, self.state, mesh=mesh, specs=self.state_specs)
            self.progress.update(progress)
            if loader is not None:
                self._load_loader(loader)
            self._info("resumed at step %d", self.progress["step"])

    # ------------------------------------------------------------------

    def _shard(self, params):
        """This rank's blocks of whole parameters (all of them alone)."""
        if self.mesh is None:
            return params
        from .. import parallel

        return parallel.shard_params(params, self.mesh, self.param_specs)

    def _layout(self, target, specs):
        """The trained tree's place on the mesh (None alone): ``target``
        this rank's blocks, ``specs`` theirs (None: ``target`` is whole,
        as the adapters are)."""
        if self.mesh is None:
            return None
        from .. import parallel

        if specs is None:
            specs = parallel.param_specs(target, self.cfg, self.mesh.tp)
        return parallel.Layout(self.mesh, specs, target,
                               zero=self.tcfg.zero_opt_sharding)

    def _info(self, *args) -> None:
        if self.lead:
            log.info(*args)

    def _whole_params(self):
        """Plain whole parameters (LoRA merged) from every rank's blocks:
        collective over a mesh."""
        from .. import parallel

        params = self.state.params
        base = getattr(self, "base_params", None)
        if self.mesh is not None:
            if self.lcfg is None:
                params = parallel.gather_params(params, self.mesh,
                                                self.param_specs)
            else:
                base = parallel.gather_params(base, self.mesh,
                                              self.param_specs)
        if self.lcfg is not None:
            from . import lora

            params = lora.merge(base, params, self.lcfg)
        return params

    def _loader(self) -> Dict[str, Any]:
        """The data position a bundle records: waiting batches and the
        dataset's random state."""
        version, internal, gauss = self.train_ds._rng.getstate()
        return {
            "pending": {int(b): [{k: torch.from_numpy(v) for k, v in nb.items()}
                                 for nb in lst]
                        for b, lst in self._pending.items() if lst},
            "rng": [version, list(internal), gauss],
        }

    def _load_loader(self, loader: Dict[str, Any]) -> None:
        self._pending = defaultdict(list, {
            int(b): [{k: v.numpy() for k, v in nb.items()} for nb in lst]
            for b, lst in loader["pending"].items()})
        version, internal, gauss = loader["rng"]
        self.train_ds._rng.setstate((version, tuple(internal), gauss))

    def _save(self, name: str = ckpt.BUNDLE, rotate: bool = True) -> None:
        ckpt.save_bundle(self.tcfg.exp_dir, self.state, self.progress,
                         name=name, rotate=rotate, loader=self._loader(),
                         mesh=self.mesh, specs=self.state_specs)

    def _lr(self, step: int) -> torch.Tensor:
        t = self.tcfg
        if t.optimizer_name == "ScaledAdam":
            epoch = step // t.pseudo_epoch_size + 1
            lr = optim.eden_lr(
                t.lr, step, epoch, float(t.reduce_lr_start_step),
                float(t.reduce_lr_start_epoch),
                warmup_batches=t.num_steps * t.warmup_fraction)
        else:
            lr = optim.linear_warmup_decay_lr(
                t.lr, step, t.num_steps, t.num_steps * t.warmup_fraction)
        return lr.to(self.device)

    def _to_batch(self, examples, bucket_id, plan):
        return batching.pad_batch(
            examples, plan, bucket_id, text_len=self.tcfg.text_max_length,
            text_pad=self.tcfg.text_pad_token, audio_pad=self.cfg.special.pad)

    def _device_batch(self, np_batches: List[Dict[str, np.ndarray]]):
        stacked = {k: np.stack([nb[k] for nb in np_batches])
                   for k in np_batches[0]}
        if self.mesh is not None:
            from .. import parallel

            stacked = parallel.shard_batch(stacked, self.mesh, axis=1)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in stacked.items()}

    # ------------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        t = self.tcfg
        meters = defaultdict(float)
        running_loss, data_t0 = None, time.time()
        done = self.progress["step"] >= t.num_steps

        start_epoch = self.progress["epoch"]
        for epoch in range(start_epoch, t.num_epochs):
            if done:
                break
            if epoch == start_epoch and self.progress["cur_step"] > 0:
                self.sampler.set_epoch_resume(epoch, self.progress["cur_step"])
            else:
                self.sampler.set_epoch(epoch)
                self.progress["cur_step"] = 0
            self.progress["epoch"] = epoch

            for bucket_id, rows in self.sampler:
                examples = [self.train_ds[i] if i >= 0 else None for i in rows]
                self._pending[bucket_id].append(
                    self._to_batch(examples, bucket_id, self.plan))
                self.progress["cur_step"] += 1
                if len(self._pending[bucket_id]) < \
                        t.gradient_accumulation_steps:
                    continue
                batch = self._device_batch(self._pending.pop(bucket_id))

                step = self.progress["step"]
                lr = self._lr(step)
                meters["data_time"] += time.time() - data_t0
                t0 = time.time()
                self.state, metrics = self._step_fn(self.state, batch, lr)
                loss = float(metrics.loss)
                seconds = time.time() - t0
                meters["train_time"] += seconds
                data_t0 = time.time()
                self.history.append({
                    "step": step + 1, "loss": loss,
                    "ntokens": float(metrics.ntokens),
                    "grad_norm": float(metrics.grad_norm),
                    "nan_step": int(metrics.nan_step), "lr": float(lr),
                    "seconds": seconds})

                self.progress["step"] = step + 1
                if int(metrics.nan_step):
                    if self.lead:
                        log.warning("step %d skipped (non-finite "
                                    "gradients)", step)
                    self._log_dominant_params(batch)
                running_loss = loss if running_loss is None else (
                    0.98 * running_loss + 0.02 * loss)
                if not np.isfinite(running_loss) and step > 50:
                    raise RuntimeError(
                        "training diverged: running loss is not finite")

                if self.tb is not None and self.lead and \
                        (step + 1) % t.tb_write_every_n_steps == 0:
                    for k in ("loss", "mean_ce", "perplexity", "top10acc",
                              "grad_norm", "lr"):
                        self.tb.add_scalar(f"train/{k}",
                                           float(getattr(metrics, k)),
                                           step + 1)
                if (step + 1) % t.print_every_n_steps == 0:
                    self._info(
                        "step %d | loss %.4f | ppl %.2f | top10 %.3f | "
                        "lr %.2e | data %.1fs train %.1fs",
                        step + 1, loss, float(metrics.perplexity),
                        float(metrics.top10acc), float(lr),
                        meters["data_time"], meters["train_time"])
                if (step + 1) % t.save_every_n_steps == 0:
                    self._save(name=f"bundle_step{step + 1}", rotate=False)
                if (step + 1) % t.val_every_n_steps == 0:
                    if not self.validate_and_save(step + 1):
                        self._info("early stopping at step %d", step + 1)
                        done = True
                if self.progress["step"] >= t.num_steps:
                    done = True
                if done:
                    break
            else:
                # the epoch's sampler ran out: the next epoch starts fresh
                self.progress["cur_step"] = 0
                self.progress["epoch"] = epoch + 1

        self._save()
        return dict(self.progress)

    def _log_dominant_params(self, batch) -> None:
        """Name the tensors dominating the rms-scaled gradient norm after a
        skipped step (over a mesh every rank joins in the gradients, and
        rank 0 reports its own blocks)."""
        if not isinstance(self.state.opt, optim.ScaledAdamState):
            return
        try:
            mb = {k: v[:1] for k, v in batch.items()}
            if self.lcfg is not None:
                from . import lora

                def forward(ads, b):
                    return voice.forward(lora.wrap(self.base_params, ads,
                                                   self.lcfg), self.cfg, b)
            else:
                def forward(p, b):
                    return voice.forward(p, self.cfg, b)

            grads, _ = train_step.accumulate_grads(self.state.params, mb,
                                                   forward, self.mesh)
            if not self.lead:
                return
            for row in optim.dominant_parameter_report(
                    grads, self.state.opt, self.state.params):
                log.warning(
                    "dominant parameter %s: proportion %.2f of tot_sumsq "
                    "(sumsq %.3e, grad_sumsq %.3e, rms_sq %.3e)",
                    row["name"], row["proportion"], row["sumsq"],
                    row["grad_sumsq"], row["rms_sq"])
        except Exception:  # diagnostics must never kill training
            log.exception("dominant-parameter diagnostics failed")

    # ------------------------------------------------------------------

    def validate(self) -> Dict[str, float]:
        if self.valid_ds is None:
            raise ValueError("no validation dataset")
        sampler = batching.BucketBatchSampler(
            self.valid_ds.lengths, self.val_plan, shuffle=False, seed=0)
        params = self.state.params
        if self.lcfg is not None:
            from . import lora

            params = lora.apply(self.base_params, params, self.lcfg,
                                0 if self.mesh is None else self.mesh.tp_rank)
        tot = defaultdict(float)
        for bucket_id, rows in sampler:
            examples = [self.valid_ds[i] if i >= 0 else None for i in rows]
            b = self._to_batch(examples, bucket_id, self.val_plan)
            if self.mesh is not None:
                from .. import parallel

                b = parallel.shard_batch(b, self.mesh, axis=0)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                     .to(self.device) for k, v in b.items()}
            m = self._eval_fn(params, batch)
            ntok = float(m.ntokens)
            tot["loss_sum"] += float(m.mean_ce) * ntok
            tot["top10_sum"] += float(m.top10acc) * ntok
            tot["ntok"] += ntok
        ntok = max(tot["ntok"], 1.0)
        return {"loss": tot["loss_sum"] / ntok,
                "top10acc": tot["top10_sum"] / ntok, "ntokens": ntok}

    def validate_and_save(self, step: int) -> bool:
        """Returns False when early stopping should trigger."""
        t = self.tcfg
        if self.valid_ds is not None:
            val = self.validate()
            if self.tb is not None and self.lead:
                self.tb.add_scalar("val/loss", val["loss"], step)
                self.tb.add_scalar("val/top10acc", val["top10acc"], step)
            self._info("val @ %d: loss %.4f top10 %.3f", step, val["loss"],
                     val["top10acc"])
            score = val["loss"]
            improved = score < self.progress["best_score"] - max(
                t.early_stop_threshold, 0.0)
            if improved:
                self.progress["best_score"] = score
                self.progress["best_step"] = step
                self._save(name=ckpt.BEST_BUNDLE, rotate=False)
            if self._hooked and step % t.inference_every_n_steps == 0:
                # a plain whole tree, LoRA merged (gathered over a mesh)
                params = self._whole_params()
                if self.generation_hook is not None and self.lead:
                    try:
                        self.generation_hook(params, step)
                    except Exception as exc:  # diagnostics must not kill
                        log.warning("generation diagnostics failed: %s", exc)
                del params
        self._save()
        if (self.valid_ds is not None and t.early_stop_step > 0
                and step - self.progress["best_step"] >= t.early_stop_step):
            return False
        return True

"""Metric logging: TensorBoard + optional wandb.

Counterpart of ``t5gemma_tts_tpu/train/logging_utils.py``
(WANDB_MODE=offline is honored through the usual environment variable).
The TensorBoard writer is opened at the first scalar: importing it loads
TensorFlow where that is installed, which a run that logs nothing (a
smoke run, a test) need not pay.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger(__name__)


class MultiLogger:
    """add_scalar fan-out to TensorBoard and wandb (either optional)."""

    def __init__(self, exp_dir: str, use_tb: bool = True,
                 use_wandb: bool = False, wandb_project: str = "t5gemma-tts",
                 wandb_entity: Optional[str] = None,
                 config: Optional[dict] = None):
        self.exp_dir = exp_dir
        self.use_tb = use_tb
        self.tb = None
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, entity=wandb_entity,
                           dir=exp_dir, config=config or {})
                self.wandb = wandb
            except ImportError:
                log.info("wandb unavailable; skipping wandb logging")

    def _writer(self):
        if self.tb is None and self.use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(self.exp_dir, "tb"))
            except ImportError:
                log.info("tensorboard unavailable; skipping TB logging")
                self.use_tb = False
        return self.tb

    def add_scalar(self, name: str, value: float, step: int) -> None:
        if self._writer() is not None:
            self.tb.add_scalar(name, value, step)
        if self.wandb is not None:
            self.wandb.log({name: value}, step=step)

    def add_audio(self, name: str, wav, step: int, sample_rate: int) -> None:
        if self._writer() is not None:
            import torch

            self.tb.add_audio(name, torch.as_tensor(wav)[None], step,
                              sample_rate=sample_rate)
        if self.wandb is not None:
            self.wandb.log(
                {name: self.wandb.Audio(wav, sample_rate=sample_rate)},
                step=step)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()

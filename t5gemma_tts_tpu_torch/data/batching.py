"""Token-budget bucket batching with fixed padded shapes.

The port's own copy of ``t5gemma_tts_tpu/data/batching.py``: bucket
boundaries from the lognorm-warped quantile construction, batches filled to
a token budget, and every batch of bucket *i* the exact shape
(bucket_batch_size[i], bucket_len[i]), partial batches padded with dummy
rows that count no loss. Per-epoch seeded shuffle (seed + epoch) and
mid-epoch resume by skipping ``cur_step`` batches.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import lognorm

log = logging.getLogger(__name__)


def lognorm_bucket_boundaries(max_length: int, num_buckets: int) -> np.ndarray:
    """Lognormal-warped quantile boundaries."""
    num_boundaries = num_buckets + 1
    latent = np.linspace(1 / num_boundaries, num_buckets / num_boundaries,
                         num_buckets)
    q = lognorm.ppf(latent, 1)
    return np.sort(q * max_length / q[-1])


@dataclass
class BucketPlan:
    boundaries: np.ndarray       # right boundaries, ascending
    batch_sizes: List[int]       # rows per batch, per bucket (incl. overflow)
    pad_lens: List[int]          # static padded length per bucket

    @property
    def num_buckets(self) -> int:
        return len(self.batch_sizes)


def make_plan(lengths: Sequence[int], max_batch_tokens: int,
              num_buckets: int, max_len: Optional[int] = None,
              round_to: int = 32, batch_multiple: int = 1) -> BucketPlan:
    """``batch_multiple``: bucket batch sizes are rounded up to a multiple of
    the mesh's data-parallel size so sharded batches divide evenly."""
    lengths = np.asarray(lengths)
    cap = int(max_len if max_len is not None else lengths.max())
    boundaries = lognorm_bucket_boundaries(min(int(lengths.max()), cap),
                                           num_buckets)
    pad_lens, batch_sizes = [], []
    bounds = list(boundaries) + [cap]
    m = max(1, batch_multiple)
    for b in bounds:
        pad = int(math.ceil(min(b, cap) / round_to) * round_to)
        pad = max(pad, round_to)
        pad_lens.append(pad)
        bs = max(1, int(max_batch_tokens / pad))
        batch_sizes.append(int(math.ceil(bs / m) * m))
    return BucketPlan(boundaries=boundaries, batch_sizes=batch_sizes,
                      pad_lens=pad_lens)


class BucketBatchSampler:
    """Yields (bucket_id, indices) with len(indices) == batch_sizes[bucket];
    indices of -1 mark dummy padding rows."""

    def __init__(self, lengths: Sequence[int], plan: BucketPlan,
                 shuffle: bool = True, seed: int = 0, epoch: int = 0,
                 drop_last: bool = False,
                 data_parallel: int = 1):
        self.lengths = np.asarray(lengths)
        self.plan = plan
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.data_parallel = max(1, data_parallel)
        self._skip = 0
        self._regenerate()

    # -- epoch control (mirrors set_epoch / set_epoch_resume) ---------------

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._skip = 0
        self._regenerate()

    def set_epoch_resume(self, epoch: int, cur_step: int) -> None:
        self.epoch = epoch
        self._skip = cur_step
        self._regenerate()

    def _regenerate(self) -> None:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(self.lengths)) if self.shuffle \
            else np.arange(len(self.lengths))

        buckets: List[List[int]] = [[] for _ in range(self.plan.num_buckets)]
        batches: List[Tuple[int, List[int]]] = []
        for idx in order:
            b = int(np.searchsorted(self.plan.boundaries, self.lengths[idx]))
            buckets[b].append(int(idx))
            if len(buckets[b]) >= self.plan.batch_sizes[b]:
                batches.append((b, buckets[b]))
                buckets[b] = []
        if not self.drop_last:
            for b, rows in enumerate(buckets):
                if rows:
                    # pad to the static batch size with dummy rows
                    pad = self.plan.batch_sizes[b] - len(rows)
                    batches.append((b, rows + [-1] * pad))

        if self.shuffle:
            perm = rng.permutation(len(batches))
            batches = [batches[i] for i in perm]
        # batch size per bucket must divide the data-parallel axis evenly;
        # round batch sizes up at plan time if you shard the batch dim.
        self._batches = batches

    def __len__(self) -> int:
        return max(0, len(self._batches) - self._skip)

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        for bucket_id, rows in self._batches[self._skip:]:
            yield bucket_id, rows
        self._skip = 0


def pad_batch(examples, plan: BucketPlan, bucket_id: int,
              text_len: int, text_pad: int, audio_pad: int):
    """Assemble a fixed-shape numpy batch from Example objects (None/dummy
    entries become zero-loss rows)."""
    bsz = plan.batch_sizes[bucket_id]
    t_audio = plan.pad_lens[bucket_id]
    x = np.full((bsz, text_len), text_pad, np.int32)
    x_lens = np.ones((bsz,), np.int32)
    y = np.full((bsz, t_audio), audio_pad, np.int32)
    y_lens = np.ones((bsz,), np.int32)
    sep = np.full((bsz,), t_audio + 2, np.int32)  # dummy rows: nothing counted
    for i, ex in enumerate(examples):
        if ex is None:
            continue
        xi = ex.x[:text_len]
        yi = ex.y[:t_audio]
        x[i, : len(xi)] = xi
        x_lens[i] = len(xi)
        y[i, : len(yi)] = yi
        y_lens[i] = len(yi)
        sep[i] = min(ex.y_sep_position, len(yi))
    return {"x": x, "x_lens": x_lens, "y": y, "y_lens": y_lens,
            "y_sep_position": sep}

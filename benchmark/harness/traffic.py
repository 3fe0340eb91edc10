"""The one generator of requests: it reads a traffic file's parameters and
the run's ``--seed``. Every seed does the same work: offline batches hold
the same stratified quantiles of their law in an order of the seed's own;
arrivals follow one Poisson schedule drawn from the traffic file's
``schedule_seed``. The seed draws the texts.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List

ALPHABET = "abcdefghijklmnopqrstuvwxyz"


@dataclass(frozen=True)
class Item:
    text: str
    duration_s: float
    due_s: float = 0.0          # arrivals: seconds after the window opens
    batch: int = 0              # offline: the batch it belongs to


def rng_for(seed: int, stream: str) -> random.Random:
    """A generator of the seed and a named stream (so that adding a draw to
    one stream does not shift another)."""
    return random.Random(f"{int(seed)}/{stream}")


def text_of(rng: random.Random, n_chars: int) -> str:
    """Lower-case words of 2-9 letters joined by single spaces, exactly
    ``n_chars`` long, neither starting nor ending with a space (the
    port's text front-end leaves such English text as it is)."""
    words: List[str] = []
    length = 0
    while length < n_chars:
        w = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(2, 9)))
        words.append(w)
        length += len(w) + 1
    text = " ".join(words)[:n_chars]
    return text.rstrip() + "x" * (n_chars - len(text.rstrip()))


def n_chars(params: Dict, duration_s: float) -> int:
    return max(1, round(float(params["chars_per_s"]) * duration_s))


def quantize_duration(params: Dict, seconds: float) -> float:
    """A whole number of codec frames."""
    fps = int(params.get("frames_per_s", 50))
    return round(seconds * fps) / fps


def stratified_uniform(low: float, high: float, n: int) -> List[float]:
    return [low + (i + 0.5) / n * (high - low) for i in range(n)]


def offline_batches(params: Dict, seed: int) -> Iterator[List[Item]]:
    """Batches of ``per_batch`` requests without end, each holding the same
    stratified durations in an order of its own. A batch is drawn when it
    is taken, so set-up draws none that the run does not send."""
    d = params["duration_s"]
    per = int(params["per_batch"])
    base = [quantize_duration(params, x)
            for x in stratified_uniform(float(d["low"]), float(d["high"]),
                                        per)]
    order, texts = rng_for(seed, "order"), rng_for(seed, "text")
    b = 0
    while True:
        durs = list(base)
        order.shuffle(durs)
        yield [Item(text_of(texts, n_chars(params, x)), x, batch=b)
               for x in durs]
        b += 1


def arrivals(params: Dict, seed: int, seconds: float) -> List[Item]:
    """Open-loop Poisson arrivals at ``rate_per_s``: independent exponential
    gaps (unit draws over the rate, so that one schedule serves a sweep of
    rates) and log-normal durations, clipped, both drawn from the traffic
    file's ``schedule_seed``; every request due within ``seconds`` is sent.
    The schedule, bursts and all, is the same for every run, so the seed
    changes the texts and not the load."""
    rate = float(params["rate_per_s"])
    d = params["duration_s"]
    mu, sigma = math.log(float(d["median"])), float(d["sigma"])
    low, high = float(d["low"]), float(d["high"])
    schedule = int(params["schedule_seed"])
    gaps, durs = rng_for(schedule, "gaps"), rng_for(schedule, "durations")
    texts = rng_for(seed, "text")
    items: List[Item] = []
    due = gaps.expovariate(1.0) / rate
    while due <= seconds:
        dur = quantize_duration(
            params, min(max(durs.lognormvariate(mu, sigma), low), high))
        items.append(Item(text_of(texts, n_chars(params, dur)), dur,
                          due_s=due))
        due += gaps.expovariate(1.0) / rate
    return items

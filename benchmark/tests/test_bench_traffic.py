"""The generator repeats exactly from a seed, and every seed does the same
work: offline, the same sizes in an order of its own; arrivals, one
Poisson schedule."""

import math
import statistics
from collections import Counter
from itertools import islice

from benchmark.harness import traffic

OFF = {"per_batch": 16, "duration_s": {"low": 5.0, "high": 10.0},
       "chars_per_s": 14, "frames_per_s": 50}
ARR = {"rate_per_s": 3.2, "chars_per_s": 14, "frames_per_s": 50,
       "schedule_seed": 1,
       "duration_s": {"median": 2.5, "sigma": 0.6, "low": 0.5, "high": 10.0}}
BIG = 2 ** 31 + 987654321


def batches(params, seed, n):
    return list(islice(traffic.offline_batches(params, seed), n))


def test_offline_repeats_from_seed():
    assert batches(OFF, BIG, 5) == batches(OFF, BIG, 5)
    # a longer job starts with the same batches
    assert batches(OFF, BIG, 3) == batches(OFF, BIG, 7)[:3]


def test_offline_same_sizes_every_seed():
    a = batches(OFF, 1, 4)
    b = batches(OFF, BIG, 4)
    for x, y in zip(a, b):
        assert Counter(i.duration_s for i in x) == Counter(
            i.duration_s for i in y)
        assert [i.text for i in x] != [i.text for i in y]
    durs = sorted(i.duration_s for i in a[0])
    assert durs[0] > 5.0 and durs[-1] < 10.0 and len(set(durs)) == 16


def test_offline_texts():
    for item in batches(OFF, 7, 2)[1]:
        assert len(item.text) == round(14 * item.duration_s)
        assert item.text == item.text.strip()
        assert "  " not in item.text
        assert set(item.text) <= set(traffic.ALPHABET + " ")
        assert abs(item.duration_s * 50 - round(item.duration_s * 50)) < 1e-9


def test_arrivals_repeat_and_share_sizes():
    a = traffic.arrivals(ARR, BIG, 50)
    assert a == traffic.arrivals(ARR, BIG, 50)
    b = traffic.arrivals(ARR, 3, 50)
    assert [(i.due_s, i.duration_s) for i in a] == [
        (i.due_s, i.duration_s) for i in b]
    assert [i.text for i in a] != [i.text for i in b]
    assert [len(i.text) for i in a] == [len(i.text) for i in b]
    dues = [i.due_s for i in a]
    assert dues == sorted(dues) and dues[0] > 0 and dues[-1] <= 50
    assert min(i.duration_s for i in a) >= 0.5
    assert max(i.duration_s for i in a) <= 10.0
    # another schedule seed, another schedule; a longer window, more of it
    other = traffic.arrivals(dict(ARR, schedule_seed=2), BIG, 50)
    assert [i.due_s for i in other] != dues
    assert traffic.arrivals(ARR, BIG, 80)[:len(a)] == a


def test_arrivals_rate():
    # one schedule of unit gaps over the rate: a faster rate is the same
    # sequence of requests, due sooner
    slow = traffic.arrivals(dict(ARR, rate_per_s=1.0), 11, 400)
    for rate in (1.0, 4.0, 9.5):
        items = traffic.arrivals(dict(ARR, rate_per_s=rate), 11, 400)
        n = rate * 400
        assert abs(len(items) - n) < 4 * math.sqrt(n)
        k = min(len(items), len(slow))
        assert [i.duration_s for i in items[:k]] == [
            i.duration_s for i in slow[:k]]
        assert all(abs(x.due_s * rate - y.due_s) < 1e-6
                   for x, y in zip(items[:k], slow[:k]))


def test_arrivals_are_poisson():
    # independent exponential gaps: their spread equals their mean, and the
    # counts in stretches of the window spread as Poisson counts do (no
    # smoothing of bursts)
    items = traffic.arrivals(ARR, BIG, 3000)
    dues = [0.0] + [i.due_s for i in items]
    gaps = [b - a for a, b in zip(dues, dues[1:])]
    mean = statistics.fmean(gaps)
    assert abs(mean * ARR["rate_per_s"] - 1) < 0.05
    assert abs(statistics.pstdev(gaps) / mean - 1) < 0.08
    width = 6.25
    counts = Counter(int(i.due_s // width) for i in items)
    per = [counts.get(k, 0) for k in range(int(3000 // width))]
    dispersion = statistics.pvariance(per) / statistics.fmean(per)
    assert 0.75 < dispersion < 1.3
    durs = sorted(i.duration_s for i in items)
    assert abs(durs[len(durs) // 2] - 2.5) < 0.15

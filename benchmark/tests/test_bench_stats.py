"""The metric arithmetic: a whole-window rate, a percentile over all
requests with failures counted as missing, and the union of intervals."""

import math

import pytest

from benchmark.harness import stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(480.0, 60.0) == 8.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_p95_counts_failures_as_missing():
    served = [float(i) for i in range(1, 201)]          # 1 .. 200 s
    assert stats.nearest_rank(served, 0.95) == 190.0
    # ten failures rank above every served request
    with_failures = served[:190] + [math.inf] * 10
    assert stats.nearest_rank(with_failures, 0.95) == 190.0
    with_more = served[:189] + [math.inf] * 11
    assert stats.nearest_rank(with_more, 0.95) == math.inf
    assert stats.nearest_rank([3.0], 0.95) == 3.0


def test_union_counts_overlap_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert stats.union_length([]) == 0


def test_gaps():
    assert stats.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
    assert stats.gaps([(0, 7)], 0, 7) == []

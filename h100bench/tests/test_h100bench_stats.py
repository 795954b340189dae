"""Window attribution, percentiles and rates on synthetic timestamps."""

import math
import statistics

from h100bench import stats


def test_tokens_and_gaps_are_attributed_by_timestamp():
    reqs = [[0.5, 1.0, 1.5, 2.0, 2.5], [1.9, 2.1, 3.2]]
    assert stats.tokens_in(reqs, 1.0, 3.0) == 6            # 1.0 .. 2.5 and 1.9, 2.1
    gaps = stats.gaps_in(reqs, 1.0, 3.0)
    assert sorted(gaps) == sorted([0.5, 0.5, 0.5, 2.1 - 1.9])   # 2.1 -> 3.2 leaves the window


def test_a_stall_that_a_median_hides_shows_in_the_tail():
    # 30 streams ticking every 20 ms; every 50th gap holds a 600 ms admission
    reqs = []
    for s in range(30):
        t, times = s * 0.001, []
        for k in range(500):
            t += 0.6 if (k + s) % 50 == 0 else 0.02
            times.append(t)
        reqs.append(times)
    gaps = stats.gaps_in(reqs, 0.0, 1e9)
    assert abs(statistics.median(gaps) - 0.02) < 1e-9
    assert stats.percentile(gaps, 95) < 0.03
    assert abs(stats.percentile(gaps, 99) - 0.6) < 1e-9


def test_percentile_interpolates_and_keeps_infinity():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0
    assert stats.percentile([1.0] * 95 + [math.inf] * 5, 95) == math.inf


def test_ttft_counts_failures_as_infinite():
    v = stats.ttfts([(1.0, 1.5, False), (2.0, None, False), (2.5, 3.0, True), (9.0, 9.1, False)],
                    0.0, 5.0)
    assert v == [0.5, math.inf, math.inf]


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps_between(iv, 0, 8) == [(3, 5), (6, 8)]
    assert stats.gaps_between(iv, -1, 1) == [(-1, 0)]


def test_rate_over_window():
    reqs = [[i * 0.01 for i in range(1000)]]
    assert stats.tokens_in(reqs, 2.0, 7.0) / 5.0 == 100.0

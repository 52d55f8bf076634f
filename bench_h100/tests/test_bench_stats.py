"""Percentiles over all requests, rates over all work and all the window."""
import pytest

from stats import chunk_gaps_ms, frames_per_s, percentile, ttfa_ms, union_ms


def _rec(due, chunks, end=None):
    return {"due": due, "chunks": [(t, n, {}) for t, n in chunks], "end": end}


def test_percentile_interpolates_between_order_statistics():
    assert percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert percentile([4, 1, 3, 2], 50) == 2.5
    assert percentile([7.0], 95) == 7.0
    assert percentile([], 95) is None


def test_ttfa_counts_from_the_due_time_for_every_request():
    recs = [_rec(10.0, [(10.5, 8), (11.0, 8)]), _rec(10.2, [(11.2, 8)]), _rec(11.0, [])]
    assert ttfa_ms(recs) == pytest.approx([500.0, 1000.0])
    assert chunk_gaps_ms(recs) == pytest.approx([500.0])


def test_frames_per_s_is_all_frames_over_the_whole_window():
    recs = [_rec(0.0, [(1.0, 8), (2.0, 8)], end=2.0), _rec(2.0, [(3.0, 4)], end=4.0)]
    assert frames_per_s(recs, t0=0.0) == pytest.approx(20 / 4.0)


def test_union_of_intervals():
    assert union_ms([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_ms([(-1, 2), (9, 12)], 0, 10) == 3

"""The window's arithmetic (provebench/window.py)."""

import pytest

import window


def test_rate_counts_whole_proves_over_the_window():
    proves = [{"steps": 1 << 20}, {"steps": 1 << 20}, {"steps": 1 << 20}]
    assert window.rate(proves, 2.0) == 3 * (1 << 20) / 2.0


@pytest.mark.parametrize("n, rank", [(1, 1), (9, 9), (10, 9), (11, 10), (45, 41), (100, 90)])
def test_p90_is_the_nearest_rank(n, rank):
    values = [float(v) for v in range(n, 0, -1)]  # unsorted on purpose
    assert window.percentile(values, 90) == float(rank)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        window.percentile([], 90)


def test_busy_is_the_union_clipped_to_the_window():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert window.busy(intervals, 0.5, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert window.merged(intervals, 0.0, 10.0) == [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]


def test_gaps_are_the_complement_of_the_union():
    intervals = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert window.gaps(intervals, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    assert window.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    busy = window.busy(intervals, 0.0, 7.0)
    assert busy + sum(b - a for a, b in window.gaps(intervals, 0.0, 7.0)) == pytest.approx(7.0)


def test_stage_edges_are_running_sums_of_the_timings():
    edges = window.stage_edges(10.0, [("device_columns", 0.5), ("commit", 0.25), ("lde", 1.0)])
    assert edges == [("device_columns", 10.0, 10.5), ("commit", 10.5, 10.75),
                     ("lde", 10.75, 11.75)]


def test_gaps_are_cut_at_stage_edges():
    spans = window.stage_edges(1.0, [("a", 1.0), ("b", 1.0)])  # a: [1, 2], b: [2, 3]
    idle = window.label_gaps([(0.5, 1.5), (1.8, 2.4), (2.9, 4.0)], spans)
    assert idle == pytest.approx({"outside_prove": 0.5 + 1.0, "a": 0.5 + 0.2, "b": 0.4 + 0.1})


def test_mean_stage_sums_the_keys_a_prove_has():
    proves = [{"timings": {"lde": 1.0, "commit": 0.5}}, {"timings": {"lde": 3.0}},
              {"timings": None}]
    assert window.mean_stage(proves, "lde", "commit") == pytest.approx((1.5 + 3.0) / 2)
    assert window.mean_stage(proves, "fri_commit") is None

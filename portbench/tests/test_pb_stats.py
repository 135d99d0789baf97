import statistics

import pytest

from portbench import stats


def test_sypd_is_all_steps_over_all_the_time():
    # 86400 steps of 365 s in one day of wall time: 86400 * 365 s = 1 year... per day
    assert stats.sypd(86400, 365.0, 86400.0) == pytest.approx(1.0)
    # 1,000 steps of 500 s in 8 s
    assert stats.sypd(1000, 500.0, 8.0) == pytest.approx(1000 * 500 / (365 * 86400) / (8 / 86400))
    with pytest.raises(ValueError):
        stats.sypd(0, 500.0, 1.0)


def test_p95_takes_every_step_not_chunks():
    steps = [1.0] * 90 + [10.0] * 10          # a stall in a tenth of the steps
    assert stats.percentile(steps, 95) == pytest.approx(10.0)
    # medians of chunks of ten would hide it
    chunks = [statistics.median(steps[i:i + 10]) for i in range(0, 100, 10)]
    assert stats.percentile(chunks, 95) < 10.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_step_times_from_stamps():
    assert stats.intervals_between([0.0, 1.0, 3.0, 6.0]) == [1.0, 2.0, 3.0]


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.0)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.union_length([]) == 0.0
    g = stats.gaps(iv, 0.0, 5.0)
    assert g[0] == (4.0, 5.0) or g[0] == (2.0, 3.0)
    assert sum(b - a for a, b in g) == pytest.approx(5.0 - 3.0)



def test_idle_share_is_busy_a_traced_step_against_an_untraced_step():
    from portbench import metrics

    # the profiled window ran 10 steps in 0.2 s with 0.08 s busy; the
    # measured window ran 100 steps in 1.0 s: 8 ms busy of 10 ms a step
    run = {"steps": 100, "wall_s": 1.0, "trace": {"busy_s": 0.08, "steps": 10, "window_s": 0.2}}
    assert metrics.read("device_idle_share", run) == pytest.approx(20.0)
    # a split of the quantity is read by the same reader
    assert metrics.read("device_idle_share.campaign", run) == pytest.approx(20.0)
    assert metrics.read("device_idle_share", {"steps": 100, "wall_s": 1.0, "trace": None}) is None

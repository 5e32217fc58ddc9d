"""The end-to-end arithmetic: every trial and the whole window, so that a
stall anywhere moves the numbers."""

import gb_fixtures  # noqa: F401
import pytest

from gbharness import window


def _trials(walls):
    return [window.Trial(index=i, algo="a", source=0, start=0.0, wall=w, stats={})
            for i, w in enumerate(walls)]


def test_percentile_takes_every_trial():
    walls = [0.1] * 95 + [0.5] * 5
    assert window.trial_ms_p95(_trials(walls)) == pytest.approx(100.0)
    walls[0] = 0.9   # one more slow trial among 100 lifts the 95th
    assert window.trial_ms_p95(_trials(walls)) == pytest.approx(500.0)
    assert window.percentile([3, 1, 2], 50) == 2


def test_a_stall_moves_the_rates():
    steady = _trials([0.1] * 100)
    stalled = _trials([0.1] * 99 + [2.0])
    assert window.gteps(steady, 10.0, 10**9) == pytest.approx(10.0)
    assert window.gteps(stalled, 11.9, 10**9) < window.gteps(steady, 10.0, 10**9)
    assert window.solve_s(stalled, 11.9) > window.solve_s(steady, 10.0)
    assert window.trial_ms_p95(stalled) == pytest.approx(100.0)
    stalled_tail = _trials([0.1] * 90 + [2.0] * 10)
    assert window.trial_ms_p95(stalled_tail) == pytest.approx(2000.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_run_counts_the_trial_in_flight_and_all_time():
    clock = FakeClock()
    walls = iter([0.4, 0.4, 3.0, 0.4, 0.4, 0.4])

    def call(algo, source):
        clock.t += next(walls)
        return None, {}

    def gap():
        clock.t += 0.05   # time between trials belongs to the window too

    win = window.run(lambda k: ("a", k), call, gap, 4.0, clock=clock)
    assert len(win.trials) == 4
    assert win.seconds == pytest.approx(4.4)
    assert [t.source for t in win.trials] == [0, 1, 2, 3]
    assert window.solve_s(win.trials, win.seconds) == pytest.approx(1.1)


def test_run_stops_at_max_trials():
    clock = FakeClock()
    win = window.run(lambda k: ("a", k), lambda a, s: (None, {}), lambda: None, None,
                     max_trials=3, clock=clock)
    assert len(win.trials) == 3


def test_sample_keeps_per_algo_and_the_slowest():
    s = window.Sample(seed=7, per_algo=2)
    for i in range(50):
        t = window.Trial(index=i, algo="ab"[i % 2], source=i, start=0.0,
                         wall=1.0 if i == 31 else 0.1, stats={})
        s.offer(t, i)
    items = s.items()
    assert {t.algo for t, _ in items} == {"a", "b"}
    assert 31 in [t.index for t, _ in items]
    assert len(items) <= 6
    again = window.Sample(seed=7, per_algo=2)
    for i in range(50):
        again.offer(window.Trial(index=i, algo="ab"[i % 2], source=i, start=0.0,
                                 wall=1.0 if i == 31 else 0.1, stats={}), i)
    assert [t.index for t, _ in again.items()] == [t.index for t, _ in items]

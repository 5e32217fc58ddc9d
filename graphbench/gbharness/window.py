"""The measured window: a closed loop with one client, and the end-to-end
arithmetic over everything it ran.

Each trial (a traversal from one source, or one solve) is timed by the
host clock from its call to ``synchronize()``.  The window runs trials
back to back until ``seconds`` have passed; the trial in flight at the
deadline is finished and counted, so the window is the wall from its
start to the end of its last trial, and every second of it is in the
rates.  No statistic is taken over chunks of the window.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable


@dataclasses.dataclass
class Trial:
    index: int
    algo: str
    source: int | None
    start: float   # host clock, seconds since the window began
    wall: float    # seconds from the call to synchronize()
    stats: dict


@dataclasses.dataclass
class Window:
    trials: list
    seconds: float        # from the window's start to its last trial's end
    captures: int = 0     # rung loops the program captured inside the window


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values`` (all of them)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def gteps(trials, seconds: float, m: int) -> float:
    """Completed trials times the input's edge count over the window, in
    billions a second."""
    return len(trials) * m / seconds / 1e9


def trial_ms_p95(trials) -> float:
    return percentile([t.wall for t in trials], 95) * 1e3


def solve_s(trials, seconds: float) -> float:
    """The window's wall over its completed solves."""
    return seconds / len(trials)


class Sample:
    """A seeded reservoir of ``per_algo`` trial outputs for each algorithm,
    plus each algorithm's slowest trial: what ``correct`` compares.  Only
    references are held, so keeping them costs no device work."""

    def __init__(self, seed: int, per_algo: int):
        self._rng = random.Random(seed)
        self.per_algo = per_algo
        self._seen: dict = {}
        self.kept: dict = {}      # algo -> [(trial, output)]
        self.slowest: dict = {}   # algo -> (trial, output)

    def offer(self, trial: Trial, output) -> None:
        a = trial.algo
        seen = self._seen[a] = self._seen.get(a, 0) + 1
        kept = self.kept.setdefault(a, [])
        if len(kept) < self.per_algo:
            kept.append((trial, output))
        else:
            j = self._rng.randrange(seen)
            if j < self.per_algo:
                kept[j] = (trial, output)
        slow = self.slowest.get(a)
        if slow is None or trial.wall > slow[0].wall:
            self.slowest[a] = (trial, output)

    def items(self):
        """The sampled trials, each once, in trial order."""
        out = {}
        for a, kept in self.kept.items():
            for t, o in kept + [self.slowest[a]]:
                out[t.index] = (t, o)
        return [out[i] for i in sorted(out)]


def run(plan: Callable[[int], tuple], call: Callable, sync: Callable,
        seconds: float | None, *, max_trials: int | None = None,
        on_trial: Callable | None = None, captures: Callable = lambda: 0,
        clock: Callable = time.perf_counter) -> Window:
    """Trials ``plan(0), plan(1), ...`` (each ``(algo, source)``) back to
    back, until ``seconds`` have passed or ``max_trials`` have run.
    ``call(algo, source)`` returns ``(output, stats)``; ``on_trial(trial,
    output)`` sees each one."""
    trials = []
    cap0 = captures()
    start = clock()
    end = start
    k = 0
    while True:
        algo, source = plan(k)
        t0 = clock()
        out, stats = call(algo, source)
        sync()
        end = clock()
        t = Trial(index=k, algo=algo, source=source, start=t0 - start,
                  wall=end - t0, stats=dataclasses.asdict(stats)
                  if dataclasses.is_dataclass(stats) else dict(stats))
        trials.append(t)
        if on_trial is not None:
            on_trial(t, out)
        k += 1
        if max_trials is not None and k >= max_trials:
            break
        if seconds is not None and end - start >= seconds:
            break
    return Window(trials=trials, seconds=end - start, captures=captures() - cap0)
